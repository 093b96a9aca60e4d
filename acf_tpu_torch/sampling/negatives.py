"""Samplers on the device (counterpart of ``acf_tpu/sampling/negatives.py``).

Pairs: :func:`sample_pair_epoch` shuffles the train pairs into the epoch's
batches (the reference's per-epoch shuffle and drop-remainder batching,
evaluation_adv.py:59-72) and :func:`uniform_negatives` draws one negative
per row by fixed-round resampling: R candidate rounds drawn up front, the
first that is not one of the row's train items taken, the last round the
fallback.

Sequences: the semantics of the reference's ``WarpSampler``/``sample_function``
(SASRecLayers.py:329-358) in the JAX package's vectorized form: users with
at least two train items are drawn with replacement; each one's window is
the last ``maxlen + 1`` items of its right-aligned history, left-padded with
item 0 when the history is narrower; every non-pad position gets one
negative by fixed-round resampling (R candidate rounds drawn up front, the
first that is not one of the user's train items is taken, the last round
is the fallback).

The draws are split from the arithmetic: :func:`pair_batches_from_perm`,
:func:`negatives_from_draws` and :func:`seq_window_from_draws` are pure
functions of the drawn permutation, candidates and user indices, so the
tests feed them ``jax.random``'s draws and compare exactly; the samplers
draw them from a :class:`torch.Generator` on its device.
"""

from __future__ import annotations

import torch


def pair_batches_from_perm(perm, batch_size: int, num_batches: int):
    """[num_batches, batch_size] pair indices from a permutation of the
    pairs: the permutation is repeated when one epoch needs more indices
    than there are pairs (fewer pairs than one batch), and the remainder is
    dropped."""
    need = num_batches * batch_size
    if need > perm.shape[0]:
        perm = perm.repeat(-(-need // perm.shape[0]))
    return perm[:need].reshape(num_batches, batch_size)


def sample_pair_epoch(generator: torch.Generator, num_pairs: int, batch_size: int,
                      num_batches: int):
    """The epoch's shuffled batches of pair indices, [num_batches,
    batch_size] int64, from ``generator`` on its device."""
    perm = torch.randperm(num_pairs, generator=generator, device=generator.device)
    return pair_batches_from_perm(perm, batch_size, num_batches)


def negatives_from_draws(cand, hist_rows):
    """[B] negatives from the candidate rounds ``cand`` [R, B] (items in
    [1, num_items)) and each row's train items ``hist_rows`` [B, L]
    (0-padded, so the padding never collides): the first round whose
    candidate is not a train item, else the last round."""
    rounds = cand.shape[0]
    collide = (cand[:, :, None] == hist_rows[None, :, :]).any(dim=-1)  # [R, B]
    clean = ~collide
    first = torch.where(clean.any(dim=0), clean.to(torch.int8).argmax(dim=0), rounds - 1)
    return cand.gather(0, first[None, :].to(torch.int64))[0]


def uniform_negatives(generator: torch.Generator, hist_rows, num_items: int, rounds: int = 8):
    """One uniform negative per row of ``hist_rows`` [B, L], rejecting the
    row's train items; [B] int32 in [1, num_items)."""
    cand = torch.randint(1, num_items, (rounds, hist_rows.shape[0]), generator=generator,
                         device=generator.device, dtype=torch.int32)
    return negatives_from_draws(cand, hist_rows)


def seq_window_from_draws(hist, eligible_users, idx, cand, maxlen: int):
    """(users [B], window [B, maxlen + 1], neg [B, maxlen]) from the draws.

    Args:
      hist: [U, L] right-aligned train histories (0-padded), int32.
      eligible_users: [E] users with at least two train items.
      idx: [B] indices into ``eligible_users``.
      cand: [R, B, maxlen] negative candidates in [1, num_items).
      maxlen: window length T (the window holds T + 1 items).
    """
    users = eligible_users[idx]
    rows = hist[users]  # [B, L]
    b, L = rows.shape
    if L >= maxlen + 1:
        window = rows[:, L - maxlen - 1:]
    else:
        window = torch.cat([torch.zeros(b, maxlen + 1 - L, dtype=rows.dtype,
                                        device=rows.device), rows], dim=1)
    pos = window[:, 1:]
    # membership of each candidate in its user's row: a sorted-row search
    # instead of an [R, B, T, L] comparison (hist is 0-padded and
    # candidates are >= 1, so the padding never collides)
    rounds = cand.shape[0]
    srt = rows.sort(dim=1).values.contiguous()
    flat = cand.permute(1, 0, 2).reshape(b, -1).to(srt.dtype).contiguous()
    at = torch.searchsorted(srt, flat).clamp_(max=L - 1)
    collide = (srt.gather(1, at) == flat).reshape(b, rounds, maxlen)
    clean = ~collide
    # the first clean round, else the last (the JAX scan's init)
    first = torch.where(clean.any(dim=1), clean.to(torch.int8).argmax(dim=1), rounds - 1)
    neg = cand.permute(1, 0, 2).gather(1, first[:, None, :].to(torch.int64))[:, 0]
    neg = torch.where(pos != 0, neg.to(window.dtype), 0)  # pad positions carry no negative
    return users, window, neg


def sample_seq_window_batch(generator: torch.Generator, hist, eligible_users,
                            maxlen: int, num_items: int, batch_size: int,
                            rounds: int = 8):
    """(users, window [B, maxlen + 1], neg [B, maxlen]) with seq =
    ``window[:, :-1]`` and pos = ``window[:, 1:]``, drawn from
    ``generator`` on its device (the packed form ``loss_window`` reads)."""
    dev = generator.device
    idx = torch.randint(0, eligible_users.shape[0], (batch_size,), generator=generator,
                        device=dev)
    cand = torch.randint(1, num_items, (rounds, batch_size, maxlen), generator=generator,
                         device=dev, dtype=torch.int32)
    return seq_window_from_draws(hist, eligible_users, idx, cand, maxlen)


def sample_seq_batch(generator: torch.Generator, hist, eligible_users, maxlen: int,
                     num_items: int, batch_size: int, rounds: int = 8):
    """(users, seq, pos, neg): :func:`sample_seq_window_batch` expanded."""
    users, window, neg = sample_seq_window_batch(
        generator, hist, eligible_users, maxlen, num_items, batch_size, rounds)
    return users, window[:, :-1], window[:, 1:], neg
