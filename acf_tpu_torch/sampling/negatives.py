"""Sequence-window sampler on the device (the sequence half of
``acf_tpu/sampling/negatives.py``).

Semantics of the reference's ``WarpSampler``/``sample_function``
(SASRecLayers.py:329-358) in the JAX package's vectorized form: users with
at least two train items are drawn with replacement; each one's window is
the last ``maxlen + 1`` items of its right-aligned history, left-padded with
item 0 when the history is narrower; every non-pad position gets one
negative by fixed-round resampling (R candidate rounds drawn up front, the
first that is not one of the user's train items is taken, the last round
is the fallback).

The draws are split from the arithmetic: :func:`seq_window_from_draws` is a
pure function of the drawn user indices and candidates, so the tests feed
it ``jax.random``'s draws and compare exactly; :func:`sample_seq_window_batch`
draws them from a :class:`torch.Generator` on the data's device.
"""

from __future__ import annotations

import torch


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
