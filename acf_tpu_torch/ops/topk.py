"""Full-catalog top-K retrieval (counterpart of ``acf_tpu/ops/topk.py``).

Serving needs the top-K items per user over the whole catalog with the
user's train items excluded. Scores are produced per item tile and reduced
to a per-tile top-K at once, so only [B, n_tiles·K] candidates exist before
the final merge. The [B, d] x [d, T] tile product is a plain ``torch.matmul``
(the JAX package leaves it to XLA as well).
"""

from __future__ import annotations

import numpy as np
import torch

from acf_tpu_torch.device import resolve_device

NEG = -3.0e38


def topk_factored(u_repr, item_emb, hists, bias=None, k: int = 10,
                  item_tile: int = 4096, id_base: int = 0):
    """Top-K (scores, item ids) per user for dot-factored scorers.

    Args:
      u_repr: [B, d] user representations.
      item_emb: [I, d] item table.
      hists: [B, L] train items to exclude (0-padded; id 0 always excluded).
      bias: optional [I] item bias.
      k: results per user.
      id_base: the global id of ``item_emb``'s first row (a catalog shard's
        offset); ``hists`` and the results are global ids.

    Returns:
      (scores [B, k], items [B, k]) sorted descending. Slots past the
      valid items hold ``NEG``.
    """
    b = u_repr.shape[0]
    num_items = item_emb.shape[0]
    hists = hists.long()
    tile_s, tile_i = [], []
    for start in range(0, num_items, item_tile):
        emb = item_emb[start:start + item_tile]
        width = emb.shape[0]
        scores = u_repr @ emb.T  # [B, T]
        if bias is not None:
            scores = scores + bias[None, start:start + width]
        # mask the pad id and the user's train items; history entries
        # outside this tile scatter into a spare last column
        local = hists - (id_base + start)
        inside = (local >= 0) & (local < width)
        invalid = torch.zeros(b, width + 1, dtype=torch.bool, device=scores.device)
        invalid.scatter_(1, torch.where(inside, local, width), True)
        invalid = invalid[:, :width]
        if id_base + start == 0:
            invalid[:, 0] = True
        s, idx = torch.topk(scores.masked_fill(invalid, NEG), min(k, width), dim=1)
        tile_s.append(s)
        tile_i.append(idx + (id_base + start))
    all_s = u_repr.new_zeros((b, 0)) if not tile_s else torch.cat(tile_s, dim=1)
    all_i = hists.new_zeros((b, 0)) if not tile_i else torch.cat(tile_i, dim=1)
    short = k - all_s.shape[1]
    if short > 0:  # fewer items than k: fill with NEG slots past the table
        all_s = torch.cat([all_s, all_s.new_full((b, short), NEG)], dim=1)
        fill = id_base + num_items + torch.arange(short, device=all_i.device)
        all_i = torch.cat([all_i, fill.expand(b, short)], dim=1)
    s, idx = torch.topk(all_s, k, dim=1)
    return s, torch.gather(all_i, 1, idx)


def _topk_core(model, k: int):
    """(params, ub, hb) -> (scores, items) for one user batch."""
    fs = getattr(model, "factored_scorer", lambda: None)()
    if fs is not None:
        def core(params, ub, hb):
            reprs = fs[0](params, ub, hb)
            table, bias = fs[1](params)
            return topk_factored(reprs, table, hb, bias=bias, k=k)
    else:
        def core(params, ub, hb):
            scores = model.score_all(params, ub, hb)  # fresh: masked in place
            rows = torch.arange(ub.shape[0], device=scores.device)
            scores[:, 0] = NEG
            scores[rows[:, None], hb.long()] = NEG
            return torch.topk(scores, k, dim=1)
    return core


def _hist_dev(data, device):
    """The history table on ``device``, uploaded once per dataset."""
    cached = getattr(data, "_hist_dev", None)
    if cached is None or cached.device != device:
        cached = data._hist_dev = torch.as_tensor(data.hist, device=device)
    return cached


def recommend(model, params, data, users, k: int = 10, batch_users: int = 512,
              device=None):
    """Serving entry point: top-K unseen items per user.

    Works for any model: uses the factored scorer when available, falls back
    to ``score_all`` + masked ``topk``. Large requests (>= 4 batches) gather
    each batch's histories on the device from the resident history table;
    smaller requests upload each batch's histories. Batches run on the
    device back to back, converted to numpy once at the end.

    Returns (scores [n, k] float32, items [n, k] int32) numpy arrays.
    """
    dev = resolve_device(device)
    users = np.asarray(users, dtype=np.int32)
    n = len(users)
    core = _topk_core(model, k)
    starts = range(0, n, batch_users)
    if len(starts) >= 4:
        hist = _hist_dev(data, dev)
        users_d = torch.as_tensor(users, device=dev)
        batches = ((ub, hist[ub.long()]) for ub in
                   (users_d[s:s + batch_users] for s in starts))
    else:
        batches = ((torch.as_tensor(users[s:s + batch_users], device=dev),
                    torch.as_tensor(data.hist[users[s:s + batch_users]], device=dev))
                   for s in starts)
    outs = [core(params, ub, hb) for ub, hb in batches]
    return (torch.cat([s for s, _ in outs]).cpu().numpy(),
            torch.cat([i for _, i in outs]).to(torch.int32).cpu().numpy())


class SessionStream:
    """Stateful session-stream recommender: the serving surface of GRU4Rec's
    streaming API (reference ``predict_next_batch``, GRU4Rec.py:285-327).

    A fixed number of parallel session slots, one event per slot per call,
    the hidden state carried between calls on the device. It wraps any
    model exposing

      * ``init_state(batch_size, device) -> state``
      * ``step_state(params, state, items, reset_mask) -> (state, scores [B, I])``

    Feed one item id per slot (0 = no event for that slot this tick: its
    state is untouched) and get the top-k next items of every slot back;
    ``reset_mask`` starts a new session in a slot (the reference resets the
    slot's state when its session id changes, GRU4Rec.py:314-318)::

        stream = SessionStream(model, params, batch_size=128, k=10)
        scores, items = stream.push(first_events)
        scores, items = stream.push(next_events)           # state carried
        stream.push(ev, reset_mask=(session_id != prev))   # new sessions

    Each call runs the cell, the catalog's scores (the pad item 0 set to
    ``NEG``) and ``torch.topk`` on ``device`` (default ``cuda``); only the
    [B, k] results come back to the host.
    """

    def __init__(self, model, params, batch_size: int, k: int = 10, device=None):
        if not hasattr(model, "step_state"):
            raise ValueError(f"{type(model).__name__} has no streaming step_state API "
                             "(GRU4Rec-style session models only)")
        self.model = model
        self.params = params
        self.batch_size = int(batch_size)
        self.k = int(k)
        self.device = resolve_device(device)
        self.reset()

    @torch.no_grad()
    def push(self, items, reset_mask=None):
        """Consume one event per slot; return (scores [B, k] float32, items
        [B, k] int32) numpy arrays, the next-item prediction of every
        slot."""
        items = torch.as_tensor(np.asarray(items, dtype=np.int32), device=self.device)
        if tuple(items.shape) != (self.batch_size,):
            raise ValueError(f"items must be [{self.batch_size}], got {tuple(items.shape)}")
        reset = None if reset_mask is None else torch.as_tensor(
            np.asarray(reset_mask, dtype=bool), device=self.device)
        self.state, scores = self.model.step_state(self.params, self.state, items, reset)
        scores[:, 0] = NEG  # the pad item is never recommended
        s, i = torch.topk(scores, self.k, dim=1)
        return s.cpu().numpy(), i.to(torch.int32).cpu().numpy()

    def reset(self):
        """Reset every slot (the end of all sessions)."""
        self.state = self.model.init_state(self.batch_size, self.device)
