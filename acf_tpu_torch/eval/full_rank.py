"""Leave-one-out evaluators on the device (counterpart of
``acf_tpu/eval/full_rank.py``).

Users are tiled into fixed-size batches; each tile scores the full catalog
(or, for factored models, counts through the rank-count kernel), and the
rank position of the held-out item is a masked comparison-sum. Tiles run as
a Python loop on the device with one host transfer at the end; metrics are
closed-form from the position (:mod:`acf_tpu_torch.eval.metrics`). With a
mesh, factored models are evaluated with each tile's users split over the
"data" ranks and the item table's rows over the "model" ranks
(:mod:`acf_tpu_torch.parallel.sharded_eval`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from acf_tpu_torch.data.datasets import Interactions
from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.eval.metrics import metrics_from_position
from acf_tpu_torch.ops.ranking import rank_positions_dot


@dataclasses.dataclass
class EvalResult:
    hr: np.ndarray    # [U, K] per-user HR@1..K
    ndcg: np.ndarray  # [U, K]
    auc: np.ndarray   # [U]

    def at_k(self, k: int = 10):
        return (float(self.hr[:, k - 1].mean()),
                float(self.ndcg[:, k - 1].mean()),
                float(self.auc.mean()))

    def summary(self, k: int = 10):
        hr, ndcg, auc = self.at_k(k)
        return {"hr": hr, "ndcg": ndcg, "auc": auc}


def _positions_full(score_fn, params, users, hists, gt):
    """Rank position of ``gt`` against all unseen items for one user tile.

    Candidate rule = reference evaluation_adv.py:425-437: every item except
    the pad id 0, the user's train items, and the gt itself; ties count
    against the gt (``>=``, evaluation_adv.py:473).
    """
    scores = score_fn(params, users, hists)  # [B, I] float32
    rows = torch.arange(scores.shape[0], device=scores.device)
    gt = gt.long()
    gt_score = scores[rows, gt]  # [B]

    valid = torch.ones_like(scores, dtype=torch.bool)
    valid[:, 0] = False
    # hist padding is 0 → scatters harmlessly into the already-masked col 0
    valid[rows[:, None], hists.long()] = False
    valid[rows, gt] = False

    ge = (scores >= gt_score[:, None]) & valid
    return ge.sum(dim=1).to(torch.int32)  # [B]


def correction_rows(hists: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """[B, C] per-user invalid-item array: the unique train items of each
    row of ``hists`` and its gt, left-compacted and 0-padded (0 is handled
    separately). Vectorized numpy."""
    gts = gts.astype(np.int32)
    h = hists.astype(np.int32)
    # append the gt as an extra column, zeroed where it already appears in
    # the row (set semantics) or where there is no gt
    gt_col = np.where((h == gts[:, None]).any(1) | (gts == 0), 0, gts)[:, None]
    h = np.concatenate([h, gt_col], axis=1)
    # per-row unique: sort, keep first occurrences of nonzero runs
    h.sort(axis=1)
    first = np.ones_like(h, dtype=bool)
    first[:, 1:] = h[:, 1:] != h[:, :-1]
    first &= h != 0
    # left-compact the unique entries (stable: uniques keep order)
    order = np.argsort(~first, axis=1, kind="stable")
    vals = np.take_along_axis(np.where(first, h, 0), order, axis=1)
    width = int(first.sum(1).max()) if len(h) else 1
    return vals[:, :max(width, 1)]


def factored_thresholds(reprs, corr_rows, corr_bias, corr, gt):
    """(thresholds t [B], the count of each user's train items scoring >= t
    [B]) from the item rows of the correction array ``corr`` [B, C]:
    ``corr_rows`` [B, C, d] and ``corr_bias`` [B, C] or None.

    The gt is always present (exactly once) in the correction array; the
    threshold is taken FROM these scores so the gt's own correction cancels
    bit-exactly regardless of contraction order."""
    s_corr = torch.einsum("bd,bcd->bc", reprs, corr_rows)
    if corr_bias is not None:
        s_corr = s_corr + corr_bias
    is_gt = corr == gt[:, None]
    t = torch.where(is_gt, s_corr, 0.0).sum(dim=1)
    # the kernel masks the pad column and the gt column itself, so the
    # correction only subtracts the user's (non-gt) train items
    valid = (corr != 0) & ~is_gt
    return t, ((s_corr >= t[:, None]) & valid).sum(dim=1)


def _positions_factored(user_repr_fn, table_fn, params, users, hists, gt, corr):
    """Rank positions for dot-factored models via the rank-count kernel.

    ``corr`` is the per-user invalid-item array (unique train items ∪ {gt},
    0-padded) — counted over all items by the kernel, then subtracted here.
    """
    # contiguous: a model's representation may be a strided view
    reprs = user_repr_fn(params, users, hists).contiguous()  # [B, d]
    table, bias = table_fn(params)
    t, n_corr = factored_thresholds(reprs, table[corr.long()],
                                    None if bias is None else bias[corr.long()], corr, gt)
    total = rank_positions_dot(reprs, table, t, bias=bias, gt=gt)
    return (total - n_corr.to(torch.float32)).to(torch.int32)


def _positions_sampled(score_some_fn, params, users, hists, gt, negs):
    """Rank position of ``gt`` among sampled negatives
    (reference evaluation.py:114-135 rank-position rule)."""
    items = torch.cat([negs, gt[:, None]], dim=1)  # [B, K+1]
    scores = score_some_fn(params, users, hists, items.long())  # [B, K+1]
    gt_score = scores[:, -1]
    return (scores[:, :-1] >= gt_score[:, None]).sum(dim=1).to(torch.int32)


def _item_shard(mesh, model, table_fn, params, layout):
    """(the :class:`~acf_tpu_torch.parallel.sharded_eval.ShardedTable` of
    the model's item table, the params its user representations read):
    a stored shard of the table taken as it stands, else the whole table
    (gathered when stored sharded) shard by shard. A bias is 1-D, so it is
    never stored sharded."""
    from acf_tpu_torch.parallel.sharded_eval import ShardedTable

    if layout is None:
        return ShardedTable(mesh, *table_fn(params)), params
    table, bias = table_fn(params)
    rows = layout.rows_of(params, table)
    if rows is None:
        params = layout.gather(params)
        return ShardedTable(mesh, *table_fn(params)), params
    keep = () if getattr(model, "repr_reads_table", True) else (table,)
    return ShardedTable(mesh, table, bias, rows=rows), layout.gather(params, keep=keep)


class FullRankEvaluator:
    """Batched full-catalog (or sampled) leave-one-out evaluator.

    Args:
      data: the dataset.
      batch_users: user-tile size; memory per tile is ``batch_users *
        num_items * 4`` bytes for the score matrix (dense path).
      K: metric cutoff sweep (reference reports K = 1..100).
      device: where the tiles live and run (default ``cuda``).
      mesh: a :class:`acf_tpu_torch.parallel.mesh.Mesh`: factored models are
        then evaluated sharded (:meth:`positions_sharded`), each tile's users
        over "data" (the tile rounded up to divide the axis) and the item
        rows over "model"; ``device`` is the mesh's.
    """

    def __init__(self, data: Interactions, batch_users: int = 512, K: int = 100,
                 device=None, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.K = K
        self.data = data
        users = data.eval_users()
        self.users = users
        n = len(users)
        self.batch_users = min(batch_users, max(n, 1))
        if mesh is not None:
            self.batch_users += (-self.batch_users) % mesh.shape["data"]
        # pad to a multiple of the tile size; padded rows are dropped after.
        pad = (-n) % self.batch_users
        users_p = np.concatenate([users, np.zeros(pad, dtype=np.int32)])
        self._users_p = users_p
        self._users_d = torch.as_tensor(users_p, device=self.device)
        self._hists_d = torch.as_tensor(data.hist[users_p], device=self.device)
        self._gt_d = torch.as_tensor(data.test_item[users_p], device=self.device)
        self._negs_d = (torch.as_tensor(data.test_negatives[users_p],
                                        device=self.device)
                        if data.test_negatives is not None else None)
        self._num_neg = data.num_eval_candidates()[users]
        self._corr_d = None  # built lazily for the factored path

    def _corrections(self):
        """[Up, C] per-user invalid-item array (:func:`correction_rows`) on
        the device, built once."""
        if self._corr_d is None:
            users_p = self._users_p
            self._corr_d = torch.as_tensor(
                correction_rows(self.data.hist[users_p], self.data.test_item[users_p]),
                device=self.device)
        return self._corr_d

    def _run_tiles(self, fn, *arrays) -> np.ndarray:
        """``fn`` over each user tile of the padded device arrays; one host
        transfer at the end, padded rows dropped."""
        if self._users_d.shape[0] == 0:  # dataset with zero eval users
            return np.zeros(0, dtype=np.int32)
        out = []
        for s in range(0, self._users_d.shape[0], self.batch_users):
            e = s + self.batch_users
            out.append(fn(*(x[s:e] for x in arrays)))
        return torch.cat(out).cpu().numpy()[: len(self.users)]

    def positions(self, score_fn: Callable, params) -> np.ndarray:
        """Rank positions for every eval user (full-catalog mode).

        ``score_fn(params, users[B], hists[B, L]) -> [B, num_items]``.
        """
        return self._run_tiles(
            lambda u, h, g: _positions_full(score_fn, params, u, h, g),
            self._users_d, self._hists_d, self._gt_d)

    def positions_factored(self, user_repr_fn: Callable, table_fn: Callable,
                           params) -> np.ndarray:
        """Rank positions via the rank-count kernel (models whose scores
        factor as ``user_repr · item_table + bias``)."""
        return self._run_tiles(
            lambda u, h, g, c: _positions_factored(user_repr_fn, table_fn,
                                                   params, u, h, g, c),
            self._users_d, self._hists_d, self._gt_d, self._corrections())

    def positions_sampled(self, score_some_fn: Callable, params) -> np.ndarray:
        """Rank positions against the sampled negatives.

        ``score_some_fn(params, users[B], hists[B, L], items[B, M]) -> [B, M]``.
        """
        if self._negs_d is None:
            raise ValueError("dataset has no sampled negatives")
        return self._run_tiles(
            lambda u, h, g, n: _positions_sampled(score_some_fn, params,
                                                  u, h, g, n),
            self._users_d, self._hists_d, self._gt_d, self._negs_d)

    def positions_sharded(self, model, params, layout=None) -> np.ndarray:
        """Rank positions through the mesh (needs ``mesh`` and a factored
        scorer): this rank counts its data rank's users of each tile against
        its model rank's rows of the item table (K1 with the shard's
        ``id_base``), the counts are summed over "model", and every rank gets
        every position. Equal to :meth:`positions_factored` (see
        :mod:`acf_tpu_torch.parallel.sharded_eval`). ``params`` are stored
        as ``layout`` (a :class:`~acf_tpu_torch.parallel.mesh.Layout`, or
        None for whole leaves) says: a stored item shard is counted as it
        stands; the user representations read the other leaves gathered
        whole, and the item table too for a model whose representation reads
        it (``repr_reads_table``, SASRec's)."""
        from acf_tpu_torch.parallel.input_pipeline import replicate_result
        from acf_tpu_torch.parallel.sharded_eval import ShardedTable, sharded_positions

        mesh = self.mesh
        if mesh is None:
            raise ValueError("positions_sharded needs an evaluator built with a mesh")
        user_repr_fn, table_fn = model.factored_scorer()
        if self._users_d.shape[0] == 0:  # dataset with zero eval users
            return np.zeros(0, dtype=np.int32)
        shard, params = _item_shard(mesh, model, table_fn, params, layout)
        rows = mesh.rows(self.batch_users)
        out = []
        for s in range(0, self._users_d.shape[0], self.batch_users):
            u, h, g, c = (x[s:s + self.batch_users][rows] for x in (
                self._users_d, self._hists_d, self._gt_d, self._corrections()))
            out.append(sharded_positions(shard, user_repr_fn(params, u, h).contiguous(), g, c))
        local = torch.stack(out)  # [n_tiles, B / dp]
        every = replicate_result(mesh, local[None], "data")  # [dp, n_tiles, B / dp]
        return every.transpose(0, 1).reshape(-1).cpu().numpy()[: len(self.users)]

    def evaluate_model(self, model, params, layout=None) -> EvalResult:
        """Evaluate a model through its factored scorer (the rank-count
        kernel) when it has one, sharded when the evaluator has a mesh, else
        through ``score_all``; ``params`` stored as ``layout`` says (a
        trainer's sharded storage; None: whole)."""
        fs = getattr(model, "factored_scorer", lambda: None)()
        if fs is not None and self.mesh is not None:
            pos = self.positions_sharded(model, params, layout)
            hr, ndcg, auc = metrics_from_position(pos, self._num_neg, self.K)
            return EvalResult(hr=hr, ndcg=ndcg, auc=auc)
        if layout is not None:
            params = layout.gather(params)
        if fs is not None:
            pos = self.positions_factored(fs[0], fs[1], params)
            hr, ndcg, auc = metrics_from_position(pos, self._num_neg, self.K)
            return EvalResult(hr=hr, ndcg=ndcg, auc=auc)
        return self.evaluate(model.score_all, params)

    def evaluate(self, score_fn: Callable, params, sampled: bool = False) -> EvalResult:
        if sampled:
            pos = self.positions_sampled(score_fn, params)
            num_neg = np.full(len(self.users), self.data.test_negatives.shape[1])
        else:
            pos = self.positions(score_fn, params)
            num_neg = self._num_neg
        hr, ndcg, auc = metrics_from_position(pos, num_neg, self.K)
        return EvalResult(hr=hr, ndcg=ndcg, auc=auc)
