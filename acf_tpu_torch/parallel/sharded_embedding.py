"""Row-sharded embedding tables with an explicit collective lookup
(counterpart of ``acf_tpu/parallel/sharded_embedding.py``).

A table's rows are split over the mesh's "model" axis: model rank m holds
rows [m · I_local, (m + 1) · I_local) of the table padded with zero rows to
a multiple of the axis size (:func:`shard_table`). A lookup of global ids
gathers on each rank the rows that live in its shard, zero elsewhere, and
one ``all_reduce`` over the model group assembles the [B, d] rows on every
rank: the sum of one row and zeros is exact, so the rows equal a dense
gather bit for bit.

The backward of :func:`sharded_lookup` scatters the rows' gradient into the
rank's own rows and sums it over the data group, so callers get the table
gradient already summed over the data ranks (as the JAX custom VJP hands
it). Row normalisation for FGSM stays local: a row is never split.
"""

from __future__ import annotations

import math

import torch

from acf_tpu_torch.models.base import row_normalize as row_normalize_local  # noqa: F401
from acf_tpu_torch.models.base import scatter_rows
from acf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def shard_rows(num_rows: int, m: int) -> int:
    """Rows of each shard of a table of ``num_rows`` over ``m`` ranks."""
    return -(-num_rows // m)


def shard_table(mesh, table: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """This rank's rows of ``table`` [R, ...] padded with zero rows to a
    multiple of the axis size: [ceil(R / m), ...], a fresh tensor."""
    m = mesh.shape[axis]
    il = shard_rows(table.shape[0], m)
    start = mesh.index(axis) * il
    local = table.new_zeros((il,) + tuple(table.shape[1:]))
    real = max(min(il, table.shape[0] - start), 0)
    local[:real] = table[start:start + real]
    return local


def gather_table(mesh, local: torch.Tensor, rows: int, axis: str = "model") -> torch.Tensor:
    """The whole table [rows, ...] whose shards over ``axis`` are ``local``
    (:func:`shard_table`'s layout): one ``all_reduce`` of a zero-filled
    buffer in which each rank fills its own block, exact, as gloo on CUDA
    offers ``all_reduce`` only."""
    from acf_tpu_torch.parallel.input_pipeline import replicate_result

    return replicate_result(mesh, local, axis)[:rows]


def local_window(i_local: int, ids: torch.Tensor, index: int):
    """(local row of each global id, clipped into [0, i_local), and whether
    the id lives in the shard of model rank ``index``)."""
    local = ids.long() - index * i_local
    ok = (local >= 0) & (local < i_local)
    return torch.clamp(local, 0, i_local - 1), ok


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_local, ids, mesh):
        idx, ok = local_window(table_local.shape[0], ids, mesh.model_index)
        rows = torch.where(ok[:, None], table_local[idx], 0.0)
        mesh.all_reduce(rows, "model")
        ctx.save_for_backward(idx, ok)
        ctx.mesh, ctx.i_local = mesh, table_local.shape[0]
        return rows

    @staticmethod
    def backward(ctx, ct):
        idx, ok = ctx.saved_tensors
        g = scatter_rows(ctx.i_local, idx, torch.where(ok[:, None], ct, 0.0))
        ctx.mesh.all_reduce(g, "data")
        return g, None, None


def sharded_lookup(mesh, table_local: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows [B, d] of the GLOBAL ``ids`` [B] (the same ids on every rank of
    a data row) from this rank's shard ``table_local`` [I_local, d].
    Differentiable in ``table_local``: the gradient is the rank's rows of the
    table gradient, summed over the data ranks; do not sum it again."""
    return _Lookup.apply(table_local, ids, mesh)


class TableRows:
    """Reads and gradient scatters of a model's tables by global id, on the
    tables as a :class:`~acf_tpu_torch.parallel.mesh.Layout` stores them
    (whole everywhere when ``layout`` is None): the row path of a step that
    reads its tables only at the batch's ids, so no whole table is formed.
    ``name`` is a table's key in the params."""

    def __init__(self, layout=None):
        self.layout = layout

    def _rows(self, name):
        return None if self.layout is None else self.layout.rows[name]

    def rows(self, name: str, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows [N, ...] of global ``ids`` [N] of ``table`` (its storage, or
        a table in the same layout such as its gradient); a shard's rows come
        through :func:`sharded_lookup`, equal to a whole table's bit for bit."""
        if self._rows(name) is None:
            return table[ids]
        return sharded_lookup(self.layout.mesh, table, ids)

    def window(self, name: str, table: torch.Tensor, ids: torch.Tensor,
               rows: torch.Tensor):
        """(ids, rows) of an update at global ``ids`` [N] of ``table``'s
        storage: as given for a whole table; for a shard, each id's local
        row, the ids outside this rank's window clipped into it with a zero
        row, so a scatter or an in-place update leaves each stored row as a
        whole table's update does, each id's run in the same order."""
        if self._rows(name) is None:
            return ids, rows
        idx, ok = local_window(table.shape[0], ids, self.layout.mesh.model_index)
        return idx, torch.where(ok[:, None], rows, 0.0)

    def scatter(self, name: str, table: torch.Tensor, ids: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
        """A gradient shaped like ``table``'s storage: zeros with each row of
        ``rows`` [N, ...] added at its id of ``ids`` (:func:`scatter_rows`),
        in this rank's window (:meth:`window`)."""
        return scatter_rows(table.shape[0], *self.window(name, table, ids, rows))


def _bpr_sum(pu, qp, qn):
    diff = torch.clamp(torch.sum(pu * (qp - qn), -1), -80.0, 1e8)
    return torch.sum(torch.logaddexp(torch.zeros_like(diff), -diff))


def make_sharded_bpr_step(mesh, eps: float = 0.0, reg_adv: float = 1.0, lr: float = 0.05):
    """The fully sharded (data x model) adversarial BPR step: ``step(P_shard,
    Q_shard, users, pos, neg) -> (P_shard, Q_shard)`` with the tables
    row-sharded over "model" (:func:`shard_table`) and the batch this data
    rank's rows; the gradients come summed over "data" from
    :func:`sharded_lookup`, the FGSM deltas are shard-local row normalises,
    and the update is SGD (the JAX package's explicit-collectives reference
    step)."""

    def grads(tables, users, pos, neg, deltas=None):
        tabs = [t.detach().requires_grad_(True) for t in tables]
        with torch.enable_grad():
            Pl, Ql = tabs
            if deltas is not None:
                Pl, Ql = Pl + deltas[0], Ql + deltas[1]
            loss = _bpr_sum(sharded_lookup(mesh, Pl, users), sharded_lookup(mesh, Ql, pos),
                            sharded_lookup(mesh, Ql, neg))
            return torch.autograd.grad(loss, tabs)

    def step(P_shard, Q_shard, users, pos, neg):
        gP, gQ = grads((P_shard, Q_shard), users, pos, neg)
        if eps > 0.0:
            dP = eps * row_normalize_local(gP)
            dQ = eps * row_normalize_local(gQ)
            aP, aQ = grads((P_shard, Q_shard), users, pos, neg, (dP, dQ))
            gP = gP + reg_adv * aP
            gQ = gQ + reg_adv * aQ
        return P_shard - lr * gP, Q_shard - lr * gQ

    return step


def make_sharded_sasrec_step(mesh, model, lr: float = 1e-3):
    """The explicit-collectives adversarial SASRec step: ``step(item_shard,
    rest, seq, pos, neg) -> (item_shard, rest)`` with the item table
    row-sharded over "model", the other leaves ``rest`` (``params`` without
    ``item_emb``) replicated and the batch this data rank's rows.

    Semantics of the JAX step (reference asasrec, SASRec.py:356-363): a
    sum-reduced pointwise loss without dropout, the FGSM delta on the item
    table only, from the clean loss's gradient, perturbing the target rows
    against the clean representations; SGD. The encoder is the model's own
    (:meth:`SASRec.encode_core`) in its training compute dtype
    (``train_dtype``): on CUDA its forward and backward are the K2a and K2b
    kernels, in their bfloat16 forms under ``train_dtype="bfloat16"``. The
    item shard's gradient comes summed over "data" from
    :func:`sharded_lookup`; the replicated leaves' gradients are summed over
    "data" here."""
    d = model.dim

    def pointwise_sum_loss(reprs, pos_e, neg_e, ist):
        zero = torch.zeros_like(reprs[..., 0])
        pos_logit = torch.sum(pos_e * reprs, -1)
        neg_logit = torch.sum(neg_e * reprs, -1)
        return (torch.sum(torch.logaddexp(zero, -pos_logit) * ist)
                + torch.sum(torch.logaddexp(zero, neg_logit) * ist))

    def grads(item_shard, rest, seq, pos, neg, delta=None):
        b, t = seq.shape
        ist = (pos != 0).to(torch.float32)
        item = item_shard.detach().requires_grad_(True)
        rp = tree_map(lambda x: x.detach().requires_grad_(True), rest)
        with torch.enable_grad():
            def lookup(tbl, ids):
                return sharded_lookup(mesh, tbl, ids.reshape(-1)).reshape(b, t, d)

            x = lookup(item, seq) * math.sqrt(d)
            reprs = model.encode_core(rp, x, seq != 0, dtype=model._compute_dtype())
            tgt = item if delta is None else item + delta
            loss = pointwise_sum_loss(reprs, lookup(tgt, pos), lookup(tgt, neg), ist)
            leaves = tree_leaves(rp)
            got = torch.autograd.grad(loss, [item] + leaves, allow_unused=True)
        g_rest = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, got[1:])]
        flat = torch.cat([g.reshape(-1) for g in g_rest])
        mesh.all_reduce(flat, "data")
        g_rest = list(torch.split(flat, [g.numel() for g in g_rest]))
        g_rest = [g.reshape(x.shape) for g, x in zip(g_rest, leaves)]
        return got[0], tree_unflatten(rest, g_rest)

    def step(item_shard, rest, seq, pos, neg):
        g_item, g_rest = grads(item_shard, rest, seq, pos, neg)
        if model.adversarial:
            delta = model.eps * row_normalize_local(g_item)
            ag_item, ag_rest = grads(item_shard, rest, seq, pos, neg, delta)
            g_item = g_item + model.reg_adv * ag_item
            g_rest = tree_map(lambda g, ag: g + model.reg_adv * ag, g_rest, ag_rest)
        new_item = item_shard - lr * g_item
        new_rest = tree_map(lambda p, g: p - lr * g, rest, g_rest)
        return new_item, new_rest

    return step
