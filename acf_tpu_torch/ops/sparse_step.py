"""The sparse row-space MF-BPR/APR step (counterpart of
``acf_tpu/ops/sparse_step.py``, single device).

The pair trainer differentiates through the embedding gathers, so each step
builds dense [U, d] and [I, d] gradient tables, and Adagrad then reads and
writes every row of the params and the accumulators. This step keeps
everything in *row space*:

* the gradients are taken with respect to the gathered rows [B, d], in
  closed form (:meth:`MFBPR.row_grads`, the rows of the dense APR step's
  closed form before its scatter);
* duplicate ids are aggregated per unique id by one of two programs
  (``dedup="auto"`` takes ``"matmul"`` up to a batch of 4,096, else
  ``"sort"``): ``"matmul"`` sums each duplicate group with one [N, N] x
  [N, d] product of the 0/1 equality matrix and keeps the first occurrence
  of each id (its argmax), parking the other slots at the pad id 0 with a
  zero payload; ``"sort"`` takes ``torch.unique`` padded with 0 to the
  batch's size and scatter-adds the examples into their slots;
* Adagrad reads and writes only the touched rows, as optax computes it:
  ``acc_rows = acc[ids] + g²``, ``P[ids] += -lr · g · rsqrt(acc_rows +
  eps)``, ``acc[ids] += g²``, each an ``index_add_`` (pad slots add 0, so
  row 0 and its accumulator stay bit-identical);
* with ``adversarial``, the FGSM deltas come from the clean loss's row
  gradients, aggregated per id before the row normalize, which equals the
  dense formulation (evaluation_adv.py:192-203): untouched rows have a zero
  gradient and a zero delta.

The tables and the accumulators are copied once an epoch and updated in
place within it, so a step moves O(B·d) bytes, not O(U·d + I·d).

Both programs sum an id's duplicates in a fixed order (the ``"sort"``
program's scatter-add is :func:`scatter_rows`), so two runs of a step are
equal bit for bit.

With a mesh (``make_epoch_fn(..., mesh=)``; the JAX package's
``_make_mesh_epoch_fn``) the batch is replicated (the scaling axis of this
step is "model": ``--mesh 1xN``) and P, Q and their accumulators are taken
as the trainer stores them (its :class:`~acf_tpu_torch.train.optim.Sharded`
optimizer's layout): a table stored as a row shard over "model", with its
accumulator, stays one for the epoch; a whole table stays whole on every
rank. Each step reads a shard's rows by the masked ``all_reduce`` of
:func:`~acf_tpu_torch.parallel.sharded_embedding.sharded_lookup`, runs the
same full-batch row-space math on every rank (the dedup over the whole
batch keeps Adagrad's sum-then-square), and applies Adagrad to the rows of
its own shard only, off-shard slots clipped into the window with a zero
payload. No whole table is formed. The trajectory is the single-device one:
the lookups are exact and every shard's rows see the same arithmetic.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from acf_tpu_torch.models.base import row_normalize, scatter_rows
from acf_tpu_torch.models.mf import MFBPR, equality
from acf_tpu_torch.parallel.sharded_embedding import TableRows
from acf_tpu_torch.sampling.negatives import (
    negatives_from_draws, sample_pair_epoch, uniform_negatives,
)
from acf_tpu_torch.train.optim import layout_of
from acf_tpu_torch.train.trainer import _add_stats, _mean_stats

# "auto" takes the equality-matrix program up to this batch size: its
# [2B, 2B] matrix is 1 GB of f32 at a batch of 8,192
MATMUL_MAX_BATCH = 4096


def dedup_matmul(ids):
    """The sort-free program for ``ids`` [N]: (slot ids [N], agg, delta_rows).
    ``agg(g)`` maps per-example rows [N, d] to per-slot sums, each id's sum
    in its first occurrence's slot, the other slots id 0 with a zero row;
    ``delta_rows(g, eps)`` is eps times the row-normalized group sum of each
    example's id."""
    eq = equality(ids)
    first = torch.argmax(eq, dim=1) == torch.arange(ids.shape[0], device=ids.device)
    slots = torch.where(first, ids, 0)

    def agg(g):
        return torch.where(first[:, None], torch.matmul(eq, g), 0.0)

    def delta_rows(g, eps):
        return eps * row_normalize(torch.matmul(eq, g))

    return slots, agg, delta_rows


def dedup_sort(ids):
    """The ``torch.unique`` program for ``ids`` [N]: the unique ids in
    ascending order padded with 0 to N (``jnp.unique(size=N,
    fill_value=0)``), agg and delta_rows as :func:`dedup_matmul` gives
    them."""
    n = ids.shape[0]
    uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
    slots = torch.zeros(n, dtype=ids.dtype, device=ids.device)
    slots[:uniq.shape[0]] = uniq

    def agg(g):
        return scatter_rows(n, inv, g)

    def delta_rows(g, eps):
        return (eps * row_normalize(agg(g)))[inv]

    return slots, agg, delta_rows


def sparse_adagrad_(table, acc, ids, g, lr, eps):
    """Adagrad on the rows ``ids`` of ``table`` and ``acc``, in place, as
    optax computes it; each id at most once, but for slots with a zero row
    (the pad slots, and a shard's off-shard slots), which add zeros."""
    acc_rows = acc[ids] + torch.square(g)
    table.index_add_(0, ids, -lr * g * torch.rsqrt(acc_rows + eps))
    acc.index_add_(0, ids, torch.square(g))


@dataclasses.dataclass(eq=False)
class SparseMFBPR(MFBPR):
    """MFBPR with the row-space epoch. The trainer's optimizer is ignored:
    the step is Adagrad(lr, initial_acc, opt_eps), as the reference trains
    MF-BPR (evaluation_adv.py:205-207)."""

    lr: float = 0.05
    initial_acc: float = 0.1
    opt_eps: float = 1e-7  # optax.adagrad's eps
    dedup: str = "auto"    # "auto" | "matmul" | "sort"

    def init_opt_state(self, optimizer, params):
        """The Adagrad accumulators under the JAX package's names."""
        return {"accP": torch.full_like(params["P"], self.initial_acc),
                "accQ": torch.full_like(params["Q"], self.initial_acc)}

    def opt_state_rows(self, optimizer, rows):
        """Where :meth:`init_opt_state`'s leaves live: each accumulator as
        its table."""
        return {"accP": rows["P"], "accQ": rows["Q"]}

    def dedup_mode(self, batch_size: int) -> str:
        if self.dedup == "auto":
            return "matmul" if batch_size <= MATMUL_MAX_BATCH else "sort"
        if self.dedup not in ("matmul", "sort"):
            raise ValueError(f"dedup {self.dedup!r} not in ('auto', 'matmul', 'sort')")
        return self.dedup

    def row_space_grads(self, users, pos, neg, pu, qp, qn, mode: str):
        """The step's gradients on the gathered rows (the closed form,
        :meth:`MFBPR.row_grads`, its FGSM deltas from the ``mode`` program's
        group sums), aggregated per unique id over the batch: (user slots
        [B], gP [B, d], item slots [2B], gQ [2B, d], aux), gP and gQ aligned
        with the slots. Aux as the JAX package's step reports it: ``loss``,
        ``acc`` and, under APR, ``acc_adv``."""
        dedup = dedup_matmul if mode == "matmul" else dedup_sort
        uu, agg_u, delta_u = dedup(users)
        ii, agg_i, delta_i = dedup(torch.cat([pos, neg]))
        rows_p, rows_q, aux = self.row_grads(pu, qp, qn, delta_u, delta_i)
        aux.pop("loss_adv", None)
        return uu, agg_u(rows_p), ii, agg_i(rows_q), aux

    def make_epoch_fn(self, optimizer, batch_size: int, num_batches: int, dev=None,
                      mesh=None):
        """``epoch_fn(params, opt_state, data, generator, batches=None,
        cands=None) -> (params, opt_state, stats)``: the pair epoch's draws
        (``batches`` [num_batches, B] pair indices, ``cands`` [num_batches,
        R, B] negative candidates, drawn from ``generator`` in the pair
        epoch's order when not given) through the row-space step. Stats:
        the mean ``loss`` and ``acc`` (and ``acc_adv``) over the steps.
        With ``mesh`` the tables and slots stay as ``optimizer``'s layout
        stores them (the module docstring). Every rank steps on the whole
        batch, so no loss is a share: the trainer's data-parallel copy runs
        as the model itself."""
        if self.data_mesh is not None:
            model = copy.copy(self)
            model.data_mesh = None
            return model.make_epoch_fn(optimizer, batch_size, num_batches, dev, mesh)
        mode = self.dedup_mode(batch_size)
        lr, eps = self.lr, self.opt_eps
        tables = TableRows(None if mesh is None else layout_of(optimizer))
        lookup = tables.rows

        def adagrad(name, tbl, acc, ids, g):
            sparse_adagrad_(tbl, acc, *tables.window(name, tbl, ids, g), lr, eps)

        @torch.no_grad()
        def epoch_fn(params, opt_state, data, generator, batches=None, cands=None):
            if batches is None:
                batches = sample_pair_epoch(generator, data["pairs_u"].shape[0], batch_size,
                                            num_batches)
            P, Q, accP, accQ = (x.clone() for x in (params["P"], params["Q"],
                                                   opt_state["accP"], opt_state["accQ"]))
            sums = {}
            for step in range(num_batches):
                idx = batches[step]
                u, pos = data["pairs_u"][idx], data["pairs_i"][idx]
                hist_rows = data["hist"][u]
                if cands is None:
                    neg = uniform_negatives(generator, hist_rows, self.num_items)
                else:
                    neg = negatives_from_draws(cands[step], hist_rows)
                uu, gP, ii, gQ, aux = self.row_space_grads(
                    u, pos, neg, lookup("P", P, u), lookup("Q", Q, pos), lookup("Q", Q, neg),
                    mode)
                adagrad("P", P, accP, uu, gP)
                adagrad("Q", Q, accQ, ii, gQ)
                _add_stats(sums, aux)
            return {"P": P, "Q": Q}, {"accP": accP, "accQ": accQ}, _mean_stats(sums, num_batches)

        return epoch_fn
