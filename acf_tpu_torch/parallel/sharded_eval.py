"""Mesh-sharded full-catalog evaluation (counterpart of
``acf_tpu/parallel/sharded_eval.py``).

Both axes of the evaluation are sharded: the users of a tile over "data"
(each data rank ranks its own rows) and the item table's rows over "model"
(each model rank counts against its catalog shard only). The positions are
those of the single-device factored evaluator
(:func:`acf_tpu_torch.eval.full_rank._positions_factored`), step by step:

* the thresholds and the train-item correction come from the rows of the
  user's correction array (unique train items and the gt), assembled by
  :func:`~acf_tpu_torch.parallel.sharded_embedding.sharded_lookup`: the same
  rows bit for bit, through the same
  :func:`~acf_tpu_torch.eval.full_rank.factored_thresholds`;
* K1 counts on each shard with its ``id_base`` (the global id of the
  shard's first row, so the pad id 0 and the gt are masked by global id) over
  the shard's real rows only, never the zero rows that pad the table;
* one ``all_reduce`` over "model" sums the counts, which are whole numbers.

The dot products are never split over ranks, so the counts are the
single-device counts exactly. A trainer whose storage shards the item table
hands its shard as it stands (``ShardedTable(mesh, shard, bias,
rows=R)``): K1 counts on it with its ``id_base``, and no table is gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from acf_tpu_torch.eval.full_rank import correction_rows, factored_thresholds
from acf_tpu_torch.ops.ranking import rank_positions_dot
from acf_tpu_torch.parallel.sharded_embedding import shard_rows, shard_table, sharded_lookup


class ShardedTable:
    """This rank's shard of an item table [I, d] and its bias [I] (or None):
    ``table``/``bias`` the shard's rows padded to ``i_local`` with zero rows,
    ``id_base`` the global id of its first row and ``real`` its rows inside
    the catalog. ``table`` is the whole table, or with ``rows`` (its global
    row count) this rank's stored shard of it, taken as it is; ``bias`` is
    whole."""

    def __init__(self, mesh, table: torch.Tensor, bias=None, rows=None):
        self.mesh = mesh
        self.num_items = table.shape[0] if rows is None else rows
        self.i_local = shard_rows(self.num_items, mesh.shape["model"])
        self.id_base = mesh.model_index * self.i_local
        self.real = max(min(self.i_local, self.num_items - self.id_base), 0)
        self.table = shard_table(mesh, table) if rows is None else table
        self.bias = None if bias is None else shard_table(mesh, bias)

    def rows(self, ids: torch.Tensor):
        """(the table's rows [*ids.shape, d] and the bias's [*ids.shape] or
        None) of global ``ids``, on every rank of the data row."""
        flat = ids.reshape(-1)
        rows = sharded_lookup(self.mesh, self.table, flat).reshape(*ids.shape, -1)
        if self.bias is None:
            return rows, None
        return rows, sharded_lookup(self.mesh, self.bias[:, None], flat).reshape(ids.shape)


@torch.no_grad()
def sharded_positions(shard: ShardedTable, reprs: torch.Tensor, gt: torch.Tensor,
                      corr: torch.Tensor) -> torch.Tensor:
    """Positions [B] int32 of this data rank's users: ``reprs`` [B, d]
    their representations, ``gt`` [B] their held-out items, ``corr`` [B, C]
    their correction arrays (:func:`correction_rows`)."""
    corr_rows, corr_bias = shard.rows(corr)
    t, n_corr = factored_thresholds(reprs, corr_rows, corr_bias, corr, gt)
    if shard.real > 0:
        real = slice(0, shard.real)
        total = rank_positions_dot(reprs, shard.table[real], t,
                                   bias=None if shard.bias is None else shard.bias[real],
                                   gt=gt, id_base=shard.id_base)
    else:  # a shard wholly past the catalog (more model ranks than rows)
        total = torch.zeros_like(t)
    shard.mesh.all_reduce(total, "model")
    return (total - n_corr.to(torch.float32)).to(torch.int32)


def make_sharded_positions(mesh, user_repr_fn, num_items: int):
    """``positions(params, shard, users, hists, gt) -> [B] int32`` for
    dot-factored models (scores = ``user_repr(params, users, hists) @
    table.T + bias``): ``shard`` a :class:`ShardedTable` of the item table
    and its bias, ``users [B] / hists [B, L] / gt [B]`` this data rank's
    rows."""

    def positions(params, shard, users, hists, gt):
        if shard.num_items != num_items:
            raise ValueError(f"the table has {shard.num_items} rows, not {num_items}")
        corr = torch.as_tensor(correction_rows(hists.cpu().numpy(), gt.cpu().numpy()),
                               device=gt.device)
        return sharded_positions(shard, user_repr_fn(params, users, hists).contiguous(),
                                 gt, corr)

    return positions


def sharded_positions_for_model(mesh, model, params, users, hists, gt) -> np.ndarray:
    """Sharded positions of any model with a ``factored_scorer()`` for the
    global request ``users [B] / hists [B, L] / gt [B]`` (numpy; ``B``
    divisible by the data-axis size): each data rank takes its rows, and
    every rank gets all ``B`` positions."""
    from acf_tpu_torch.parallel.input_pipeline import host_sharded_array, replicate_result

    fs = model.factored_scorer()
    if fs is None:
        raise ValueError(f"{type(model).__name__} has no factored scorer")
    user_repr_fn, table_fn = fs
    mesh.rows(len(users))  # B must divide over the data axis
    shard = ShardedTable(mesh, *table_fn(params))
    fn = make_sharded_positions(mesh, user_repr_fn, model.num_items)
    local = fn(params, shard, *(host_sharded_array(mesh, np.asarray(x)) for x in
                                (users, hists, gt)))
    return replicate_result(mesh, local, "data").cpu().numpy()
