"""Mesh-sharded serving: top-K recommendation over the mesh (counterpart of
``acf_tpu/parallel/sharded_serve.py``).

Sharded like the evaluation (:mod:`acf_tpu_torch.parallel.sharded_eval`):
request users over "data", item-table rows over "model". Each model rank
scores only its catalog shard and reduces it at once to a local top-kl with
the masks of :func:`acf_tpu_torch.ops.topk.topk_factored` (the pad id 0, the
zero rows that pad the table, the user's train items, all by global id).
The m shards' candidates are gathered shard-major over "model" and merged
into the top-k. ``torch.topk`` sets no order among equal scores, so the
merge states its tie rule: among equal scores, the lowest global id first.
The dot products are never split, so the ids are the single-device
``recommend``'s but where two scores tie within rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from acf_tpu_torch.ops.topk import topk_factored
from acf_tpu_torch.parallel.input_pipeline import host_sharded_array, replicate_result
from acf_tpu_torch.parallel.sharded_eval import ShardedTable
from acf_tpu_torch.parallel.sharded_embedding import shard_rows


def _shard_width(mesh, num_items: int, k: int) -> int:
    """kl, the candidates each shard keeps; raises when the m shards cannot
    hold k between them."""
    m = mesh.shape["model"]
    il = shard_rows(num_items, m)  # padded local shard width
    kl = min(k, il)
    if m * kl < k:
        raise ValueError(
            f"cannot serve top-{k} from {num_items} items over a "
            f"{m}-way model axis: shards hold only {il} rows each "
            f"({m}*{kl} candidates < k)")
    return kl


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """The top-``k`` of candidates [B, N], score descending and, among equal
    scores, the lowest id first."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    s, i = torch.gather(scores, 1, by_id), torch.gather(ids, 1, by_id)
    order = torch.argsort(s, dim=1, descending=True, stable=True)[:, :k]
    return torch.gather(s, 1, order), torch.gather(i, 1, order)


def local_candidates(shard: ShardedTable, reprs: torch.Tensor, hists: torch.Tensor, kl: int):
    """(scores [B, kl], global ids [B, kl]) of this model rank's shard: its
    real rows through ``topk_factored`` at the shard's ``id_base``, then
    NEG slots with ids past the catalog where the shard has fewer than kl."""
    real = slice(0, shard.real)
    return topk_factored(reprs, shard.table[real], hists,
                         bias=None if shard.bias is None else shard.bias[real], k=kl,
                         id_base=shard.id_base)


def make_sharded_recommend(mesh, user_repr_fn, num_items: int, k: int = 10):
    """``rec(params, shard, users, hists) -> (scores [B, k], items [B, k])``
    for dot-factored models: ``shard`` a :class:`ShardedTable` of the item
    table and its bias, ``users [B] / hists [B, L]`` this data rank's rows;
    sorted descending."""
    kl = _shard_width(mesh, num_items, k)

    @torch.no_grad()
    def rec(params, shard, users, hists):
        reprs = user_repr_fn(params, users, hists)
        s, i = local_candidates(shard, reprs, hists, kl)
        # shard-major: [m, B, kl] -> [B, m * kl]
        s_all = replicate_result(mesh, s[None], "model").permute(1, 0, 2).reshape(s.shape[0], -1)
        i_all = replicate_result(mesh, i[None], "model").permute(1, 0, 2).reshape(i.shape[0], -1)
        return merge_topk(s_all, i_all, k)

    return rec


def _scorer(model):
    fs = model.factored_scorer()
    if fs is None:
        raise ValueError(f"{type(model).__name__} has no factored scorer")
    return fs


def sharded_recommend_for_model(mesh, model, params, users, hists, k: int = 10):
    """Sharded top-K of any model with a ``factored_scorer()`` for the global
    request ``users [B] / hists [B, L]`` (numpy; ``B`` divisible by the
    data-axis size: pad with user 0 and slice the tail off, as
    ``recommend`` does). Returns numpy (scores [B, k] float32, items [B, k]
    int32) on every rank."""
    user_repr_fn, table_fn = _scorer(model)
    mesh.rows(len(users))  # B must divide over the data axis
    rec = make_sharded_recommend(mesh, user_repr_fn, model.num_items, k)
    shard = ShardedTable(mesh, *table_fn(params))
    s, i = rec(params, shard, host_sharded_array(mesh, np.asarray(users)),
               host_sharded_array(mesh, np.asarray(hists)))
    return (replicate_result(mesh, s, "data").cpu().numpy(),
            replicate_result(mesh, i, "data").to(torch.int32).cpu().numpy())


def sharded_recommend_bulk(mesh, model, params, data, users, k: int = 10,
                           batch_users: int = 512):
    """Bulk sharded serving (the mesh form of ``ops.topk.recommend``): the
    request is padded with user 0 to whole batches of ``batch_users``
    (rounded up to divide the data axis), each data rank serves its rows of
    every batch from the history table on its device, and one gather over
    "data" at the end gives every rank numpy (scores [n, k], items [n, k])."""
    user_repr_fn, table_fn = _scorer(model)
    batch_users += (-batch_users) % mesh.shape["data"]
    users = np.asarray(users, dtype=np.int32)
    n = len(users)
    nb = max(-(-n // batch_users), 1)
    up = np.zeros(nb * batch_users, dtype=np.int32)
    up[:n] = users
    rec = make_sharded_recommend(mesh, user_repr_fn, model.num_items, k)
    shard = ShardedTable(mesh, *table_fn(params))
    hist = torch.as_tensor(data.hist, device=mesh.device)
    rows = mesh.rows(batch_users)
    local = torch.as_tensor(up.reshape(nb, batch_users)[:, rows], device=mesh.device)
    outs = [rec(params, shard, ub, hist[ub.long()]) for ub in local]
    s = torch.stack([o[0] for o in outs])  # [nb, B / dp, k]
    i = torch.stack([o[1] for o in outs])
    s = replicate_result(mesh, s[None], "data").transpose(0, 1).reshape(-1, k)
    i = replicate_result(mesh, i[None], "data").transpose(0, 1).reshape(-1, k)
    return s.cpu().numpy()[:n], i.to(torch.int32).cpu().numpy()[:n]
