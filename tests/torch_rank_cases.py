"""Rank functions that drive each distributed path of the port on given
inputs and return numpy results, for :func:`acf_tpu_torch.parallel.launch.run`
(``run("tests.torch_rank_cases:lookup", 2, "1x2", "cpu", ...)``). The CPU
tests hold their results against the JAX package and the port on one device;
``chip_smoke.py`` runs them on the card.

Every function takes the mesh spec and the device first and builds the mesh
over the group the launcher started; inputs are numpy arrays, models and
optimizers their (picklable) dataclasses, datasets
:class:`~acf_tpu_torch.data.datasets.Interactions`. Results hold this rank's
values and the launch counts of the kernels on its path. This module imports
no JAX, so the ranks stay free of it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from acf_tpu_torch.compat.jax_params import params_from_numpy, params_to_numpy
from acf_tpu_torch.parallel.input_pipeline import host_sharded_array, replicate_result
from acf_tpu_torch.parallel.mesh import mesh_from_spec


def launches() -> dict:
    """The launch counters of the kernels that the mesh paths run."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.ops.sasrec_fused import encoder_bwd, fused_encoder

    return {"k1": rank_positions_dot.launches, "k2a": fused_encoder.launches,
            "k2b": encoder_bwd.launches}


def _whole(mesh, shard, rows):
    """The table whose model-rank shards are ``shard``, cut to ``rows``."""
    return replicate_result(mesh, shard, "model")[:rows]


def lookup(spec, device, table, ids, ct):
    """:func:`sharded_lookup` of ``ids[data rank]`` from ``table``'s shard,
    and the gradient of ``sum(rows * ct[data rank])`` in the shard."""
    from acf_tpu_torch.parallel.sharded_embedding import shard_table, sharded_lookup

    mesh = mesh_from_spec(spec, device)
    shard = shard_table(mesh, torch.as_tensor(table, device=mesh.device)).requires_grad_(True)
    d = mesh.data_index
    rows = sharded_lookup(mesh, shard, torch.as_tensor(ids[d], device=mesh.device))
    (rows * torch.as_tensor(ct[d], device=mesh.device)).sum().backward()
    return {"rows": rows.detach().cpu().numpy(), "shard": shard.detach().cpu().numpy(),
            "grad": shard.grad.cpu().numpy()}


def positions(spec, device, model, params, users, hists, gt):
    """:func:`sharded_positions_for_model` of the global request."""
    from acf_tpu_torch.parallel.sharded_eval import sharded_positions_for_model

    mesh = mesh_from_spec(spec, device)
    prm = params_from_numpy(params, mesh.device)
    return {"pos": sharded_positions_for_model(mesh, model, prm, users, hists, gt),
            **launches()}


def evaluator(spec, device, model, params, data, batch_users):
    """Every eval user's position through ``FullRankEvaluator(mesh=)``."""
    from acf_tpu_torch.eval.full_rank import FullRankEvaluator

    mesh = mesh_from_spec(spec, device)
    ev = FullRankEvaluator(data, batch_users=batch_users, mesh=mesh)
    before = launches()
    pos = ev.positions_sharded(model, params_from_numpy(params, mesh.device))
    return {"pos": pos, **{k: v - before[k] for k, v in launches().items()}}


def recommend(spec, device, model, params, users, hists, k):
    """:func:`sharded_recommend_for_model` of the global request."""
    from acf_tpu_torch.parallel.sharded_serve import sharded_recommend_for_model

    mesh = mesh_from_spec(spec, device)
    s, i = sharded_recommend_for_model(mesh, model, params_from_numpy(params, mesh.device),
                                       users, hists, k)
    return {"scores": s, "items": i}


def recommend_bulk(spec, device, model, params, data, users, k, batch_users):
    """:func:`sharded_recommend_bulk` of ``users``."""
    from acf_tpu_torch.parallel.sharded_serve import sharded_recommend_bulk

    mesh = mesh_from_spec(spec, device)
    s, i = sharded_recommend_bulk(mesh, model, params_from_numpy(params, mesh.device), data,
                                  users, k, batch_users)
    return {"scores": s, "items": i}


def bpr_step(spec, device, P, Q, users, pos, neg, eps, lr=0.05):
    """One :func:`make_sharded_bpr_step` on the global batch; the whole
    updated tables."""
    from acf_tpu_torch.parallel.sharded_embedding import make_sharded_bpr_step, shard_table

    mesh = mesh_from_spec(spec, device)
    step = make_sharded_bpr_step(mesh, eps=eps, lr=lr)
    Pl, Ql = (shard_table(mesh, torch.as_tensor(x, device=mesh.device)) for x in (P, Q))
    Pl, Ql = step(Pl, Ql, *(host_sharded_array(mesh, x) for x in (users, pos, neg)))
    return {"P": _whole(mesh, Pl, P.shape[0]).cpu().numpy(),
            "Q": _whole(mesh, Ql, Q.shape[0]).cpu().numpy()}


def sasrec_step(spec, device, model, params, seq, pos, neg, lr=1e-3):
    """One :func:`make_sharded_sasrec_step` on the global batch; the whole
    updated params, and the kernels' launches in the step."""
    from acf_tpu_torch.parallel.sharded_embedding import make_sharded_sasrec_step, shard_table

    mesh = mesh_from_spec(spec, device)
    prm = params_from_numpy(params, mesh.device)
    rest = {k: v for k, v in prm.items() if k != "item_emb"}
    step = make_sharded_sasrec_step(mesh, model, lr=lr)
    before = launches()
    item, rest = step(shard_table(mesh, prm["item_emb"]), rest,
                      *(host_sharded_array(mesh, x) for x in (seq, pos, neg)))
    out = dict(prm, **rest)  # the params' order of leaves
    out["item_emb"] = _whole(mesh, item, model.num_items)
    return {"params": params_to_numpy(out), **{k: v - before[k] for k, v in launches().items()}}


def train(spec, device, models, optimizer, data, epochs, steps=None, seed=2019,
          batch_size=512, reset_opt=True, init=None, draws=None):
    """A :class:`Trainer` over ``data`` with ``TrainConfig(mesh=...)`` (one
    device when ``spec`` is None): ``epochs[i]`` epochs of ``models[i]``,
    switching models in turn (``reset_opt`` as ``fit_two_phase``), each
    epoch of ``steps`` steps when given. ``init`` (numpy params) replaces
    the seeded init; ``draws``, one (batches, cands) pair of numpy arrays an
    epoch, are injected into the pair epochs in place of the trainer's own
    draws. Returns the params and optimizer slots (by their snapshot names),
    each epoch's stats and the kernels' launches."""
    from acf_tpu_torch.train import TrainConfig, Trainer
    from acf_tpu_torch.train.checkpoint import state_arrays

    mesh = None if spec is None else mesh_from_spec(spec, device)
    cfg = TrainConfig(batch_size=batch_size, verbose=10 ** 9, seed=seed, mesh=mesh,
                      device=str(device) if mesh is None else None)
    tr = Trainer(models[0], data, optimizer, cfg)
    if init is not None:
        tr.params = params_from_numpy(init, tr.device)
    draws = iter(draws or ())
    before, stats = launches(), []
    for i, (model, n) in enumerate(zip(models, epochs)):
        if i:
            tr.switch_model(model, reset_opt=reset_opt)
        if steps is not None:
            tr.num_batches = steps
            tr.epoch_fn = tr._make_epoch_fn(model)
        for _ in range(n):
            drawn = next(draws, None)
            if drawn is None:
                stats.append(tr.run_epoch())
                continue
            tr.params, tr.opt_state, s = tr.epoch_fn(
                tr.params, tr.opt_state, tr.dev, tr.generator,
                *(torch.as_tensor(x, device=tr.device) for x in drawn))
            stats.append(s)
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    return {"state": state_arrays(tr.params, tr.opt_state), "stats": stats,
            **{k: v - before[k] for k, v in launches().items()}}


def seq_steps(spec, device, model, optimizer, params, batches, masks):
    """The data-parallel sequence step on injected draws: one
    :func:`seq_train_step` of :func:`data_parallel`'s copy of ``model`` for
    each global batch ``(users, window, neg)`` of ``batches``, with its
    dropout masks ``(training pass, asasrec2's adversarial pass)`` of
    ``masks``; each data rank takes its rows, and the gradients are summed
    over "data", as the mesh epoch steps. Returns the params and optimizer
    slots by their snapshot names."""
    from acf_tpu_torch.models.base import data_parallel
    from acf_tpu_torch.parallel.mesh import all_reduce_tree
    from acf_tpu_torch.train.checkpoint import state_arrays
    from acf_tpu_torch.train.trainer import seq_train_step
    from acf_tpu_torch.utils.tree import tree_map

    mesh = mesh_from_spec(spec, device)
    dp = data_parallel(model, mesh)
    prm = params_from_numpy(params, mesh.device)
    opt = optimizer.init(prm)

    def reduce(grads):
        return all_reduce_tree(mesh, grads, "data")

    for batch, drawn in zip(batches, masks):
        rows = mesh.rows(batch[0].shape[0])
        mine = [None if m is None else
                tree_map(lambda x: x[rows], params_from_numpy(m, mesh.device)) for m in drawn]
        batch = tuple(torch.as_tensor(x, device=mesh.device)[rows] for x in batch)
        prm, opt, _ = seq_train_step(dp, optimizer, prm, opt, batch, None, *mine, reduce)
    return {"state": state_arrays(prm, opt)}


def ping(spec, device):
    """An all_reduce over each axis: (the sum of the ranks over "data", over
    "model")."""
    mesh = mesh_from_spec(spec, device)
    out = []
    for axis in ("data", "model"):
        x = torch.tensor([float(mesh.rank)], device=mesh.device)
        out.append(float(mesh.all_reduce(x, axis)[0]))
    return np.asarray(out)


def serve_error(spec, device, num_items, k):
    """The message of the ``ValueError`` that sharded serving raises for a
    top-``k`` of ``num_items`` items over this mesh."""
    from acf_tpu_torch.parallel.sharded_serve import make_sharded_recommend

    mesh = mesh_from_spec(spec, device)
    try:
        make_sharded_recommend(mesh, None, num_items, k)
    except ValueError as e:
        return str(e)
    return None


def several(spec, device, calls):
    """Each ``(name, args)`` of ``calls`` as ``name(spec, device, *args)`` on
    one group: one launch for many cases. Returns their results in order;
    rank 0 prints each case's seconds."""
    out = []
    for name, args in calls:
        t0 = time.perf_counter()
        out.append(globals()[name](spec, device, *args))
        if torch.distributed.get_rank() == 0:
            print(f"mesh {spec} rank 0: {name} {time.perf_counter() - t0:.2f} s", flush=True)
    return out
