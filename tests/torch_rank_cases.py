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
from acf_tpu_torch.utils.tree import tree_map


def launches() -> dict:
    """The launch counters of the kernels that the mesh paths run."""
    from acf_tpu_torch.ops.apl_gen_fused import KERNELS
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.ops.sasrec_fused import encoder_bwd, fused_encoder

    return {"k1": rank_positions_dot.launches, "k2a": fused_encoder.launches,
            "k2b": encoder_bwd.launches, **{k.__name__: k.launches for k in KERNELS}}


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
          batch_size=512, reset_opt=True, init=None, draws=None, evaluate=False):
    """A :class:`Trainer` over ``data`` with ``TrainConfig(mesh=...)`` (one
    device when ``spec`` is None): ``epochs[i]`` epochs of ``models[i]``,
    switching models in turn (``reset_opt`` as ``fit_two_phase``), each
    epoch of ``steps`` steps when given. ``init`` (numpy params) replaces
    the seeded init; ``draws``, one tuple of numpy arrays (or dicts of them)
    an epoch, the epoch function's draw arguments in order (the pair epoch's
    batches and cands; a bespoke epoch's own), are injected in place of the
    trainer's own draws. With ``evaluate`` the trainer's evaluation follows
    (sharded over the mesh for a factored model): its HR, NDCG and AUC at
    10 under ``at10``. Returns the params and optimizer slots (by their
    snapshot names), each epoch's stats and the kernels' launches."""
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
                *tree_map(lambda x: torch.as_tensor(x, device=tr.device), tuple(drawn)))
            stats.append(s)
    out = {"state": state_arrays(tr.params, tr.opt_state), "stats": stats}
    if evaluate:
        out["at10"] = tr.evaluate().at_k(10)
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    return {**out, **{k: v - before[k] for k, v in launches().items()}}


def apl_pass(name, x, up, fn):
    """One call of APL's generator pass ``name`` (``apl_stats1`` … ``apl_grad``,
    K3a–K3e) through ``fn`` (the kernel's wrapper or its plain version) on the
    step's inputs ``x`` and the outputs ``up`` of the passes before it; its
    outputs as a tuple."""
    wt = dict(w=0.2, temperature=0.2)
    if name == "apl_stats1":
        return fn(x["pu_g"], x["Qg"])
    m1, l1 = up["apl_stats1"]
    if name == "apl_z":
        return fn(x["pu_g"], x["Qg"], x["member"], x["nuniq"], x["gnoise"], m1, l1, **wt)
    z, m2, l2 = up["apl_z"]
    if name == "apl_fake":
        return (fn(x["pu_c"], x["Qc"], z, m2, l2),)
    chain = (x["pu_g"], x["Qg"], x["pu_c"], x["Qc"], x["member"], x["nuniq"], z, m1, l1, m2,
             l2, x["a"], up["apl_fake"][0])
    if name == "apl_bigr":
        return (fn(*chain, **wt),)
    return fn(*chain, up["apl_bigr"][0], **wt)


def apl_chain(x, up=None):
    """K3a–K3e in order, each fed the outputs of the ones before it; or,
    given the kernels' outputs ``up``, each plain version fed the kernel
    outputs of the passes before it, so each kernel is checked alone."""
    from acf_tpu_torch.ops import apl_gen_fused as ops

    out = {}
    for k in ops.KERNELS:
        name = k.__name__
        fn = getattr(ops, name if up is None else name + "_plain")
        out[name] = apl_pass(name, x, out if up is None else up, fn)
    return out


def apl_kernels(spec, device, data, dim, batch_size, seed, scale=0.4):
    """K3a–K3e on this data rank's rows of one global generator batch: tables
    of ``scale`` times normal draws (logits of a few units), ``batch_size``
    of ``data``'s pairs, the global [B, I] Gumbel noise and ∂L/∂fake of the
    rank's share of the generator's loss, all drawn from ``seed`` alike on
    every rank; each kernel's outputs against its plain version fed the
    kernel outputs of the passes before it. Returns the rank's rows,
    ``errs`` {kernel: [(max |kernel − plain|, max |plain|) of each
    output]}, the pad item's largest Q gradient and the kernels' launches
    in the check."""
    from acf_tpu_torch.models.apl import APL, gumbel, membership
    from acf_tpu_torch.models.base import data_parallel
    from acf_tpu_torch.ops.apl_gen_fused import apl_gen_forward

    mesh = mesh_from_spec(spec, device)
    dev = mesh.device
    model = data_parallel(APL(data.num_users, data.num_items, dim), mesh)
    g = torch.Generator(device=dev).manual_seed(seed)
    U, I = data.num_users, data.num_items

    def normal(*shape):
        return scale * torch.randn(*shape, generator=g, device=dev)

    Pg, Qg, Pc, Qc = normal(U, dim), normal(I, dim), normal(U, dim), normal(I, dim)
    idx = torch.randint(0, data.num_pairs, (batch_size,), generator=g, device=dev)
    noise = gumbel(torch.rand(batch_size, I, generator=g, device=dev))
    rows = mesh.rows(batch_size)
    u = torch.as_tensor(data.pairs_u, device=dev)[idx][rows].long()
    i = torch.as_tensor(data.pairs_i, device=dev)[idx][rows].long()
    member, nuniq = membership(torch.as_tensor(data.hist, device=dev)[u], I)
    x = dict(pu_g=Pg[u], Qg=Qg, pu_c=Pc[u], Qc=Qc, member=member, nuniq=nuniq,
             gnoise=noise[rows])
    fake, _ = apl_gen_forward(x["pu_g"], Qg, x["pu_c"], Qc, member, nuniq, x["gnoise"],
                              w=model.p_aux_weight, temperature=model.temperature)
    real = torch.sum(x["pu_c"] * Qc[i], dim=-1)
    with torch.enable_grad():
        f = fake.detach().requires_grad_(True)
        (x["a"],) = torch.autograd.grad(model._losses(real, f, 0.0, 0.0)[0], f)
    before = launches()
    got = apl_chain(x)
    plain = apl_chain(x, up=got)
    errs = {name: [(float((k - p).abs().max()), float(p.abs().max()))
                   for k, p in zip(got[name], plain[name])] for name in got}
    pad = float(got["apl_grad"][0][0].abs().max())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"rows": int(u.shape[0]), "errs": errs, "pad_grad": pad,
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
