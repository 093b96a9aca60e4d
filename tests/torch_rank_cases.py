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

import os
import time

import numpy as np
import torch

from acf_tpu_torch.compat.jax_params import params_from_numpy, params_to_numpy
from acf_tpu_torch.parallel.input_pipeline import host_sharded_array, replicate_result
from acf_tpu_torch.parallel.mesh import mesh_from_spec
from acf_tpu_torch.utils.tree import tree_map


_MESHES = {}


def _mesh(spec, device):
    """The mesh of ``spec`` over this launch's group, made once a launch
    (its groups are made on every rank in one order, so every case that
    reuses it must run on every rank)."""
    if (spec, str(device)) not in _MESHES:
        _MESHES[spec, str(device)] = mesh_from_spec(spec, device)
    return _MESHES[spec, str(device)]


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

    mesh = _mesh(spec, device)
    shard = shard_table(mesh, torch.as_tensor(table, device=mesh.device)).requires_grad_(True)
    d = mesh.data_index
    rows = sharded_lookup(mesh, shard, torch.as_tensor(ids[d], device=mesh.device))
    (rows * torch.as_tensor(ct[d], device=mesh.device)).sum().backward()
    return {"rows": rows.detach().cpu().numpy(), "shard": shard.detach().cpu().numpy(),
            "grad": shard.grad.cpu().numpy()}


def positions(spec, device, model, params, users, hists, gt):
    """:func:`sharded_positions_for_model` of the global request."""
    from acf_tpu_torch.parallel.sharded_eval import sharded_positions_for_model

    mesh = _mesh(spec, device)
    prm = params_from_numpy(params, mesh.device)
    return {"pos": sharded_positions_for_model(mesh, model, prm, users, hists, gt),
            **launches()}


def evaluator(spec, device, model, params, data, batch_users):
    """Every eval user's position through ``FullRankEvaluator(mesh=)``."""
    from acf_tpu_torch.eval.full_rank import FullRankEvaluator

    mesh = _mesh(spec, device)
    ev = FullRankEvaluator(data, batch_users=batch_users, mesh=mesh)
    before = launches()
    pos = ev.positions_sharded(model, params_from_numpy(params, mesh.device))
    return {"pos": pos, **{k: v - before[k] for k, v in launches().items()}}


def recommend(spec, device, model, params, users, hists, k):
    """:func:`sharded_recommend_for_model` of the global request."""
    from acf_tpu_torch.parallel.sharded_serve import sharded_recommend_for_model

    mesh = _mesh(spec, device)
    s, i = sharded_recommend_for_model(mesh, model, params_from_numpy(params, mesh.device),
                                       users, hists, k)
    return {"scores": s, "items": i}


def recommend_bulk(spec, device, model, params, data, users, k, batch_users):
    """:func:`sharded_recommend_bulk` of ``users``."""
    from acf_tpu_torch.parallel.sharded_serve import sharded_recommend_bulk

    mesh = _mesh(spec, device)
    s, i = sharded_recommend_bulk(mesh, model, params_from_numpy(params, mesh.device), data,
                                  users, k, batch_users)
    return {"scores": s, "items": i}


def bpr_step(spec, device, P, Q, users, pos, neg, eps, lr=0.05):
    """One :func:`make_sharded_bpr_step` on the global batch; the whole
    updated tables."""
    from acf_tpu_torch.parallel.sharded_embedding import make_sharded_bpr_step, shard_table

    mesh = _mesh(spec, device)
    step = make_sharded_bpr_step(mesh, eps=eps, lr=lr)
    Pl, Ql = (shard_table(mesh, torch.as_tensor(x, device=mesh.device)) for x in (P, Q))
    Pl, Ql = step(Pl, Ql, *(host_sharded_array(mesh, x) for x in (users, pos, neg)))
    return {"P": _whole(mesh, Pl, P.shape[0]).cpu().numpy(),
            "Q": _whole(mesh, Ql, Q.shape[0]).cpu().numpy()}


def sasrec_step(spec, device, model, params, seq, pos, neg, lr=1e-3):
    """One :func:`make_sharded_sasrec_step` on the global batch; the whole
    updated params, and the kernels' launches in the step."""
    from acf_tpu_torch.parallel.sharded_embedding import make_sharded_sasrec_step, shard_table

    mesh = _mesh(spec, device)
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
          batch_size=512, reset_opt=True, init=None, draws=None, evaluate=False,
          shard_min_rows=1024, positions=False):
    """A :class:`Trainer` over ``data`` with ``TrainConfig(mesh=...)`` (one
    device when ``spec`` is None): ``epochs[i]`` epochs of ``models[i]``,
    switching models in turn (``reset_opt`` as ``fit_two_phase``), each
    epoch of ``steps`` steps when given. ``init`` (numpy params) replaces
    the seeded init; ``draws``, one tuple of numpy arrays (or dicts of them)
    an epoch, the epoch function's draw arguments in order (the pair epoch's
    batches and cands; a bespoke epoch's own), are injected in place of the
    trainer's own draws. With ``evaluate`` the trainer's evaluation follows
    (sharded over the mesh for a factored model): its HR, NDCG and AUC at
    10 under ``at10``; with ``positions`` every eval user's position under
    ``pos`` (the sharded evaluation's, from the stored item shard, under a
    mesh). ``shard_min_rows`` as ``TrainConfig``'s. Returns the
    params and optimizer slots (by their snapshot names, gathered whole),
    each epoch's stats, the kernels' launches and, under sharded storage,
    ``storage``: each snapshot name's stored shape and global row count
    (None: whole), and whether every padded row is zero."""
    from acf_tpu_torch.train import TrainConfig, Trainer
    from acf_tpu_torch.train.checkpoint import state_arrays

    mesh = None if spec is None else _mesh(spec, device)
    cfg = TrainConfig(batch_size=batch_size, verbose=10 ** 9, seed=seed, mesh=mesh,
                      device=str(device) if mesh is None else None,
                      shard_min_rows=shard_min_rows)
    tr = Trainer(models[0], data, optimizer, cfg)
    if init is not None:
        tr.set_state(params_from_numpy(init, tr.device))
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
    out = {"state": state_arrays(*tr.whole_state()), "stats": stats}
    if tr.layout is not None:
        out["storage"] = storage(tr)
    if evaluate:
        out["at10"] = tr.evaluate().at_k(10)
    if positions:
        out["pos"] = trainer_positions(tr)
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    return {**out, **{k: v - before[k] for k, v in launches().items()}}


def trainer_positions(tr):
    """Every eval user's position under ``tr``'s params through its
    evaluator (K1; sharded over the mesh from the stored item shard)."""
    if tr.mesh is not None:
        return tr.evaluator.positions_sharded(tr.model, tr.params, tr.layout)
    fs = tr.model.factored_scorer()
    return tr.evaluator.positions_factored(fs[0], fs[1], tr.params)


def stored_bytes(tr) -> int:
    """The bytes of the params and optimizer slots a rank stores."""
    from acf_tpu_torch.utils.tree import tree_leaves

    return sum(x.numel() * x.element_size()
               for x in tree_leaves(tr.params) + tree_leaves(tr.opt_state))


def memory(spec, device, model, optimizer, data, steps, seed=27, batch_size=512, shards=2):
    """One epoch of ``steps`` steps of a :class:`Trainer` over the mesh
    (``shard_min_rows`` 1024), as the first case of a launch: the bytes of
    params and slots stored on this rank, the peak of
    ``torch.cuda.max_memory_allocated`` over the run (the trainer's set-up
    included), and a SHA-256 of the bytes of each param's rows by
    (name, model rank of a ``shards``-way row split): this rank's shard's
    real rows, or of a whole table each such block of its rows."""
    import hashlib

    from acf_tpu_torch.train import TrainConfig, Trainer
    from acf_tpu_torch.train.checkpoint import _flatten_with_names

    mesh = _mesh(spec, device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = Trainer(model, data, optimizer,
                 TrainConfig(batch_size=batch_size, verbose=10 ** 9, seed=seed, mesh=mesh))
    tr.num_batches = steps
    tr.epoch_fn = tr._make_epoch_fn(model)
    tr.run_epoch()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    def sha(x):
        return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()

    names = _flatten_with_names(tr.params)
    rows = ([r for _, r in _flatten_with_names(tr.layout.rows)] if tr.layout is not None
            else [None] * len(names))
    hashes = {}
    for (name, x), r in zip(names, rows):
        if r is not None:
            real = max(min(x.shape[0], r - mesh.model_index * x.shape[0]), 0)
            hashes[name, mesh.model_index] = sha(x[:real])
            continue
        il = -(-x.shape[0] // shards)
        for k in range(shards):
            hashes[name, k] = sha(x[k * il:(k + 1) * il])
    return {"stored": stored_bytes(tr), "sharded": tr.layout is not None,
            "peak": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
            "hashes": hashes, "wall_s": wall}


def storage(tr) -> dict:
    """A sharded trainer's storage: {snapshot name: (stored shape, global
    rows or None)} and ``pad_zero``, whether every padded row of every
    sharded param is zero."""
    from acf_tpu_torch.train.checkpoint import _state_rows, state_entries

    entries = state_entries(tr.params, tr.opt_state)
    rows = _state_rows(tr.params, tr.opt_state, tr._state_layout(), rng=False)
    mesh = tr.mesh
    pad_zero = True
    for (name, x), r in zip(entries, rows):
        if r is not None and name.startswith("params/"):
            real = max(min(x.shape[0], r - mesh.model_index * x.shape[0]), 0)
            pad_zero = pad_zero and bool((x[real:] == 0).all())
    return {"leaves": {n: (tuple(x.shape), r) for (n, x), r in zip(entries, rows)},
            "pad_zero": pad_zero}


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

    mesh = _mesh(spec, device)
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

    mesh = _mesh(spec, device)
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
    mesh = _mesh(spec, device)
    out = []
    for axis in ("data", "model"):
        x = torch.tensor([float(mesh.rank)], device=mesh.device)
        out.append(float(mesh.all_reduce(x, axis)[0]))
    return np.asarray(out)


def serve_error(spec, device, num_items, k):
    """The message of the ``ValueError`` that sharded serving raises for a
    top-``k`` of ``num_items`` items over this mesh."""
    from acf_tpu_torch.parallel.sharded_serve import make_sharded_recommend

    mesh = _mesh(spec, device)
    try:
        make_sharded_recommend(mesh, None, num_items, k)
    except ValueError as e:
        return str(e)
    return None


def meshes(spec, device, plan):
    """:func:`several` for each ``(spec, calls)`` of ``plan`` in turn, on
    one group (every spec of the launch's world size): one launch for many
    meshes. ``spec`` is not used."""
    return [several(s, device, calls) for s, calls in plan]


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


def lifecycle(spec, device, models, optimizer, data, root, shard_min_rows, batch_size=32,
              seed=13):
    """``fit_two_phase``'s steps on a :class:`Trainer` over the mesh, every
    save on: ``models[0]`` for one epoch, ``-pretrain`` params, the switch
    to ``models[1]`` (fresh slots), a second epoch, ``-final`` params, with
    an evaluation, ``.best``/``.last`` params and a full-state snapshot
    every epoch, all under ``root``; then ``load_pretrain`` of the
    ``-pretrain`` file into a fresh trainer. Returns the final state
    gathered whole, the epoch line's norms, the best NDCG, the storage
    after the switch, after the fit and of the fresh trainer after
    ``load_pretrain`` (:func:`storage`, None when nothing is sharded), the
    names it loaded and its params gathered whole."""
    from acf_tpu_torch.train import TrainConfig, Trainer
    from acf_tpu_torch.train.checkpoint import state_arrays

    mesh = _mesh(spec, device)
    ck = os.path.join(root, "ck")
    cfg = TrainConfig(batch_size=batch_size, epochs=2, verbose=1, seed=seed, mesh=mesh,
                      ckpt_every=1, ckpt_path=ck, save_model_path=os.path.join(root, "model"),
                      shard_min_rows=shard_min_rows)
    tr = Trainer(models[0], data, optimizer, cfg)
    tr.fit(epochs=1, tag="t", final=False)
    tr.save_params(ck + "-pretrain")
    tr.switch_model(models[1], reset_opt=True)
    after_switch = storage(tr) if tr.layout is not None else None
    best = tr.fit(epochs=2, epoch_start=1, tag="t")
    tr.save_params(ck + "-final")
    fresh = Trainer(models[0], data, optimizer, cfg)
    loaded = fresh.load_pretrain(ck + "-pretrain")
    return {"state": state_arrays(*tr.whole_state()), "norms": tr._table_norms(),
            "ndcg": best["ndcg"], "after_switch": after_switch,
            "after_fit": storage(tr) if tr.layout is not None else None,
            "pretrained": storage(fresh) if fresh.layout is not None else None,
            "loaded": loaded, "pretrained_params": params_to_numpy(fresh.whole_params())}


def cli_run(spec, device, argv, shard_min_rows):
    """The port's command line on ``argv`` + ``--mesh spec`` over this
    launch's group, its trainers storing every leaf of at least
    ``shard_min_rows`` rows sharded (the command line keeps the default
    1024, more rows than the bundled data's tables have). Returns the best
    NDCG and, for each trainer it built, whether it stores any leaf
    sharded."""
    import functools

    from acf_tpu_torch.cli import main as cli
    from acf_tpu_torch.train import TrainConfig, Trainer

    made = []

    class Recorded(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self.layout is not None)

    cli.TrainConfig = functools.partial(TrainConfig, shard_min_rows=shard_min_rows)
    cli.Trainer = Recorded
    try:
        best = cli.main(list(argv) + ["--mesh", spec, "--device", device])
    finally:
        cli.TrainConfig, cli.Trainer = TrainConfig, Trainer
    return {"ndcg": best["ndcg"], "sharded": made}


def snapshots(spec, device, model, optimizer, data, actions, shard_min_rows=2,
              batch_size=32, seed=13, backend="dcp", steps=None):
    """A :class:`Trainer` over the mesh (one device when ``spec`` is None)
    that runs ``actions`` in order: ``("epoch",)`` an epoch, ``("save",
    path)`` a full-state snapshot (``backend``), ``("restore", path)`` one
    restored, ``("state",)`` the state gathered whole with the generator
    state, ``("await", path, seconds)`` a wait until another launch has
    written the snapshot ``path``, ``("eval",)`` the per-user HR and NDCG,
    ``("positions",)`` every
    eval user's position and K1's launches in it. An epoch has ``steps``
    steps when given. Returns the outputs of the ``state``, ``eval`` and
    ``positions`` actions in order."""
    from acf_tpu_torch.train import TrainConfig, Trainer
    from acf_tpu_torch.train.checkpoint import state_arrays

    mesh = None if spec is None else _mesh(spec, device)
    cfg = TrainConfig(batch_size=batch_size, verbose=10 ** 9, seed=seed, mesh=mesh,
                      device=str(device) if mesh is None else None,
                      shard_min_rows=shard_min_rows, ckpt_backend=backend)
    tr = Trainer(model, data, optimizer, cfg)
    if steps is not None:
        tr.num_batches = steps
        tr.epoch_fn = tr._make_epoch_fn(model)
    out = []
    for act in actions:
        if act[0] == "await":  # a snapshot that another launch writes
            deadline = time.monotonic() + act[2]
            while not os.path.exists(os.path.join(act[1], ".metadata")):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no snapshot at {act[1]} after {act[2]} s")
                time.sleep(0.2)
        elif act[0] == "epoch":
            tr.run_epoch()
        elif act[0] == "save":
            tr.save_checkpoint(act[1])
        elif act[0] == "restore":
            tr.restore_checkpoint(act[1])
        elif act[0] == "state":
            out.append({"state": state_arrays(*tr.whole_state(), tr.generator.get_state()),
                        "sharded": tr.layout is not None})
        elif act[0] == "eval":
            res = tr.evaluate()
            out.append({"hr": res.hr, "ndcg": res.ndcg})
        elif act[0] == "positions":
            before = launches()["k1"]
            pos = trainer_positions(tr)
            out.append({"pos": pos, "k1": launches()["k1"] - before})
    return out
