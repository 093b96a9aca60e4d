"""The trainer (counterpart of ``acf_tpu/train/trainer.py``).

Each epoch is a Python loop of ``num_batches`` steps on the device, and one
host transfer per epoch reads the mean of the steps' aux values. Three
kinds of epoch, chosen as the JAX package chooses them:

* a model's own ``make_epoch_fn`` (APL's critic-then-generator epoch, the
  popularity adversaries' discriminator-then-recommender epoch), checked
  first, with its ``init_opt_state`` for the optimizer slots and its
  ``extra_device_data`` on the device;
* sequence models (``batch_kind == "seq"``): draw a packed window batch
  (:func:`acf_tpu_torch.sampling.sample_seq_window_batch`), take
  ``loss_window``'s value and gradient (or ``loss``'s on the expanded
  batch, for a model without ``loss_window`` such as the FGSM wrapper),
  apply the update (:func:`seq_train_step`);
* pair models: shuffle the train pairs into the epoch's batches, draw one
  uniform negative per pair (with DNS, ``dns > 1``, the highest scored of
  ``dns`` such draws), take the gradient of ``loss`` by autograd or, for
  APR's reference configuration, the model's closed form
  (``manual_grads``), apply the update (:func:`pair_train_step`).

Each step is one function of (params, optimizer state, batch, draws), so a
test can drive it with the JAX package's draws, and the epoch functions
take the epoch's draws injected the same way.

With ``TrainConfig.mesh`` the pair and sequence epochs run data-parallel
over the mesh's "data" axis: every rank draws the whole global batch (its
negatives and dropout masks too) from the same seeded generator, as one
device would, and takes its data rank's rows; its loss is its share of the
global loss (:func:`acf_tpu_torch.models.base.data_parallel`); the
gradients are summed over the data ranks before the update, so every rank
applies the same update. Evaluation is sharded over both axes. Every model
trains under a mesh: the generic epochs take the data-parallel copy, and a
model's own epoch gets it and the mesh (``make_epoch_fn(..., mesh=)``) and
draws, splits and sums the same way (the sparse step instead steps on the
whole batch on every rank with its tables row-sharded over "model"; the
naive baselines train nothing).

Under a mesh the params are stored as
:func:`acf_tpu_torch.parallel.mesh.shard_params` places them
(``TrainConfig.shard_min_rows``, the JAX meaning): each large 2-D leaf as a
row shard over "model", its optimizer slots with it, so the stored state a
rank falls with the "model" size m. Every epoch gets the optimizer as
:class:`~acf_tpu_torch.train.optim.Sharded` over that layout. Two access
forms: a step gathers each sharded leaf whole before its loss (every
model; the transient leaf and its gradient stay whole) and updates its own
rows; the MF family's pair step (clean MF-BPR, DNS, pointwise MF and APR's
closed form) takes the row path instead, which reads the batch's rows
through :class:`~acf_tpu_torch.parallel.sharded_embedding.TableRows`,
scatters its row gradients into the rank's own rows and forms no whole
table. The sparse step updates the stored shards in place, and the sharded
evaluation counts on the stored item shard. With m = 1 nothing is sharded.

:class:`Trainer` adds leave-one-out evaluation through
:class:`acf_tpu_torch.eval.FullRankEvaluator` (so through K1 for factored
models, and K2a for SASRec), best-NDCG tracking, the reference's epoch line
and per-user dumps, the NaN abort, snapshots of the full train state (an
npz written from rank 0, or with ``ckpt_backend="dcp"`` a directory in which
each rank writes its own rows, periodic ones written in the background), and
the two-phase staging of :func:`fit_two_phase`. Every rank takes part in
every save, every gather and every evaluation, in the same order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from acf_tpu_torch.data.datasets import Interactions
from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.eval.full_rank import FullRankEvaluator
from acf_tpu_torch.parallel.sharded_embedding import shard_table
from acf_tpu_torch.sampling.negatives import (
    negatives_from_draws, pair_batches_from_perm, sample_pair_epoch, sample_seq_window_batch,
    uniform_negatives,
)
from acf_tpu_torch.train.checkpoint import (
    AsyncSnapshotter, _flatten_with_names, check_backend, is_dcp, load_state, load_state_dcp,
    save_params, save_state, save_state_dcp,
)
from acf_tpu_torch.train.optim import Sharded, grad_update, layout_of, update_rows, whole
from acf_tpu_torch.utils.io import OutputWriter
from acf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 512
    epochs: int = 100
    verbose: int = 1          # evaluate every N epochs (reference --verbose)
    topk: int = 10
    ckpt_every: int = 0       # save the full train state every N epochs; 0 = off
    ckpt_path: Optional[str] = None
    seed: int = 2019
    eval_batch_users: int = 512
    eval_sampled: bool = False  # rank against sampled negatives
                                # (reference --eval_mode sample)
    membership_len: Optional[int] = None  # cap on the history columns the
                                          # pair sampler's rejection reads
    # --save_model protocol (reference run.py:257-272): params on every new
    # best NDCG to <save_model_path>.best.npz and after every epoch to
    # <save_model_path>.last.npz. None = off.
    save_model_path: Optional[str] = None
    device: Optional[str] = None  # default cuda; "cpu" to train on the CPU
    # a ("data", "model") acf_tpu_torch.parallel.mesh.Mesh: data-parallel
    # training over "data" and evaluation sharded over both axes; the mesh's
    # device is the trainer's. None = one device.
    mesh: Optional[object] = None
    # under a mesh, 2-D leaves with fewer rows than this stay whole on every
    # rank (the JAX meaning: sharding a small table costs more in
    # collectives than it saves in memory); larger ones are row shards
    shard_min_rows: int = 1024
    # "npz" (one file from rank 0) or "dcp" (a torch.distributed.checkpoint
    # directory: each rank writes its own rows; periodic snapshots in fit
    # written in the background by an AsyncSnapshotter)
    ckpt_backend: str = "npz"


def _mean_stats(sums, n, mesh=None):
    """One host transfer: the mean over ``n`` steps of each summed aux value
    (each rank's values its shares, summed over the data ranks under a
    mesh)."""
    names = sorted(sums)
    total = torch.stack([sums[k] for k in names])
    if mesh is not None:
        mesh.all_reduce(total, "data")
    means = (total / n).cpu().tolist()
    return dict(zip(names, means))


def _add_stats(sums, aux):
    for k, v in aux.items():
        sums[k] = v.detach() if k not in sums else sums[k] + v.detach()


def pair_train_step(model, optimizer, params, opt_state, batch, generator=None,
                    manual_grads=None, reduce=None, read=None):
    """One step of a pair model on ``batch`` = (users, pos, neg): the
    gradient of ``model.loss`` at ``params`` (read as :func:`grad_update`
    reads them, ``read`` the leaves already gathered) by autograd, or
    ``manual_grads(params, batch, generator) -> (grads, aux)`` when given
    (gradients shaped as ``params`` are stored: the row path's), through
    ``reduce`` when given (the sum over data ranks), then the optimizer's
    update. Returns (params, opt_state, aux)."""
    if manual_grads is not None:
        with torch.no_grad():
            grads, aux = manual_grads(params, batch, generator)
            if reduce is not None:
                grads = reduce(grads)
        params, opt_state = update_rows(optimizer, grads, opt_state, params)
        return params, opt_state, aux
    params, opt_state, _, aux = grad_update(optimizer, params, opt_state,
                                            lambda prm: model.loss(prm, batch, generator),
                                            reduce, read)
    return params, opt_state, aux


def dns_negatives(model, params, users, hist_rows, cands, tables=None):
    """DNS (reference evaluation_adv.py:349-367): of the ``dns`` negatives
    ``cands`` [B, dns], the one ``model.score_some`` scores highest at
    ``params`` (whole, or with ``tables`` as the row path stores them: the
    model's :meth:`row_scores`) (the first on ties, as ``jnp.argmax``)."""
    with torch.no_grad():
        if tables is None:
            scores = model.score_some(params, users, hist_rows, cands)
        else:
            scores = model.row_scores(tables, params, users, hist_rows, cands)
    return cands.gather(1, torch.argmax(scores, dim=1)[:, None])[:, 0]


def _data_parallel(mesh, batch_size: int):
    """(this data rank's rows of a global batch, the gradient reduce: the
    sum over the data ranks); every row and no reduce on one device, and no
    reduce over a data axis of one rank: a sum of one term, whose packing
    (:func:`~acf_tpu_torch.parallel.mesh.all_reduce_tree`) would copy every
    gradient into one buffer, a transient as large as the stored shards on
    the row path at 1xM."""
    if mesh is None:
        return slice(None), None
    from acf_tpu_torch.parallel.mesh import all_reduce_tree

    if mesh.shape["data"] == 1:
        return mesh.rows(batch_size), None
    return mesh.rows(batch_size), lambda grads: all_reduce_tree(mesh, grads, "data")


def make_pair_epoch_fn(model, optimizer, batch_size: int, num_batches: int, mesh=None):
    """The one-epoch function for pair models (``acf_tpu/train/trainer.py``'s
    ``make_pair_epoch_fn``): ``epoch_fn(params, opt_state, data, generator,
    batches=None, cands=None) -> (params, opt_state, stats)`` with ``data``
    holding ``pairs_u``, ``pairs_i`` and ``hist`` on the device.
    ``batches`` [num_batches, batch_size] (pair indices) and ``cands``
    (negative candidates: [num_batches, R, batch_size], or [num_batches,
    dns, R, batch_size] with DNS) replace the draws from ``generator`` when
    given.

    The step takes the model's closed-form gradients when it has them
    (``manual_grads``, APR) and ``batch_size <= model.manual_grads_max_batch``
    (its equality matrices grow as B²); otherwise autograd. With ``mesh``
    (``model`` then :func:`~acf_tpu_torch.models.base.data_parallel`'s copy)
    the draws are the global batch's and the step takes this data rank's
    rows. With sharded storage (``optimizer`` a
    :class:`~acf_tpu_torch.train.optim.Sharded`) a model with a row path
    (``row_path``: clean MF-BPR, DNS, pointwise MF, and APR by its closed
    form) steps on the rows it reads (``model.row_step``); any other
    gathers its leaves whole for each step (:func:`grad_update`)."""
    rows, reduce = _data_parallel(mesh, batch_size)
    dns = getattr(model, "dns", 1)
    manual_grads = getattr(model, "manual_grads", None)
    if manual_grads is not None and batch_size > getattr(model, "manual_grads_max_batch", 4096):
        manual_grads = None
    tables = None
    layout = layout_of(optimizer)
    if (layout is not None and getattr(model, "row_path", False)
            and not (getattr(model, "adversarial", False) and manual_grads is None)):
        from acf_tpu_torch.parallel.sharded_embedding import TableRows

        tables = TableRows(layout)
        closed = manual_grads is not None
        manual_grads = (lambda prm, batch, gen: model.row_step(tables, prm, batch, gen,
                                                               closed_form=closed))

    def negatives(params, u, hist_rows, step, generator, cands):
        """This rank's rows' negatives, of the global batch's draws (DNS
        scores them at ``params``: whole, or as the row path stores them)."""
        if dns <= 1:
            if cands is None:
                return uniform_negatives(generator, hist_rows, model.num_items)[rows]
            return negatives_from_draws(cands[step], hist_rows)[rows]
        if cands is None:
            drawn = [uniform_negatives(generator, hist_rows, model.num_items)
                     for _ in range(dns)]
        else:
            drawn = [negatives_from_draws(c, hist_rows) for c in cands[step]]
        return dns_negatives(model, params, u[rows], hist_rows[rows],
                             torch.stack(drawn, dim=1)[rows], tables)

    def epoch_fn(params, opt_state, data, generator, batches=None, cands=None):
        if batches is None:
            batches = sample_pair_epoch(generator, data["pairs_u"].shape[0], batch_size,
                                        num_batches)
        sums = {}
        for step in range(num_batches):
            idx = batches[step]
            u, pos = data["pairs_u"][idx], data["pairs_i"][idx]
            hist_rows = data["hist"][u]
            # DNS off the row path reads the leaves whole: gathered once a step
            read = whole(optimizer, params) if dns > 1 and tables is None else None
            neg = negatives(params if read is None else read, u, hist_rows, step, generator,
                            cands)
            params, opt_state, aux = pair_train_step(model, optimizer, params, opt_state,
                                                     (u[rows], pos[rows], neg), generator,
                                                     manual_grads, reduce, read)
            _add_stats(sums, aux)
        return params, opt_state, _mean_stats(sums, num_batches, mesh)

    return epoch_fn


def window_loss(model):
    """``model.loss_window``, or ``model.loss`` on the expanded batch
    (``seq = window[:, :-1]``, ``pos = window[:, 1:]``) for a model without
    one (the FGSM wrapper around a sequence model)."""
    if hasattr(model, "loss_window"):
        return model.loss_window

    def expanded(params, batch, generator=None, **masks):
        users, window, neg = batch
        return model.loss(params, (users, window[:, :-1], window[:, 1:], neg), generator,
                          **masks)

    return expanded


def seq_train_step(model, optimizer, params, opt_state, batch, generator=None,
                   masks=None, adv_masks=None, reduce=None):
    """One training step: the value and gradient of :func:`window_loss` at
    ``params`` on ``batch`` = (users, window, neg), dropout from
    ``generator`` or the injected ``masks``/``adv_masks``, the gradients
    through ``reduce`` when given, then the optimizer's update. Returns
    (params, opt_state, aux)."""
    loss_fn = window_loss(model)
    kw = {k: v for k, v in (("masks", masks), ("adv_masks", adv_masks)) if v is not None}
    params, opt_state, _, aux = grad_update(
        optimizer, params, opt_state, lambda prm: loss_fn(prm, batch, generator, **kw), reduce)
    return params, opt_state, aux


def make_seq_epoch_fn(model, optimizer, batch_size: int, num_batches: int, mesh=None):
    """The one-epoch function for sequence models (WarpSampler semantics:
    users sampled with replacement, SASRecLayers.py:329-358):
    ``epoch_fn(params, opt_state, data, generator) -> (params, opt_state,
    stats)`` with ``data`` holding ``hist`` and ``eligible`` on the device
    and ``stats`` the mean of each aux value over the steps. With ``mesh``
    every rank draws the global batch and its dropout masks and steps on its
    data rank's rows."""
    rows, reduce = _data_parallel(mesh, batch_size)

    def epoch_fn(params, opt_state, data, generator):
        sums = {}
        for _ in range(num_batches):
            batch = sample_seq_window_batch(generator, data["hist"], data["eligible"],
                                            model.maxlen, model.num_items, batch_size)
            masks = adv_masks = None
            if mesh is not None:
                masks, adv_masks = (m if m is None else tree_map(lambda x: x[rows], m)
                                    for m in model.train_masks(generator, batch))
                batch = tuple(x[rows] for x in batch)
            params, opt_state, aux = seq_train_step(model, optimizer, params, opt_state,
                                                    batch, generator, masks, adv_masks, reduce)
            _add_stats(sums, aux)
        return params, opt_state, _mean_stats(sums, num_batches, mesh)

    return epoch_fn


@contextlib.contextmanager
def profiled(trace_dir: str, device: torch.device):
    """torch.profiler over the block (CPU ops, and the GPU's kernels on a
    CUDA device); its Chrome trace is written into ``trace_dir`` when the
    block ends, also when it raises."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "acf_tpu_torch.pt.trace.json"))


class Trainer:
    """Epoch-driven trainer with reference-protocol evaluation and logging.

    Pair models (MF-BPR, APR, DNS, pointwise MF) and sequence models
    (SASRec, ASASRec), bare or in the FGSM wrapper, train on the epochs this
    module builds; a model with ``make_epoch_fn`` (APL, the popularity
    adversaries) brings its own. ``config.membership_len`` truncates the histories
    the pair sampler's rejection reads, except for sequence models and
    models marked ``uses_full_hist`` (APL's positive mixture), whose
    objective reads the whole history.

    With ``config.mesh`` (see the module docstring) every model trains
    data-parallel on params stored as ``self.layout`` says (None when
    nothing is sharded), and only rank 0 writes predictions, params and npz
    snapshots; every rank calls every method, since a save, a restore, an
    evaluation and the epoch line's norms are collectives there."""

    def __init__(self, model, data: Interactions, optimizer,
                 config: TrainConfig = TrainConfig(),
                 writer: Optional[OutputWriter] = None):
        self.model = model
        self.data = data
        self.optimizer = optimizer
        self.cfg = config
        self.writer = writer or OutputWriter(None, None)
        self.mesh = config.mesh
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.device = resolve_device(config.device if self.mesh is None else self.mesh.device)
        ml = config.membership_len
        if getattr(model, "batch_kind", "pair") == "seq" or \
                getattr(model, "uses_full_hist", False):
            ml = None
        hist = data.hist if ml is None else data.hist[:, -ml:]
        self.dev = {
            "pairs_u": torch.as_tensor(data.pairs_u, device=self.device),
            "pairs_i": torch.as_tensor(data.pairs_i, device=self.device),
            "hist": torch.as_tensor(np.ascontiguousarray(hist), device=self.device),
            "eligible": torch.as_tensor(
                np.nonzero(data.hist_len >= 2)[0].astype(np.int32), device=self.device),
        }
        self._add_device_data(model)
        if hasattr(model, "make_epoch_fn"):
            self.num_batches = max(data.num_pairs // config.batch_size, 1)
        elif model.batch_kind == "seq":
            # reference: num_batch = len(trainSeq) // batch_size (SASRec.py:449)
            n_seq_users = int((data.hist_len >= 1).sum())
            self.num_batches = max(n_seq_users // config.batch_size, 1)
        else:
            self.num_batches = max(data.num_pairs // config.batch_size, 1)
        check_backend(config.ckpt_backend)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.params = model.init_params(self.generator, device=self.device)
        self.layout = None
        if self.mesh is not None:
            from acf_tpu_torch.parallel.mesh import shard_params

            stored, layout = shard_params(self.mesh, self.params, config.shard_min_rows)
            if layout.sharded:
                self.params, self.layout = stored, layout
                self.optimizer = Sharded(optimizer, layout)
        self.epoch_fn = self._make_epoch_fn(model)
        self.evaluator = self._make_evaluator(model)
        self.opt_state = self._init_opt_state(model)
        self.best = {"ndcg": -1.0, "epoch": -1, "result": None}
        self._snapshotter = None

    def _add_device_data(self, model):
        """A model's ``extra_device_data(data)`` (e.g. the popularity pools
        of :class:`acf_tpu_torch.adversarial.PopularityAdversarial`), put on
        the trainer's device beside the pairs and histories."""
        if hasattr(model, "extra_device_data"):
            self.dev.update({k: torch.as_tensor(v, device=self.device)
                             for k, v in model.extra_device_data(self.data).items()})

    def _make_epoch_fn(self, model):
        """The model's own epoch (checked first: a sequence model may bring
        one), else the sequence or the pair epoch; under a mesh each is
        built from the data-parallel copy of the model, with the mesh."""
        kw = {}
        if self.mesh is not None:
            from acf_tpu_torch.models.base import data_parallel

            model, kw = data_parallel(model, self.mesh), {"mesh": self.mesh}
        if hasattr(model, "make_epoch_fn"):
            return model.make_epoch_fn(self.optimizer, self.cfg.batch_size, self.num_batches,
                                       self.dev, **kw)
        make = make_seq_epoch_fn if model.batch_kind == "seq" else make_pair_epoch_fn
        return make(model, self.optimizer, self.cfg.batch_size, self.num_batches, **kw)

    def _init_opt_state(self, model):
        if hasattr(model, "init_opt_state"):
            return model.init_opt_state(self.optimizer, self.params)
        return self.optimizer.init(self.params)

    # ------------------------------------------------------------------
    def run_epoch(self):
        self.params, self.opt_state, stats = self.epoch_fn(
            self.params, self.opt_state, self.dev, self.generator)
        return stats

    def run_epochs(self, n: int):
        """``n`` epochs; the per-epoch stats stacked on a leading axis."""
        out = [self.run_epoch() for _ in range(n)]
        return {k: np.asarray([s[k] for s in out]) for k in out[0]}

    def profile_epoch(self, trace_dir: str):
        """One epoch and one evaluation under torch.profiler, its Chrome
        trace written into ``trace_dir`` (open it with Perfetto or
        chrome://tracing). Returns (the epoch's stats, the evaluation)."""
        with profiled(trace_dir, self.device):
            stats = self.run_epoch()
            res = self.evaluate()
        return stats, res

    @torch.no_grad()
    def evaluate(self):
        if self.cfg.eval_sampled:
            return self.evaluator.evaluate(self.model.score_some, self.whole_params(),
                                           sampled=True)
        return self.evaluator.evaluate_model(self.model, self.params, layout=self.layout)

    # -- the stored state -------------------------------------------------
    def _state_layout(self):
        """The :class:`~acf_tpu_torch.parallel.mesh.Layout` of (params,
        optimizer slots): the slots live as the optimizer, or the model
        where it makes its own (``init_opt_state``), says; None when
        nothing is sharded."""
        if self.layout is None:
            return None
        from acf_tpu_torch.parallel.mesh import Layout

        rows = self.layout.rows
        if hasattr(self.model, "init_opt_state"):
            slots = self.model.opt_state_rows(self.optimizer, rows)
        else:
            slots = self.optimizer.state_rows(rows)
        return Layout(self.mesh, (rows, slots))

    def whole_params(self):
        """The params with every sharded leaf gathered whole (a collective
        under sharded storage: every rank calls it)."""
        return self.params if self.layout is None else self.layout.gather(self.params)

    def whole_state(self):
        """(params, optimizer slots), every sharded leaf gathered whole."""
        if self.layout is None:
            return self.params, self.opt_state
        return self._state_layout().gather((self.params, self.opt_state))

    def set_state(self, params, opt_state=None):
        """Store whole ``params`` (and ``opt_state``) as the layout says:
        this rank's rows of each sharded leaf."""
        if self.layout is not None:
            layout = self.layout if opt_state is None else self._state_layout()
            tree = params if opt_state is None else (params, opt_state)
            tree = tree_map(lambda x: x.to(self.device), layout.own(tree))
            params, opt_state = (tree, None) if opt_state is None else tree
        self.params = params
        if opt_state is not None:
            self.opt_state = opt_state

    # -- snapshots ----------------------------------------------------------
    def save_params(self, path: str):
        """The params, gathered whole, in one npz that rank 0 writes (the
        JAX package's ``load_params`` reads it)."""
        params = self.whole_params()
        if self.is_main:
            save_params(path, params)

    def save_checkpoint(self, path: str, blocking: bool = True):
        """Full train state: params, optimizer slots and the generator
        state, so a crashed run resumes exactly. npz: gathered whole, rank 0
        writes. ``"dcp"``: a directory in which each rank writes its own rows
        (copied to the host at once); with ``blocking=False`` the write goes
        on in the background (:class:`AsyncSnapshotter`) while training
        continues."""
        rng = self.generator.get_state()
        if self.cfg.ckpt_backend == "dcp":
            if blocking:
                self.wait_snapshots()
                save_state_dcp(path, self.params, self.opt_state, rng, self.mesh,
                               self._state_layout())
                return
            if self._snapshotter is None:
                self._snapshotter = AsyncSnapshotter(self.mesh)
            self._snapshotter.save_state(path, self.params, self.opt_state, rng,
                                         self._state_layout())
            return
        params, opt_state = self.whole_state()
        if self.is_main:
            save_state(path, params, opt_state, rng)

    def wait_snapshots(self):
        """Wait for a snapshot still being written in the background."""
        if self._snapshotter is not None:
            self._snapshotter.wait()

    def restore_checkpoint(self, path: str):
        """The state of :meth:`save_checkpoint` from a ``"dcp"`` directory
        (written on any mesh or one device: each rank reads its own rows) or
        an npz file (the port's or the JAX package's), into this trainer's
        storage."""
        self.wait_snapshots()
        if is_dcp(path):
            self.params, self.opt_state, rng = load_state_dcp(
                path, self.params, self.opt_state, self.generator.get_state(), self.mesh,
                self._state_layout())
        else:
            like = self.whole_state() if self.layout is None else self._global_like()
            params, opt_state, rng = load_state(path, *like)
            self.set_state(params, opt_state)
        if rng is not None:
            self.generator.set_state(rng)

    def _global_like(self):
        """(params, slots) of empty tensors shaped as the whole leaves (CPU
        meta-data for a load: no collective, nothing whole on the device)."""
        def like(x, r):
            shape = tuple(x.shape) if r is None else (r,) + tuple(x.shape[1:])
            return torch.empty(shape, dtype=x.dtype, device="cpu")

        return tree_map(like, (self.params, self.opt_state), self._state_layout().rows)

    def load_pretrain(self, path: str):
        """Copy matching leaves from an npz into the current params — the
        reference's ``load_pre_train`` by-layer-name handoff (BPR.py:59-65).
        Leaves present with matching shape are loaded (a full train-state
        snapshot's ``params/`` names count too); the rest keep their init.
        A sharded leaf matches its whole shape and keeps this rank's rows.
        Returns the loaded names."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as f:
            data = dict(f)
        for k in list(data):
            if k.startswith("params/"):
                data.setdefault(k[len("params/"):], data[k])
        loaded, leaves = [], []
        rows = (tree_leaves(self.layout.rows) if self.layout is not None
                else [None] * len(tree_leaves(self.params)))
        for (name, leaf), r in zip(_flatten_with_names(self.params), rows):
            shape = tuple(leaf.shape) if r is None else (r,) + tuple(leaf.shape[1:])
            if name in data and tuple(data[name].shape) == shape:
                x = torch.as_tensor(data[name]).to(dtype=leaf.dtype)
                if r is not None:
                    x = shard_table(self.mesh, x)
                leaves.append(x.to(device=leaf.device))
                loaded.append(name)
            else:
                leaves.append(leaf)
        self.params = tree_unflatten(self.params, leaves)
        return loaded

    def fit(self, epochs: Optional[int] = None, epoch_start: int = 0,
            tag: str = "", final: bool = True) -> dict:
        cfg = self.cfg
        epochs = cfg.epochs if epochs is None else epochs
        for epoch in range(epoch_start, epochs):
            t0 = time.time()
            stats = self.run_epoch()
            train_time = time.time() - t0
            if math.isnan(stats.get("loss", math.nan)):
                self.writer.line(f"Epoch {epoch}: NaN loss, aborting")
                break
            if cfg.verbose and epoch % cfg.verbose == 0:
                t1 = time.time()
                res = self.evaluate()
                eval_time = time.time() - t1
                hr, ndcg, auc = res.at_k(cfg.topk)
                norms = self._table_norms()
                # reference epoch-line format (evaluation_adv.py:323-325)
                self.writer.line(
                    "Epoch %d [%.1fs + %.1fs]: HR = %.4f, NDCG = %.4f "
                    "ACC = %.4f ACC_adv = %.4f [%.1fs], |P|=%.2f, |Q|=%.2f"
                    % (epoch, 0.0, train_time, hr, ndcg,
                       stats.get("acc", 0.0),
                       stats.get("acc_adv", stats.get("acc", 0.0)),
                       eval_time, norms[0], norms[1]))
                if ndcg > self.best["ndcg"]:
                    self.best = {"ndcg": ndcg, "epoch": epoch, "result": res,
                                 "hr": hr, "auc": auc}
                    # full-rank runs dump the K=100 (last) column
                    # (evaluation_adv.py:292-294); sampled runs @topk
                    # (run.py:263-265)
                    col = (cfg.topk - 1) if cfg.eval_sampled else -1
                    if self.is_main:
                        self.writer.predictions(f"{tag}.hr", res.hr[:, col])
                        self.writer.predictions(f"{tag}.ndcg", res.ndcg[:, col])
                    if cfg.save_model_path:  # reference .best.h5, run.py:260-262
                        self.save_params(cfg.save_model_path + ".best")
            if cfg.save_model_path:  # reference .last.h5, run.py:271-272
                self.save_params(cfg.save_model_path + ".last")
            if cfg.ckpt_every and cfg.ckpt_path and epoch % cfg.ckpt_every == 0:
                # "dcp": the write overlaps the next epochs
                self.save_checkpoint(f"{cfg.ckpt_path}-{epoch}", blocking=False)
        self.wait_snapshots()
        # the reference writes the K=1..100 sweep only at the terminal epoch
        # (evaluation_adv.py:295-300) — not between phases
        if final and self.best["result"] is not None:
            self._write_best_sweep()
        return self.best

    def _write_best_sweep(self):
        res = self.best["result"]
        self.writer.line("Epoch %d is the best epoch" % self.best["epoch"])
        hr_k = res.hr.mean(0)
        ndcg_k = res.ndcg.mean(0)
        auc = float(res.auc.mean())
        # K=1..100 in full-rank mode, K=1..10 in sampled mode (utils.py:344)
        k_max = 10 if self.cfg.eval_sampled else hr_k.shape[0]
        for k in range(min(k_max, hr_k.shape[0])):
            self.writer.line("K = %d: HR = %.4f, NDCG = %.4f AUC = %.4f"
                             % (k + 1, hr_k[k], ndcg_k[k], auc))

    @torch.no_grad()
    def _table_norms(self):
        """(|P|, |Q|) for the epoch line (reference evaluation_adv.py:319-325),
        of the wrapped model's tables (``base``) or the generator's (``g``)
        where the params nest them; the item table alone for sequence models
        (|P| is then 0)."""
        if not isinstance(self.params, dict):
            return 0.0, 0.0
        src = self.params.get("base", self.params.get("g", self.params))
        if not isinstance(src, dict):
            return 0.0, 0.0
        p = src.get("P", src.get("user_emb"))
        q = src.get("Q", src.get("item_emb", src.get("emb")))

        def norm(x):
            if x is None:
                return 0.0
            n = torch.linalg.vector_norm(x)
            if self.layout is not None and self.layout.rows_of(self.params, x) is not None:
                # a shard: its padded rows are 0; the squares summed over "model"
                sq = torch.square(n).reshape(1)
                n = torch.sqrt(self.mesh.all_reduce(sq, "model"))[0]
            return float(n)

        return norm(p), norm(q)

    # ------------------------------------------------------------------
    def switch_model(self, model, reset_opt: bool = True):
        """Swap the model (e.g. clean → adversarial for phase 2) keeping
        params. ``reset_opt=True`` starts fresh optimizer slots (the APR-MF
        protocol, run_adv.py:114-120); ``reset_opt=False`` carries them (the
        ASASRec protocol, whose full-variable Saver restores the Adam
        moments, utils.py:306-315). Best tracking restarts either way; the
        number of batches an epoch stays the first model's."""
        old_eval_key = self._eval_key(self.model)
        self.model = model
        if reset_opt:
            self.opt_state = self._init_opt_state(model)
        self._add_device_data(model)
        self.epoch_fn = self._make_epoch_fn(model)
        # keep the evaluator when the new model needs the same eval geometry
        if self._eval_key(model) != old_eval_key:
            self.evaluator = self._make_evaluator(model)
        self.best = {"ndcg": -1.0, "epoch": -1, "result": None}

    def _eval_key(self, model):
        return (min(self.cfg.eval_batch_users,
                    getattr(model, "eval_batch_users", self.cfg.eval_batch_users)),
                getattr(model, "maxlen", None))

    def _make_evaluator(self, model):
        return FullRankEvaluator(self.data, batch_users=self._eval_key(model)[0],
                                 device=self.device, mesh=self.mesh)


def fit_two_phase(clean_model, adv_model, data: Interactions, optimizer,
                  config: TrainConfig, adv_epoch: int,
                  writer: Optional[OutputWriter] = None, tag: str = "",
                  restore: Optional[tuple] = None,
                  pretrain: Optional[str] = None,
                  reset_opt: bool = True) -> dict:
    """Train the clean model for ``adv_epoch`` epochs, then continue
    adversarially to ``config.epochs`` (reference run_adv.py:56-120).

    ``restore=(path, epoch)`` resumes from a full-state snapshot in
    whichever phase ``epoch`` falls. ``reset_opt``: whether phase 2 starts
    with fresh optimizer slots (True, the APR-MF protocol) or carries them
    (False, the ASASRec protocol with ``adam(1e-3, b2=0.98)``,
    ``acf_tpu/cli/main.py:235-243``).
    """
    trainer = Trainer(clean_model, data, optimizer, config, writer)
    if pretrain:
        trainer.load_pretrain(pretrain)
    start = 0
    if restore is not None and restore[1] < adv_epoch:
        trainer.restore_checkpoint(restore[0])
        start = restore[1]
    if restore is None or restore[1] < adv_epoch:
        trainer.fit(epochs=adv_epoch, epoch_start=start, tag=tag, final=False)
        if config.ckpt_path:
            trainer.save_params(config.ckpt_path + "-pretrain")
        trainer.switch_model(adv_model, reset_opt=reset_opt)
        start = adv_epoch
    else:
        trainer.switch_model(adv_model, reset_opt=reset_opt)
        trainer.restore_checkpoint(restore[0])
        start = restore[1]
    best = trainer.fit(epochs=config.epochs, epoch_start=start, tag=tag)
    if config.ckpt_path:
        trainer.save_params(config.ckpt_path + "-final")
    return best
