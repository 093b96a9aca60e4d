"""The port's trainer on row-sharded storage (``TrainConfig.shard_min_rows``)
on CPU ranks: where each leaf lives, against the JAX package's
``shard_params``; every model's params and optimizer slots, gathered,
against the same mesh with nothing sharded; APR and APL against the JAX
mesh trainer with sharded tables, on its draws; and the trainer's
lifecycle (evaluation, npz snapshots and params, the epoch line's norms,
the switch of models, ``load_pretrain``) on shards.

The port runs 2 or 4 gloo ranks through ``parallel/launch.py``
(``tests/torch_rank_cases.py``), one launch a mesh for every case. Runs use
``shard_min_rows=2``, so dense weights shard too (as the JAX package's mesh
tests set it), and the item tables of 37 rows and 13 rows do not divide 2
or 4: their last shard is padded with zero rows.

Tolerances: the sharded runs equal the unsharded runs of the same mesh bit
for bit (the generic form gathers each leaf exactly and updates each
shard's rows with the whole update's elementwise arithmetic; the row path
sums each id's gradient rows in a whole table's order; with at most two
data ranks each summed element is one exact a+b). Against the JAX mesh
trainer the bars of ``tests/test_torch_parallel_epochs.py`` (APR) and
``tests/test_torch_parallel_models_jax.py`` (APL), which are tighter than
``tests/test_parallel.py:261-294`` and ``:564-591``. The norms of the epoch
line (a sum of squares over "model") to rtol 1e-6.
"""

import concurrent.futures
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.models.apl import APL as JaxAPL
from acf_tpu.models.irgan import IRGAN as JaxIRGAN
from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu.models.neumf import NeuMF as JaxNeuMF
from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.parallel.mesh import make_mesh
from acf_tpu.parallel.mesh import shard_params as jax_shard_params
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu.train.checkpoint import _flatten_with_names as jax_names
from acf_tpu.train.checkpoint import load_params as jax_load_params
from acf_tpu_torch.adversarial import FGSMAdversarial
from acf_tpu_torch.adversarial.popularity import PopularityAdversarial
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.apl import APL
from acf_tpu_torch.models.caser import Caser
from acf_tpu_torch.models.drcf import DRCF
from acf_tpu_torch.models.dream import DREAM
from acf_tpu_torch.models.dsin import DSIN
from acf_tpu_torch.models.gru4rec import GRU4Rec
from acf_tpu_torch.models.irgan import IRGAN
from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
from acf_tpu_torch.models.naive import MostPopular
from acf_tpu_torch.models.neumf import NeuMF
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.ops.sparse_step import SparseMFBPR
from acf_tpu_torch.parallel import launch
from acf_tpu_torch.parallel.mesh import parse_spec, shard_params
from acf_tpu_torch.train import adagrad, adam, sgd
from acf_tpu_torch.train.checkpoint import _flatten_with_names
from tests import test_torch_apl
from tests.test_sasrec import seq_data
from tests.test_torch_apr import jax_pair_draws
from tests.test_trainer import synthetic_data

CASES = "tests.torch_rank_cases"
SPECS = ("1x2", "2x2", "1x4")
TIMEOUT = 240.0
PAIR_BATCH = 32
SEQ_BATCH = 16
SEED = 13
SHARD = 2            # shard_min_rows of the sharded runs
WHOLE = 10 ** 9      # ... and of the unsharded ones
STEPS = 4            # steps an epoch of the storage runs
APR = dict(adversarial=True, eps=0.5, reg_adv=1.0)


class StubMesh:
    """The placement reads only the "model" size and this rank's index."""

    def __init__(self, m):
        self.shape = {"data": 1, "model": m}
        self.model_index = 0

    def index(self, axis):
        return 0


def placement_models(U, I):
    """name -> (JAX model, the port's): the trees the placement test
    covers."""
    sas = dict(maxlen=8, num_blocks=1)
    return {
        "mf": (JaxMFBPR(U, I, 8), MFBPR(U, I, 8)),
        "sasrec": (JaxSASRec(U, I, 16, **sas), SASRec(U, I, 16, **sas)),
        "apl": (JaxAPL(U, I, 8), APL(U, I, 8)),
        "neumf": (JaxNeuMF(U, I, 8), NeuMF(U, I, 8)),
        "irgan": (JaxIRGAN(U, I, 8), IRGAN(U, I, 8)),
    }


@pytest.mark.parametrize("min_rows", [2, 1024])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", ["mf", "sasrec", "apl", "neumf", "irgan"])
def test_placement_matches_jax_shard_params(name, m, min_rows):
    """The leaves stored as row shards are the ones JAX's ``shard_params``
    shards (by rows or, where the rows do not divide, by columns), on trees
    wide enough that both rules and the row threshold show; each shard has
    ceil(R / m) rows."""
    jax_params, params = placement_params(name)
    mesh = make_mesh(1, m, devices=jax.devices()[:m])
    placed = jax_shard_params(mesh, jax_params, min_rows=min_rows)
    jax_sharded = {n for n, x in _leaves_with_names(placed)
                   if any(a is not None for a in x.sharding.spec)}
    stored, layout = shard_params(StubMesh(m), params, min_rows)
    rows = dict(zip([n for n, _ in _flatten_with_names(params)],
                    [r for _, r in _flatten_with_names(layout.rows)]))
    assert {n for n, r in rows.items() if r is not None} == jax_sharded, (name, m, min_rows)
    for (n, x), (_, s) in zip(_flatten_with_names(params), _flatten_with_names(stored)):
        want = tuple(x.shape) if rows[n] is None else (-(-x.shape[0] // m),) + tuple(x.shape[1:])
        assert tuple(s.shape) == want, (name, n)


@functools.lru_cache(maxsize=None)
def placement_params(name):
    """(JAX's params, the port's) of the placement test's model ``name``:
    1200 users and 1203 items, rows that divide 2 and 4 and rows that
    divide neither."""
    jm, pm = placement_models(1200, 1203)[name]
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))  # the placement reads shapes
    return (jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes),
            pm.init_params(torch.Generator().manual_seed(0), device="cpu"))


def _leaves_with_names(tree):
    from acf_tpu.train.checkpoint import path_name

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(path_name(p), x) for p, x in flat]


def runs(pair, seq):
    """name -> (models, optimizer, data, batch, epochs of each, reset_opt):
    every family of ``tests/test_torch_parallel_models.py`` and the pair
    and sequence runs of ``tests/test_torch_parallel_train.py``."""
    U, I = pair.num_users, pair.num_items
    sU, sI = seq.num_users, seq.num_items
    pop = dict(weight=0.1, pop_percent=0.2)
    sas = dict(maxlen=8, num_blocks=1)
    p, s = (pair, PAIR_BATCH), (seq, SEQ_BATCH)

    def caser():
        return Caser(sU, sI, 16, maxlen=5)

    def popularity(base):
        return PopularityAdversarial(U, I, 8, base=base, **pop)

    ada = adagrad(0.05, initial_accumulator_value=0.1)
    return {
        "apr": ([MFBPR(U, I, 8, reg=0.01), MFBPR(U, I, 8, reg=0.01, **APR)], ada, *p, [1, 1],
                True),
        "dns": ([MFBPR(U, I, 8, dns=3)], ada, *p, [1], True),
        "pointwise": ([PointwiseMF(U, I, 8)], adam(1e-3), *p, [1], True),
        "apr_random": ([MFBPR(U, I, 8, adv_mode="random", **APR)], ada, *p, [1], True),
        "sparse": ([SparseMFBPR(U, I, 8, reg=0.01, **APR)], adagrad(0.05), *p, [2], True),
        "asasrec": ([SASRec(sU, sI, 16, **sas), SASRec(sU, sI, 16, adversarial=True, **sas)],
                    adam(1e-3, b2=0.98), *s, [1, 1], False),
        "apl": ([APL(U, I, 8, reg_g=0.1)], sgd(0.05), *p, [1], True),
        "apl_wgan": ([APL(U, I, 8, loss_function="wgan", reg_g=0.1)], sgd(0.05), *p, [1], True),
        "irgan": ([IRGAN(U, I, 8, d_lr=0.05, g_lr=0.05, lamda_d=0.5, lamda_g=0.1)], sgd(0.05),
                  *p, [1], True),
        "amf": ([popularity(PointwiseMF(U, I, 8))], adam(0.01), *p, [1], True),
        "abpr": ([popularity(MFBPR(U, I, 8))], adam(0.01), *p, [1], True),
        "aneumf": ([popularity(NeuMF(U, I, 8))], adam(0.01), *p, [1], True),
        "neumf": ([NeuMF(U, I, 8)], adam(0.01), *p, [1], True),
        "caser": ([caser()], adam(0.01), *s, [1], True),
        "gru4rec": ([GRU4Rec(sU, sI, 16, maxlen=8)], adam(0.01), *s, [1], True),
        "dream": ([DREAM(sU, sI, 16, maxlen=8)], adam(0.01), *s, [1], True),
        "drcf": ([DRCF(sU, sI, 16, maxlen=5)], adam(0.01), *s, [1], True),
        "dsin": ([DSIN(sU, sI, 16, sess_count=2, sess_len=4, l2_emb=1e-3)], adam(0.01), *s,
                 [1], True),
        "naive": ([MostPopular(U, I, 8, data=pair)], adam(0.01), *p, [1], True),
        "fgsm_mf": ([MFBPR(U, I, 8), FGSMAdversarial(U, I, 8, base=MFBPR(U, I, 8))], ada, *p,
                    [1, 1], True),
        "fgsm_caser": ([caser(), FGSMAdversarial(sU, sI, 16, base=caser())], adam(0.01), *s,
                       [1, 1], True),
    }


def datasets():
    return (Interactions(**dataclasses.asdict(synthetic_data(seed=41))),
            Interactions(**dataclasses.asdict(seq_data(seed=5))))


NAMES = tuple(runs(*datasets()))


def calls(x):
    """Each run twice: sharded, then with nothing sharded (evaluated both
    times)."""
    out = []
    for models, opt, data, batch, epochs, reset in x.values():
        for rows in (SHARD, WHOLE):
            out.append(("train", (models, opt, data, epochs, STEPS, SEED, batch, reset, None,
                                  None, True, rows)))
    return out


def jax_cases():
    """({run: [(JAX state by snapshot name, stats)] after each epoch}, the
    port's calls on the same draws): the JAX trainers at 2x2 with
    ``shard_min_rows=2``."""
    data = synthetic_data(seed=41)
    pdata = Interactions(**dataclasses.asdict(data))
    dp, m = parse_spec(JAX_SPEC)
    mesh = make_mesh(dp, m, devices=jax.devices()[:dp * m])
    want, cases = {}, []
    for name, (jms, pms, jopt, popt, epochs, draw) in jax_runs(data.num_users,
                                                                data.num_items).items():
        jt = JaxTrainer(jms[0], data, jopt, JaxConfig(batch_size=PAIR_BATCH, verbose=10 ** 9,
                                                      mesh=mesh, shard_min_rows=SHARD))
        init = jax.tree.map(np.asarray, jax.device_get(jt.params))
        draws, after = [], []
        for i, (jm, n) in enumerate(zip(jms, epochs)):
            if i:
                jt.switch_model(jm, reset_opt=True)
            for _ in range(n):
                draws.append(draw(jt))
                stats = jt.run_epoch()
                state = jax_names({"params": jax.device_get(jt.params),
                                   "opt": jax.device_get(jt.opt_state)})
                after.append(({k: np.asarray(v) for k, v in state.items()},
                              {k: float(v) for k, v in stats.items()}))
        want[name] = after
        cases.append(("train", (pms, popt, pdata, epochs, None, SEED, PAIR_BATCH, True, init,
                                draws, False, SHARD)))
    return want, cases


def lifecycle_cases(roots):
    """APR's two phases at 1x2 with every save on, sharded and unsharded,
    writing under ``roots``."""
    data = Interactions(**dataclasses.asdict(synthetic_data(seed=41)))
    U, I = data.num_users, data.num_items
    models = [MFBPR(U, I, 8, reg=0.01), MFBPR(U, I, 8, reg=0.01, **APR)]
    opt = adagrad(0.05, initial_accumulator_value=0.1)
    return [("lifecycle", (models, opt, data, root, rows))
            for root, rows in zip(roots, (SHARD, WHOLE))]


# the command line's staged-epsilon run (clean, eps, eps_stage2) with
# snapshots, on the bundled data (401 users, 865 items)
CLI_ARGV = ["--data", "test", "--path", "data/", "--model", "apr", "--epochs", "3",
            "--adv_epoch", "1", "--stage2_epoch", "2", "--eps", "0.5", "--eps_stage2", "0.8",
            "--d", "8", "--bs", "64", "--ckpt", "1"]


def cli_cases(roots):
    """The command line's staged-epsilon run at 1x2, sharded and unsharded,
    its snapshots and outputs under ``roots``."""
    return [("cli_run", (CLI_ARGV + ["--ckpt_dir", root, "--opath", root + "/out/"], rows))
            for root, rows in zip(roots, (SHARD, WHOLE))]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every rank case of this file in two launches: 2 ranks (1x2: the
    storage runs, the lifecycle and the command line) and 4 ranks (2x2: the storage runs and
    the runs on JAX's draws; 1x4: the storage runs). Returns {"storage":
    {spec: each rank's results by run name: (sharded, unsharded)},
    "jax": (JAX's runs, each rank's results by run name), "lifecycle" and
    "cli": (the roots of the files, each rank's (sharded, unsharded))}."""
    x = runs(*datasets())
    storage = calls(x)
    roots = [str(tmp_path_factory.mktemp(k)) for k in ("sharded", "whole")]
    cli_roots = [str(tmp_path_factory.mktemp(k)) for k in ("cli_sharded", "cli_whole")]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the 2 ranks beside the JAX runs
        two = pool.submit(launch.run, f"{CASES}:meshes", 2, None, "cpu",
                          [("1x2", storage + lifecycle_cases(roots) + cli_cases(cli_roots))], device="cpu",
                          timeout=TIMEOUT)
        want, on_draws = jax_cases()
        four = launch.run(f"{CASES}:meshes", 4, None, "cpu",
                          [("2x2", storage + on_draws), ("1x4", storage)], device="cpu",
                          timeout=TIMEOUT)
        two = two.result()
    n = len(storage)

    def by_run(results):
        return {name: (results[2 * i], results[2 * i + 1]) for i, name in enumerate(x)}

    return {"storage": {"1x2": [by_run(r[0][:n]) for r in two],
                        "2x2": [by_run(r[0][:n]) for r in four],
                        "1x4": [by_run(r[1]) for r in four]},
            "jax": (want, [dict(zip(want, r[0][n:])) for r in four]),
            "lifecycle": (roots, [r[0][n:n + 2] for r in two]),
            "cli": (cli_roots, [r[0][n + 2:] for r in two])}


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_storage_equals_the_unsharded_mesh_run(launched, spec, name):
    res = launched["storage"][spec]
    _, m = parse_spec(spec)
    for r, x in enumerate(res):
        sharded, whole = x[name]
        assert "storage" not in whole
        if name != "naive":  # the baselines have no 2-D leaf with a gradient
            assert "storage" in sharded, (spec, name)
        store = sharded.get("storage", {"leaves": {}, "pad_zero": True})
        assert store["pad_zero"], (spec, name, r)
        for n, (shape, rows) in store["leaves"].items():
            if rows is not None:
                assert shape[0] == -(-rows // m), (spec, name, n, shape, rows)
        assert set(sharded["state"]) == set(whole["state"]), (spec, name)
        for k, w in whole["state"].items():
            np.testing.assert_array_equal(sharded["state"][k], w,
                                          err_msg=f"{spec} rank {r} {name} {k}")
        assert sharded["stats"] == whole["stats"], (spec, name)
        assert sharded["at10"] == whole["at10"], (spec, name)
    for x in res[1:]:  # every rank holds the same state
        for k, w in res[0][name][0]["state"].items():
            np.testing.assert_array_equal(x[name][0]["state"][k], w)


# -- against the JAX mesh trainer, on its draws --------------------------------

JAX_SPEC = "2x2"


def jax_runs(U, I):
    """name -> (JAX models, port models, JAX optimizer, port optimizer,
    epochs of each, the JAX trainer's draws of its next epoch)."""
    ada = (optax.adagrad(0.05, initial_accumulator_value=0.1),
           adagrad(0.05, initial_accumulator_value=0.1))
    return {
        "apr": ([JaxMFBPR(U, I, 8, reg=0.01), JaxMFBPR(U, I, 8, reg=0.01, **APR)],
                [MFBPR(U, I, 8, reg=0.01), MFBPR(U, I, 8, reg=0.01, **APR)], *ada, [1, 1],
                lambda jt: [x.numpy() for x in jax_pair_draws(jt, 1)]),
        "apl": ([JaxAPL(U, I, 8, reg_g=0.1)], [APL(U, I, 8, reg_g=0.1)], optax.sgd(0.05),
                sgd(0.05), [2], lambda jt: jax.tree.map(
                    lambda x: x.numpy(), test_torch_apl.jax_epoch_draws(jt))),
    }


# (rtol, atol of the params, atol as a share of the table's scale): APR's
# is tests/test_torch_parallel_epochs.py's after one clean and one APR epoch
# (its slots to rtol 1e-5, atol 1e-8), APL's tests/test_torch_parallel_models_jax.py's
JAX_TOL = {"apr": (1e-5, 1e-5, True), "apl": (2e-4, 2e-6, False)}


@pytest.mark.parametrize("name", tuple(JAX_TOL))
def test_sharded_trainer_matches_the_jax_mesh_trainer(launched, name):
    want, res = launched["jax"]
    rtol, atol, of_scale = JAX_TOL[name]
    state = want[name][-1][0]
    for r, x in enumerate(res):
        got = x[name]
        assert "storage" in got
        assert set(got["state"]) == set(state), name
        for k, w in state.items():
            if k.startswith("params/"):
                tol = atol * np.abs(w).max() if of_scale else atol
            else:
                tol = 1e-8 if name == "apr" else atol
            np.testing.assert_allclose(got["state"][k], w, rtol=rtol, atol=tol,
                                       err_msg=f"{JAX_SPEC} rank {r} {name} {k}")
        for s, (_, w) in zip(got["stats"], want[name]):
            for k in w:
                if k.startswith("acc"):
                    assert abs(s[k] - w[k]) <= 1.0 / PAIR_BATCH + 1e-6, (name, k)
                else:
                    np.testing.assert_allclose(s[k], w[k], rtol=1e-4, err_msg=f"{name} {k}")


# -- the lifecycle on shards ------------------------------------------------------

def test_lifecycle_on_shards(launched):
    roots, got = launched["lifecycle"]
    for r, (sharded, whole) in enumerate(got):
        for k, w in whole["state"].items():
            np.testing.assert_array_equal(sharded["state"][k], w, err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(sharded["norms"], whole["norms"], rtol=1e-6)
        assert sharded["ndcg"] == whole["ndcg"]
        assert whole["after_switch"] is None
        for key in ("after_switch", "after_fit", "pretrained"):
            leaves = sharded[key]["leaves"]
            assert leaves["params/P"] == ((30, 8), 60) and leaves["params/Q"] == ((19, 8), 37)
            assert leaves["opt/0/.sum_of_squares/Q"] == ((19, 8), 37), key
        assert sharded["loaded"] == ["P", "Q"] == whole["loaded"]
        for k in ("P", "Q"):
            np.testing.assert_array_equal(sharded["pretrained_params"][k],
                                          whole["pretrained_params"][k])
    # rank 0 wrote the same files either way, and JAX's load_params reads them
    names = sorted(os.listdir(roots[1]))
    assert names == sorted(os.listdir(roots[0]))
    assert {"ck-0.npz", "ck-1.npz", "ck-pretrain.npz", "ck-final.npz", "model.best.npz",
            "model.last.npz"} <= set(names)
    final = got[0][0]["state"]
    like = {"P": jnp.zeros(final["params/P"].shape), "Q": jnp.zeros(final["params/Q"].shape)}
    for f in ("ck-final", "model.last"):
        loaded = jax_load_params(os.path.join(roots[0], f), like)
        for k in ("P", "Q"):
            np.testing.assert_array_equal(np.asarray(loaded[k]), final[f"params/{k}"])
    full = {"params": like,
            "opt": optax.adagrad(0.05, initial_accumulator_value=0.1).init(like)}
    snap = jax_load_params(os.path.join(roots[0], "ck-1"), full)
    for k in ("P", "Q"):
        np.testing.assert_array_equal(np.asarray(snap["params"][k]), final[f"params/{k}"])
    for f in names:
        with np.load(os.path.join(roots[0], f)) as a, np.load(os.path.join(roots[1], f)) as b:
            assert set(a.files) == set(b.files), f
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f} {k}")


def test_cli_staged_eps_saves_whole_tables_on_shards(launched):
    """``--eps_stage2`` at ``--mesh 1x2`` with ``--ckpt``: every rank joins
    the ``-pretrain``/``-final`` saves, rank 0 writes the whole tables, and
    the files (and every snapshot) equal the unsharded run's and load whole
    in JAX's ``load_params``."""
    roots, got = launched["cli"]
    for r, (sharded, whole) in enumerate(got):
        assert sharded["sharded"] == [True] and whole["sharded"] == [False], r
        assert sharded["ndcg"] == whole["ndcg"], r
    ck = [os.path.join(root, "test") for root in roots]
    names = sorted(os.listdir(ck[1]))
    assert names == sorted(os.listdir(ck[0]))
    assert {"apr-pretrain.npz", "apr-final.npz", "apr-0.npz", "apr-2.npz"} <= set(names)
    for f in names:
        with np.load(os.path.join(ck[0], f)) as a, np.load(os.path.join(ck[1], f)) as b:
            assert set(a.files) == set(b.files), f
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f} {k}")
    like = {"P": jnp.zeros((401, 8)), "Q": jnp.zeros((865, 8))}
    for f in ("apr-pretrain", "apr-final"):
        loaded = jax_load_params(os.path.join(ck[0], f), like)
        with np.load(os.path.join(ck[1], f + ".npz")) as b:
            for k in ("P", "Q"):
                assert loaded[k].shape == like[k].shape, (f, k)
                np.testing.assert_array_equal(np.asarray(loaded[k]), b[k], err_msg=f"{f} {k}")
