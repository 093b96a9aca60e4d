"""The port's distributed training on CPU ranks: the sharded steps against
the JAX package's, the data-parallel trainer and the sparse step's mesh
epoch against the port on one device, and ``--mesh`` on the command line.

The port runs 2 or 4 gloo ranks through ``parallel/launch.py``
(``tests/torch_rank_cases.py``), one launch a mesh for every case; the JAX
steps run on conftest's virtual CPU devices on a mesh of the same shape (the
data-parallel epochs against JAX's mesh trainer are in
``tests/test_torch_parallel_epochs.py``). Tolerances:

* ``make_sharded_bpr_step`` at eps 0 and 0.5: rtol 1e-4, atol 1e-7, and
  ``make_sharded_sasrec_step`` bare and adversarial: rtol 2e-4, atol 1e-7,
  against JAX's (``tests/test_parallel.py`` holds the JAX steps to
  single-device math at these);
* the data-parallel trainer (APR two-phase with its closed form, DNS,
  pointwise MF, ASASRec two-phase and ASASRec2) against the single-device
  trainer from the same seed, the same draws: rtol 2e-4, atol 1e-6, what
  ``tests/test_parallel.py:261-294`` holds the JAX mesh trainer to (only the
  order of the sums over the data ranks differs); the epoch losses to rtol
  1e-5, accuracies within one pair of the batch; every rank's params equal
  bit for bit;
* the sparse step's mesh epoch (APR, three epochs) against the
  single-device sparse epoch: rtol 1e-6, atol 1e-8, JAX's bar
  (``tests/test_parallel.py:594-628``); the lookups are exact and each
  shard's Adagrad is the same arithmetic, so it is expected bit for bit.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.parallel.mesh import make_mesh
from acf_tpu.parallel.sharded_embedding import make_sharded_bpr_step as jax_bpr_step
from acf_tpu.parallel.sharded_embedding import make_sharded_sasrec_step as jax_sasrec_step
from acf_tpu.parallel.sharded_embedding import shard_table as jax_shard_table
from acf_tpu_torch.cli import main as cli
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.ops.sparse_step import SparseMFBPR
from acf_tpu_torch.parallel import launch
from acf_tpu_torch.parallel.mesh import parse_spec
from acf_tpu_torch.train import TrainConfig, Trainer, adagrad, adam
from tests import torch_rank_cases as rank_cases
from tests.test_sasrec import seq_data
from tests.test_trainer import synthetic_data

CASES = "tests.torch_rank_cases"
SPECS = ("1x2", "2x1", "2x2")
TIMEOUT = 120.0
PAIR_BATCH = 32
SEQ_BATCH = 16


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_mesh(spec):
    dp, m = parse_spec(spec)
    return make_mesh(dp, m, devices=jax.devices()[:dp * m])


def runs(pair, seq):
    """name -> (models, optimizer, data, epochs, reset_opt): the trainer
    runs held against one device."""
    U, I = pair.num_users, pair.num_items
    apr = dict(adversarial=True, eps=0.5, reg_adv=1.0)
    sU, sI = seq.num_users, seq.num_items
    sas = dict(maxlen=8, num_blocks=1)
    return {
        "apr": ([MFBPR(U, I, 8, reg=0.01), MFBPR(U, I, 8, reg=0.01, **apr)],
                adagrad(0.05, initial_accumulator_value=0.1), pair, [1, 1], True),
        "dns": ([MFBPR(U, I, 8, dns=3)], adagrad(0.05, initial_accumulator_value=0.1), pair,
                [1], True),
        "pointwise": ([PointwiseMF(U, I, 8)], adam(1e-3), pair, [1], True),
        "asasrec": ([SASRec(sU, sI, 16, **sas), SASRec(sU, sI, 16, adversarial=True, **sas)],
                    adam(1e-3, b2=0.98), seq, [1, 1], False),
        "asasrec2": ([SASRec(sU, sI, 16, adversarial=True, adv_mode="asasrec2", eps_dense=0.1,
                             l2_emb=1e-3, **sas)], adam(1e-3, b2=0.98), seq, [1], False),
        "sparse": ([SparseMFBPR(U, I, 8, **apr)], adagrad(0.05), pair, [3], True),
    }


RUN_NAMES = ("apr", "dns", "pointwise", "asasrec", "asasrec2", "sparse")
# (rtol, atol) against one device: the JAX package's own bars for its mesh
# trainer, pair (tests/test_parallel.py:290) and sequence (:327), and for the
# sparse step (:620). The sequence bar is wider because of the attention's key
# bias: a constant added to every key's score, its gradient is zero but for
# rounding, and Adam scales that noise up to steps of ~lr (the 2x1 run moves
# blocks/0/wk/b by 7.6e-5 of lr 1e-3 in four steps; every other leaf stays
# within 1e-6)
TOL = {"apr": (2e-4, 1e-6), "dns": (2e-4, 1e-6), "pointwise": (2e-4, 1e-6),
       "asasrec": (1e-3, 5e-4), "asasrec2": (1e-3, 5e-4), "sparse": (1e-6, 1e-8)}


def run_call(name, run):
    models, opt, data, epochs, reset_opt = run
    batch = SEQ_BATCH if models[0].batch_kind == "seq" else PAIR_BATCH
    return ("train", (models, opt, data, epochs, None, 7, batch, reset_opt))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(22)
    U, B = 32, 16
    x = {"bpr": [rng.standard_normal(s).astype(np.float32) * 0.01 for s in ((U, 8), (64, 8))],
         "bpr_batch": [rng.integers(1, n, B).astype(np.int32) for n in (U, 64, 64)],
         "seq": {}}
    for adversarial in (False, True):
        jm = JaxSASRec(U, 64, 8, maxlen=6, num_blocks=1, adversarial=adversarial, eps=0.5,
                       reg_adv=1.0, train_dtype="float32")
        pm = SASRec(U, 64, 8, maxlen=6, num_blocks=1, adversarial=adversarial, eps=0.5,
                    reg_adv=1.0)
        x["seq"][adversarial] = (jm, pm, np_tree(jm.init_params(jax.random.PRNGKey(3))))
    x["seq_batch"] = [rng.integers(1, 64, (B, 6)).astype(np.int32) for _ in range(3)]
    pair = Interactions(**dataclasses.asdict(synthetic_data(seed=41)))
    seq = Interactions(**dataclasses.asdict(seq_data(seed=5)))
    x["runs"] = runs(pair, seq)
    x["one"] = {n: getattr(rank_cases, name)(None, "cpu", *args)
                for n in RUN_NAMES for name, args in [run_call(n, x["runs"][n])]}
    return x


def calls(x):
    out = [("bpr_step", (*x["bpr"], *x["bpr_batch"], eps)) for eps in (0.0, 0.5)]
    for adversarial in (False, True):
        _, pm, prm = x["seq"][adversarial]
        out.append(("sasrec_step", (pm, prm, *x["seq_batch"])))
    return out + [run_call(n, x["runs"][n]) for n in RUN_NAMES]


NAMES = ("bpr_0", "bpr_05", "sasrec_bare", "sasrec_adv") + RUN_NAMES


@pytest.fixture(scope="module", params=SPECS)
def ranks(request, inputs):
    """(spec, each rank's results by case name): one launch a mesh."""
    spec = request.param
    dp, m = parse_spec(spec)
    got = launch.run(f"{CASES}:several", dp * m, spec, "cpu", calls(inputs), device="cpu",
                     timeout=TIMEOUT)
    return spec, [dict(zip(NAMES, r)) for r in got]


@pytest.mark.parametrize("eps", [0.0, 0.5])
def test_sharded_bpr_step_matches_jax(ranks, inputs, eps):
    spec, res = ranks
    P, Q = inputs["bpr"]
    with jax_mesh(spec) as mesh:
        step = jax_bpr_step(mesh, eps=eps, lr=0.05)
        wP, wQ = step(jax_shard_table(mesh, jnp.asarray(P)), jax_shard_table(mesh, jnp.asarray(Q)),
                      *(jnp.asarray(b) for b in inputs["bpr_batch"]))
    for x in res:
        got = x["bpr_0" if eps == 0.0 else "bpr_05"]
        np.testing.assert_allclose(got["P"], np.asarray(wP)[:P.shape[0]], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(got["Q"], np.asarray(wQ)[:Q.shape[0]], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("adversarial", [False, True])
def test_sharded_sasrec_step_matches_jax(ranks, inputs, adversarial):
    spec, res = ranks
    jm, _, prm = inputs["seq"][adversarial]
    rest = {k: jax.tree.map(jnp.asarray, v) for k, v in prm.items() if k != "item_emb"}
    with jax_mesh(spec) as mesh:
        step = jax_sasrec_step(mesh, jm, lr=1e-3)
        w_item, w_rest = step(jax_shard_table(mesh, jnp.asarray(prm["item_emb"])), rest,
                              *(jnp.asarray(b) for b in inputs["seq_batch"]))
    want = np_tree(w_rest)
    want["item_emb"] = np.asarray(w_item)[:jm.num_items]
    for x in res:
        got = x["sasrec_adv" if adversarial else "sasrec_bare"]["params"]
        assert set(got) == set(want)
        for k in want:
            for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
                np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-7, err_msg=k)


def leaves(out):
    return [out["state"][k] for k in sorted(out["state"])]


@pytest.mark.parametrize("name", RUN_NAMES)
def test_mesh_training_tracks_one_device(ranks, inputs, name):
    _, res = ranks
    want = inputs["one"][name]
    rtol, atol = TOL[name]
    for x in res:
        got = x[name]
        for k in want["state"]:
            np.testing.assert_allclose(got["state"][k], want["state"][k], rtol=rtol, atol=atol,
                                       err_msg=k)
        batch = SEQ_BATCH if name.startswith("asasrec") else PAIR_BATCH
        for s, w in zip(got["stats"], want["stats"]):
            assert set(s) == set(w)
            for k in w:
                tol = 1.0 / batch + 1e-6 if k.startswith("acc") else 1e-5 * abs(w[k]) + 1e-7
                assert abs(s[k] - w[k]) <= tol, (name, k, s[k], w[k])
    for x in res[1:]:  # every rank applied the same updates
        for a, b in zip(leaves(x[name]), leaves(res[0][name])):
            np.testing.assert_array_equal(a, b)


ARGS = ["--data", "test", "--path", "data/", "--epochs", "2", "--adv_epoch", "1", "--d", "8",
        "--bs", "64", "--device", "cpu"]


@pytest.mark.parametrize("model", [["apr"], ["apr", "--sparse"], ["apl"], ["irgan"], ["amf"],
                                   ["caser", "--maxlen", "5"], ["bpr", "--fgsm"]],
                         ids=lambda m: " ".join(m))
def test_cli_mesh_1x1_equals_one_device(tmp_path, monkeypatch, model):
    """``--mesh 1x1`` without torchrun: a gloo group of one process, the
    sharded evaluation and the data-parallel epoch. With one data rank every
    share and sum is the single-device one, so the .out file is the
    single-device run's line for line, but for the timings and the mesh
    line; the group is gone afterwards."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    outs = []
    for extra in ([], ["--mesh", "1x1"]):
        opath = tmp_path / ("mesh" if extra else "one")
        cli.main(ARGS + ["--model", *model, "--opath", str(opath) + "/", *extra])
        assert not dist.is_initialized()
        (out,) = [f for f in os.listdir(opath) if f.endswith(".out")]
        lines = (opath / out).read_text().splitlines()
        if extra:
            assert lines[1] == "Mesh: data=1 model=1 over 1 rank(s), gloo on cpu"
            del lines[1]
        outs.append([re.sub(r"\[[^\]]*\]", "[]", ln) for ln in lines])
    assert len(outs[0]) > 100 and outs[0] == outs[1]
