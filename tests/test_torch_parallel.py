"""The port's distribution (``acf_tpu_torch/parallel/``) on CPU ranks against
the JAX package's ``acf_tpu/parallel/`` on meshes of the same shape.

The port runs 2 or 4 gloo ranks through ``parallel/launch.py``
(``tests/torch_rank_cases.py``); the JAX side runs on conftest's virtual CPU
devices with ``make_mesh(num_data, num_model, devices=jax.devices()[:n])``.
Inputs are made with numpy from a seed and JAX's params are carried across
as numpy. One launch a mesh runs every case (a launch costs ~4 s), and its results are held
case by case:

* ``sharded_lookup`` forward and gradient, and the ragged ``shard_table``:
  exact (the gradient's cotangents are whole numbers, so any order of the
  sum over data ranks is exact);
* sharded positions, with and without an item bias (MF-BPR, Caser) at an I
  that the model axis does not divide, and ``FullRankEvaluator(mesh=)``:
  equal to JAX's ``sharded_positions_for_model`` and to the port's
  single-device evaluator;
* sharded top-K (MF-BPR, Caser, SASRec, a k wider than a shard, bulk): ids
  equal to JAX's, scores to rtol 1e-6 (JAX's own bar); the error when the
  shards cannot hold k;
* the input pipeline's index math and ``mesh_from_spec``'s validation
  against JAX's, and its raise where JAX falls back to virtual devices.

The sharded steps and the data-parallel trainers are in
``tests/test_torch_parallel_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from acf_tpu.eval.full_rank import FullRankEvaluator as JaxEvaluator
from acf_tpu.models.caser import Caser as JaxCaser
from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.parallel import input_pipeline as jax_ip
from acf_tpu.parallel.mesh import make_mesh
from acf_tpu.parallel.mesh import mesh_from_spec as jax_mesh_from_spec
from acf_tpu.parallel.sharded_embedding import shard_table as jax_shard_table
from acf_tpu.parallel.sharded_eval import sharded_positions_for_model as jax_positions
from acf_tpu.parallel.sharded_serve import sharded_recommend_bulk as jax_rec_bulk
from acf_tpu.parallel.sharded_serve import sharded_recommend_for_model as jax_rec
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.eval.full_rank import FullRankEvaluator
from acf_tpu_torch.models.caser import Caser
from acf_tpu_torch.models.mf import MFBPR
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.ops.topk import recommend
from acf_tpu_torch.parallel import input_pipeline as ip
from acf_tpu_torch.parallel import launch
from acf_tpu_torch.parallel.mesh import mesh_from_spec, parse_spec
from tests.test_full_rank import make_data

CASES = "tests.torch_rank_cases"
SPECS = ("1x2", "2x1", "2x2")
TIMEOUT = 90.0


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_mesh(spec):
    dp, m = parse_spec(spec)
    return make_mesh(dp, m, devices=jax.devices()[:dp * m])


@pytest.fixture(scope="module")
def inputs():
    """Every case's numpy inputs, models and params (from seeds)."""
    rng = np.random.default_rng(21)
    U, B = 32, 16
    x = {}
    x["table"] = rng.standard_normal((31, 4)).astype(np.float32)  # 31 rows: ragged over 2
    x["ids"] = rng.integers(0, 31, (2, 12)).astype(np.int64)
    x["ct"] = rng.integers(-3, 4, (2, 12, 4)).astype(np.float32)
    x["users"] = rng.integers(1, U, B).astype(np.int32)

    mf = JaxMFBPR(U, 63, 8)
    x["mf"] = (mf, MFBPR(U, 63, 8), np_tree(mf.init_params(jax.random.PRNGKey(0))))
    caser = JaxCaser(U, 50, 8, maxlen=5)
    x["caser"] = (caser, Caser(U, 50, 8, maxlen=5),
                  np_tree(caser.init_params(jax.random.PRNGKey(1))))
    sas = JaxSASRec(U, 63, 8, maxlen=6, num_blocks=1)
    x["sasrec"] = (sas, SASRec(U, 63, 8, maxlen=6, num_blocks=1),
                   np_tree(sas.init_params(jax.random.PRNGKey(2))))
    narrow = JaxMFBPR(U, 14, 8)  # 7 rows a shard over 2, k = 10
    x["narrow"] = (narrow, MFBPR(U, 14, 8),
                   np_tree(narrow.init_params(jax.random.PRNGKey(3))))
    # right-aligned histories: the last slot holds an item (a SASRec window
    # ending in padding scores every item 0, a tie that torch.topk orders
    # arbitrarily on one device too)
    x["hists"] = {n: np.concatenate([rng.integers(0, x[n][0].num_items, (B, 5)),
                                     rng.integers(1, x[n][0].num_items, (B, 1))],
                                    axis=1).astype(np.int32)
                  for n in ("mf", "caser", "sasrec")}
    x["hists"]["narrow"] = rng.integers(0, 14, (B, 3)).astype(np.int32)
    x["gt"] = {n: rng.integers(1, x[n][0].num_items, B).astype(np.int32)
               for n in ("mf", "caser")}
    x["k"] = {"mf": 5, "caser": 4, "sasrec": 5, "narrow": 10}

    jdata = make_data(num_users=40, num_items=33, seed=3)
    x["jdata"], x["data"] = jdata, Interactions(**dataclasses.asdict(jdata))
    ev = JaxMFBPR(jdata.num_users, jdata.num_items, 8)
    x["ev"] = (ev, MFBPR(jdata.num_users, jdata.num_items, 8),
               np_tree(ev.init_params(jax.random.PRNGKey(4))))
    x["bulk_users"] = rng.integers(1, jdata.num_users, 21).astype(np.int32)

    return x


def calls(x):
    out = [("lookup", (x["table"], x["ids"], x["ct"]))]
    for n in ("mf", "caser"):
        out.append(("positions", (x[n][1], x[n][2], x["users"], x["hists"][n], x["gt"][n])))
    out.append(("evaluator", (x["ev"][1], x["ev"][2], x["data"], 6)))
    for n in ("mf", "caser", "sasrec", "narrow"):
        out.append(("recommend", (x[n][1], x[n][2], x["users"], x["hists"][n], x["k"][n])))
    out.append(("recommend_bulk", (x["ev"][1], x["ev"][2], x["data"], x["bulk_users"], 10, 8)))
    out.append(("serve_error", (4, 10)))
    return out


NAMES = ["lookup", "positions_mf", "positions_caser", "evaluator", "rec_mf", "rec_caser",
         "rec_sasrec", "rec_narrow", "rec_bulk", "serve_error"]


@pytest.fixture(scope="module", params=SPECS)
def ranks(request, inputs):
    """(spec, each rank's results by case name): one launch a mesh."""
    spec = request.param
    dp, m = parse_spec(spec)
    got = launch.run(f"{CASES}:several", dp * m, spec, "cpu", calls(inputs), device="cpu",
                     timeout=TIMEOUT)
    return spec, [dict(zip(NAMES, r)) for r in got]


def test_lookup_and_ragged_shard_table_exact(ranks, inputs):
    spec, res = ranks
    dp, m = parse_spec(spec)
    table, ids, ct = inputs["table"], inputs["ids"][:dp], inputs["ct"][:dp]
    il = -(-31 // m)
    want_grad = np.zeros_like(table)
    for d in range(dp):
        np.add.at(want_grad, ids[d], ct[d])
    padded = np.concatenate([table, np.zeros((il * m - 31, 4), np.float32)])
    jax_sh = np.asarray(jax_shard_table(jax_mesh(spec), jnp.asarray(table)))
    np.testing.assert_array_equal(jax_sh, padded)  # JAX pads the same rows
    for r, x in enumerate(res):
        d, mi = divmod(r, m)
        np.testing.assert_array_equal(x["lookup"]["rows"], table[ids[d]])
        np.testing.assert_array_equal(x["lookup"]["shard"], padded[mi * il:(mi + 1) * il])
    grad = np.concatenate([res[mi]["lookup"]["grad"] for mi in range(m)])
    np.testing.assert_array_equal(grad[:31], want_grad)
    np.testing.assert_array_equal(grad[31:], 0.0)


@pytest.mark.parametrize("name", ["mf", "caser"])
def test_sharded_positions_equal_jax_and_one_device(ranks, inputs, name):
    spec, res = ranks
    jm, pm, prm = inputs[name]
    users, hists, gt = inputs["users"], inputs["hists"][name], inputs["gt"][name]
    with jax_mesh(spec) as mesh:
        want = np.asarray(jax_positions(mesh, jm, jax.tree.map(jnp.asarray, prm),
                                        jnp.asarray(users), jnp.asarray(hists),
                                        jnp.asarray(gt)))
    for x in res:
        np.testing.assert_array_equal(x[f"positions_{name}"]["pos"], want)


def test_evaluator_positions_sharded_equal_one_device(ranks, inputs):
    _, res = ranks
    jm, pm, prm = inputs["ev"]
    one = FullRankEvaluator(inputs["data"], batch_users=6, device="cpu")
    want = one.positions_factored(*pm.factored_scorer(), params_from_numpy(prm, "cpu"))
    jev = JaxEvaluator(inputs["jdata"], batch_users=6)
    jwant = np.asarray(jev.positions_factored(*jm.factored_scorer(),
                                              jax.tree.map(jnp.asarray, prm)))
    np.testing.assert_array_equal(want, jwant)
    for x in res:
        np.testing.assert_array_equal(x["evaluator"]["pos"], want)


@pytest.mark.parametrize("name", ["mf", "caser", "sasrec", "narrow"])
def test_sharded_recommend_equals_jax(ranks, inputs, name):
    spec, res = ranks
    jm, pm, prm = inputs[name]
    with jax_mesh(spec) as mesh:
        ws, wi = jax_rec(mesh, jm, jax.tree.map(jnp.asarray, prm), jnp.asarray(inputs["users"]),
                         jnp.asarray(inputs["hists"][name]), k=inputs["k"][name])
    for x in res:
        got = x[f"rec_{name}"]
        np.testing.assert_array_equal(got["items"], np.asarray(wi))
        np.testing.assert_allclose(got["scores"], np.asarray(ws), rtol=1e-6, atol=1e-7)


def test_sharded_recommend_bulk_equals_jax_and_one_device(ranks, inputs):
    spec, res = ranks
    jm, pm, prm = inputs["ev"]
    users = inputs["bulk_users"]
    with jax_mesh(spec) as mesh:
        ws, wi = jax_rec_bulk(mesh, jm, jax.tree.map(jnp.asarray, prm), inputs["jdata"], users,
                              k=10, batch_users=8)
    ps, pi = recommend(pm, params_from_numpy(prm, "cpu"), inputs["data"], users, k=10,
                       batch_users=8, device="cpu")
    np.testing.assert_array_equal(pi, np.asarray(wi))
    for x in res:
        np.testing.assert_array_equal(x["rec_bulk"]["items"], np.asarray(wi))
        np.testing.assert_allclose(x["rec_bulk"]["scores"], np.asarray(ws), rtol=1e-6,
                                   atol=1e-7)


def test_sharded_serving_refuses_k_past_the_shards(ranks):
    spec, res = ranks
    _, m = parse_spec(spec)
    for x in res:
        if m * 2 >= 10:
            assert x["serve_error"] is None
        else:
            assert x["serve_error"].startswith(f"cannot serve top-10 from 4 items over a {m}-way")


@pytest.mark.parametrize("count,index,axis_size", [(4, i, 1) for i in range(4)]
                         + [(2, i, 1) for i in range(2)] + [(2, i, 8) for i in range(2)])
@pytest.mark.parametrize("n", [10, 8, 2])
def test_process_rows_match_jax(n, count, index, axis_size):
    x = np.arange(n * 2, dtype=np.int32).reshape(n, 2)
    assert ip.process_rows(n, count, index, axis_size) == jax_ip.process_rows(
        n, count, index, axis_size)
    got, pn = ip.process_local_rows(x, count, index, axis_size)
    want, wn = jax_ip.process_local_rows(x, count, index, axis_size)
    np.testing.assert_array_equal(got, want)
    assert pn == wn


@pytest.mark.parametrize("spec", ["0x2", "2x0", "axb", "1x2x3", "-1", "", "x2"])
def test_mesh_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_mesh_from_spec(spec)
    with pytest.raises(ValueError) as got:
        parse_spec(spec)
    assert str(got.value) == str(want.value)


def test_mesh_from_spec_raises_where_jax_falls_back(monkeypatch):
    """JAX moves a mesh larger than its devices to virtual CPU devices; the
    port raises, naming torchrun, and builds nothing. A group of one rank
    takes 1x1 (and "1")."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    try:
        for spec in ("1x1", "1"):
            mesh = mesh_from_spec(spec, "cpu")
            assert mesh.shape == {"data": 1, "model": 1} and mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match=r"needs 4 ranks but the process group has 1: "
                                             r"start one process a rank, e\.g\. torchrun "
                                             r"--nproc_per_node 4"):
            mesh_from_spec("2x2", "cpu")
    finally:
        dist.destroy_process_group()


def test_launch_raises_for_a_failing_rank_and_a_timeout():
    with pytest.raises(RuntimeError, match="(?s)rank 0:.*ValueError: --mesh 2x1 needs 2 ranks"):
        launch.run(f"{CASES}:ping", 1, "2x1", "cpu", device="cpu", timeout=TIMEOUT)
    with pytest.raises(TimeoutError, match="still running"):
        launch.run("time:sleep", 1, 30.0, device="cpu", timeout=1.0)
