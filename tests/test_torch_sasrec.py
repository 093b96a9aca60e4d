"""The port's SASRec serving slice (on the CPU) against the JAX package's:
layers, init tree, scores, windows (never padded), full-catalog evaluation,
top-K serving, and carrying a SASRec tree through numpy and npz.

Tolerances: layers and scores rtol 1e-5 / atol 1e-5 (f32, different
summation orders); rank positions equal, except ±1 where an item's score
lies within 1e-5 of the threshold relative to max(|t|, 1) (the two encoders
round differently, so such an item can land on either side); top-K items
equal wherever scores are not tied within the score tolerance; params and
npz files exactly.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.eval import FullRankEvaluator as JaxEvaluator
from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.nn import layers as jax_layers
from acf_tpu.ops.topk import recommend as jax_recommend
from acf_tpu.train.checkpoint import load_params as jax_load_params
from acf_tpu.train.checkpoint import save_params as jax_save_params
from acf_tpu_torch.compat.jax_params import params_from_numpy, params_to_numpy
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.eval import FullRankEvaluator
from acf_tpu_torch.models.base import SequenceModel
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.nn import layers
from acf_tpu_torch.ops.sasrec_fused import fused_encoder
from acf_tpu_torch.ops.topk import recommend
from acf_tpu_torch.train.checkpoint import load_params, save_params
from tests.test_full_rank import make_data
from tests.test_trainer import synthetic_data

CPU = "cpu"
D = 16
TOL = dict(rtol=1e-5, atol=1e-5)
DATASETS = {"make_data": lambda: make_data(num_users=13, num_items=40, seed=3),
            "synthetic_data": lambda: synthetic_data(seed=2)}


def _carried(num_users, num_items, maxlen, seed=0, **kw):
    jmodel = JaxSASRec(num_users, num_items, D, maxlen=maxlen, **kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    return jmodel, jparams, SASRec(num_users, num_items, D, maxlen=maxlen, **kw), tparams


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


# --- layers ------------------------------------------------------------------

def test_layer_norm_and_dense_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 7, D)) * 3 + 1).astype(np.float32)
    x[0, 0] = 0.0  # a zero row gives beta
    p = {"gamma": rng.standard_normal(D).astype(np.float32),
         "beta": rng.standard_normal(D).astype(np.float32)}
    w = {"w": rng.standard_normal((D, D)).astype(np.float32),
         "b": rng.standard_normal(D).astype(np.float32)}
    tp = params_from_numpy(p, device=CPU)
    np.testing.assert_allclose(layers.layer_norm(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_layers.layer_norm(p, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        layers.dense(params_from_numpy(w, device=CPU), torch.from_numpy(x)).numpy(),
        np.asarray(jax_layers.dense(w, jnp.asarray(x))), **TOL)


def test_initialisers_follow_tf_semantics():
    g = torch.Generator().manual_seed(0)
    t = layers.trunc_normal(g, (4000, 16), 0.01)
    assert float(t.abs().max()) <= 0.02 and abs(float(t.std()) - 0.0088) < 0.0003
    w = layers.glorot_uniform(g, (64, 32))
    limit = math.sqrt(6.0 / 96)
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.95 * limit
    conv = layers.glorot_uniform(g, (3, 8, 8))  # receptive field multiplies both fans
    assert float(conv.abs().max()) <= math.sqrt(6.0 / 48)
    dense = layers.init_dense(g, 8, 4)
    assert dense["w"].shape == (8, 4) and not dense["b"].any()
    ln = layers.init_layer_norm(5)
    assert ln["gamma"].eq(1).all() and not ln["beta"].any()
    again = layers.glorot_uniform(torch.Generator().manual_seed(0), (64, 32))
    torch.testing.assert_close(again, layers.glorot_uniform(
        torch.Generator().manual_seed(0), (64, 32)), rtol=0, atol=0)


# --- model -------------------------------------------------------------------

def test_init_params_tree_matches_jax():
    jmodel = JaxSASRec(30, 50, D, maxlen=12, num_blocks=3)
    jtree = _leaves(jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0))))
    model = SASRec(30, 50, D, maxlen=12, num_blocks=3)
    params = model.init_params(torch.Generator().manual_seed(0), device=CPU)
    ttree = _leaves(params)
    assert (sorted((n, tuple(x.shape)) for n, x in ttree)
            == sorted((n, x.shape) for n, x in jtree))
    assert list(params) == ["item_emb", "pos_emb", "blocks", "ln_f"]
    assert list(params["blocks"][0]) == ["ln1", "wq", "wk", "wv", "ln2", "conv1", "conv2", "ln3"]
    assert all(x.dtype == torch.float32 for _, x in ttree)
    assert not params["item_emb"][0].any()  # pad row
    assert float(params["item_emb"].abs().max()) <= 0.02
    assert float(params["pos_emb"].abs().max()) <= math.sqrt(6.0 / (12 + D))
    assert isinstance(model, SequenceModel) and model.maxlen == 12
    for field in ("num_blocks", "num_heads", "dropout_rate", "l2_emb", "adversarial",
                  "adv_mode", "eps", "reg_adv", "eps_pos", "eps_dense", "eps_conv",
                  "adv_steps"):
        assert getattr(SASRec(1, 2, 4), field) == getattr(JaxSASRec(1, 2, 4), field)


def test_encode_train_raises():
    """Training with dropout needs a generator or injected masks."""
    model, _, tmodel, tparams = _carried(10, 30, 8)
    seq = torch.ones(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="torch.Generator or injected masks"):
        tmodel.encode(tparams, seq, train=True)


def test_encode_train_is_the_jax_training_forward():
    """encode(train=True) with the JAX model's masks for a key equals the
    JAX training forward for that key; drawn from a generator, the masks
    keep each value with probability 1 - dropout_rate."""
    jmodel, jparams, tmodel, tparams = _carried(10, 30, 8, dropout_rate=0.3)
    seq = np.random.default_rng(0).integers(0, 30, (4, 8)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jmodel.encode(jparams, jnp.asarray(seq), train=True, key=key))
    masks = params_from_numpy(jax.tree.map(np.asarray, jmodel._dropout_masks(key, 4, 8)),
                              device=CPU)
    got = tmodel.encode(tparams, torch.from_numpy(seq), train=True, masks=masks)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    inference = tmodel.encode(tparams, torch.from_numpy(seq))
    assert not np.allclose(got.numpy(), inference.numpy(), atol=1e-3)
    drawn = tmodel._dropout_masks(torch.Generator().manual_seed(0), 64, 8)
    assert drawn["emb"].shape == (64, 8, D) and drawn["emb"].dtype == torch.bool
    assert [m["p"].shape for m in drawn["blocks"]] == [(64, 1, 8, 8)] * 2
    assert abs(float(drawn["emb"].float().mean()) - 0.7) < 0.02
    again = tmodel.encode(tparams, torch.from_numpy(seq), train=True,
                          generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(again, tmodel.encode(
        tparams, torch.from_numpy(seq), train=True, generator=torch.Generator().manual_seed(1)),
        rtol=0, atol=0)


def test_cpu_encoder_runs_encode_math_without_a_launch(monkeypatch):
    _, _, tmodel, tparams = _carried(10, 30, 8, num_heads=2)  # multi-head runs on CPU
    seen = []
    real = tmodel.encode_math
    monkeypatch.setattr(tmodel, "encode_math", lambda *a: seen.append(a[1].shape) or real(*a))
    before = fused_encoder.launches
    out = tmodel.encode(tparams, torch.arange(16, dtype=torch.int32).reshape(2, 8))
    assert out.shape == (2, 8, D) and seen == [(2, 8, D)]
    assert fused_encoder.launches == before


@pytest.mark.parametrize("width,maxlen", [(5, 8), (12, 8)])
def test_windows_are_jax_windows_and_never_padded(width, maxlen, monkeypatch):
    """A history narrower than maxlen gives a window of its own width; a
    wider one its last maxlen items."""
    jmodel, jparams, tmodel, tparams = _carried(10, 30, maxlen, seed=1)
    rng = np.random.default_rng(width)
    hists = rng.integers(1, 30, (4, width)).astype(np.int32)
    hists[0, :3] = 0  # left-padded history
    users = np.arange(4, dtype=np.int32)
    widths = []
    real = tmodel.encode_core
    monkeypatch.setattr(tmodel, "encode_core",
                        lambda p, x, m, **kw: widths.append(x.shape[1]) or real(p, x, m, **kw))
    got = tmodel.score_all(tparams, torch.from_numpy(users), torch.from_numpy(hists))
    assert widths == [min(width, maxlen)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.score_all(jparams, users, hists)),
                               **TOL)
    reprs = tmodel.factored_scorer()[0](tparams, torch.from_numpy(users), torch.from_numpy(hists))
    jreprs = jmodel.factored_scorer()[0](jparams, users, hists)
    np.testing.assert_allclose(reprs.numpy(), np.asarray(jreprs), **TOL)


def test_score_some_and_table_match_jax():
    jmodel, jparams, tmodel, tparams = _carried(10, 30, 8, seed=2)
    rng = np.random.default_rng(0)
    hists = rng.integers(0, 30, (5, 8)).astype(np.int32)
    items = rng.integers(1, 30, (5, 7)).astype(np.int32)
    users = np.arange(5, dtype=np.int32)
    got = tmodel.score_some(tparams, torch.from_numpy(users), torch.from_numpy(hists),
                            torch.from_numpy(items))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.score_some(jparams, users, hists, items)),
                               **TOL)
    table, bias = tmodel.factored_scorer()[1](tparams)
    assert table is tparams["item_emb"] and bias is None
    assert tmodel.factored_scorer() is tmodel.factored_scorer()  # cached


# --- evaluation and serving ----------------------------------------------------

def assert_positions_agree(pos, ref, tmodel, tparams, tev):
    """Equal, except ±1 for users with an item within 1e-5 of the threshold
    relative to max(|t|, 1) (items 0 and the gt excluded)."""
    differ = np.nonzero(pos != ref)[0]
    assert np.abs(pos.astype(np.int64) - ref).max(initial=0) <= 1
    for row in differ:
        u = int(tev.users[row])
        hist = torch.from_numpy(tev.data.hist[u:u + 1])
        scores = tmodel.score_all(tparams, torch.tensor([u]), hist)[0]
        gt = int(tev.data.test_item[u])
        t = float(scores[gt])
        near = (scores - t).abs() <= 1e-5 * max(abs(t), 1.0)
        near[0] = near[gt] = False
        assert bool(near.any()), f"user {u} differs with no near tie"
    return len(differ)


@pytest.mark.parametrize("batch_users", [4, 16])
@pytest.mark.parametrize("maxlen", [5, 50])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_evaluate_model_matches_jax(dataset, maxlen, batch_users):
    jdata = DATASETS[dataset]()
    tdata = Interactions(**dataclasses.asdict(jdata))
    jmodel, jparams, tmodel, tparams = _carried(jdata.num_users, jdata.num_items, maxlen,
                                                seed=maxlen)
    jev = JaxEvaluator(jdata, batch_users=batch_users)
    tev = FullRankEvaluator(tdata, batch_users=batch_users, device=CPU)
    jfs, tfs = jmodel.factored_scorer(), tmodel.factored_scorer()
    ref = jev.positions_factored(jfs[0], jfs[1], jparams, interpret=True)
    pos = tev.positions_factored(tfs[0], tfs[1], tparams)
    assert_positions_agree(pos, ref, tmodel, tparams, tev)
    np.testing.assert_array_equal(pos, tev.positions(tmodel.score_all, tparams))

    a = jev.evaluate_model(jmodel, jparams)
    b = tev.evaluate_model(tmodel, tparams)
    same = pos == ref
    for field in ("hr", "ndcg", "auc"):
        np.testing.assert_allclose(getattr(b, field)[same], getattr(a, field)[same], rtol=1e-6)


@pytest.mark.parametrize("batch_users", [3, 8])  # bulk and per-batch paths
@pytest.mark.parametrize("maxlen", [5, 50])
def test_recommend_matches_jax(maxlen, batch_users):
    jdata = synthetic_data(seed=4)
    tdata = Interactions(**dataclasses.asdict(jdata))
    jmodel, jparams, tmodel, tparams = _carried(jdata.num_users, jdata.num_items, maxlen,
                                                seed=1)
    users = tdata.eval_users()[:20]
    s, it = recommend(tmodel, tparams, tdata, users, k=10, batch_users=batch_users,
                      device=CPU)
    js, ji = jax_recommend(jmodel, jparams, jdata, users, k=10, batch_users=batch_users)
    assert s.shape == (20, 10) and it.dtype == np.int32
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(s, js, **TOL)
    # items equal in every slot whose score is not tied with a neighbour
    # within the score tolerance
    tied = np.zeros_like(js, dtype=bool)
    close = np.abs(np.diff(js, axis=1)) <= TOL["atol"] + TOL["rtol"] * np.abs(js[:, 1:])
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(it[~tied], ji[~tied])
    for row, u in enumerate(users):
        assert not set(int(x) for x in tdata.hist[u] if x) & set(it[row].tolist())


# --- carrying weights ------------------------------------------------------------

def test_sasrec_tree_survives_numpy_round_trip():
    jmodel = JaxSASRec(10, 30, D, maxlen=8)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(3)))
    params = params_from_numpy(tree, device=CPU)
    assert isinstance(params["blocks"], list) and isinstance(params["blocks"][1]["wq"], dict)
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    ref = dict(_leaves(tree))
    got = dict(_leaves(back))
    assert got.keys() == ref.keys()
    for name, a in ref.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


def test_sasrec_npz_both_ways(tmp_path):
    tmodel = SASRec(10, 30, D, maxlen=8)
    tparams = tmodel.init_params(torch.Generator().manual_seed(5), device=CPU)
    path = str(tmp_path / "sasrec.npz")
    save_params(path, tparams)
    with np.load(path) as f:
        names = set(f.files)
    assert {"item_emb", "pos_emb", "blocks/0/wq/w", "blocks/1/conv2/b", "blocks/0/ln1/gamma",
            "ln_f/gamma", "ln_f/beta"} <= names
    assert len(names) == len(_leaves(tparams))
    jlike = JaxSASRec(10, 30, D, maxlen=8).init_params(jax.random.PRNGKey(0))
    jloaded = jax_load_params(path, jlike)
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jloaded)))
    for name, a in _leaves(tparams):
        np.testing.assert_array_equal(jleaves[name], a.numpy(), err_msg=name)
    back = load_params(path, tmodel.init_params(torch.Generator().manual_seed(0), device=CPU))
    for (n1, a), (_, b) in zip(_leaves(tparams), _leaves(back)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n1)
    # and a file written by the JAX package loads into the port's tree
    jpath = str(tmp_path / "jax_sasrec")
    jax_save_params(jpath, jloaded)
    again = load_params(jpath, tparams)
    torch.testing.assert_close(again["blocks"][0]["wv"]["w"], tparams["blocks"][0]["wv"]["w"],
                               rtol=0, atol=0)
