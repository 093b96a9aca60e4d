"""The port's NeuMF (``acf_tpu_torch/models/neumf.py``) on the CPU against the
JAX package's (``acf_tpu/models/neumf.py``, modelled on
``tests/test_neumf.py``): the same numpy params, carried across by
``acf_tpu_torch/compat/jax_params.py``, and the same batches go through both.

Tolerance (``SCALE_TOL`` = 1e-6 of a scale): scores to 1e-6 of their
largest magnitude, the loss to 1e-6 of itself. A gradient entry is a sum
over the batch rows, and the bias gradients cancel: ``out/b`` is the mean
of σ(logit) − label over 2B examples, terms of ±0.5 / 2B that sum to ~3e-3.
So each gradient leaf is held to 1e-6 of its summand scale: the largest,
over its entries, of Σ over the rows of |that row's gradient| (float64),
the magnitude the f32 sums must resolve. Both sides run the same f32
operations but add the terms in other orders (torch's against XLA's matmuls
and scatter-adds): on ``out/b`` the JAX package itself lies up to 4.3e-8
from a float64 evaluation of the same loss (4 seeds), 1e-7 of its summand
scale of ~0.5; the tables lie within 1e-10. The accuracy is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.eval.full_rank import FullRankEvaluator as JaxEvaluator
from acf_tpu.models.neumf import NeuMF as JaxNeuMF
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.eval import FullRankEvaluator
from acf_tpu_torch.models.neumf import NeuMF
from acf_tpu_torch.ops.ranking import rank_positions_dot
from acf_tpu_torch.train import TrainConfig, Trainer, adam
from acf_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_pair_trainer import port_data
from tests.test_trainer import synthetic_data

CPU = "cpu"
SCALE_TOL = 1e-6
U, I, D = 20, 30, 8


def close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=SCALE_TOL * max(float(np.abs(want).max()), 1e-30),
                               err_msg=msg)


def carried(seed=0, users=U, items=I, dim=D):
    jm = JaxNeuMF(users, items, dim)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jm, jp, NeuMF(users, items, dim), params_from_numpy(jax.tree.map(np.asarray, jp),
                                                               device=CPU)


def batch(seed=0, b=16):
    """(users, pos, neg) int32 with duplicate users and an item that is one
    row's positive and another's negative."""
    rng = np.random.default_rng(seed)
    u = rng.integers(1, U, size=b).astype(np.int32)
    i = rng.integers(1, I, size=b).astype(np.int32)
    j = rng.integers(1, I, size=b).astype(np.int32)
    u[3] = u[0]
    j[2] = i[4]
    return u, i, j


@pytest.mark.parametrize("chunk", [4096, 7])
def test_score_all_and_score_some_match_jax(chunk):
    """Full-catalog scores in one chunk and in chunks of 7 items (the last
    one short, which the JAX package pads with clamped items), and
    ``score_some`` on [B, M] items."""
    jm, jp, tm, tp = carried()
    jm._item_chunk = tm._item_chunk = chunk
    users = np.array([3, 7, 0, 19], np.int32)
    got = tm.score_all(tp, torch.from_numpy(users), None)
    assert got.shape == (4, I)
    close(got.numpy(), jm.score_all(jp, jnp.asarray(users), None))
    items = np.random.default_rng(1).integers(0, I, size=(4, 11)).astype(np.int32)
    some = tm.score_some(tp, torch.from_numpy(users), None, torch.from_numpy(items))
    close(some.numpy(), jm.score_some(jp, jnp.asarray(users), None, jnp.asarray(items)))
    np.testing.assert_allclose(some.numpy(), np.take_along_axis(got.numpy(), items, 1),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_every_gradient_leaf_match_jax(seed):
    jm, jp, tm, tp = carried(seed)
    u, i, j = batch(seed)
    (jl, jaux), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, (jnp.asarray(u), jnp.asarray(i), jnp.asarray(j)), jax.random.PRNGKey(0))
    prm = tree_map(lambda x: x.clone().requires_grad_(True), tp)
    leaves = tree_leaves(prm)
    loss, aux = tm.loss(prm, tuple(map(torch.from_numpy, (u, i, j))))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=SCALE_TOL)
    assert set(aux) == {"loss", "acc"} and float(aux["acc"]) == float(jaux["acc"])
    assert len(grads) == len(jax.tree_util.tree_leaves(jg)) == 10
    scales = summand_scales(tm, tp, (u, i, j))
    for name, g, scale in zip(_names(tp), grads, scales):
        np.testing.assert_allclose(g.numpy(), _leaf(jg, name), rtol=0, atol=SCALE_TOL * scale,
                                   err_msg=name)


def summand_scales(model, params, batch):
    """Per leaf, max over its entries of Σ over the 2B examples of |the
    example's gradient of the loss| in float64 (each of the B positive and
    B negative examples weighs 1 / 2B in the mean BCE)."""
    users, pos, neg = (torch.from_numpy(x) for x in batch)
    prm = tree_map(lambda x: x.double().requires_grad_(True), params)
    leaves = tree_leaves(prm)
    n = 2 * len(users)
    total = [torch.zeros_like(x) for x in leaves]
    for items, label in ((pos, 1.0), (neg, 0.0)):
        for r in range(len(users)):
            logit = model._logits(prm, users[r:r + 1], items[r:r + 1])[0]
            example = torch.logaddexp(torch.zeros_like(logit), logit) - label * logit
            g = torch.autograd.grad(example / n, leaves, allow_unused=True)
            total = [t if gi is None else t + gi.abs() for t, gi in zip(total, g)]
    return [float(t.max()) for t in total]


def _names(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += _names(v, prefix + k + "/") if isinstance(v, dict) else [prefix + k]
    return out


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def test_init_params_shapes_and_ranges():
    """Keras-uniform embeddings in (-0.05, 0.05), glorot kernels, zero
    biases: the JAX init's tree, shapes and ranges."""
    _, jp, tm, _ = carried()
    tp = tm.init_params(torch.Generator().manual_seed(0), device=CPU)
    assert sorted(_names(tp)) == sorted(_names(jax.tree.map(np.asarray, jp)))
    for name in _names(tp):
        assert tuple(_leaf(tp, name).shape) == _leaf(jp, name).shape, name
    for k in ("P_mf", "Q_mf", "P_mlp", "Q_mlp"):
        assert float(tp[k].abs().max()) <= 0.05 and float(tp[k].std()) > 0.02
    limit = np.sqrt(6.0 / (4 * D))
    assert float(tp["mlp1"]["w"].abs().max()) <= limit
    assert all(float(tp[k]["b"].abs().max()) == 0.0 for k in ("mlp1", "mlp2", "out"))


def test_adv_encoders_gather_the_four_tables():
    _, _, tm, tp = carried()
    enc = tm.adv_encoders()
    assert list(enc) == ["mf_u", "mf_i", "mlp_u", "mlp_i"]
    ids = torch.tensor([1, 4])
    for name, table in zip(enc, ("P_mf", "Q_mf", "P_mlp", "Q_mlp")):
        side, fn, width = enc[name]
        assert side == ("user" if name.endswith("_u") else "item") and width == D
        torch.testing.assert_close(fn(tp, ids), tp[table][ids], rtol=0, atol=0)


def test_dense_evaluation_matches_jax_positions():
    """NeuMF has no factored scorer: ``evaluate_model`` takes the dense path
    (no K1 launch), and its rank positions equal the JAX evaluator's except
    where two scores tie within rounding."""
    jd = synthetic_data(seed=3)
    td = port_data(3)
    jm, jp, tm, tp = carried(2, jd.num_users, jd.num_items)
    assert tm.factored_scorer() is None
    ev = FullRankEvaluator(td, batch_users=tm.eval_batch_users, device=CPU)
    got = ev.positions(tm.score_all, tp)
    want = np.asarray(JaxEvaluator(jd, batch_users=jm.eval_batch_users).positions(
        jm.score_all, jp))
    assert (got == want).mean() >= 0.99 and np.abs(got.astype(int) - want).max() <= 1
    res = ev.evaluate_model(tm, tp)
    assert rank_positions_dot.launches == 0 and res.hr.shape == (len(ev.users), 100)


def test_neumf_trains_with_adam():
    """``tests/test_neumf.py::test_neumf_trains`` on the port's pair
    trainer: NDCG@10 rises and the accuracy passes 0.6."""
    data = port_data(7)
    tr = Trainer(NeuMF(data.num_users, data.num_items, 8), data, adam(0.01),
                 TrainConfig(batch_size=32, verbose=10 ** 9, device=CPU))
    before = tr.evaluate().at_k(10)
    for _ in range(25):
        stats = tr.run_epoch()
    after = tr.evaluate().at_k(10)
    assert after[1] > before[1], (before, after)
    assert stats["acc"] > 0.6
