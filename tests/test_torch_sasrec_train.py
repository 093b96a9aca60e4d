"""The port's SASRec training surface against the JAX package's, on the CPU,
with the JAX model's dropout draws injected: ``loss_window`` and ``loss``
for sasrec, asasrec (the FGSM hot path), asasrec2 (``eps_pos``,
``eps_dense``, ``eps_conv``), PGD (``adv_steps=2``) and ``l2_emb``; the
loss, the aux values and every gradient leaf against ``jax.value_and_grad``.

On CPU tensors the encoder's backward is the hand-derived
``encoder_bwd_math`` (K2b's plain version), so these gradients go through
the derivation the kernel follows.

Tolerances: losses and aux values rtol 1e-5 (f32 sums in another order).
Gradients: rtol 1e-4 and an atol of 1e-5 times the largest entry of the
whole gradient tree. The item-table gradient is a scatter-add of many rows
summed in another order, some entries are analytically zero (the key bias)
and are rounding noise on both sides, and the FGSM directions are
normalised gradients, which carry the inner gradient's rounding into the
outer one.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.models.sasrec import _tf_l2_normalize as jax_l2n
from acf_tpu.train.checkpoint import _flatten_with_names as jax_named
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.models.sasrec import SASRec, _tf_l2_normalize
from acf_tpu_torch.ops.sasrec_fused import fused_encoder
from acf_tpu_torch.train.checkpoint import _flatten_with_names
from acf_tpu_torch.utils.tree import tree_leaves, tree_map

CPU = "cpu"
D, NUM_ITEMS, B = 16, 30, 6
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

CONFIGS = {
    "sasrec": {},
    "asasrec": dict(adversarial=True, eps=0.5, reg_adv=1.0),
    "asasrec2": dict(adversarial=True, adv_mode="asasrec2", eps_pos=0.3, eps_dense=0.2,
                     eps_conv=0.1),
    "pgd": dict(adversarial=True, adv_steps=2),
    "l2_emb": dict(l2_emb=0.01),
}


def models(t, **kw):
    jm = JaxSASRec(10, NUM_ITEMS, D, maxlen=t, dropout_rate=0.3, fused="never", **kw)
    return jm, SASRec(10, NUM_ITEMS, D, maxlen=t, dropout_rate=0.3, **kw)


def carried(jm, seed=1):
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


def window_batch(t, seed):
    """(users, window [B, T+1], neg [B, T]): row 0 left-padded, row 1 all
    padding but its last (target) item, negatives 0 on pad positions."""
    rng = np.random.default_rng(seed)
    window = rng.integers(1, NUM_ITEMS, (B, t + 1)).astype(np.int32)
    window[0, : t // 2] = 0
    window[1, :t] = 0
    neg = rng.integers(1, NUM_ITEMS, (B, t)).astype(np.int32)
    neg[window[:, 1:] == 0] = 0
    return np.arange(B, dtype=np.int32), window, neg


def jax_masks(jm, key, t):
    """The masks JAX's loss draws from ``key``: (training pass, asasrec2's
    adversarial pass), as port trees."""
    k_enc, k_adv = jax.random.split(key)
    return tuple(params_from_numpy(jax.tree.map(np.asarray, jm._dropout_masks(k, B, t)),
                                   device=CPU) for k in (k_enc, k_adv))


def port_value_and_grad(fn, tparams, batch, masks, adv_masks):
    prm = tree_map(lambda x: x.detach().requires_grad_(True), tparams)
    loss, aux = fn(prm, tuple(torch.from_numpy(b) for b in batch), masks=masks,
                   adv_masks=adv_masks)
    grads = torch.autograd.grad(loss, tree_leaves(prm), allow_unused=True)
    names = [n for n, _ in _flatten_with_names(tparams)]
    return loss, aux, {n: (np.zeros(x.shape, np.float32) if g is None else g.numpy())
                       for n, x, g in zip(names, tree_leaves(tparams), grads)}


def assert_grads_match(jgrads, tgrads):
    ref = jax_named(jgrads)
    assert ref.keys() == tgrads.keys()
    scale = max(float(np.abs(v).max()) for v in ref.values())
    for name, r in ref.items():
        np.testing.assert_allclose(tgrads[name], r, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("form", ["loss_window", "loss"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("t", [8, 33])
def test_loss_and_every_grad_match_jax(t, config, form):
    jm, tm = models(t, **CONFIGS[config])
    jp, tp = carried(jm, seed=t)
    users, window, neg = window_batch(t, seed=t + len(config))
    batch = (users, window, neg) if form == "loss_window" else \
        (users, window[:, :-1], window[:, 1:], neg)
    key = jax.random.PRNGKey(t * 3 + 1)
    (jl, jaux), jg = jax.value_and_grad(getattr(jm, form), has_aux=True)(jp, batch, key)
    masks, adv_masks = jax_masks(jm, key, t)
    loss, aux, tg = port_value_and_grad(getattr(tm, form), tp, batch, masks, adv_masks)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOSS_TOL)
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **LOSS_TOL, err_msg=k)
        assert not aux[k].requires_grad
    assert_grads_match(jg, tg)


def test_fgsm_inner_gradient_takes_dx_only(monkeypatch):
    """The asasrec hot path's inner gradient is taken with respect to the
    item table alone: the encoder's backward runs without weight
    gradients; the outer backward with them."""
    from acf_tpu_torch.ops import sasrec_fused

    calls = []
    real = sasrec_fused.encoder_bwd
    monkeypatch.setattr(sasrec_fused, "encoder_bwd",
                        lambda *a, **k: calls.append(a[-1]) or real(*a, **k))
    jm, tm = models(8, **CONFIGS["asasrec"])
    _, tp = carried(jm)
    masks, _ = jax_masks(jm, jax.random.PRNGKey(0), 8)
    port_value_and_grad(tm.loss_window, tp, window_batch(8, 0), masks, None)
    assert calls == [False, True]


def test_eps_tree_and_delta_tree_match_jax():
    jm, tm = models(8, **CONFIGS["asasrec2"])
    jp, tp = carried(jm)
    eps = tm._eps_tree(tp)
    assert tree_leaves(eps) == [jax_named(jm._eps_tree(jp))[n]
                                for n, _ in _flatten_with_names(tp)]
    assert eps["blocks"][1]["wq"] == {"w": 0.2, "b": 0.2} and eps["blocks"][0]["wk"]["w"] == 0.0
    users, window, neg = window_batch(8, 3)
    seq, pos = window[:, :-1], window[:, 1:]
    ref = jax_named(jm._delta_tree(jp, seq, pos, neg))
    got = dict(_flatten_with_names(tm._delta_tree(
        tp, *(torch.from_numpy(a) for a in (seq, pos, neg)))))
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r, rtol=1e-4, atol=1e-6, err_msg=name)
    norms = np.linalg.norm(got["item_emb"].numpy(), axis=1)
    np.testing.assert_allclose(norms[norms > 1e-9], 0.5, rtol=1e-5)  # FGSM rows on the ball


@pytest.mark.parametrize("shape", [(7,), (5, 3), (4, 6)])
def test_tf_l2_normalize_matches_jax(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    x[0] = 0.0  # a zero row stays zero
    np.testing.assert_allclose(_tf_l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_l2n(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_adv_target_loss_is_the_clean_unregularised_loss():
    jm, tm = models(8, l2_emb=0.5)
    jp, tp = carried(jm)
    users, window, neg = window_batch(8, 5)
    batch = (users, window[:, :-1], window[:, 1:], neg)
    ref = float(jm.adv_target_loss(jp, batch, jax.random.PRNGKey(0)))
    got = tm.adv_target_loss(tp, tuple(torch.from_numpy(b) for b in batch))
    np.testing.assert_allclose(float(got), ref, **LOSS_TOL)
    assert tm.batch_kind == "seq"


def test_generator_draws_give_a_finite_loss_and_no_launch():
    """Training from a generator (the trainer's path) on CPU tensors: finite
    loss and gradients, the kernels' counters untouched."""
    jm, tm = models(8, **CONFIGS["asasrec"])
    _, tp = carried(jm)
    before = fused_encoder.launches
    prm = tree_map(lambda x: x.detach().requires_grad_(True), tp)
    loss, aux = tm.loss_window(prm, tuple(torch.from_numpy(b) for b in window_batch(8, 1)),
                               torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(loss, tree_leaves(prm))
    assert math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    assert set(aux) == {"loss", "acc", "loss_adv", "acc_adv"}
    assert fused_encoder.launches == before
