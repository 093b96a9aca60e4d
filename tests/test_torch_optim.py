"""The port's Adam, SGD and Adagrad against ``optax.adam``, ``optax.sgd``
and ``optax.adagrad``, and their states carried across both ways.

Tolerance: equal to the last bit in the five-step runs here (the same f32
operations in the same order; asserted with rtol 1e-7, atol 1e-9 so a
rounding-order change in either library would show as a near miss rather
than an unexplained failure).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from acf_tpu_torch.compat.jax_params import (
    opt_state_from_numpy, opt_state_to_numpy, params_from_numpy, params_to_numpy,
)
from acf_tpu_torch.train.optim import Adagrad, Adam, adagrad, adam, sgd

TOL = dict(rtol=1e-7, atol=1e-9)


def tree(seed):
    rng = np.random.default_rng(seed)
    return {"item_emb": rng.standard_normal((6, 4)).astype(np.float32),
            "blocks": [{"wq": {"w": rng.standard_normal((4, 4)).astype(np.float32),
                               "b": np.zeros(4, np.float32)}}],
            "ln_f": {"gamma": np.ones(4, np.float32)}}


def grads_like(p, rng, scale):
    return jax.tree.map(lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32), p)


def assert_trees_close(jtree, ttree):
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(params_to_numpy(ttree))):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)


@pytest.mark.parametrize("lr,b2", [(1e-3, 0.98), (1e-2, 0.999)])
def test_five_steps_match_optax(lr, b2):
    p = tree(0)
    jopt, topt = optax.adam(lr, b2=b2), adam(lr, b2=b2)
    jp, js = p, jopt.init(p)
    tp = params_from_numpy(p, device="cpu")
    ts = topt.init(tp)
    rng = np.random.default_rng(1)
    for step in range(5):  # gradients over five decades, zeros included
        g = grads_like(p, rng, 10.0 ** (step - 2))
        g["blocks"][0]["wq"]["b"][:] = 0.0
        u, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = topt.update(params_from_numpy(g, device="cpu"), ts, tp)
        assert_trees_close(jp, tp)
        assert_trees_close(js[0].mu, ts["mu"])
        assert_trees_close(js[0].nu, ts["nu"])
        assert int(ts["count"]) == int(js[0].count) == step + 1
    assert ts["count"].dtype == torch.int32


def test_state_carries_both_ways():
    """Two optax steps, hand the state to the port, two port steps, hand it
    back, one optax step: the same as five optax steps."""
    p = tree(2)
    jopt, topt = optax.adam(1e-3, b2=0.98), adam(1e-3, b2=0.98)
    rng = np.random.default_rng(3)
    gs = [grads_like(p, rng, 1.0) for _ in range(5)]
    ref_p, ref_s = p, jopt.init(p)
    for g in gs:
        u, ref_s = jopt.update(g, ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, u)

    jp, js = p, jopt.init(p)
    for g in gs[:2]:
        u, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert int(ts["count"]) == 2
    for g in gs[2:4]:
        tp, ts = topt.update(params_from_numpy(g, device="cpu"), ts, tp)
    back = opt_state_to_numpy(ts)
    js = (optax.ScaleByAdamState(**back), optax.EmptyState())
    jp = params_to_numpy(tp)
    u, js = jopt.update(gs[4], js, jp)
    jp = optax.apply_updates(jp, u)
    for a, b in zip(jax.tree.leaves(ref_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)
    assert int(js[0].count) == 5


def test_adam_defaults_are_optax_defaults():
    assert adam(1e-3) == Adam(1e-3, 0.9, 0.999, 1e-8)
    s = adam(1e-3).init(params_from_numpy(tree(0), device="cpu"))
    assert s["count"].shape == () and int(s["count"]) == 0
    assert not any(bool(x.any()) for x in jax.tree.leaves(params_to_numpy(s["mu"])))
    # a dict state carries too (the fields of ScaleByAdamState)
    again = opt_state_from_numpy(opt_state_to_numpy(s), device="cpu")
    assert int(again["count"]) == 0 and again["nu"]["item_emb"].shape == (6, 4)


def test_sgd_equals_optax_to_the_last_bit():
    p = tree(4)
    jopt, topt = optax.sgd(0.05), sgd(0.05)
    jp, js = p, jopt.init(p)
    tp = params_from_numpy(p, device="cpu")
    ts = topt.init(tp)
    assert ts == {} and opt_state_to_numpy(ts) == {}
    rng = np.random.default_rng(5)
    for step in range(5):
        g = grads_like(p, rng, 10.0 ** (step - 2))
        u, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = topt.update(params_from_numpy(g, device="cpu"), ts, tp)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params_to_numpy(tp))):
            np.testing.assert_array_equal(b, np.asarray(a))


def test_adagrad_equals_optax():
    """The accumulators equal optax's to the last bit over five steps; the
    params to one ulp of each update: XLA's CPU rsqrt (optax's
    ``jax.lax.rsqrt``) is not correctly rounded and differs from
    ``torch.rsqrt`` in the last bit for about a third of the inputs."""
    p = tree(6)
    jopt, topt = optax.adagrad(0.05), adagrad(0.05)
    assert topt == Adagrad(0.05, 0.1, 1e-7)  # optax's defaults
    jp, js = p, jopt.init(p)
    tp = params_from_numpy(p, device="cpu")
    ts = topt.init(tp)
    rng = np.random.default_rng(7)
    for step in range(5):  # gradients over five decades, zeros included
        g = grads_like(p, rng, 10.0 ** (step - 2))
        g["blocks"][0]["wq"]["b"][:] = 0.0
        u, js = jopt.update(g, js, jp)
        old = jp
        jp = optax.apply_updates(jp, u)
        tp, ts = topt.update(params_from_numpy(g, device="cpu"), ts, tp)
        for a, b in zip(jax.tree.leaves(js[0].sum_of_squares),
                        jax.tree.leaves(params_to_numpy(ts["sum_of_squares"]))):
            np.testing.assert_array_equal(b, np.asarray(a))
        for a, b, o in zip(jax.tree.leaves(jp), jax.tree.leaves(params_to_numpy(tp)),
                           jax.tree.leaves(old)):
            step_size = np.abs(np.asarray(a) - np.asarray(o))
            np.testing.assert_array_less(np.abs(b - np.asarray(a)),
                                         2.0 ** -22 * step_size + np.spacing(np.abs(a)) + 1e-30)


def test_adagrad_and_apl_states_carry_both_ways():
    """optax's Adagrad state to the port and back, and APL's per-player SGD
    states (``{"g": …, "c": …}``, no slots)."""
    p = tree(8)
    jopt = optax.adagrad(0.05)
    js = jopt.init(p)
    u, js = jopt.update(grads_like(p, np.random.default_rng(9), 1.0), js, p)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert set(ts) == {"sum_of_squares"}
    back = opt_state_to_numpy(ts)
    js2 = (optax.ScaleByRssState(**back), optax.EmptyState())
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(js2)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    apl = {"g": optax.sgd(0.05).init(p), "c": optax.sgd(0.05).init(p)}
    assert opt_state_from_numpy(apl, device="cpu") == {"g": {}, "c": {}}
    assert opt_state_to_numpy({"g": {}, "c": {}}) == {"g": {}, "c": {}}
