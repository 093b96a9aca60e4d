"""The port's IRGAN (``acf_tpu_torch/models/irgan.py``) on the CPU against the
JAX package's (``acf_tpu/models/irgan.py``, modelled on
``tests/test_gan_models.py``): D's pointwise and pairwise losses and G's
policy-gradient loss with every gradient leaf against ``jax.value_and_grad``
of the JAX epoch's own loss functions (read from its closure), the draws of
a step, whole epochs with the JAX epoch's draws injected, the pad column,
and the generator's rank positions.

Tolerances: a loss to rtol 1e-6 and its gradients to 1e-6 of their tree's
scale (the same f32 products and sums in another order); the samples and
D's fakes exactly (an argmax over draws that tie only within rounding would
flip, and none does here); epochs: both players' tables to rtol 1e-5, atol
1e-7 (SGD's steps of 1e-3 times gradients summed in another order), D's
loss to rtol 1e-5, G's to rtol 1e-5 with atol 1e-8 (``G_LOSS_ATOL``: a mean
of terms log p · reward of ~1e-4 and both signs, the rewards 2(σ(D) − 0.5)
around 0, which cancels to ~1e-5, so its rounding is relative to the terms,
not to the mean); rank positions exactly.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.eval.full_rank import FullRankEvaluator as JaxEvaluator
from acf_tpu.models.irgan import IRGAN as JaxIRGAN
from acf_tpu.sampling.negatives import sample_pair_epoch as jax_sample_pair_epoch
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.eval import FullRankEvaluator
from acf_tpu_torch.models.irgan import IRGAN
from acf_tpu_torch.ops.ranking import rank_positions_dot
from acf_tpu_torch.train import Trainer, sgd
from acf_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_apl import config, port_data
from tests.test_torch_apl import jax_params as to_port
from tests.test_trainer import synthetic_data

CPU = "cpu"
B = 32
S = 2
EPOCH_TOL = dict(rtol=1e-5, atol=1e-7)
G_LOSS_ATOL = 1e-8


def jax_losses(jm, batch_size=B):
    """The JAX epoch's own loss functions and logits, from its closure."""
    fn = jm.make_epoch_fn(optax.sgd(0.001), batch_size, 1)
    return inspect.getclosurevars(fn.__wrapped__).nonlocals


def pair(seed, **kw):
    """A JAX and a port trainer on the same data, the port's params copied
    from the JAX trainer's init."""
    jd = synthetic_data(seed=seed)
    jt = JaxTrainer(JaxIRGAN(jd.num_users, jd.num_items, 8, **kw), jd, optax.sgd(0.001),
                    JaxConfig(batch_size=B, seed=11, verbose=10 ** 9))
    td = port_data(jd)
    tt = Trainer(IRGAN(td.num_users, td.num_items, 8, **kw), td, sgd(0.001), config(seed=11))
    tt.params = to_port(jt.params)
    return jt, tt


def jax_epoch_draws(jt):
    """The draws the JAX trainer's next ``run_epoch`` makes (its key split,
    then ``k_perm, k_d, k_g = split(key, 3)``, acf_tpu/models/irgan.py:149):
    the batches, D's [nb, B, I] uniforms, and G's mixture choices, [nb, B,
    2, I] uniforms and history draws, as tensors."""
    _, k = jax.random.split(jt.key)
    k_perm, k_d, k_g = jax.random.split(k, 3)
    nb, b, n_items = jt.num_batches, jt.cfg.batch_size, jt.model.num_items
    batches = np.asarray(jax_sample_pair_epoch(k_perm, jt.data.num_pairs, b, nb))
    d_u = np.stack([np.asarray(jax.random.uniform(kk, (b, n_items), minval=1e-20, maxval=1.0))
                    for kk in jax.random.split(k_d, nb)])
    mix, g_u, g_idx = [], [], []
    for kk in jax.random.split(k_g, nb):
        k1, k2, k3 = jax.random.split(kk, 3)
        mix.append(np.asarray(jax.random.bernoulli(k1, jt.model.sample_lambda, (b, S))))
        g_u.append(np.asarray(jax.random.uniform(k2, (b, S, n_items), minval=1e-20,
                                                 maxval=1.0)))
        g_idx.append(np.asarray(jax.random.randint(k3, (b, S), 0, jnp.iinfo(jnp.int32).max)))
    return tuple(torch.from_numpy(np.asarray(x)) for x in
                 (batches.astype(np.int64), d_u, np.stack(mix), np.stack(g_u),
                  np.stack(g_idx).astype(np.int64)))


def tree_close(got, want, label, tol=1e-6):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=tol * scale, err_msg=label)


def grads_of(loss_fn, params):
    prm = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(prm)
    return float(loss.detach()), dict(zip(prm, torch.autograd.grad(loss, list(prm.values()))))


def step_inputs(jd, seed):
    """Users and positives [B] with a duplicate user and a duplicate
    positive."""
    rng = np.random.default_rng(seed)
    u = rng.integers(1, jd.num_users, B).astype(np.int32)
    pos = rng.integers(1, jd.num_items, B).astype(np.int32)
    u[5], pos[6] = u[0], pos[1]
    return u, pos


@pytest.mark.parametrize("pairwise_d", [False, True], ids=["pointwise", "pairwise"])
def test_d_loss_and_gradients_match_jax(pairwise_d):
    jd = synthetic_data(seed=3)
    jm = JaxIRGAN(jd.num_users, jd.num_items, 8, pairwise_d=pairwise_d)
    tm = IRGAN(jd.num_users, jd.num_items, 8, pairwise_d=pairwise_d)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = to_port(jp)
    u, pos = step_inputs(jd, 0)
    fake = np.random.default_rng(1).integers(1, jd.num_items, B).astype(np.int32)
    fns = jax_losses(jm)
    lam_d = jm.lamda_d / B
    if pairwise_d:
        want = jax.value_and_grad(fns["d_pair_loss_fn"])(jp["d"], u, pos, fake)
    else:
        labels = np.r_[np.ones(B), np.zeros(B)].astype(np.float32)
        want = jax.value_and_grad(fns["d_loss_fn"])(jp["d"], np.r_[u, u], np.r_[pos, fake],
                                                    labels)
    t = [torch.from_numpy(x) for x in (u, pos, fake)]
    got = grads_of(lambda prm: tm.d_loss(prm, *t, lam_d), tp["d"])
    np.testing.assert_allclose(got[0], float(want[0]), rtol=1e-6)
    tree_close(got[1], want[1], "d grads")


def test_g_samples_rewards_loss_and_gradients_match_jax():
    """G's step at JAX's draws: the samples (a user whose history has
    repeats included), the rewards, the loss and both gradient leaves."""
    jd = synthetic_data(seed=4)
    jm = JaxIRGAN(jd.num_users, jd.num_items, 8, lamda_g=0.3)
    tm = IRGAN(jd.num_users, jd.num_items, 8, lamda_g=0.3)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = to_port(jp)
    u, _ = step_inputs(jd, 2)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    mix = np.asarray(jax.random.bernoulli(k1, 0.2, (B, S)))
    noise = np.array(jax.random.uniform(k2, (B, S, jd.num_items), minval=1e-20, maxval=1.0))
    idx = np.array(jax.random.randint(k3, (B, S), 0, jnp.iinfo(jnp.int32).max))
    mix = np.array(mix)
    # the JAX g_step's arithmetic (acf_tpu/models/irgan.py:186-223) on the draws
    fns = jax_losses(jm)
    hist = jd.hist[u]
    prob = jax.nn.softmax(fns["g_row_logits"](jp["g"], u), axis=-1)
    hist_len = jnp.maximum(jnp.sum(hist != 0, -1, keepdims=True), 1)
    cat = jnp.argmax(jnp.log(jnp.maximum(prob, 1e-20))[:, None, :]
                     - jnp.log(-jnp.log(noise)), axis=-1)
    pick = jnp.take_along_axis(hist, hist.shape[1] - 1 - (idx % hist_len), axis=1)
    sample = jnp.where(mix, pick, cat).astype(jnp.int32)
    p_i = jnp.take_along_axis(prob, sample, axis=1)
    mult = jnp.sum(sample[:, :, None] == hist[:, None, :], -1)
    pn_i = 0.8 * p_i + 0.2 / hist_len * mult
    d_scores = jnp.sum(jp["d"]["P"][u][:, None, :] * jp["d"]["Q"][sample], -1)
    reward = 2.0 * (jax.nn.sigmoid(d_scores) - 0.5) * p_i / jnp.maximum(pn_i, 1e-20)
    assert int(mix.sum()) > 0 and int((mult > 1).sum()) > 0

    tu = torch.from_numpy(u)
    t_sample, t_reward = tm.g_samples(tp["g"], tp["d"], tu, torch.from_numpy(hist),
                                      torch.from_numpy(mix), torch.from_numpy(noise),
                                      torch.from_numpy(idx))
    np.testing.assert_array_equal(t_sample.numpy(), np.asarray(sample))
    np.testing.assert_allclose(t_reward.numpy(), np.asarray(reward), rtol=1e-6, atol=1e-9)
    lam_g = jm.lamda_g / B
    want = jax.value_and_grad(fns["g_loss_fn"])(jp["g"], jp["d"], u, sample, reward)
    got = grads_of(lambda prm: tm.g_loss(prm, tu, t_sample, t_reward, lam_g), tp["g"])
    np.testing.assert_allclose(got[0], float(want[0]), rtol=1e-6)
    tree_close(got[1], want[1], "g grads")
    assert float(got[1]["Q"][0].abs().max()) == 0.0  # the pad column passes no gradient


def test_d_fakes_match_jax():
    jd = synthetic_data(seed=5)
    jm, tm = JaxIRGAN(jd.num_users, jd.num_items, 8), IRGAN(jd.num_users, jd.num_items, 8)
    jp = jm.init_params(jax.random.PRNGKey(2))
    u, _ = step_inputs(jd, 3)
    noise = np.array(jax.random.uniform(jax.random.PRNGKey(6), (B, jd.num_items),
                                          minval=1e-20, maxval=1.0))
    logits = jax_losses(jm)["g_row_logits"](jp["g"], u) / jm.temperature
    want = jnp.argmax(logits - jnp.log(-jnp.log(noise)), axis=-1)
    got = tm.d_fakes(to_port(jp)["g"], torch.from_numpy(u), torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) >= 1


@pytest.mark.parametrize("pairwise_d", [False, True], ids=["pointwise", "pairwise"])
def test_epochs_match_the_jax_trainer(pairwise_d):
    """Two epochs, each with the JAX epoch's draws injected: both players'
    tables and the epoch's stats after each."""
    jt, tt = pair(33, pairwise_d=pairwise_d)
    assert tt.num_batches == jt.num_batches
    for epoch in range(2):
        draws = jax_epoch_draws(jt)
        js = jt.run_epoch()
        tt.params, tt.opt_state, ts = tt.epoch_fn(tt.params, tt.opt_state, tt.dev,
                                                  tt.generator, *draws)
        assert set(ts) == set(js) == {"loss", "d_loss", "acc"} and ts["acc"] == 0.0
        np.testing.assert_allclose(ts["d_loss"], js["d_loss"], rtol=1e-5)
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5, atol=G_LOSS_ATOL)
        for side in ("g", "d"):
            for name in ("P", "Q"):
                np.testing.assert_allclose(tt.params[side][name].numpy(),
                                           np.asarray(jt.params[side][name]), **EPOCH_TOL,
                                           err_msg=f"epoch {epoch} {side}/{name}")
    assert tt.opt_state == {"g": {}, "d": {}}


def test_pad_item_gets_no_mass():
    """The IRGAN half of ``tests/test_gan_models.py::test_gan_pad_item_gets_no_mass``:
    after three epochs drawn from the trainer's generator, the pad rows of
    both players' item tables keep their init bits."""
    data = port_data(synthetic_data(seed=15))
    tr = Trainer(IRGAN(data.num_users, data.num_items, 8), data, sgd(0.001), config())
    q0 = {side: tr.params[side]["Q"][0].clone() for side in ("g", "d")}
    moved = {side: tr.params[side]["Q"][1:].clone() for side in ("g", "d")}
    for _ in range(3):
        stats = tr.run_epoch()
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["d_loss"])
    for side in ("g", "d"):
        assert torch.equal(tr.params[side]["Q"][0], q0[side]), side
        assert not torch.equal(tr.params[side]["Q"][1:], moved[side]), side


def test_generator_rank_positions_match_jax():
    """Evaluation ranks with the generator through the factored path (K1's
    plain version on the CPU: no launch): positions equal to the JAX
    evaluator's, the metrics too; scoring and the reporting loss."""
    jd = synthetic_data(seed=21)
    jm, tm = JaxIRGAN(jd.num_users, jd.num_items, 8), IRGAN(jd.num_users, jd.num_items, 8)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tp = to_port(jp)
    ev, jev = FullRankEvaluator(port_data(jd), device=CPU), JaxEvaluator(jd)
    fs, jfs = tm.factored_scorer(), jm.factored_scorer()
    np.testing.assert_array_equal(ev.positions_factored(fs[0], fs[1], tp),
                                  jev.positions_factored(jfs[0], jfs[1], jp, interpret=True))
    got, want = ev.evaluate_model(tm, tp), jev.evaluate_model(jm, jp)
    np.testing.assert_allclose(got.at_k(10), want.at_k(10), rtol=1e-6)
    assert rank_positions_dot.launches == 0
    rng = np.random.default_rng(0)
    users = rng.integers(1, jd.num_users, 16).astype(np.int32)
    items = rng.integers(1, jd.num_items, (16, 3)).astype(np.int32)
    np.testing.assert_allclose(tm.score_all(tp, torch.from_numpy(users), None).numpy(),
                               np.asarray(jm.score_all(jp, users, None)), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        tm.score_some(tp, torch.from_numpy(users), None, torch.from_numpy(items)).numpy(),
        np.asarray(jm.score_some(jp, users, None, items)), rtol=1e-6, atol=1e-9)
    batch = (users, items[:, 1], items[:, 2])
    tl, taux = tm.loss(tp, tuple(map(torch.from_numpy, batch)))
    jl, jaux = jm.loss(jp, batch, None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(taux["acc"]) == float(jaux["acc"])


def test_init_params_and_opt_state():
    model = IRGAN(50, 30, 8)
    p = model.init_params(torch.Generator().manual_seed(0), device=CPU)
    for side in ("g", "d"):
        assert p[side]["P"].shape == (50, 8) and p[side]["Q"].shape == (30, 8)
        for leaf in p[side].values():
            assert leaf.dtype == torch.float32 and float(leaf.abs().max()) <= 0.05
    assert not torch.equal(p["g"]["P"], p["d"]["P"])
    assert model.init_opt_state(sgd(0.1), p) == {"g": {}, "d": {}}
    assert model.uses_full_hist
