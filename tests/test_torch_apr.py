"""APR, DNS and pointwise MF in the port (``acf_tpu_torch/models/mf.py``,
the pair trainer of ``acf_tpu_torch/train/trainer.py``) on the CPU against
the JAX package's (modelled on ``tests/test_mf.py`` and
``tests/test_trainer.py``): the same numpy params and batches go through
both, carried across by ``acf_tpu_torch/compat/jax_params.py``.

Tolerances:

* one loss, its aux and its gradients (``TOL``): rtol 1e-5, atol 1e-7. Both
  sides run the same f32 operations; sums (autograd's against XLA's
  scatter-adds over duplicate rows, the equality-matrix products) round in
  another order, by a few ulps of values of order 1.
* the FGSM deltas: atol 1e-6 on rows of norm ε = 0.5 (a few ulps of a
  normalized row).
* epochs: rtol 1e-5, atol 1e-8, as ``tests/test_torch_pair_trainer.py``:
  XLA's CPU ``rsqrt`` in optax's Adagrad is not correctly rounded and differs
  from ``torch.rsqrt`` in the last bit for about a third of the inputs, so
  updates differ by an ulp. APR's params get atol 1e-5 of the table's
  largest entry (``APR_PARAM_ATOL``) instead: FGSM normalizes each row's
  gradient, so an ulp of a small row's gradient turns its delta by ulp/|g|,
  and over two epochs the JAX package's own closed form and autodiff drift
  apart by up to 2.4e-6 of that scale (the port from JAX by up to 3.8e-6).
  The Adagrad slots keep rtol 1e-5.
* ``acc`` and ``acc_adv``: exact (a share of signs of scores that differ by
  far more than rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu.models.mf import PointwiseMF as JaxPointwiseMF
from acf_tpu.sampling.negatives import sample_pair_epoch as jax_sample_pair_epoch
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.models.base import row_normalize
from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
from acf_tpu_torch.ops.ranking import rank_positions_dot
from acf_tpu_torch.train import TrainConfig, Trainer, adagrad, fit_two_phase
from acf_tpu_torch.train.trainer import make_pair_epoch_fn
from acf_tpu_torch.utils.io import OutputWriter
from tests.test_torch_pair_trainer import ROUNDS, config, port_data
from tests.test_trainer import synthetic_data

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-7)
DELTA_ATOL = 1e-6
EPOCH_TOL = dict(rtol=1e-5, atol=1e-8)
APR_PARAM_ATOL = 1e-5
U, I, D = 20, 30, 8


def batch_with_duplicates(seed=0, b=16):
    """(users, pos, neg) int32 with duplicate users, duplicate items and an
    item that is the positive of one row and the negative of another (as
    ``tests/test_mf.py::test_manual_apr_grads_match_autodiff``)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(1, U, size=b).astype(np.int32)
    i = rng.integers(1, I, size=b).astype(np.int32)
    j = rng.integers(1, I, size=b).astype(np.int32)
    u[3] = u[0]
    u[7] = u[0]
    i[5] = i[1]
    j[2] = i[4]
    j[6] = j[1]
    return u, i, j


def both(jax_cls, port_cls, seed=0, **kw):
    """The JAX and port models with the JAX init's params in both forms."""
    jm, tm = jax_cls(U, I, D, **kw), port_cls(U, I, D, **kw)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


def port_value_and_grads(model, params, batch, **kw):
    prm = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, aux = model.loss(prm, batch, **kw)
    gP, gQ = torch.autograd.grad(loss, (prm["P"], prm["Q"]))
    assert prm["P"].grad is None and prm["Q"].grad is None  # nothing leaked into .grad
    return float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()}, {"P": gP, "Q": gQ}


def assert_loss_aux_grads(jax_out, port_out):
    (jl, jaux), jg = jax_out
    tl, taux, tg = port_out
    np.testing.assert_allclose(tl, float(jl), **TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        if k.startswith("acc"):
            assert taux[k] == float(jaux[k]), k
        else:
            np.testing.assert_allclose(taux[k], float(jaux[k]), **TOL, err_msg=k)
    for k in ("P", "Q"):
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_apr_loss_aux_and_gradients_match_jax(reg):
    jm, tm, jp, tp = both(JaxMFBPR, MFBPR, adversarial=True, reg=reg)
    u, i, j = batch_with_duplicates()
    want = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, (jnp.asarray(u), jnp.asarray(i), jnp.asarray(j)), jax.random.PRNGKey(1))
    got = port_value_and_grads(tm, tp, tuple(map(torch.from_numpy, (u, i, j))))
    assert set(got[1]) == {"loss", "acc", "loss_adv", "acc_adv"}
    assert_loss_aux_grads(want, got)
    assert got[1]["loss_adv"] > got[1]["loss"]  # the perturbation raises the loss


@pytest.mark.parametrize("reg", [0.0, 0.3])
def test_closed_form_matches_jax_and_autograd(reg):
    """``manual_grads`` against JAX's ``_apr_manual_grads`` and against the
    port's autograd of the APR loss (``tests/test_mf.py:151``), with
    duplicate users and items and a pos/neg collision."""
    jm, tm, jp, tp = both(JaxMFBPR, MFBPR, adversarial=True, reg=reg)
    u, i, j = batch_with_duplicates(seed=3)
    jg, jaux = jm.manual_grads(jp, (jnp.asarray(u), jnp.asarray(i), jnp.asarray(j)),
                               jax.random.PRNGKey(1))
    batch = tuple(map(torch.from_numpy, (u, i, j)))
    assert tm.manual_grads is not None
    tg, taux = tm.manual_grads(tp, batch)
    _, ad_aux, ad_g = port_value_and_grads(tm, tp, batch)
    for k in ("P", "Q"):
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **TOL, err_msg=k)
        np.testing.assert_allclose(tg[k].numpy(), ad_g[k].numpy(), **TOL, err_msg=k)
    for k in ("loss", "acc", "loss_adv", "acc_adv"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **TOL, err_msg=k)
        np.testing.assert_allclose(float(taux[k]), ad_aux[k], **TOL, err_msg=k)
    # untouched rows get no gradient
    untouched = sorted(set(range(U)) - set(u.tolist()))
    assert float(tg["P"][untouched].abs().max()) == 0.0


def test_closed_form_gate():
    """``manual_grads`` exists only for grad-mode single-step APR, and the
    pair epoch takes it only up to ``manual_grads_max_batch``
    (``tests/test_mf.py:179``; ``acf_tpu/train/trainer.py:100-116``)."""
    assert MFBPR(5, 5, 4, adversarial=True).manual_grads is not None
    assert MFBPR(5, 5, 4).manual_grads is None
    assert MFBPR(5, 5, 4, adversarial=True, adv_mode="random").manual_grads is None
    assert MFBPR(5, 5, 4, adversarial=True, adv_steps=3).manual_grads is None
    data = port_data(6)
    for cap, closed in ((4096, True), (32, True), (31, False)):
        model = MFBPR(data.num_users, data.num_items, 8, adversarial=True,
                      manual_grads_max_batch=cap)
        calls = []
        real = model._apr_manual_grads
        model._apr_manual_grads = lambda *a: calls.append(1) or real(*a)
        tr = Trainer(model, data, adagrad(0.05), config())
        stats = tr.run_epoch()
        assert len(calls) == (tr.num_batches if closed else 0), cap
        assert set(stats) == {"loss", "acc", "loss_adv", "acc_adv"}


@pytest.mark.parametrize("adv_steps", [1, 3])
def test_fgsm_deltas_match_jax(adv_steps):
    """The delta tables at one FGSM step and at three PGD steps
    (``tests/test_mf.py:123``): rows inside the ε-ball, untouched rows 0."""
    jm, tm, jp, tp = both(JaxMFBPR, MFBPR, adversarial=True, adv_steps=adv_steps)
    u, i, j = batch_with_duplicates(seed=4)
    jd = jm.fgsm_deltas(jp, jnp.asarray(u), jnp.asarray(i), jnp.asarray(j))
    td = tm.fgsm_deltas(tp, *map(torch.from_numpy, (u, i, j)))
    for name, a, b in zip("PQ", td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=DELTA_ATOL,
                                   err_msg=name)
        assert float(torch.linalg.vector_norm(a, dim=1).max()) <= tm.eps + 1e-6
    untouched = sorted(set(range(U)) - set(u.tolist()))
    assert float(td[0][untouched].abs().max()) == 0.0
    if adv_steps == 3:
        one = MFBPR(U, I, D, adversarial=True).fgsm_deltas(tp, *map(torch.from_numpy, (u, i, j)))
        assert not torch.allclose(one[0], td[0])


def test_loss_holds_the_deltas_constant():
    """The gradient of ``loss`` treats the FGSM deltas as constants (JAX's
    ``stop_gradient``): it equals the gradient of the same objective with
    the tables of ``fgsm_deltas`` fed in as fixed inputs."""
    from acf_tpu_torch.models.base import bpr_pair_loss

    _, tm, _, tp = both(JaxMFBPR, MFBPR, adversarial=True, reg=0.01)
    users, pos, neg = map(torch.from_numpy, batch_with_duplicates(seed=5))
    dP, dQ = tm.fgsm_deltas(tp, users, pos, neg)
    assert not dP.requires_grad and not dQ.requires_grad
    prm = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    clean, reg_term, _, _ = tm._clean_loss(prm, users, pos, neg)
    pos_a, _, _ = tm._pair_scores(prm, users, pos, dP, dQ)
    neg_a, _, _ = tm._pair_scores(prm, users, neg, dP, dQ)
    want = clean + 2 * tm.reg * reg_term + tm.reg_adv * bpr_pair_loss(pos_a, neg_a)
    want_g = torch.autograd.grad(want, (prm["P"], prm["Q"]))
    loss, _, grads = port_value_and_grads(tm, tp, (users, pos, neg))
    np.testing.assert_allclose(loss, float(want), **TOL)
    for k, b in zip("PQ", want_g):
        np.testing.assert_allclose(grads[k].numpy(), b.numpy(), **TOL, err_msg=k)


def test_row_normalize_keeps_zero_rows_zero():
    """``tests/test_mf.py:86`` on the port's ``row_normalize``."""
    out = row_normalize(torch.tensor([[0.0, 0.0], [3.0, 4.0]]))
    np.testing.assert_allclose(out[0].numpy(), [0.0, 0.0])
    np.testing.assert_allclose(out[1].numpy(), [0.6, 0.8], rtol=1e-6)


@pytest.mark.parametrize("adv_steps", [1, 3])
def test_table_path_loss_matches_jax(adv_steps):
    """``loss`` through the ``fgsm_deltas`` tables at one step and at three:
    loss, aux and gradients against JAX's."""
    jm, tm, jp, tp = both(JaxMFBPR, MFBPR, adversarial=True, adv_steps=adv_steps, reg=0.01)
    u, i, j = batch_with_duplicates(seed=6)
    want = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, (jnp.asarray(u), jnp.asarray(i), jnp.asarray(j)), jax.random.PRNGKey(1))
    assert_loss_aux_grads(want, port_value_and_grads(tm, tp, tuple(map(torch.from_numpy,
                                                                        (u, i, j)))))


def test_random_mode_with_jax_noise():
    """``adv_mode="random"``: the loss of JAX's model at a key against the
    port's with the noise that key draws (``acf_tpu/models/mf.py:120-125``)
    injected; the port's own draws from a generator stay inside the ε-ball."""
    jm, tm, jp, tp = both(JaxMFBPR, MFBPR, adversarial=True, adv_mode="random")
    u, i, j = batch_with_duplicates(seed=7)
    key = jax.random.PRNGKey(11)
    want = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, (jnp.asarray(u), jnp.asarray(i), jnp.asarray(j)), key)
    kp, kq = jax.random.split(key)
    noise = tuple(torch.from_numpy(np.array(
        0.01 * jax.random.truncated_normal(k, -2.0, 2.0, shape, jnp.float32)))
        for k, shape in ((kp, (U, D)), (kq, (I, D))))
    batch = tuple(map(torch.from_numpy, (u, i, j)))
    assert_loss_aux_grads(want, port_value_and_grads(tm, tp, batch, noise=noise))
    dP, dQ = tm.fgsm_deltas(tp, *batch, generator=torch.Generator().manual_seed(0))
    for d in (dP, dQ):
        np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=1).numpy(), tm.eps, rtol=1e-5)


def test_pointwise_mf_loss_matches_jax():
    """The mean BCE over the 2B pointwise examples (``tests/test_mf.py:93``)
    and its gradients against JAX's; ``adv_encoders`` gathers the rows."""
    jm, tm, jp, tp = both(JaxPointwiseMF, PointwiseMF)
    u, i, j = batch_with_duplicates(seed=8)
    want = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, (jnp.asarray(u), jnp.asarray(i), jnp.asarray(j)), jax.random.PRNGKey(0))
    got = port_value_and_grads(tm, tp, tuple(map(torch.from_numpy, (u, i, j))))
    assert_loss_aux_grads(want, got)
    P, Q = np.asarray(jp["P"]), np.asarray(jp["Q"])
    logits = np.concatenate([(P[u] * Q[i]).sum(-1), (P[u] * Q[j]).sum(-1)])
    labels = np.r_[np.ones(len(u)), np.zeros(len(u))]
    np.testing.assert_allclose(got[0], np.mean(np.logaddexp(0, logits) - labels * logits),
                               rtol=1e-5)
    for model in (tm, MFBPR(U, I, D)):
        enc = model.adv_encoders()
        assert set(enc) == {"u", "i"} and enc["u"][0] == "user" and enc["i"][2] == D
        ids = torch.tensor([1, 2])
        torch.testing.assert_close(enc["i"][1](tp, ids), tp["Q"][ids], rtol=0, atol=0)


def jax_pair_draws(jt, dns=1):
    """The draws the JAX trainer's next pair epoch makes
    (acf_tpu/train/trainer.py:118-139): the batches and, per step, the
    negative candidates of ``kn, kl = split(step key)``; with DNS, ``kn``
    split into ``dns`` keys, each one ``randint((R, B))``: [nb, dns, R, B]."""
    _, k = jax.random.split(jt.key)
    k_perm, k_steps = jax.random.split(k)
    nb, b = jt.num_batches, jt.cfg.batch_size
    batches = np.asarray(jax_sample_pair_epoch(k_perm, jt.data.num_pairs, b, nb))

    def rounds(kk):
        return np.asarray(jax.random.randint(kk, (ROUNDS, b), 1, jt.model.num_items,
                                             dtype=jnp.int32))

    cands = []
    for kk in jax.random.split(k_steps, nb):
        kn = jax.random.split(kk)[0]
        cands.append(rounds(kn) if dns <= 1
                     else np.stack([rounds(x) for x in jax.random.split(kn, dns)]))
    return torch.from_numpy(batches.astype(np.int64)), torch.from_numpy(np.stack(cands))


def run_against_jax_trainer(jax_model, port_model, epochs, dns=1, seed=5):
    """``epochs`` epochs of the JAX trainer and of the port's epoch function
    with the JAX draws injected, from the same params: the stats, params and
    Adagrad slots after each."""
    jd = synthetic_data(seed=seed)
    jt = JaxTrainer(jax_model, jd, optax.adagrad(0.05, initial_accumulator_value=0.1),
                    JaxConfig(batch_size=32, verbose=10 ** 9))
    td = port_data(seed)
    tt = Trainer(port_model, td, adagrad(0.05, initial_accumulator_value=0.1), config())
    assert tt.num_batches == jt.num_batches
    tt.params = params_from_numpy(jax.tree.map(np.asarray, jt.params), device=CPU)
    for epoch in range(epochs):
        draws = jax_pair_draws(jt, dns)
        js = jt.run_epoch()
        tt.params, tt.opt_state, ts = tt.epoch_fn(tt.params, tt.opt_state, tt.dev,
                                                  tt.generator, *draws)
        assert set(ts) == set(js)
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"epoch {epoch} {k}")
        for name in ("P", "Q"):
            want = np.asarray(jt.params[name])
            atol = (APR_PARAM_ATOL * float(np.abs(want).max()) if port_model.adversarial
                    else EPOCH_TOL["atol"])
            np.testing.assert_allclose(tt.params[name].numpy(), want, rtol=EPOCH_TOL["rtol"],
                                       atol=atol, err_msg=f"epoch {epoch} {name}")
            np.testing.assert_allclose(tt.opt_state["sum_of_squares"][name].numpy(),
                                       np.asarray(jt.opt_state[0].sum_of_squares[name]),
                                       **EPOCH_TOL, err_msg=f"epoch {epoch} acc {name}")
    return jt, tt


@pytest.mark.parametrize("path", ["closed_form", "autograd"])
@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_apr_epochs_match_the_jax_trainer(path, reg):
    """Two APR epochs (the JAX trainer takes its closed form at batch 32)
    against the port's epoch on its closed form, and on autograd (its cap
    below the batch), with JAX's draws injected."""
    jd = synthetic_data(seed=5)
    cap = 4096 if path == "closed_form" else 16
    run_against_jax_trainer(
        JaxMFBPR(jd.num_users, jd.num_items, 8, adversarial=True, reg=reg),
        MFBPR(jd.num_users, jd.num_items, 8, adversarial=True, reg=reg,
              manual_grads_max_batch=cap), epochs=2)


@pytest.mark.parametrize("adversarial", [False, True])
def test_dns_epoch_matches_the_jax_trainer(adversarial):
    """One DNS epoch (``dns=3``): per step three rejection-sampled negatives,
    the one the step's params score highest kept."""
    jd = synthetic_data(seed=7)
    run_against_jax_trainer(
        JaxMFBPR(jd.num_users, jd.num_items, 8, dns=3, adversarial=adversarial),
        MFBPR(jd.num_users, jd.num_items, 8, dns=3, adversarial=adversarial),
        epochs=1, dns=3, seed=7)


def test_dns_takes_the_highest_scored_candidate_first_on_ties():
    from acf_tpu_torch.train.trainer import dns_negatives

    model = MFBPR(4, 6, 2)
    params = {"P": torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
              "Q": torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [0.0, 3.0],
                                 [2.0, 0.0], [0.0, 0.0]])}
    users = torch.tensor([1, 2, 0])
    cands = torch.tensor([[1, 2, 4], [1, 3, 2], [5, 1, 3]], dtype=torch.int32)
    got = dns_negatives(model, params, users, None, cands)
    assert got.tolist() == [2, 3, 5]  # user 1: items 2 and 4 tie, the first; user 0: all tie


def test_pair_epoch_draws_dns_and_random_mode_from_its_generator():
    """Without injected draws DNS and random-mode epochs repeat under one
    seed, and PointwiseMF trains."""
    data = port_data(3)
    for model in (MFBPR(data.num_users, data.num_items, 8, dns=3),
                  MFBPR(data.num_users, data.num_items, 8, adversarial=True, adv_mode="random"),
                  PointwiseMF(data.num_users, data.num_items, 8)):
        runs = []
        for _ in range(2):
            tr = Trainer(model, data, adagrad(0.1), config(seed=5))
            stats = tr.run_epoch()
            runs.append(tr.params)
            assert all(np.isfinite(v) for v in stats.values())
        assert all(torch.equal(runs[0][k], runs[1][k]) for k in ("P", "Q"))
    epoch = make_pair_epoch_fn(MFBPR(5, 5, 4, dns=2), adagrad(0.1), 32, 2)
    assert callable(epoch)


def test_fit_two_phase_clean_then_apr(tmp_path):
    """The README quick start's protocol: clean MF-BPR epochs, then APR with
    the Adagrad slots reset; each epoch line carries its own ACC_adv in the
    APR phase, the evaluation runs through K1's plain version on the CPU
    (no launch counted), and APR keeps the ranking learned."""
    data = port_data(1)
    clean = MFBPR(data.num_users, data.num_items, 8)
    adv = MFBPR(data.num_users, data.num_items, 8, adversarial=True, eps=0.5, reg_adv=1.0)
    seen = []
    real = Trainer.switch_model

    def switch_model(self, model, reset_opt=True):
        real(self, model, reset_opt)
        seen.append({k: v.clone() for k, v in self.opt_state["sum_of_squares"].items()})

    Trainer.switch_model = switch_model
    try:
        best = fit_two_phase(clean, adv, data, adagrad(0.1, initial_accumulator_value=0.1),
                             TrainConfig(batch_size=32, epochs=30, verbose=5, device=CPU,
                                         ckpt_path=str(tmp_path / "ck")),
                             adv_epoch=15, writer=OutputWriter(str(tmp_path), "apr", quiet=True))
    finally:
        Trainer.switch_model = real
    assert len(seen) == 1 and all(float(v.min()) == float(v.max()) == pytest.approx(0.1)
                                  for v in seen[0].values())  # slots reset at the switch
    assert rank_positions_dot.launches == 0
    lines = (tmp_path / "apr.out").read_text().splitlines()
    epochs = [ln for ln in lines if ln.startswith("Epoch ") and "HR =" in ln]
    assert [int(ln.split()[1]) for ln in epochs] == [0, 5, 10, 15, 20, 25]

    def accs(line):
        part = line.split("ACC = ")[1]
        return float(part.split()[0]), float(part.split("ACC_adv = ")[1].split()[0])

    assert all(a == b for a, b in map(accs, epochs[:3]))  # clean: no adversarial term
    assert all(a != b for a, b in map(accs, epochs[3:]))  # APR: its own accuracy
    assert best["epoch"] >= 15 and best["ndcg"] > 0.10  # as tests/test_trainer.py:43
    assert (tmp_path / "ck-pretrain.npz").exists() and (tmp_path / "ck-final.npz").exists()
