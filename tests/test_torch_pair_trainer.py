"""The port's pair trainer (``acf_tpu_torch/train/trainer.py``) and pair
sampler (``acf_tpu_torch/sampling/negatives.py``) on the CPU against the JAX
package's: the shuffled batches and the negatives with JAX's draws injected
(equal exactly: integer arithmetic), an MF-BPR clean epoch against the JAX
``Trainer`` with its draws injected, ``membership_len``, ``switch_model``
and ``fit_two_phase`` for pair models, and snapshots of Adagrad's and APL's
optimizer states (modelled on ``tests/test_trainer.py`` and
``tests/test_sampling.py``).

Epoch tolerance: rtol 1e-5, atol 1e-8. Both sides run the same f32
operations, but XLA's CPU ``rsqrt`` in optax's Adagrad is not correctly
rounded and differs from ``torch.rsqrt`` in the last bit for about a third
of the inputs (``tests/test_torch_optim.py``), so updates differ by an ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.models.apl import APL as JaxAPL
from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu.sampling.negatives import sample_pair_epoch as jax_sample_pair_epoch
from acf_tpu.sampling.negatives import uniform_negatives as jax_uniform_negatives
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu.train.checkpoint import save_params as jax_save_params
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.apl import APL
from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
from acf_tpu_torch.sampling import (
    negatives_from_draws, pair_batches_from_perm, sample_pair_epoch, uniform_negatives,
)
from acf_tpu_torch.train import TrainConfig, Trainer, adagrad, fit_two_phase, sgd
from acf_tpu_torch.train.trainer import make_pair_epoch_fn
from tests.test_trainer import synthetic_data

CPU = "cpu"
ROUNDS = 8


def port_data(seed=0):
    return Interactions(**dataclasses.asdict(synthetic_data(seed=seed)))


def config(**kw):
    return TrainConfig(batch_size=32, verbose=10 ** 9, device=CPU, **kw)


@pytest.mark.parametrize("num_pairs,batch,nb", [(100, 16, 6), (10, 16, 1), (7, 4, 3)])
def test_pair_batches_equal_jax_with_its_permutation(num_pairs, batch, nb):
    """Shuffled, wrapped when one epoch needs more indices than there are
    pairs, the remainder dropped."""
    key = jax.random.PRNGKey(num_pairs)
    want = np.asarray(jax_sample_pair_epoch(key, num_pairs, batch, nb))
    perm = np.array(jax.random.permutation(key, num_pairs))
    got = pair_batches_from_perm(torch.from_numpy(perm), batch, nb)
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = sample_pair_epoch(torch.Generator().manual_seed(0), num_pairs, batch, nb)
    assert drawn.shape == (nb, batch) and set(drawn.flatten().tolist()) <= set(range(num_pairs))
    if nb * batch <= num_pairs:
        assert len(set(drawn.flatten().tolist())) == nb * batch  # no repeats


def test_uniform_negatives_equal_jax_with_its_candidates():
    """The first clean round, else the last; a user whose candidates all
    collide keeps the last round's."""
    rng = np.random.default_rng(0)
    num_items = 12
    hist = np.zeros((40, 6), np.int32)
    for row in hist:
        n = rng.integers(0, 7)
        row[6 - n:] = rng.integers(1, num_items, n)
    hist[3] = [1, 2, 3, 4, 5, 6]
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_uniform_negatives(key, jnp.asarray(hist), num_items))
        cand = np.asarray(jax.random.randint(key, (ROUNDS, 40), 1, num_items, dtype=jnp.int32))
        got = negatives_from_draws(torch.from_numpy(cand), torch.from_numpy(hist))
        np.testing.assert_array_equal(got.numpy(), want)
    cand = np.full((ROUNDS, 40), 2, np.int32)
    cand[-1, 3] = 4
    got = negatives_from_draws(torch.from_numpy(cand), torch.from_numpy(hist))
    assert int(got[3]) == 4  # all collide: the last round
    drawn = uniform_negatives(torch.Generator().manual_seed(1), torch.from_numpy(hist), 200)
    assert drawn.dtype == torch.int32 and int(drawn.min()) >= 1 and int(drawn.max()) < 200
    for row, neg in zip(hist, drawn.tolist()):
        assert neg not in set(row.tolist())


def jax_pair_draws(jt):
    """The draws the JAX trainer's next pair epoch makes
    (acf_tpu/train/trainer.py:118-133): the batches and, per step, the
    negative candidates of ``kn, kl = split(step key)``."""
    _, k = jax.random.split(jt.key)
    k_perm, k_steps = jax.random.split(k)
    nb, b = jt.num_batches, jt.cfg.batch_size
    batches = np.asarray(jax_sample_pair_epoch(k_perm, jt.data.num_pairs, b, nb))
    cands = [np.asarray(jax.random.randint(jax.random.split(kk)[0], (ROUNDS, b), 1,
                                           jt.model.num_items, dtype=jnp.int32))
             for kk in jax.random.split(k_steps, nb)]
    return torch.from_numpy(batches.astype(np.int64)), torch.from_numpy(np.stack(cands))


@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_mfbpr_epochs_match_the_jax_trainer(reg):
    jd = synthetic_data(seed=5)
    jt = JaxTrainer(JaxMFBPR(jd.num_users, jd.num_items, 8, reg=reg), jd,
                    optax.adagrad(0.05, initial_accumulator_value=0.1),
                    JaxConfig(batch_size=32, verbose=10 ** 9))
    td = port_data(5)
    tt = Trainer(MFBPR(td.num_users, td.num_items, 8, reg=reg), td,
                 adagrad(0.05, initial_accumulator_value=0.1), config())
    assert tt.num_batches == jt.num_batches == jd.num_pairs // 32
    tt.params = params_from_numpy(jax.tree.map(np.asarray, jt.params), device=CPU)
    for epoch in range(2):
        draws = jax_pair_draws(jt)
        js = jt.run_epoch()
        tt.params, tt.opt_state, ts = tt.epoch_fn(tt.params, tt.opt_state, tt.dev,
                                                  tt.generator, *draws)
        assert set(ts) == set(js) == {"loss", "acc"}
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
        assert ts["acc"] == pytest.approx(js["acc"], abs=1e-7)
        for name in ("P", "Q"):
            np.testing.assert_allclose(tt.params[name].numpy(), np.asarray(jt.params[name]),
                                       rtol=1e-5, atol=1e-8, err_msg=f"epoch {epoch} {name}")
            np.testing.assert_allclose(tt.opt_state["sum_of_squares"][name].numpy(),
                                       np.asarray(jt.opt_state[0].sum_of_squares[name]),
                                       rtol=1e-5, err_msg=f"epoch {epoch} acc {name}")


def test_mfbpr_training_improves_ranking():
    """As tests/test_trainer.py::test_training_improves_ranking."""
    data = port_data()
    tr = Trainer(MFBPR(data.num_users, data.num_items, 8), data,
                 adagrad(0.1, initial_accumulator_value=0.1), config())
    before = tr.evaluate().at_k(10)
    for _ in range(40):
        stats = tr.run_epoch()
    after = tr.evaluate().at_k(10)
    assert after[1] > before[1] + 0.05, (before, after)
    assert stats["acc"] > 0.7


def test_membership_len_truncates_the_pair_sampler_not_apl():
    data = port_data(2)
    full = data.hist.shape[1]
    tr = Trainer(MFBPR(data.num_users, data.num_items, 8), data, adagrad(0.1),
                 config(membership_len=3))
    assert tuple(tr.dev["hist"].shape) == (data.num_users, 3)
    np.testing.assert_array_equal(tr.dev["hist"].numpy(), data.hist[:, -3:])
    tr.run_epoch()
    apl = Trainer(APL(data.num_users, data.num_items, 8), data, sgd(0.05),
                  config(membership_len=3))
    assert apl.dev["hist"].shape[1] == full  # uses_full_hist: the mixture reads it all


def test_switch_model_and_fit_two_phase_for_pair_models():
    """A pair model through ``switch_model`` (fresh or carried Adagrad
    slots) and ``fit_two_phase`` (clean, then a regularized MF-BPR); the
    switch to APR trains with its adversarial stats, and DNS and pointwise
    MF train (``tests/test_torch_apr.py`` holds them against the JAX
    package)."""
    data = port_data(1)
    clean = MFBPR(data.num_users, data.num_items, 8)
    regd = MFBPR(data.num_users, data.num_items, 8, reg=0.01)
    tr = Trainer(clean, data, adagrad(0.1), config())
    tr.run_epoch()
    acc = {k: v.clone() for k, v in tr.opt_state["sum_of_squares"].items()}
    tr.switch_model(regd, reset_opt=False)
    assert all(torch.equal(acc[k], tr.opt_state["sum_of_squares"][k]) for k in acc)
    tr.switch_model(regd, reset_opt=True)
    assert all(float(v.max()) == pytest.approx(0.1)
               for v in tr.opt_state["sum_of_squares"].values())
    tr.run_epoch()
    best = fit_two_phase(clean, regd, data, adagrad(0.1),
                         TrainConfig(batch_size=32, epochs=6, verbose=2, device=CPU),
                         adv_epoch=3)
    assert best["epoch"] >= 3 and best["ndcg"] > 0
    adv = MFBPR(data.num_users, data.num_items, 8, adversarial=True)
    tr.switch_model(adv)
    stats = tr.run_epoch()
    assert set(stats) == {"loss", "acc", "loss_adv", "acc_adv"}
    assert stats["loss_adv"] > stats["loss"]
    for model in (MFBPR(data.num_users, data.num_items, 8, dns=2),
                  PointwiseMF(data.num_users, data.num_items, 8)):
        stats = Trainer(model, data, adagrad(0.1), config()).run_epoch()
        assert set(stats) == {"loss", "acc"} and np.isfinite(stats["loss"])


def test_pair_epoch_draws_from_its_generator():
    """Without injected draws an epoch repeats under the same seed."""
    data = port_data(3)
    model = MFBPR(data.num_users, data.num_items, 8)
    runs = []
    for _ in range(2):
        tr = Trainer(model, data, adagrad(0.1), config(seed=5))
        tr.run_epoch()
        runs.append(tr.params)
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in ("P", "Q"))
    epoch = make_pair_epoch_fn(model, adagrad(0.1), 32, 2)
    assert callable(epoch)


@pytest.mark.parametrize("kind", ["mf", "apl"])
def test_snapshots_of_adagrad_and_apl_states(tmp_path, kind):
    """A full train state with Adagrad's slots (or APL's per-player SGD
    states, which hold none) restores exactly, and carries the JAX
    package's names."""
    data = port_data(4)
    if kind == "mf":
        tr = Trainer(MFBPR(data.num_users, data.num_items, 8), data, adagrad(0.1), config())
    else:
        tr = Trainer(APL(data.num_users, data.num_items, 8), data, sgd(0.05), config())
    tr.run_epoch()
    path = str(tmp_path / "state")
    tr.save_checkpoint(path)
    names = set(np.load(path + ".npz").files)
    if kind == "mf":
        assert {"opt/0/.sum_of_squares/P", "opt/0/.sum_of_squares/Q"} <= names
        jd = synthetic_data(seed=4)
        jt = JaxTrainer(JaxMFBPR(jd.num_users, jd.num_items, 8), jd, optax.adagrad(0.1),
                        JaxConfig(batch_size=32, verbose=10 ** 9))
        jax_path = str(tmp_path / "jax_state")
        jax_save_params(jax_path, {"params": jt.params, "opt": jt.opt_state})
        assert {n for n in np.load(jax_path + ".npz").files if n.startswith("opt/")} == \
            {n for n in names if n.startswith("opt/")}
    else:
        assert not any(n.startswith("opt/") for n in names)
        jd = synthetic_data(seed=4)
        jt = JaxTrainer(JaxAPL(jd.num_users, jd.num_items, 8), jd, optax.sgd(0.05),
                        JaxConfig(batch_size=32, verbose=10 ** 9))
        assert not [p for p, _ in jax.tree_util.tree_flatten_with_path(jt.opt_state)[0]]
    saved = jax.tree.map(np.asarray, (tr.params, tr.opt_state))
    expected = tr.run_epoch()
    after = jax.tree.map(np.asarray, tr.params)
    tr.restore_checkpoint(path)
    for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves((tr.params, tr.opt_state))):
        np.testing.assert_array_equal(np.asarray(b), a)
    again = tr.run_epoch()
    assert again == expected
    for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(tr.params)):
        np.testing.assert_array_equal(np.asarray(b), a)
