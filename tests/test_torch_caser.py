"""The port's Caser (``acf_tpu_torch/models/caser.py``) on the CPU against the
JAX package's (``acf_tpu/models/caser.py``): the init tree (its ``conv_h``
list in the JAX layout), the loss and every gradient with the JAX dropout
masks injected, scores and the factored user representation, rank
positions, the sliding windows (native and the tiny-data fallback), two
epochs of its own epoch function on the JAX draws, the FGSM wrapper, and
npz and full-state snapshots of its list-holding tree both ways.
Tolerances as ``tests/test_torch_rnn.py`` states them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.models.caser import Caser as JaxCaser
from acf_tpu.sampling.negatives import sample_pair_epoch as jax_pair_epoch
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu.train.checkpoint import load_params as jax_load_params
from acf_tpu.train.checkpoint import save_params as jax_save_params
from acf_tpu_torch.adversarial import FGSMAdversarial
from acf_tpu_torch.compat.jax_params import opt_state_to_numpy, params_from_numpy
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.caser import Caser
from acf_tpu_torch.train import TrainConfig, Trainer, adam
from acf_tpu_torch.train.checkpoint import _flatten_with_names, load_params, save_params
from acf_tpu_torch.train.trainer import make_seq_epoch_fn
from tests.test_sasrec import seq_data
from tests.test_torch_rnn import (
    CPU, ROUNDS, assert_fgsm_matches, assert_loss_and_grads, assert_positions_match,
    assert_scores_match, assert_trees_close, carry, seq_batch, t,
)
from tests.test_trainer import synthetic_data

D = 16
L = 5
KEEP = 0.5


def models(data, **kw):
    args = (data.num_users, data.num_items, D)
    return JaxCaser(*args, maxlen=L, **kw), Caser(*args, maxlen=L, **kw)


def port_data(jdata):
    return Interactions(**dataclasses.asdict(jdata))


def jax_mask(key, b, features=4 * D + 16 * L):
    """The keep-mask [b, features] of JAX's ``Caser.loss(..., key)``."""
    return np.asarray(jax.random.bernoulli(jax.random.split(key)[0], KEEP, (b, features)))


def window_batch(jm, data, b=16, seed=0):
    """(users, seq [B, L], pos [B, 3], neg [B, 3]) from JAX's windows."""
    dev = jm.extra_device_data(data)
    rng = np.random.default_rng(seed)
    idx = rng.choice(dev["win_seq"].shape[0], b, replace=False)
    neg = rng.integers(1, data.num_items, (b, jm.target_len)).astype(np.int32)
    return (np.asarray(dev["win_user"])[idx], np.asarray(dev["win_seq"])[idx],
            np.asarray(dev["win_pos"])[idx], neg)


def test_init_params_tree_matches_jax():
    """``conv_h`` is a list of L blocks whose kernels keep the JAX layout
    [l, d, n_h]; the embeddings and ``W2`` are normal(0, 1/d) and
    normal(0, 1/(2d))."""
    data = seq_data()
    jm, tm = models(data)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tm.init_params(torch.Generator().manual_seed(0), device=CPU)
    got = {n: tuple(x.shape) for n, x in _flatten_with_names(tp)}
    from acf_tpu.train.checkpoint import _flatten_with_names as jax_named
    assert got == {n: v.shape for n, v in jax_named(jp).items()}
    assert isinstance(tp["conv_h"], list) and got["conv_h/2/w"] == (3, D, 16)
    assert tm.num_features == 4 * D + 16 * L == tp["fc1_w"].shape[0]
    assert abs(float(tp["W2"].std()) - 1 / (2 * D)) < 0.1 / (2 * D)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_jax(seed):
    """The dropout mask of the JAX loss's key injected; windows whose
    targets are padded at the end of a sequence included."""
    data = seq_data(seed=seed)
    jm, tm = models(data)
    jp, tp = carry(jm, seed=seed)
    batch = window_batch(jm, data, seed=seed)
    key = jax.random.PRNGKey(seed + 5)
    mask = jax_mask(key, 16)
    assert np.isfinite(assert_loss_and_grads(jm, jp, tm, tp, batch, key, masks=t(mask)))


def test_scores_and_positions_match_jax():
    data = seq_data(seed=3)
    jm, tm = models(data)
    jp, tp = carry(jm, seed=2)
    assert_scores_match(jm, jp, tm, tp, data)
    assert_positions_match(jm, jp, tm, tp, data)


def test_windows_match_jax_native_and_fallback(monkeypatch):
    """The native windows equal the JAX package's (native and its Python
    loop); a dataset where no user has more than L items takes the
    padded-history fallback, as in the JAX package."""
    import acf_tpu.data.native_io as jax_native

    data = seq_data(seed=4)
    jm, tm = models(data)
    got = tm.extra_device_data(port_data(data))
    for native in (True, False):
        if not native:
            monkeypatch.setattr(jax_native, "caser_windows", lambda *a: None)
        ref = jm.extra_device_data(data)
        for k in ("win_seq", "win_user", "win_pos"):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=f"{native} {k}")
    assert len(got["win_user"]) == sum(max(int(n) - L, 0) for n in data.hist_len[1:])
    tiny = synthetic_data(seed=1)  # 7 train items a user
    jm, tm = (m(tiny.num_users, tiny.num_items, D, maxlen=9) for m in (JaxCaser, Caser))
    got, ref = tm.extra_device_data(port_data(tiny)), jm.extra_device_data(tiny)
    for k in ("win_seq", "win_user", "win_pos"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    assert got["win_seq"].shape == (tiny.num_users - 1, 9)


def jax_epoch_draws(jm, key, n_windows, batch_size, steps):
    """The draws of JAX's ``Caser.make_epoch_fn`` epoch: window batches,
    per step ``target_len`` negative candidate rounds and the dropout
    mask."""
    k_perm, k_steps = jax.random.split(key)
    batches = np.asarray(jax_pair_epoch(k_perm, n_windows, batch_size, steps))
    cands, masks = [], []
    for kk in jax.random.split(k_steps, steps):
        kn, kl = jax.random.split(kk)
        cands.append(np.stack([np.asarray(jax.random.randint(
            k, (ROUNDS, batch_size), 1, jm.num_items, dtype=jnp.int32))
            for k in jax.random.split(kn, jm.target_len)]))
        masks.append(jax_mask(kl, batch_size))
    return (torch.from_numpy(batches.astype(np.int64)), torch.from_numpy(np.stack(cands)),
            torch.from_numpy(np.stack(masks)))


@pytest.mark.parametrize("batch_size", [32, 300])
def test_two_epochs_of_its_epoch_match_jax(batch_size):
    """``max(n_windows // batch_size, 1)`` steps; at 200 there are fewer
    windows than a batch and the permutation wraps. Params and Adam moments
    after two epochs within 1e-5 of each tree's scale, the stats to 1e-5."""
    data = seq_data(seed=5)
    jm, tm = models(data)
    jt = JaxTrainer(jm, data, optax.adam(1e-2), JaxConfig(batch_size=batch_size,
                                                          verbose=10 ** 9))
    tr = Trainer(tm, port_data(data), adam(1e-2),
                 TrainConfig(batch_size=batch_size, verbose=10 ** 9, device=CPU))
    n_windows = int(tr.dev["win_seq"].shape[0])
    assert (n_windows < batch_size) == (batch_size == 300)
    steps = tr.epoch_fn.num_batches
    assert steps == max(n_windows // batch_size, 1)
    jp, js = jt.params, jt.opt_state
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    ts = tr.optimizer.init(tp)
    key = jax.random.PRNGKey(7)
    for _ in range(2):
        key, k = jax.random.split(key)
        (jp, js), jstats = jt.epoch_fn((jp, js), jt.dev, k)
        draws = jax_epoch_draws(jm, k, n_windows, batch_size, steps)
        tp, ts, stats = tr.epoch_fn(tp, ts, tr.dev, None, *draws)
        for name in jstats:
            np.testing.assert_allclose(stats[name], float(jstats[name]), rtol=1e-5, err_msg=name)
    assert_trees_close(tp, jp, 1e-5, "params")
    assert_trees_close(ts["mu"], js[0].mu, 1e-5, "mu")
    assert_trees_close(ts["nu"], js[0].nu, 1e-5, "nu")
    # drawn from the trainer's generator: finite, and the params move
    before = tr.params["W2"].clone()
    assert np.isfinite(tr.run_epoch()["loss"]) and not torch.equal(before, tr.params["W2"])


def test_fgsm_wrapper_matches_jax_and_trains_through_the_sequence_epoch():
    """The wrapper perturbs ``user_emb``, ``item_emb`` and ``W2``; the clean
    pass and its linearization share one mask, the perturbed pass has its
    own (the JAX wrapper's key split). Its own epoch is not delegated: the
    wrapped model trains on the sequence epoch's windows, as in the JAX
    package."""
    data = seq_data(seed=6)
    jm, tm = models(data)
    batch = seq_batch(data, L, b=16, seed=2)
    key = jax.random.PRNGKey(3)
    k_clean, k_adv = jax.random.split(key)
    masks, adv = (t(jax_mask(k, 16)) for k in (k_clean, k_adv))
    names = assert_fgsm_matches(jm, tm, batch, key=key, masks=masks, adv_masks=adv)
    assert names == ("W2", "item_emb", "user_emb")
    U, I = data.num_users, data.num_items
    wrapped = FGSMAdversarial(U, I, D, base=Caser(U, I, D, maxlen=L))
    assert not hasattr(wrapped, "make_epoch_fn") and wrapped.batch_kind == "seq"
    tr = Trainer(wrapped, port_data(data), adam(1e-3),
                 TrainConfig(batch_size=16, verbose=10 ** 9, device=CPU))
    assert tr.epoch_fn.__qualname__.startswith(make_seq_epoch_fn.__name__)
    stats = tr.run_epoch()
    assert {"loss", "acc", "loss_adv", "acc_adv"} <= set(stats)
    assert all(np.isfinite(v) for v in stats.values())


def test_npz_and_snapshots_round_trip_both_ways(tmp_path):
    """The list-holding tree (``conv_h/0/w`` …) in an npz and a full-state
    snapshot (``opt/0/.mu/conv_h/4/b`` …): the port's files load in the JAX
    package and the JAX package's in the port, leaf for leaf."""
    data = seq_data(seed=7)
    jm, tm = models(data)
    tr = Trainer(tm, port_data(data), adam(1e-3),
                 TrainConfig(batch_size=32, verbose=10 ** 9, device=CPU))
    tr.run_epoch()
    save_params(str(tmp_path / "p"), tr.params)
    jlike = jm.init_params(jax.random.PRNGKey(0))
    jloaded = jax_load_params(str(tmp_path / "p.npz"), jlike)
    assert_trees_close(tr.params, jloaded, 0.0, "npz")
    jax_save_params(str(tmp_path / "j"), jloaded)
    again = load_params(str(tmp_path / "j"), tm.init_params(torch.Generator(), device=CPU))
    for (n, a), (_, b) in zip(_flatten_with_names(again), _flatten_with_names(tr.params)):
        assert torch.equal(a, b), n

    tr.save_checkpoint(str(tmp_path / "port"))
    names = set(np.load(tmp_path / "port.npz").files)
    assert {"params/conv_h/0/w", f"params/conv_h/{L - 1}/b", "opt/0/.mu/conv_h/4/b",
            "opt/0/.count", "rng"} <= names
    jt = JaxTrainer(jm, data, optax.adam(1e-3), JaxConfig(batch_size=32, verbose=10 ** 9))
    jt.run_epoch()
    jt.save_checkpoint(str(tmp_path / "jax"))
    assert names - {"rng"} == set(np.load(tmp_path / "jax.npz").files) - {"key"}
    fresh = Trainer(tm, port_data(data), adam(1e-3),
                    TrainConfig(batch_size=32, verbose=10 ** 9, device=CPU))
    fresh.restore_checkpoint(str(tmp_path / "jax"))
    assert_trees_close(fresh.params, jt.params, 0.0, "params")
    got = opt_state_to_numpy(fresh.opt_state)
    assert_trees_close(params_from_numpy(got["mu"], CPU), jt.opt_state[0].mu, 0.0, "mu")
    assert int(got["count"]) == int(jt.opt_state[0].count)
    fresh.restore_checkpoint(str(tmp_path / "port"))
    for (n, a), (_, b) in zip(_flatten_with_names(fresh.params),
                              _flatten_with_names(tr.params)):
        assert torch.equal(a, b), n
