"""The port's popularity adversaries (``acf_tpu_torch/adversarial/popularity.py``)
on the CPU against the JAX package's (``acf_tpu/adversarial/popularity.py``,
modelled on ``tests/test_adversarial_pop.py``): ``popularity_split``
exactly, and two epochs of AMF, AMF2, ABPR and ANeuMF through the port's
trainer with the JAX epoch's draws injected (the batches, the negatives'
candidate rounds, the four pool draws and the four label-swapped draws of
every step, split from its key as ``popularity.py:185-229`` splits it), from
the JAX init's params.

Tolerance (``EPOCH_TOL``): every leaf of the params and of both Adam
states within 1e-5 of its tree's scale: the largest magnitude, in the JAX
run, over the same player's params (``base`` or ``disc``) or over the same
moment of that player's Adam state (``mu`` or ``nu``), as
``chip_smoke.py`` holds an APR step to 1e-5 of the tree's scale. The
epoch stats to rtol 1e-5, ``acc`` within one pair of a step's batch. Both
sides run the same f32 operations and Adam as optax computes it
(``tests/test_torch_optim.py``) but sum in other orders. A bias's gradient
is a sum that cancels (the discriminator's output bias sums σ − label over
popular and rare ids) and Adam divides each moment by the root of the
second, so rounding moves a bias by more of its own (small) magnitude: up
to 1.4e-4 of it, yet 4.4e-6 of its tree's scale at most (seeds 1 and 5;
the tables and kernels within 1.2e-6). The JAX package's own f32 run lies
as far from a float64 run of the same epoch, so the test also holds the
port's float64 run (its arithmetic without its rounding) to the same
bound."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.adversarial.popularity import PopularityAdversarial as JaxPop
from acf_tpu.adversarial.popularity import popularity_split as jax_popularity_split
from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu.models.mf import PointwiseMF as JaxPointwiseMF
from acf_tpu.models.neumf import NeuMF as JaxNeuMF
from acf_tpu.sampling.negatives import sample_pair_epoch as jax_sample_pair_epoch
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu_torch.adversarial.popularity import (
    ADV_DRAWS, POOL_DRAWS, PopularityAdversarial, popularity_split,
)
from acf_tpu_torch.compat.jax_params import (
    opt_state_to_numpy, params_from_numpy, params_to_numpy,
)
from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
from acf_tpu_torch.models.neumf import NeuMF
from acf_tpu_torch.ops.ranking import rank_positions_dot
from acf_tpu_torch.train import TrainConfig, Trainer, adam
from acf_tpu_torch.train.checkpoint import _flatten_with_names
from acf_tpu_torch.utils.tree import tree_map
from tests.test_torch_pair_trainer import ROUNDS, port_data
from tests.test_trainer import synthetic_data

CPU = "cpu"
EPOCH_TOL = 1e-5
BATCH = 32
BASES = {"amf": (JaxPointwiseMF, PointwiseMF, False), "amf2": (JaxPointwiseMF, PointwiseMF, True),
         "abpr": (JaxMFBPR, MFBPR, False), "aneumf": (JaxNeuMF, NeuMF, False)}


def test_popularity_split_equals_jax():
    """``tests/test_adversarial_pop.py:11`` and random counts with ties."""
    counts = np.array([0, 5, 1, 3, 0, 9])
    pop, rare = popularity_split(counts, 0.25)
    assert list(pop) == [5] and set(rare) == {1, 2, 3}
    rng = np.random.default_rng(0)
    for pp in (0.0, 0.2, 0.5, 1.0):
        c = rng.integers(0, 4, size=50)
        for a, b in zip(popularity_split(c, pp), jax_popularity_split(c, pp)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    one = np.array([0, 3, 0])  # one id: rare falls back to the popular pool
    np.testing.assert_array_equal(popularity_split(one, 0.2)[1], [1])


def jax_pop_draws(jt):
    """The draws the JAX trainer's next epoch makes: the batches, and per
    step ``ks = split(step key, 10)``: the candidate rounds from ks[0], the
    pools from ks[1..4], the label-swapped halves from ks[5], ks[6], ks[8]
    and ks[9] (ks[7] is the base loss's key)."""
    _, k = jax.random.split(jt.key)
    k_perm, k_steps = jax.random.split(k)
    nb, b = jt.num_batches, jt.cfg.batch_size
    half = b // 2
    batches = np.asarray(jax_sample_pair_epoch(k_perm, jt.data.num_pairs, b, nb))
    sizes = {pool: int(jt.dev[pool].shape[0]) for pool in ("pop_u", "pop_i", "rare_u", "rare_i")}
    keys = {"pop_u": 1, "pop_i": 2, "rare_u": 3, "rare_i": 4,
            "adv_pop_u": 5, "adv_rare_u": 6, "adv_pop_i": 8, "adv_rare_i": 9}
    cands, draws = [], {name: [] for name in keys}
    for kk in jax.random.split(k_steps, nb):
        ks = jax.random.split(kk, 10)
        cands.append(np.asarray(jax.random.randint(ks[0], (ROUNDS, b), 1, jt.model.num_items,
                                                   dtype=jnp.int32)))
        for name, pool in POOL_DRAWS + ADV_DRAWS:
            n = b if name in dict(POOL_DRAWS) else half
            draws[name].append(np.asarray(jax.random.randint(ks[keys[name]], (n,), 0,
                                                             sizes[pool])))
    return (torch.from_numpy(batches.astype(np.int64)), torch.from_numpy(np.stack(cands)),
            {k: torch.from_numpy(np.stack(v).astype(np.int64)) for k, v in draws.items()})


def flat(tree):
    return dict(_flatten_with_names(tree))


def jax_opt_numpy(state):
    """optax's {"base", "disc"} Adam states as {player: {count, mu, nu}}."""
    return {k: {f: jax.tree.map(np.asarray, getattr(v[0], f)) for f in ("count", "mu", "nu")}
            for k, v in state.items()}


def pair(name, seed, batch=BATCH, d=8):
    jax_base, port_base, simultaneous = BASES[name]
    jd = synthetic_data(seed=seed)
    U, I = jd.num_users, jd.num_items
    kw = dict(weight=0.1, pop_percent=0.2, simultaneous=simultaneous)
    jm = JaxPop(U, I, d, base=jax_base(U, I, d), **kw)
    tm = PopularityAdversarial(U, I, d, base=port_base(U, I, d), **kw)
    jt = JaxTrainer(jm, jd, optax.adam(0.01), JaxConfig(batch_size=batch, verbose=10 ** 9))
    tt = Trainer(tm, port_data(seed), adam(0.01), TrainConfig(batch_size=batch,
                                                               verbose=10 ** 9, device=CPU))
    tt.params = params_from_numpy(jax.tree.map(np.asarray, jt.params), device=CPU)
    tt.opt_state = tm.init_opt_state(tt.optimizer, tt.params)
    return jt, tt


def tree_of(name):
    """``params/<player>`` or ``opt/<player>/<moment>`` of a leaf's name."""
    parts = name.split("/")
    return "/".join(parts[:3] if parts[0] == "opt" else parts[:2])


def state_arrays(params, opt_state):
    return {**{f"params/{k}": v for k, v in flat(params).items()},
            **{f"opt/{k}": v for k, v in flat(opt_state).items()}}


@pytest.mark.parametrize("name", list(BASES))
def test_epochs_match_the_jax_trainer(name):
    """Two epochs: the stats, every param leaf and both Adam states after
    each, against the JAX trainer's, for the port in f32 and in float64;
    the pools equal JAX's exactly."""
    jt, tt = pair(name, seed=5)
    assert tt.num_batches == jt.num_batches >= 8
    for pool in ("pop_u", "pop_i", "rare_u", "rare_i"):
        np.testing.assert_array_equal(tt.dev[pool].numpy(), np.asarray(jt.dev[pool]))
    runs = {"f32": (tt.params, tt.opt_state)}
    p64 = tree_map(lambda x: x.double(), tt.params)
    runs["f64"] = (p64, tt.model.init_opt_state(tt.optimizer, p64))
    for epoch in range(2):
        draws = jax_pop_draws(jt)
        js = jt.run_epoch()
        want = state_arrays(jax.tree.map(np.asarray, jt.params), jax_opt_numpy(jt.opt_state))
        scales = {}
        for k, w in want.items():
            scales[tree_of(k)] = max(scales.get(tree_of(k), 0.0), float(np.abs(w).max()))
        for label, (params, opt_state) in runs.items():
            params, opt_state, ts = tt.epoch_fn(params, opt_state, tt.dev, tt.generator, *draws)
            runs[label] = (params, opt_state)
            assert set(ts) == set(js) and "d_loss" in ts
            for k in js:
                if k.startswith("acc"):
                    assert abs(ts[k] - js[k]) <= 1.0 / BATCH / tt.num_batches + 1e-7, (epoch, k)
                else:
                    np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=f"{epoch} {k}")
            got = state_arrays(params_to_numpy(params), opt_state_to_numpy(opt_state))
            assert set(got) == set(want)
            for k, w in want.items():
                if k.endswith("count"):
                    assert int(got[k]) == int(w) == (epoch + 1) * tt.num_batches, k
                    continue
                err, scale = float(np.abs(got[k] - w).max()), scales[tree_of(k)]
                assert err <= EPOCH_TOL * scale, (
                    f"{label} epoch {epoch} {k}: {err:.3e} of its tree's scale {scale:.3e}")


def test_simultaneous_uses_the_pre_update_discriminators():
    """AMF2's recommender step sees the discriminators from before their
    update, AMF's the updated ones: with the same draws their recommender
    params differ after one step, and their discriminators do not."""
    out = {}
    for name in ("amf", "amf2"):
        jt, tt = pair(name, seed=2)
        batches, cands, draws = jax_pop_draws(jt)
        epoch = tt.model.make_epoch_fn(tt.optimizer, BATCH, 1)
        out[name] = epoch(tt.params, tt.opt_state, tt.dev, tt.generator, batches[:1],
                          cands[:1], {k: v[:1] for k, v in draws.items()})[0]
    a, b = flat(out["amf"]), flat(out["amf2"])
    assert all(torch.equal(a[k], b[k]) for k in a if k.startswith("disc/"))
    assert not torch.equal(a["base/P"], b["base/P"])


def test_recommender_gradient_holds_the_discriminators_constant():
    """The recommender's loss passes no gradient into the discriminators
    (JAX's ``stop_gradient``) and the discriminators' loss none into the
    base: each step's gradient reaches only its own player."""
    _, tt = pair("abpr", seed=1)
    m, prm = tt.model, tt.params
    u = torch.tensor([1, 2, 3, 4])
    batch = (u, torch.tensor([1, 2, 3, 4]), torch.tensor([5, 6, 7, 8]))
    ids = {"u": torch.tensor([1, 2, 3, 4]), "i": torch.tensor([1, 2, 5, 6])}
    base = {k: v.clone().requires_grad_(True) for k, v in prm["base"].items()}
    disc = {n: {l: {k: v.clone().requires_grad_(True) for k, v in d.items()}
                for l, d in layer.items()} for n, layer in prm["disc"].items()}
    loss, _ = m.rec_loss(base, disc, batch, ids)
    loss.backward()
    assert all(v.grad is None for n in disc.values() for d in n.values() for v in d.values())
    assert all(v.grad is not None for v in base.values())
    base2 = {k: v.detach().clone().requires_grad_(True) for k, v in prm["base"].items()}
    m.disc_loss(disc, base2, ids, ids).backward()
    assert all(v.grad is None for v in base2.values())


def test_trainer_runs_each_adversary_and_evaluates():
    """``tests/test_adversarial_pop.py``: AMF's NDCG rises over training
    with the trainer's own draws; ABPR and ANeuMF take an epoch and
    evaluate (AMF and ABPR through K1's factored scorer, ANeuMF densely,
    with NeuMF's user tile); no launch is counted on the CPU."""
    data = port_data(3)
    U, I = data.num_users, data.num_items
    tr = Trainer(PopularityAdversarial(U, I, 8, base=PointwiseMF(U, I, 8), weight=0.01),
                 data, adam(0.01), TrainConfig(batch_size=32, verbose=10 ** 9, device=CPU))
    before = tr.evaluate().at_k(10)
    for _ in range(30):
        stats = tr.run_epoch()
    after = tr.evaluate().at_k(10)
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["d_loss"])
    assert after[1] > before[1], (before, after)
    for base, factored in ((MFBPR(U, I, 8), True), (NeuMF(U, I, 8), False)):
        model = PopularityAdversarial(U, I, 8, base=base)
        assert (model.factored_scorer() is not None) == factored
        tr = Trainer(model, data, adam(0.01), TrainConfig(batch_size=32, verbose=10 ** 9,
                                                          device=CPU))
        assert tr.evaluator.batch_users == min(512, getattr(base, "eval_batch_users", 512),
                                               len(data.eval_users()))
        assert np.isfinite(tr.run_epoch()["loss"])
        assert 0 <= tr.evaluate().at_k(10)[0] <= 1
    assert rank_positions_dot.launches == 0


@pytest.mark.parametrize("batch", [31, 32])
def test_odd_batch_draws_half_of_it(batch):
    """``half = batch_size // 2`` as in JAX: an odd batch gives the
    recommender 2 * (B // 2) label-swapped ids; the epoch has
    ``num_pairs // batch_size`` steps."""
    data = port_data(4)
    model = PopularityAdversarial(data.num_users, data.num_items, 8,
                                  base=MFBPR(data.num_users, data.num_items, 8))
    seen = []
    real = model.rec_loss
    model.rec_loss = lambda bp, dp, b, ids, g=None: seen.append(ids["u"].shape[0]) or real(
        bp, dp, b, ids, g)
    tr = Trainer(model, data, adam(0.01), TrainConfig(batch_size=batch, verbose=10 ** 9,
                                                      device=CPU))
    tr.run_epoch()
    assert tr.num_batches == data.num_pairs // batch
    assert set(seen) == {2 * (batch // 2)}


def test_full_state_snapshot_round_trips_both_players(tmp_path):
    """A full-state snapshot holds ``{"base", "disc"}`` params and both Adam
    states under the JAX package's names (``opt/base/0/.mu/P``, …):
    restored into a fresh trainer, and from the JAX package's own
    ``save_checkpoint``, it gives the same trees."""
    jt, tt = pair("abpr", seed=6)
    jt.run_epoch()
    tt.run_epoch()
    tt.save_checkpoint(str(tmp_path / "port"))
    names = set(np.load(tmp_path / "port.npz").files)
    assert {"params/base/P", "params/disc/u/l1/w", "opt/base/0/.count", "opt/base/0/.mu/Q",
            "opt/disc/0/.nu/i/l2/b", "rng"} <= names
    jt.save_checkpoint(str(tmp_path / "jax"))
    assert names - {"rng"} == set(np.load(tmp_path / "jax.npz").files) - {"key"}
    for src, want_p, want_o in (("port", tt.params, tt.opt_state),
                                ("jax", params_from_numpy(jax.tree.map(np.asarray, jt.params),
                                                          device=CPU), None)):
        _, fresh = pair("abpr", seed=6)
        fresh.restore_checkpoint(str(tmp_path / src))
        for k, v in flat(want_p).items():
            assert torch.equal(flat(fresh.params)[k], v), (src, k)
        got_o = flat(opt_state_to_numpy(fresh.opt_state))
        ref_o = (flat(opt_state_to_numpy(want_o)) if want_o is not None
                 else flat(jax_opt_numpy(jt.opt_state)))
        for k, v in ref_o.items():
            np.testing.assert_array_equal(got_o[k], v, err_msg=f"{src} {k}")
    # a switch to a popularity model puts its own pools on the device
    data = port_data(6)
    U, I = data.num_users, data.num_items
    tr = Trainer(PopularityAdversarial(U, I, 8, base=MFBPR(U, I, 8)), data, adam(0.01),
                 TrainConfig(batch_size=32, verbose=10 ** 9, device=CPU))
    before = len(tr.dev["pop_u"])
    tr.switch_model(PopularityAdversarial(U, I, 8, base=MFBPR(U, I, 8), pop_percent=0.5))
    assert len(tr.dev["pop_u"]) > before
    assert np.isfinite(tr.run_epoch()["d_loss"])
