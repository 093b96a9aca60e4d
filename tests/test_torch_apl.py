"""The port's APL (``acf_tpu_torch/models/apl.py``) on the CPU against the
JAX package's: scoring, the losses, whole epochs with the JAX epoch's draws
injected (against the JAX ``Trainer`` with ``manual_gen`` and with the
Pallas ``fused_gen`` chain in interpret mode), wgan clipping, the critic's
pad row, the epoch line's table norms, and the pretrained protocol
(modelled on ``tests/test_gan_models.py``).

Epoch tolerance: both players' tables to rtol 2e-4, atol 2e-6, the losses
to rtol 1e-4 — the bar the JAX package sets between its own formulations
(``tests/test_gan_models.py:153-191``). Scoring and single losses: rtol
1e-6, atol 1e-9 (the same f32 products, summed in another order: scores of
~1e-3 differ by ~1e-10 there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.eval.full_rank import FullRankEvaluator as JaxEvaluator
from acf_tpu.models.apl import APL as JaxAPL
from acf_tpu.sampling.negatives import sample_pair_epoch as jax_sample_pair_epoch
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.eval import FullRankEvaluator
from acf_tpu_torch.models.apl import APL
from acf_tpu_torch.models.mf import MFBPR
from acf_tpu_torch.ops.apl_gen_fused import KERNELS
from acf_tpu_torch.train import TrainConfig, Trainer, adagrad, sgd
from acf_tpu_torch.utils.io import OutputWriter
from tests.test_trainer import synthetic_data

CPU = "cpu"
EPOCH_TOL = dict(rtol=2e-4, atol=2e-6)


def port_data(jd):
    return Interactions(**dataclasses.asdict(jd))


def config(**kw):
    return TrainConfig(batch_size=32, verbose=10 ** 9, device=CPU, **kw)


def jax_params(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device=CPU)


def jax_epoch_draws(jt):
    """The draws the JAX trainer's next ``run_epoch`` makes (its key split,
    then ``k_perm, k_c, k_g = split(key, 3)``, acf_tpu/models/apl.py:346):
    the [nb, B] pair batches and the critic's and generator's [nb, B, I]
    uniforms, as tensors."""
    _, k = jax.random.split(jt.key)
    k_perm, k_c, k_g = jax.random.split(k, 3)
    nb, b, n_items = jt.num_batches, jt.cfg.batch_size, jt.model.num_items
    batches = np.asarray(jax_sample_pair_epoch(k_perm, jt.data.num_pairs, b, nb))
    uniforms = [np.stack([np.asarray(jax.random.uniform(kk, (b, n_items)))
                          for kk in jax.random.split(key, nb)]) for key in (k_c, k_g)]
    return (torch.from_numpy(batches.astype(np.int64)),
            *(torch.from_numpy(u) for u in uniforms))


def assert_players_close(jt, tt, label):
    for side in ("g", "c"):
        for name in ("P", "Q"):
            np.testing.assert_allclose(tt.params[side][name].numpy(),
                                       np.asarray(jt.params[side][name]),
                                       err_msg=f"{label} {side}/{name}", **EPOCH_TOL)


def pair(seed, loss_fn="log", **jax_kw):
    """A JAX trainer and a port trainer on the same data, the port's params
    copied from the JAX trainer's init."""
    jd = synthetic_data(seed=seed)
    jt = JaxTrainer(JaxAPL(jd.num_users, jd.num_items, 8, loss_function=loss_fn, **jax_kw), jd,
                    optax.sgd(0.05), JaxConfig(batch_size=32, seed=11, verbose=10 ** 9))
    td = port_data(jd)
    tt = Trainer(APL(td.num_users, td.num_items, 8, loss_function=loss_fn), td, sgd(0.05),
                 config(seed=11))
    tt.params = jax_params(jt.params)
    return jt, tt


def test_init_params_shapes_and_range():
    model = APL(50, 30, 8)
    p = model.init_params(torch.Generator().manual_seed(0), device=CPU)
    for side in ("g", "c"):
        assert p[side]["P"].shape == (50, 8) and p[side]["Q"].shape == (30, 8)
        for leaf in p[side].values():
            assert leaf.dtype == torch.float32
            assert float(leaf.abs().max()) <= 0.05 and float(leaf.std()) > 0.02
    assert not torch.equal(p["g"]["P"], p["c"]["P"])
    opt = model.init_opt_state(sgd(0.05), p)
    assert opt == {"g": {}, "c": {}}
    with pytest.raises(ValueError, match="loss_function"):
        APL(5, 5, 4, loss_function="bce")


def test_scoring_loss_and_evaluation_match_jax():
    jd = synthetic_data(seed=21)
    jm = JaxAPL(jd.num_users, jd.num_items, 8)
    tm = APL(jd.num_users, jd.num_items, 8)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tp = jax_params(jp)
    rng = np.random.default_rng(0)
    users = rng.integers(1, jd.num_users, 16).astype(np.int32)
    items = rng.integers(1, jd.num_items, (16, 5)).astype(np.int32)
    pos, neg = items[:, 0], items[:, 1]
    np.testing.assert_allclose(tm.score_all(tp, torch.from_numpy(users), None).numpy(),
                               np.asarray(jm.score_all(jp, users, None)), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        tm.score_some(tp, torch.from_numpy(users), None, torch.from_numpy(items)).numpy(),
        np.asarray(jm.score_some(jp, users, None, items)), rtol=1e-6, atol=1e-9)
    tl, taux = tm.loss(tp, tuple(torch.from_numpy(x) for x in (users, pos, neg)))
    jl, jaux = jm.loss(jp, (users, pos, neg), None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(taux["acc"]) == float(jaux["acc"])
    # the factored evaluation (K1's plain version on the CPU) against JAX's
    got = FullRankEvaluator(port_data(jd), device=CPU).evaluate_model(tm, tp)
    want = JaxEvaluator(jd).evaluate_model(jm, jp)
    np.testing.assert_allclose(got.at_k(10), want.at_k(10), rtol=1e-6)
    np.testing.assert_allclose(got.auc, want.auc, rtol=1e-6)


@pytest.mark.parametrize("loss_fn", ["log", "wgan", "hinge"])
def test_losses_match_jax(loss_fn):
    rng = np.random.default_rng(1)
    real, fake = rng.standard_normal((2, 32)).astype(np.float32)
    jm = JaxAPL(10, 10, 4, loss_function=loss_fn, reg_g=0.3)
    tm = APL(10, 10, 4, loss_function=loss_fn, reg_g=0.3)
    got = tm._losses(torch.from_numpy(real), torch.from_numpy(fake), 0.7, 1.3)
    want = jm._losses(jnp.asarray(real), jnp.asarray(fake), 0.7, 1.3)
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-6)


@pytest.mark.parametrize("loss_fn,gen", [("log", "manual"), ("wgan", "manual"),
                                         ("hinge", "manual"), ("log", "fused"),
                                         ("hinge", "fused")])
def test_epochs_match_the_jax_trainer(loss_fn, gen):
    """Two epochs, each with the JAX epoch's draws injected: both players'
    tables and the epoch's losses after each."""
    jt, tt = pair(33, loss_fn, manual_gen=True, fused_gen=gen == "fused")
    for epoch in range(2):
        draws = jax_epoch_draws(jt)
        js = jt.run_epoch()
        tt.params, tt.opt_state, ts = tt.epoch_fn(tt.params, tt.opt_state, tt.dev,
                                                  tt.generator, *draws)
        assert_players_close(jt, tt, f"{loss_fn}/{gen} epoch {epoch}")
        assert set(ts) == set(js) == {"loss", "d_loss", "acc"}
        for k in ("loss", "d_loss"):
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_wgan_clips_the_critic():
    data = port_data(synthetic_data(seed=12))
    tr = Trainer(APL(data.num_users, data.num_items, 8, loss_function="wgan"), data, sgd(0.05),
                 config())
    s = tr.run_epoch()
    assert np.isfinite(s["loss"]) and np.isfinite(s["d_loss"])
    for leaf in tr.params["c"].values():  # clipped at float32(0.05)
        assert float(leaf.abs().max()) <= float(np.float32(0.05))


def test_critic_pad_row_gets_no_mass():
    """As tests/test_gan_models.py::test_gan_pad_item_gets_no_mass (APL
    half): the critic's pad row only moves if the fake one-hot leaks mass
    onto item 0; the generator's only through its regularizer (reg_g = 0)."""
    data = port_data(synthetic_data(seed=15))
    tr = Trainer(APL(data.num_users, data.num_items, 8), data, sgd(0.05), config(seed=2019))
    c0 = tr.params["c"]["Q"][0].clone()
    g0 = tr.params["g"]["Q"][0].clone()
    for _ in range(3):
        tr.run_epoch()
    np.testing.assert_allclose(tr.params["c"]["Q"][0].numpy(), c0.numpy(), atol=1e-7)
    assert torch.equal(tr.params["g"]["Q"][0], g0)


class Lines(OutputWriter):
    def __init__(self):
        super().__init__(None, None)
        self.lines = []

    def line(self, output):
        self.lines.append(output)


def _norms(line):
    return line[line.index("|P|"):]


def test_epoch_line_prints_the_generators_norms():
    """The epoch line's |P| and |Q| are the generator's, as the JAX
    trainer prints them (its ``_table_norms`` descends into ``g``): one
    fitted epoch on each side with the same draws."""
    jt, tt = pair(34)
    draws = jax_epoch_draws(jt)
    jw, tw = Lines(), Lines()
    jt.writer, tt.writer = jw, tw
    jt.cfg.verbose = tt.cfg.verbose = 1
    real_epoch_fn = tt.epoch_fn
    tt.epoch_fn = lambda p, o, d, g: real_epoch_fn(p, o, d, g, *draws)
    jt.fit(epochs=1, final=False)
    tt.fit(epochs=1, final=False)
    (jline,), (tline,) = jw.lines, tw.lines
    assert _norms(tline) == _norms(jline), (tline, jline)
    gp, gq = (float(torch.linalg.vector_norm(tt.params["g"][n])) for n in ("P", "Q"))
    assert _norms(tline) == "|P|=%.2f, |Q|=%.2f" % (gp, gq) and gp > 0 and gq > 0
    # HR / NDCG of the generator, too
    assert tline.split("ACC")[0].split("]:")[1] == jline.split("ACC")[0].split("]:")[1]


def test_table_norms_of_flat_and_sequence_params():
    """The repaired ``_table_norms`` still reads flat MF tables and a
    sequence model's item table, as the JAX trainer does."""
    from acf_tpu.models.sasrec import SASRec as JaxSASRec
    from acf_tpu_torch.models.sasrec import SASRec
    from tests.test_sasrec import seq_data
    from tests.test_torch_trainer import port_data as seq_port_data

    jd = seq_data()
    jt = JaxTrainer(JaxSASRec(jd.num_users, jd.num_items, 16, maxlen=8), jd, optax.adam(1e-3),
                    JaxConfig(batch_size=16, verbose=10 ** 9))
    td = seq_port_data()
    tt = Trainer(SASRec(td.num_users, td.num_items, 16, maxlen=8), td, adagrad(0.1), config())
    tt.params = jax_params(jt.params)
    np.testing.assert_allclose(tt._table_norms(), jt._table_norms(), rtol=1e-6)
    assert tt._table_norms()[0] == 0.0

    jd = synthetic_data(seed=3)
    td = port_data(jd)
    from acf_tpu.models.mf import MFBPR as JaxMFBPR

    jt = JaxTrainer(JaxMFBPR(jd.num_users, jd.num_items, 8), jd, optax.adagrad(0.1),
                    JaxConfig(batch_size=32, verbose=10 ** 9))
    tt = Trainer(MFBPR(td.num_users, td.num_items, 8), td, adagrad(0.1), config())
    tt.params = jax_params(jt.params)
    np.testing.assert_allclose(tt._table_norms(), jt._table_norms(), rtol=1e-6)


def test_apl_pretrained_protocol():
    """tests/test_gan_models.py::test_apl_pretrained_protocol on the port:
    pretrain MF-BPR with Adagrad through the pair trainer, hand its tables
    to APL's generator (the start NDCG is MF-BPR's), train on, and both
    players move while the ranking stays sane."""
    data = port_data(synthetic_data(seed=13))
    pre = Trainer(MFBPR(data.num_users, data.num_items, 8), data, adagrad(0.1), config())
    for _ in range(20):
        pre.run_epoch()
    bpr_ndcg = pre.evaluate().at_k(10)[1]

    tr = Trainer(APL(data.num_users, data.num_items, 8), data, sgd(0.05), config())
    tr.params["g"] = dict(pre.params)
    start = tr.evaluate().at_k(10)
    assert abs(start[1] - bpr_ndcg) < 1e-5
    p0, c0 = tr.params["g"]["P"].clone(), tr.params["c"]["P"].clone()
    before = [k.launches for k in KERNELS]
    for _ in range(5):
        s = tr.run_epoch()
    assert [k.launches for k in KERNELS] == before == [0] * 5  # plain passes on the CPU
    assert np.isfinite(s["loss"]) and np.isfinite(s["d_loss"])
    assert float((tr.params["g"]["P"] - p0).abs().max()) > 0
    assert float((tr.params["c"]["P"] - c0).abs().max()) > 0
    after = tr.evaluate().at_k(10)
    assert after[1] > 0.5 * bpr_ndcg
