"""The port's MF models, loss helpers, param carrying and npz checkpoints
against the JAX package's: float outputs to rtol 1e-6 (scores also to an
absolute 1e-6 of their largest magnitude — a dot product whose terms cancel
keeps the terms' rounding, which torch and XLA sum in different orders),
files exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.models import base as jax_base
from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu.models.mf import PointwiseMF as JaxPointwiseMF
from acf_tpu.train.checkpoint import load_params as jax_load_params
from acf_tpu.train.checkpoint import save_params as jax_save_params
from acf_tpu_torch.compat.jax_params import params_from_numpy, params_to_numpy
from acf_tpu_torch.models import base
from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
from acf_tpu_torch.train.checkpoint import load_params, save_params

CPU = "cpu"
MODELS = [(MFBPR, JaxMFBPR), (PointwiseMF, JaxPointwiseMF)]


def _carried(model_cls, jax_cls, seed=0, users=17, items=53, dim=8):
    jmodel = jax_cls(users, items, dim)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    return jmodel, jparams, model_cls(users, items, dim), tparams


@pytest.mark.parametrize("model_cls,jax_cls", MODELS, ids=["mfbpr", "pointwise"])
def test_scores_match_jax(model_cls, jax_cls):
    jmodel, jparams, tmodel, tparams = _carried(model_cls, jax_cls)
    rng = np.random.default_rng(0)
    users = rng.integers(0, 17, size=6).astype(np.int32)
    items = rng.integers(0, 53, size=(6, 11)).astype(np.int32)
    hists = np.zeros((6, 3), np.int32)
    tu, th, ti = map(torch.from_numpy, (users, hists, items))

    def close(ours, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())

    close(tmodel.score_all(tparams, tu, th), jmodel.score_all(jparams, users, hists))
    close(tmodel.score_some(tparams, tu, th, ti),
          jmodel.score_some(jparams, users, hists, items))
    (tr, tt), (jr, jt) = tmodel.factored_scorer(), jmodel.factored_scorer()
    assert tmodel.factored_scorer() is tmodel.factored_scorer()  # cached
    np.testing.assert_allclose(tr(tparams, tu, th).numpy(),
                               np.asarray(jr(jparams, users, hists)), rtol=1e-6)
    (ttab, tbias), (jtab, jbias) = tt(tparams), jt(jparams)
    np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
    assert tbias is None and jbias is None


def test_mfbpr_init_params_distribution():
    model = MFBPR(2000, 1500, 16)
    params = model.init_params(torch.Generator().manual_seed(0), device=CPU)
    assert set(params) == {"P", "Q"}
    assert params["P"].shape == (2000, 16) and params["Q"].shape == (1500, 16)
    for x in params.values():
        assert x.dtype == torch.float32 and x.device.type == "cpu"
        assert float(x.abs().max()) <= 0.02  # truncated at 2 sigma
        # std of N(0, 0.01) truncated at +-2 sigma: 0.01 * 0.8796
        assert abs(float(x.std()) - 0.0088) < 0.0002
        assert abs(float(x.mean())) < 0.0005
    again = model.init_params(torch.Generator().manual_seed(0), device=CPU)
    torch.testing.assert_close(again["P"], params["P"], rtol=0, atol=0)


def test_pointwise_init_params_range():
    params = PointwiseMF(300, 200, 8).init_params(torch.Generator().manual_seed(1),
                                                  device=CPU)
    for x in params.values():
        assert x.dtype == torch.float32
        assert float(x.abs().max()) <= 0.05 and float(x.std()) > 0.02


def test_loss_helpers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    x[3] = 0.0  # zero rows stay zero
    pos = (rng.standard_normal(9) * 50).astype(np.float32)
    neg = (rng.standard_normal(9) * 50).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(base.row_normalize(t(x)).numpy(),
                               np.asarray(jax_base.row_normalize(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(base.bpr_pair_loss(t(pos), t(neg)).numpy(),
                               np.asarray(jax_base.bpr_pair_loss(pos, neg)), rtol=1e-6)
    for eps in (0.1, 5.0):
        np.testing.assert_allclose(
            base.project_rows(t(x), eps).numpy(),
            np.asarray(jax_base.project_rows(jnp.asarray(x), eps)), rtol=1e-6)


def test_params_round_trip_numpy():
    tree = {"P": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.ones(4, np.float32)},
            "layers": [np.zeros((2, 2), np.float32)]}
    params = params_from_numpy(tree, device=CPU)
    assert isinstance(params["nested"]["b"], torch.Tensor)
    back = params_to_numpy(params)
    for a, b in ((tree["P"], back["P"]), (tree["nested"]["b"], back["nested"]["b"]),
                 (tree["layers"][0], back["layers"][0])):
        np.testing.assert_array_equal(a, b)


def test_npz_jax_to_port(tmp_path):
    jmodel, jparams, tmodel, _ = _carried(MFBPR, JaxMFBPR, seed=4)
    path = str(tmp_path / "jax_ck")
    jax_save_params(path, jparams)
    like = tmodel.init_params(torch.Generator().manual_seed(0), device=CPU)
    loaded = load_params(path, like)
    for name in ("P", "Q"):
        np.testing.assert_array_equal(loaded[name].numpy(), np.asarray(jparams[name]))
        assert loaded[name].dtype == torch.float32


def test_npz_port_to_jax(tmp_path):
    tmodel = MFBPR(11, 13, 4)
    tparams = tmodel.init_params(torch.Generator().manual_seed(5), device=CPU)
    path = str(tmp_path / "sub" / "port_ck.npz")
    save_params(path, tparams)
    like = JaxMFBPR(11, 13, 4).init_params(jax.random.PRNGKey(0))
    loaded = jax_load_params(path, like)
    for name in ("P", "Q"):
        np.testing.assert_array_equal(np.asarray(loaded[name]), tparams[name].numpy())
    # and back into the port, with a shape check
    np.testing.assert_array_equal(load_params(path, tparams)["Q"].numpy(),
                                  tparams["Q"].numpy())
    with pytest.raises(ValueError):
        load_params(path, {"P": torch.zeros(3, 4), "Q": tparams["Q"]})
