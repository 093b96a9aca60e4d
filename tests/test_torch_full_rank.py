"""The port's FullRankEvaluator (on the CPU) against the JAX package's: rank
positions exactly equal on the dense, factored and sampled paths, metrics to
rtol 1e-6, the correction array exactly equal."""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest

from acf_tpu.data import interactions_from_frame as jax_interactions_from_frame
from acf_tpu.eval import FullRankEvaluator as JaxEvaluator
from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.data import Interactions, interactions_from_frame
from acf_tpu_torch.eval import FullRankEvaluator
from acf_tpu_torch.models.mf import MFBPR
from acf_tpu_torch.ops.ranking import rank_positions_dot
from tests.test_full_rank import make_data

CPU = "cpu"
# make_data(num_users=13) has 12 eval users: tiles of 4 divide them, 5 do not
BATCHES = [4, 5]
SEEDS = [0, 3, 5]


def _setup(seed, dim=8):
    jdata = make_data(num_users=13, num_items=40, seed=seed)
    tdata = Interactions(**dataclasses.asdict(jdata))
    jmodel = JaxMFBPR(jdata.num_users, jdata.num_items, dim)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed + 7))
    tmodel = MFBPR(jdata.num_users, jdata.num_items, dim)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    return jdata, tdata, jmodel, jparams, tmodel, tparams


@pytest.mark.parametrize("batch_users", BATCHES)
@pytest.mark.parametrize("seed", SEEDS)
def test_positions_match_jax(seed, batch_users):
    jdata, tdata, jmodel, jparams, tmodel, tparams = _setup(seed)
    jev = JaxEvaluator(jdata, batch_users=batch_users)
    tev = FullRankEvaluator(tdata, batch_users=batch_users, device=CPU)

    dense = tev.positions(tmodel.score_all, tparams)
    np.testing.assert_array_equal(dense, jev.positions(jmodel.score_all, jparams))

    jfs, tfs = jmodel.factored_scorer(), tmodel.factored_scorer()
    factored = tev.positions_factored(tfs[0], tfs[1], tparams)
    np.testing.assert_array_equal(
        factored, jev.positions_factored(jfs[0], jfs[1], jparams, interpret=True))
    np.testing.assert_array_equal(factored, dense)
    assert factored.dtype == np.int32 and len(factored) == len(jdata.eval_users())


@pytest.mark.parametrize("seed", SEEDS)
def test_corrections_match_jax(seed):
    jdata, tdata, *_ = _setup(seed)
    jc = np.asarray(JaxEvaluator(jdata, batch_users=5)._corrections())
    tc = FullRankEvaluator(tdata, batch_users=5, device=CPU)._corrections().numpy()
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("batch_users", BATCHES)
@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_model_matches_jax(seed, batch_users):
    jdata, tdata, jmodel, jparams, tmodel, tparams = _setup(seed)
    a = JaxEvaluator(jdata, batch_users=batch_users).evaluate_model(jmodel, jparams)
    before = rank_positions_dot.launches
    b = FullRankEvaluator(tdata, batch_users=batch_users,
                          device=CPU).evaluate_model(tmodel, tparams)
    assert rank_positions_dot.launches == before  # CPU: the plain version
    for field in ("hr", "ndcg", "auc"):
        np.testing.assert_allclose(getattr(b, field), getattr(a, field), rtol=1e-6)
    assert b.at_k(10) == pytest.approx(a.at_k(10), rel=1e-6)


def _sampled_frame(seed, num_users=25, num_items=300):
    rng = np.random.default_rng(seed)
    n = 12 * num_users
    return pd.DataFrame({"uid": rng.integers(1, num_users, size=n),
                         "iid": rng.integers(1, num_items, size=n),
                         "timestamp": np.arange(n, dtype=np.int64)})


@pytest.mark.parametrize("batch_users", [4, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_sampled_positions_match_jax(seed, batch_users):
    df = _sampled_frame(seed)
    jdata = jax_interactions_from_frame(df, reindex=False, num_negatives=100)
    tdata = interactions_from_frame(df, reindex=False, num_negatives=100)
    jmodel = JaxMFBPR(jdata.num_users, jdata.num_items, 8)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    tmodel = MFBPR(tdata.num_users, tdata.num_items, 8)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    jev = JaxEvaluator(jdata, batch_users=batch_users)
    tev = FullRankEvaluator(tdata, batch_users=batch_users, device=CPU)
    pos = tev.positions_sampled(tmodel.score_some, tparams)
    np.testing.assert_array_equal(pos, jev.positions_sampled(jmodel.score_some, jparams))
    a = jev.evaluate(jmodel.score_some, jparams, sampled=True)
    b = tev.evaluate(tmodel.score_some, tparams, sampled=True)
    np.testing.assert_allclose(b.auc, a.auc, rtol=1e-6)
    np.testing.assert_allclose(b.ndcg, a.ndcg, rtol=1e-6)


def test_zero_eval_users():
    df = pd.DataFrame({"uid": [1], "iid": [1], "timestamp": [0]})
    data = interactions_from_frame(df, reindex=False)
    data.test_item[:] = 0
    ev = FullRankEvaluator(data, device=CPU)
    model = MFBPR(data.num_users, data.num_items, 4)
    params = params_from_numpy({"P": np.zeros((2, 4), np.float32),
                                "Q": np.zeros((2, 4), np.float32)}, device=CPU)
    assert ev.evaluate_model(model, params).auc.shape == (0,)
