"""The port's top-K serving (on the CPU) against ``acf_tpu.ops.topk``: items
exactly equal wherever scores are not tied, scores to rtol 1e-6; NEG-filled
slots compared by score only (``lax.top_k`` and ``torch.topk`` may order
tied entries differently)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu.ops.topk import recommend as jax_recommend
from acf_tpu.ops.topk import topk_factored as jax_topk_factored
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.mf import MFBPR
from acf_tpu_torch.ops.topk import NEG, recommend, topk_factored
from tests.test_full_rank import make_data

CPU = "cpu"


def assert_topk_equal(s, i, ref_s, ref_i):
    """Scores to rtol 1e-6; items equal in every slot that is neither NEG nor
    tied with a neighbouring slot."""
    s, i, ref_s, ref_i = map(np.asarray, (s, i, ref_s, ref_i))
    np.testing.assert_allclose(s, ref_s, rtol=1e-6)
    for r in range(s.shape[0]):
        for j in range(s.shape[1]):
            if ref_s[r, j] <= NEG:
                continue
            tied = any(abs(ref_s[r, j] - ref_s[r, jj]) <= 1e-6 * abs(ref_s[r, j])
                       for jj in (j - 1, j + 1) if 0 <= jj < s.shape[1])
            if not tied:
                assert i[r, j] == ref_i[r, j], (r, j, i[r], ref_i[r])


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_topk_factored_matches_jax(k, with_bias):
    rng = np.random.default_rng(0)
    b, d, n_items = 8, 8, 300
    u = rng.standard_normal((b, d)).astype(np.float32)
    E = rng.standard_normal((n_items, d)).astype(np.float32)
    bias = rng.standard_normal(n_items).astype(np.float32) if with_bias else None
    hists = np.zeros((b, 6), np.int32)
    for r in range(b):
        hists[r, 1:] = rng.choice(np.arange(1, n_items), 5, replace=False)
    s, it = topk_factored(torch.from_numpy(u), torch.from_numpy(E),
                          torch.from_numpy(hists),
                          bias=None if bias is None else torch.from_numpy(bias),
                          k=k, item_tile=128)
    js, ji = jax_topk_factored(jnp.asarray(u), jnp.asarray(E), jnp.asarray(hists),
                               bias=None if bias is None else jnp.asarray(bias),
                               k=k, item_tile=128)
    assert s.shape == (b, k) and it.shape == (b, k)
    assert_topk_equal(s, it, js, ji)
    for r in range(b):
        assert not set(it[r].tolist()) & set(hists[r].tolist())


def test_topk_factored_fewer_valid_items_than_k():
    """A tiny catalog mostly covered by the history: the tail slots are NEG
    (compared by score only)."""
    rng = np.random.default_rng(4)
    u = rng.standard_normal((3, 4)).astype(np.float32)
    E = rng.standard_normal((9, 4)).astype(np.float32)
    hists = np.array([[1, 2, 3, 4], [0, 0, 5, 6], [0, 0, 0, 8]], np.int32)
    s, it = topk_factored(torch.from_numpy(u), torch.from_numpy(E),
                          torch.from_numpy(hists), k=7, item_tile=8)
    js, ji = jax_topk_factored(jnp.asarray(u), jnp.asarray(E), jnp.asarray(hists),
                               k=7, item_tile=8)
    assert_topk_equal(s, it, js, ji)
    assert (s.numpy()[0, 4:] <= NEG).all()  # user 0 has only 4 valid items
    valid = s.numpy() > NEG
    assert not np.isin(it.numpy()[valid], [0]).any()


def _setup(seed):
    jdata = make_data(num_users=20, num_items=40, seed=seed)
    tdata = Interactions(**dataclasses.asdict(jdata))
    jmodel = JaxMFBPR(jdata.num_users, jdata.num_items, 8)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    tmodel = MFBPR(jdata.num_users, jdata.num_items, 8)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    return jdata, tdata, jmodel, jparams, tmodel, tparams


# 15 users: batch 3 -> 5 batches (bulk), batch 4 -> 4 batches (bulk, ragged),
# batch 8 -> 2 batches (per batch), batch 15 -> 1 batch (per batch)
@pytest.mark.parametrize("batch_users", [3, 4, 8, 15])
@pytest.mark.parametrize("k", [1, 10])
def test_recommend_matches_jax(k, batch_users):
    jdata, tdata, jmodel, jparams, tmodel, tparams = _setup(seed=9)
    users = tdata.eval_users()[:15]
    s, it = recommend(tmodel, tparams, tdata, users, k=k, batch_users=batch_users,
                      device=CPU)
    js, ji = jax_recommend(jmodel, jparams, jdata, users, k=k,
                           batch_users=batch_users)
    assert s.shape == (15, k) and it.shape == (15, k) and it.dtype == np.int32
    assert_topk_equal(s, it, js, ji)
    for row, u in enumerate(users):
        train = set(int(x) for x in tdata.hist[u] if x)
        assert not train & set(it[row].tolist())
        assert 0 not in it[row]


def test_recommend_score_all_branch_matches_factored():
    _, tdata, _, _, tmodel, tparams = _setup(seed=10)
    users = tdata.eval_users()[:8]

    class NoFactored:
        num_items = tmodel.num_items
        score_all = staticmethod(tmodel.score_all)

        def factored_scorer(self):
            return None

    s1, i1 = recommend(tmodel, tparams, tdata, users, k=5, device=CPU)
    s2, i2 = recommend(NoFactored(), tparams, tdata, users, k=5, device=CPU)
    np.testing.assert_array_equal(i1, i2.astype(np.int32))
    np.testing.assert_allclose(s1, s2, rtol=1e-6)
