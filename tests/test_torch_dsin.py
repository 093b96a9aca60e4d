"""The port's DSIN (``acf_tpu_torch/models/dsin.py``) on the CPU against the
JAX package's (``acf_tpu/models/dsin.py``): the init tree, the ``bce`` and
``bpr`` losses (the ``l2_emb`` term included) and every gradient with the
JAX package's three dropout masks injected, with and without
``bi_evolution``; scores in item chunks (the last one short) with the left
pad of histories narrower than S·Ls, and dense rank positions.
Tolerances as ``tests/test_torch_rnn.py`` states them.
"""

import jax
import numpy as np
import pytest
import torch

from acf_tpu.models.dsin import DSIN as JaxDSIN
from acf_tpu_torch.models.dsin import DSIN
from acf_tpu_torch.ops.ranking import rank_positions_dot
from tests.test_sasrec import seq_data
from tests.test_torch_rnn import (
    CPU, assert_loss_and_grads, assert_positions_match, assert_scores_match, carry, seq_batch,
    t,
)
from tests.test_trainer import synthetic_data

D = 16


def models(data, chunk=None, **kw):
    args = (data.num_users, data.num_items, D)
    jm, tm = JaxDSIN(*args, **kw), DSIN(*args, **kw)
    if chunk is not None:
        jm._item_chunk = tm._item_chunk = chunk
    return jm, tm


def jax_masks(key, b, keep=0.5):
    """The three keep-masks [B, 2, d] of JAX's ``DSIN.loss(..., key)``."""
    return [t(np.asarray(jax.random.bernoulli(k, keep, (b, 2, D))))
            for k in jax.random.split(key, 3)]


def test_init_params_tree_and_config():
    data = synthetic_data()
    for bi in (False, True):
        jm, tm = models(data, sess_count=2, sess_len=4, bi_evolution=bi)
        assert tm.maxlen == jm.maxlen == 8
        from acf_tpu.train.checkpoint import _flatten_with_names as jax_named
        from acf_tpu_torch.train.checkpoint import _flatten_with_names

        jp = jm.init_params(jax.random.PRNGKey(0))
        tp = tm.init_params(torch.Generator().manual_seed(0), device=CPU)
        assert {n: tuple(x.shape) for n, x in _flatten_with_names(tp)} == \
            {n: v.shape for n, v in jax_named(jp).items()}
        assert ("gru_bwd" in tp) == bi and (tp["item_emb"][0] == 0).all()
    with pytest.raises(ValueError, match="loss_type"):
        DSIN(5, 5, 4, loss_type="ce")


CASES = [dict(loss_type="bce"), dict(loss_type="bpr"),
         dict(loss_type="bce", bi_evolution=True), dict(loss_type="bpr", l2_emb=0.0)]


@pytest.mark.parametrize("kw", CASES, ids=["bce", "bpr", "bce-bi", "bpr-no-l2"])
def test_loss_and_gradients_match_jax(kw):
    """Three sessions of four items over 7-item histories: every window's
    first session is empty and its second partly padded."""
    data = synthetic_data(seed=2)
    jm, tm = models(data, sess_count=3, sess_len=4, **kw)
    jp, tp = carry(jm, seed=1)
    batch = seq_batch(data, tm.maxlen, b=16, seed=3)
    assert (batch[1][:, :4] == 0).all() and (batch[1][:, 4] == 0).all()
    key = jax.random.PRNGKey(4)
    assert np.isfinite(assert_loss_and_grads(jm, jp, tm, tp, batch, key,
                                             masks=jax_masks(key, 16)))


@pytest.mark.parametrize("bi", [False, True])
def test_scores_and_dense_positions_match_jax(bi):
    """Histories of 7 items left-padded to S·Ls = 8 (``score_all`` and
    ``score_some``), chunks of 7 over 25 items; dense: no K1 count."""
    data = synthetic_data(seed=3)
    assert data.hist.shape[1] < 8 and data.num_items % 7 != 0
    jm, tm = models(data, chunk=7, sess_count=2, sess_len=4, bi_evolution=bi)
    jp, tp = carry(jm, seed=2)
    assert tm.factored_scorer() is None and tm.eval_batch_users == 128
    before = rank_positions_dot.launches
    assert_scores_match(jm, jp, tm, tp, data)
    assert_positions_match(jm, jp, tm, tp, data)
    assert rank_positions_dot.launches == before
    data = seq_data(seed=1)  # histories wider than the window
    jm, tm = models(data, sess_count=2, sess_len=4)
    jp, tp = carry(jm, seed=3)
    assert_scores_match(jm, jp, tm, tp, data)
