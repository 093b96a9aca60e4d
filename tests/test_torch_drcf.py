"""The port's DRCF (``acf_tpu_torch/models/drcf.py``) on the CPU against the
JAX package's (``acf_tpu/models/drcf.py``): the init tree, the loss and
every gradient, scores (in item chunks, the last one short: the port
scores only real items where the JAX package pads the chunk), dense rank
positions through the evaluator, and the FGSM wrapper around its twelve
tables. Tolerances as ``tests/test_torch_rnn.py`` states them.
"""

import jax
import numpy as np
import pytest
import torch

from acf_tpu.models.drcf import DRCF as JaxDRCF
from acf_tpu_torch.models.drcf import DRCF
from acf_tpu_torch.ops.ranking import rank_positions_dot
from tests.test_sasrec import seq_data
from tests.test_torch_rnn import (
    CPU, assert_fgsm_matches, assert_loss_and_grads, assert_positions_match,
    assert_scores_match, carry, seq_batch, t,
)
from tests.test_trainer import synthetic_data

D = 16
MAXLEN = 5


def models(data, chunk=None):
    args = (data.num_users, data.num_items, D)
    jm, tm = JaxDRCF(*args, maxlen=MAXLEN), DRCF(*args, maxlen=MAXLEN)
    if chunk is not None:
        jm._item_chunk = tm._item_chunk = chunk
    return jm, tm


def test_init_params_tree_matches_jax():
    data = synthetic_data()
    jm, tm = models(data)
    from acf_tpu.train.checkpoint import _flatten_with_names as jax_named
    from acf_tpu_torch.train.checkpoint import _flatten_with_names

    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tm.init_params(torch.Generator().manual_seed(0), device=CPU)
    assert {n: tuple(x.shape) for n, x in _flatten_with_names(tp)} == \
        {n: v.shape for n, v in jax_named(jp).items()}
    assert float(tp["mlp_c"].abs().max()) <= 0.02 and tuple(tp["l1"]["w"].shape) == (25, 48)
    assert tm.eval_batch_users == 128


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_jax(seed):
    data = (synthetic_data if seed else seq_data)(seed=seed)
    jm, tm = models(data)
    jp, tp = carry(jm, seed=seed)
    batch = seq_batch(data, MAXLEN, b=16, seed=seed)
    assert np.isfinite(assert_loss_and_grads(jm, jp, tm, tp, batch))


@pytest.mark.parametrize("chunk", [2048, 7])
def test_scores_and_dense_positions_match_jax(chunk):
    """One chunk, and chunks of 7 items with a short last one (25 items);
    ranking is dense: K1's counter does not move."""
    data = seq_data(seed=2)
    assert data.num_items % 7 != 0
    jm, tm = models(data, chunk)
    jp, tp = carry(jm, seed=3)
    assert tm.factored_scorer() is None
    before = rank_positions_dot.launches
    assert_scores_match(jm, jp, tm, tp, data)
    assert_positions_match(jm, jp, tm, tp, data)
    assert rank_positions_dot.launches == before
    scores = tm.score_all(tp, t(np.arange(1, 4, dtype=np.int32)), t(data.hist[1:4]))
    assert tuple(scores.shape) == (3, data.num_items)


def test_fgsm_wrapper_matches_jax():
    """The wrapper perturbs the twelve tables (user, item and sequence
    tables of the four towers)."""
    data = synthetic_data(seed=3)
    jm, tm = models(data)
    names = assert_fgsm_matches(jm, tm, seq_batch(data, MAXLEN, b=16, seed=4))
    assert names == tuple(sorted(f"{k}_{s}" for k in ("mf", "dot_mf", "mlp", "dot_mlp")
                                 for s in "uic"))
