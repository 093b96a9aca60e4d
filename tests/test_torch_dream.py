"""The port's DREAM (``acf_tpu_torch/models/dream.py``) on the CPU against
the JAX package's (``acf_tpu/models/dream.py``): the init tree, the loss
and every gradient, scores and the factored user representation, rank
positions, two training epochs on the JAX draws and the FGSM wrapper.
Tolerances as ``tests/test_torch_rnn.py`` states them.
"""

import jax
import numpy as np
import torch

from acf_tpu.models.dream import DREAM as JaxDREAM
from acf_tpu_torch.models.dream import DREAM
from tests.test_sasrec import seq_data
from tests.test_torch_rnn import (
    CPU, assert_fgsm_matches, assert_loss_and_grads, assert_positions_match,
    assert_scores_match, assert_two_seq_epochs_match, carry, seq_batch,
)
from tests.test_trainer import synthetic_data

D = 16
MAXLEN = 8


def models(data):
    args = (data.num_users, data.num_items, D)
    return JaxDREAM(*args, maxlen=MAXLEN), DREAM(*args, maxlen=MAXLEN)


def test_init_params_tree_matches_jax():
    """``emb`` uniform in ±0.05 with its pad row zero, the SimpleRNN."""
    jm, tm = models(synthetic_data())
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tm.init_params(torch.Generator().manual_seed(0), device=CPU)
    assert tuple(tp["emb"].shape) == jp["emb"].shape
    assert {k: tuple(v.shape) for k, v in tp["rnn"].items()} == \
        {k: v.shape for k, v in jp["rnn"].items()}
    assert (tp["emb"][0] == 0).all() and float(tp["emb"].abs().max()) <= 0.05


def test_loss_and_gradients_match_jax():
    """Padded windows (7 train items at maxlen 8) and full ones."""
    for data in (synthetic_data(seed=1), seq_data(seed=2)):
        jm, tm = models(data)
        jp, tp = carry(jm, seed=1)
        batch = seq_batch(data, MAXLEN, b=16, seed=3)
        assert np.isfinite(assert_loss_and_grads(jm, jp, tm, tp, batch))


def test_scores_and_positions_match_jax():
    data = seq_data(seed=4)
    jm, tm = models(data)
    jp, tp = carry(jm, seed=2)
    assert tm.factored_scorer()[1](tp)[1] is None  # the item table, no bias
    assert_scores_match(jm, jp, tm, tp, data)
    assert_positions_match(jm, jp, tm, tp, data)


def test_two_epochs_match_jax():
    data = synthetic_data(seed=5)
    jm, tm = models(data)
    assert_two_seq_epochs_match(jm, tm, data, MAXLEN)


def test_fgsm_wrapper_matches_jax():
    """The wrapper perturbs the item table ``emb``."""
    data = synthetic_data(seed=6)
    jm, tm = models(data)
    assert assert_fgsm_matches(jm, tm, seq_batch(data, MAXLEN, b=16, seed=1)) == ("emb",)
