"""The port's GRU4Rec (``acf_tpu_torch/models/gru4rec.py``) and its session
stream (``acf_tpu_torch/ops/topk.py::SessionStream``) on the CPU against
the JAX package's: the three losses and every gradient, scores and the
factored user representation, rank positions through the evaluator, the
streaming step against the recurrence over a window, the stream's top-k,
two training epochs on the JAX draws and the FGSM wrapper.

Tolerances: ``tests/test_torch_rnn.py`` (losses to rtol 1e-5, gradients to
1e-6 of the gradient tree's largest entry, epochs' params and Adam moments
to 1e-5 of each tree's); scores rtol 1e-5, atol 1e-6; top-k items equal
wherever the scores are not tied within that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.models.gru4rec import GRU4Rec as JaxGRU4Rec
from acf_tpu.ops.topk import SessionStream as JaxSessionStream
from acf_tpu_torch.models.dream import DREAM
from acf_tpu_torch.models.gru4rec import GRU4Rec
from acf_tpu_torch.ops.topk import SessionStream
from tests.test_torch_rnn import (
    CPU, assert_fgsm_matches, assert_loss_and_grads, assert_positions_match,
    assert_scores_match, assert_two_seq_epochs_match, carry, seq_batch, t,
)
from tests.test_trainer import synthetic_data

D = 16
MAXLEN = 8


def models(data, **kw):
    args = (data.num_users, data.num_items, D)
    return JaxGRU4Rec(*args, maxlen=MAXLEN, **kw), GRU4Rec(*args, maxlen=MAXLEN, **kw)


CASES = [dict(loss_type="bpr"), dict(loss_type="top1"), dict(loss_type="ce"),
         dict(loss_type="top1", final_act="relu"), dict(loss_type="ce", hidden_act="relu"),
         dict(loss_type="bpr", final_act="tanh")]
IDS = ["-".join(str(v) for v in c.values()) for c in CASES]


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_loss_and_gradients_match_jax(kw):
    """Windows of 7 train items at maxlen 8: every row has pad steps, and
    targets repeat across rows (in-batch negatives that equal the target)."""
    data = synthetic_data(seed=5)
    jm, tm = models(data, **kw)
    jp, tp = carry(jm, seed=3)
    batch = seq_batch(data, MAXLEN, b=16, seed=4)
    assert (batch[1] == 0).any() and (batch[2] == 0).any()
    assert np.isfinite(assert_loss_and_grads(jm, jp, tm, tp, batch))


@pytest.mark.parametrize("kw", CASES[:1] + CASES[3:4] + CASES[5:], ids=["linear", "relu", "tanh"])
def test_scores_and_positions_match_jax(kw):
    """A relu or tanh output has no factored scorer (the JAX package's
    routing to the dense path); the linear one ranks through K1's plain
    version here."""
    data = synthetic_data(seed=6)
    jm, tm = models(data, **kw)
    jp, tp = carry(jm, seed=1)
    assert (tm.factored_scorer() is None) == (kw.get("final_act", "linear") != "linear")
    assert_scores_match(jm, jp, tm, tp, data)
    assert_positions_match(jm, jp, tm, tp, data)


def test_init_params_tree_matches_jax():
    data = synthetic_data()
    jm, tm = models(data)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tm.init_params(torch.Generator().manual_seed(0), device=CPU)
    shapes = {k: tuple(v.shape) if not isinstance(v, dict) else
              {n: tuple(x.shape) for n, x in v.items()} for k, v in tp.items()}
    assert shapes == {k: v.shape if not isinstance(v, dict) else
                      {n: x.shape for n, x in v.items()} for k, v in jp.items()}
    sigma = np.sqrt(6.0 / (data.num_items + D))
    assert float(tp["emb"].abs().max()) <= sigma and (tp["b"] == 0).all()
    with pytest.raises(ValueError, match="loss_type"):
        GRU4Rec(5, 5, 4, loss_type="hinge")


def test_step_state_is_the_recurrence_and_matches_jax():
    """Streaming a window item by item ends in the state of the recurrence
    over the window (pads keep the state); a reset zeroes the slot first;
    every step's state and scores equal JAX's."""
    data = synthetic_data(seed=7)
    jm, tm = models(data, final_act="tanh")
    jp, tp = carry(jm, seed=2)
    users = np.arange(1, 11, dtype=np.int32)
    hist = data.hist[users]
    seq = np.pad(hist, ((0, 0), (MAXLEN - hist.shape[1], 0)))  # 7 items, left-padded
    seq[3] = 0  # no event at all
    state, jstate = tm.init_state(10, device=CPU), jm.init_state(10)
    reset = np.zeros(10, bool)
    for s in range(MAXLEN):
        reset[:] = False
        if s == MAXLEN - 1:
            reset[5] = True
        state, scores = tm.step_state(tp, state, t(seq[:, s]), t(reset) if reset.any() else None)
        jstate, jscores = jm.step_state(jp, jstate, jnp.asarray(seq[:, s]), jnp.asarray(reset))
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=0, atol=1e-6)
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-6)
    hs = tm._hidden_states(tp, t(seq))[:, -1]
    keep = np.arange(10) != 5
    np.testing.assert_allclose(state.numpy()[keep], hs.numpy()[keep], rtol=0, atol=1e-6)
    assert (state.numpy()[3] == 0).all()
    one = tm._hidden_states(tp, t(seq[5:6, -1:]))[:, -1]  # the reset slot: its last item alone
    np.testing.assert_allclose(state.numpy()[5], one.numpy()[0], rtol=0, atol=1e-6)


def _assert_topk_equal(s, it, js, ji):
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)
    close = np.abs(np.diff(js, axis=1)) <= 1e-6 + 1e-5 * np.abs(js[:, 1:])
    tied = np.zeros_like(js, dtype=bool)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(it[~tied], ji[~tied])
    assert (it != 0).all() and it.dtype == np.int32


def test_session_stream_matches_jax():
    """Three events on 6 slots (slot 2 idle in the second, slots 0 and 4
    reset in the third): the state stays on the device between pushes and
    the top-10 equals the JAX stream's."""
    data = synthetic_data(seed=8)
    jm, tm = models(data)
    jp, tp = carry(jm, seed=4)
    stream = SessionStream(tm, tp, batch_size=6, k=10, device=CPU)
    jstream = JaxSessionStream(jm, jp, batch_size=6, k=10)
    rng = np.random.default_rng(0)
    for n in range(3):
        items = rng.integers(1, data.num_items, 6).astype(np.int32)
        reset = None
        if n == 1:
            items[2] = 0
        if n == 2:
            reset = np.array([1, 0, 0, 0, 1, 0], bool)
        s, it = stream.push(items, reset)
        js, ji = jstream.push(items, reset)
        _assert_topk_equal(s, it, js, ji)
        assert stream.state.device.type == "cpu" and tuple(stream.state.shape) == (6, D)
    with pytest.raises(ValueError, match=r"items must be \[6\]"):
        stream.push(np.ones(5, np.int32))
    stream.reset()
    assert (stream.state == 0).all()
    with pytest.raises(ValueError, match="step_state"):
        SessionStream(DREAM(5, 5, 4), {}, batch_size=2, device=CPU)


def test_session_stream_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    tm = GRU4Rec(5, 9, 4, maxlen=3)
    tp = tm.init_params(torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionStream(tm, tp, batch_size=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_params(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("loss_type", ["bpr", "ce"])
def test_two_epochs_match_jax(loss_type):
    data = synthetic_data(seed=9)
    jm, tm = models(data, loss_type=loss_type)
    assert_two_seq_epochs_match(jm, tm, data, MAXLEN)


def test_fgsm_wrapper_matches_jax():
    """The wrapper perturbs ``emb`` and ``W`` (the bias is 1-D)."""
    data = synthetic_data(seed=10)
    jm, tm = models(data, loss_type="top1")
    batch = seq_batch(data, MAXLEN, b=16, seed=2)
    assert assert_fgsm_matches(jm, tm, batch) == ("W", "emb")
    assert_fgsm_matches(jm, tm, batch, adv_steps=2)
