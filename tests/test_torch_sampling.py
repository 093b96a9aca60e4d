"""The port's sequence-window sampler against the JAX package's
(``acf_tpu/sampling/negatives.py:66-127``).

With JAX's draws injected (the user indices and the candidate rounds that
``jax.random.randint`` gives for the same split keys), users, windows and
negatives are equal exactly: the sampler is integer arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.sampling.negatives import sample_seq_batch as jax_sample_seq_batch
from acf_tpu.sampling.negatives import sample_seq_window_batch as jax_sample_window
from acf_tpu_torch.sampling import (
    sample_seq_batch, sample_seq_window_batch, seq_window_from_draws,
)

ROUNDS = 8


def histories(num_users=30, width=12, num_items=20, seed=0):
    """Right-aligned 0-padded histories of random lengths; user 3 draws from
    two items only, so its candidates collide often."""
    rng = np.random.default_rng(seed)
    hist = np.zeros((num_users, width), np.int32)
    for u in range(num_users):
        n = int(rng.integers(0, width + 1))
        hist[u, width - n:] = rng.integers(1, num_items, n)
    hist[3] = rng.integers(1, 3, width)
    eligible = np.nonzero((hist != 0).sum(1) >= 2)[0].astype(np.int32)
    return hist, eligible


def jax_draws(key, n_eligible, batch, maxlen, num_items):
    """The draws the JAX sampler makes from ``key`` (its own split)."""
    k_u, k_n = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_u, (batch,), 0, n_eligible))
    cand = np.asarray(jax.random.randint(k_n, (ROUNDS, batch, maxlen), 1, num_items,
                                         dtype=jnp.int32))
    return idx, cand


def port(hist, eligible, idx, cand, maxlen):
    return seq_window_from_draws(*(torch.from_numpy(np.array(a)) for a in (hist, eligible, idx, cand)),
                                 maxlen)


@pytest.mark.parametrize("maxlen", [5, 11, 15, 24])  # windows cut, exact, and left-padded
@pytest.mark.parametrize("seed", [0, 1])
def test_window_batch_equals_jax_with_its_draws(maxlen, seed):
    num_items, batch = 20, 16
    hist, eligible = histories(seed=seed, num_items=num_items)
    key = jax.random.PRNGKey(100 * seed + maxlen)
    ju, jw, jn = jax_sample_window(key, jnp.asarray(hist), jnp.asarray(eligible), maxlen,
                                   num_items, batch)
    idx, cand = jax_draws(key, len(eligible), batch, maxlen, num_items)
    tu, tw, tn = port(hist, eligible, idx, cand, maxlen)
    assert tw.shape == (batch, maxlen + 1) and tn.shape == (batch, maxlen)
    assert tw.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_short_histories_are_left_padded_as_jax_pads_them():
    """L < maxlen + 1: the window is the whole row behind zeros."""
    hist, eligible = histories(width=6)
    idx = np.arange(8) % len(eligible)
    cand = np.random.default_rng(0).integers(1, 20, (ROUNDS, 8, 10)).astype(np.int32)
    _, window, neg = port(hist, eligible, idx, cand, 10)
    rows = hist[eligible[idx]]
    np.testing.assert_array_equal(window[:, 5:].numpy(), rows)
    assert not window[:, :5].any()
    assert not neg[window[:, 1:] == 0].any()  # pad positions carry negative 0


def test_all_collide_falls_back_to_the_last_round():
    """A user whose every candidate is a train item keeps the last round's
    draw (the JAX scan's init), as the JAX sampler does."""
    hist = np.array([[0, 1, 2, 3, 4], [0, 0, 5, 6, 7]], np.int32)
    eligible = np.array([0, 1], np.int32)
    cand = np.empty((ROUNDS, 2, 4), np.int32)
    cand[:, 0] = np.arange(ROUNDS)[:, None] % 4 + 1  # user 0: always a train item
    cand[:, 1] = 5                                   # user 1: collides ...
    cand[3, 1, 2] = 9                                # ... but round 3 at position 2
    idx = np.array([0, 1])
    _, window, neg = port(hist, eligible, idx, cand, 4)
    np.testing.assert_array_equal(neg[0].numpy(), cand[-1, 0])
    assert neg[1, 2] == 9
    np.testing.assert_array_equal(neg[1, [0, 1, 3]].numpy(), [0, 5, 5])  # pad, fallback x2
    # the same through the JAX scan, with these candidates as its draws
    ju, jw, jn = jax.jit(lambda c: _jax_with_cand(hist, eligible, idx, c, 4))(cand)
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jn))


def _jax_with_cand(hist, eligible, idx, cand, maxlen):
    """The body of ``acf_tpu.sampling.negatives.sample_seq_window_batch``
    after its draws, run on given candidates."""
    users = jnp.asarray(eligible)[idx]
    rows = jnp.asarray(hist)[users]
    L = rows.shape[1]
    window = rows[:, L - maxlen - 1:] if L >= maxlen + 1 else \
        jnp.pad(rows, ((0, 0), (maxlen + 1 - L, 0)))
    pos = window[:, 1:]

    def body(carry, cand_r):
        chosen, done = carry
        collide = (cand_r[:, :, None] == rows[:, None, :]).any(-1)
        take = (~collide) & (~done)
        return (jnp.where(take, cand_r, chosen), done | ~collide), None

    (neg, _), _ = jax.lax.scan(body, (cand[-1], jnp.zeros(pos.shape, bool)), cand)
    return users, window, jnp.where(pos != 0, neg, 0)


def test_seq_batch_is_the_window_sliced():
    hist, eligible = histories()
    key = jax.random.PRNGKey(7)
    ju, js, jp, jn = jax_sample_seq_batch(key, jnp.asarray(hist), jnp.asarray(eligible), 8,
                                          20, 12)
    idx, cand = jax_draws(key, len(eligible), 12, 8, 20)
    tu, tw, tn = port(hist, eligible, idx, cand, 8)
    np.testing.assert_array_equal(tw[:, :-1].numpy(), np.asarray(js))
    np.testing.assert_array_equal(tw[:, 1:].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_generator_wrapper_draws_on_its_device_and_repeats():
    """Same seed, same batch; users are eligible; negatives are in range and,
    in a catalog of 200 where a history holds at most 12 items, never a
    train item (all 8 rounds colliding has odds below 1e-11)."""
    hist, eligible = histories()
    h, e = torch.from_numpy(hist), torch.from_numpy(eligible)
    a = sample_seq_window_batch(torch.Generator().manual_seed(3), h, e, 8, 200, 32)
    b = sample_seq_window_batch(torch.Generator().manual_seed(3), h, e, 8, 200, 32)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    users, window, neg = a
    assert set(users.tolist()) <= set(eligible.tolist())
    pad = window[:, 1:] == 0
    assert (neg[pad] == 0).all() and (neg[~pad] >= 1).all() and (neg < 200).all()
    for row in range(32):
        train = set(hist[int(users[row])].tolist()) - {0}
        assert not train & set(neg[row].tolist())
    u2, s2, p2, n2 = sample_seq_batch(torch.Generator().manual_seed(3), h, e, 8, 200, 32)
    torch.testing.assert_close(s2, window[:, :-1], rtol=0, atol=0)
    torch.testing.assert_close(p2, window[:, 1:], rtol=0, atol=0)
    torch.testing.assert_close(n2, neg, rtol=0, atol=0)
