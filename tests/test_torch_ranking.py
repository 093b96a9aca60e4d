"""The port's rank counter (its plain version, on the CPU) against the JAX
Pallas kernel in interpret mode and the numpy count — exact (integer
counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.ops.ranking import rank_positions_dot as jax_rank_positions_dot
from acf_tpu_torch.ops.ranking import check_supported, rank_positions_dot, rank_positions_dot_plain


def _inputs(seed, b, d, n_items, with_bias_gt):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, d)).astype(np.float32)
    E = rng.standard_normal((n_items, d)).astype(np.float32)
    t = rng.standard_normal(b).astype(np.float32)
    bias = rng.standard_normal(n_items).astype(np.float32) if with_bias_gt else None
    gt = rng.integers(1, n_items, size=b).astype(np.int32) if with_bias_gt else None
    return u, E, t, bias, gt


def _numpy_count(u, E, t, bias, gt):
    scores = u @ E.T
    if bias is not None:
        scores = scores + bias[None, :]
    ge = scores >= t[:, None]
    ge[:, 0] = False  # pad column excluded
    if gt is not None:
        ge[np.arange(len(u)), gt] = False  # gt column excluded
    return ge.sum(1)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("with_bias_gt", [True, False], ids=["bias_gt", "plain"])
def test_rank_positions_match_jax_and_numpy(with_bias_gt):
    u, E, t, bias, gt = _inputs(0, 16, 8, 300, with_bias_gt)  # 300: ragged tiles
    got = rank_positions_dot(_t(u), _t(E), _t(t), bias=_t(bias), gt=_t(gt))
    assert got.dtype == torch.float32 and got.shape == (16,)
    ref_jax = np.asarray(jax_rank_positions_dot(
        jnp.asarray(u), jnp.asarray(E), jnp.asarray(t), bias=_j(bias), gt=_j(gt),
        item_tile=128, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref_jax)
    np.testing.assert_array_equal(got.numpy(), _numpy_count(u, E, t, bias, gt))


def test_cpu_wrapper_is_the_plain_version():
    u, E, t, bias, gt = _inputs(3, 8, 4, 50, True)
    np.testing.assert_array_equal(
        rank_positions_dot(_t(u), _t(E), _t(t), bias=_t(bias), gt=_t(gt)).numpy(),
        rank_positions_dot_plain(_t(u), _t(E), _t(t), bias=_t(bias), gt=_t(gt)).numpy())


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "gt_dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    u, E, t, bias, gt = (_t(x) for x in _inputs(1, 8, 4, 50, True))
    if bad == "dtype":
        u = u.double()
    elif bad == "shape":
        t = t[:4]
    elif bad == "contiguity":
        E = torch.from_numpy(np.asfortranarray(E.numpy()))
    else:
        gt = gt.long()
    with pytest.raises((TypeError, ValueError)):
        rank_positions_dot(u, E, t, bias=bias, gt=gt)


@pytest.mark.parametrize("d", [4, 8, 64, 256, 260, 1024])
def test_check_supported_takes_any_width_divisible_by_4(d):
    """K1 streams k in slices, so no width limit is left but d % 4 == 0."""
    check_supported(torch.zeros(3, d), torch.zeros(5, d))


@pytest.mark.parametrize("case", ["d=6", "d=2", "d=0", "u_repr offset", "item_emb offset"])
def test_check_supported_takes_any_width_and_alignment(case):
    """What the kernel once refused (d % 4 != 0, d < 4, a table not 16-byte
    aligned) it now takes: 4-byte copies where TMA cannot describe the
    rows, and d = 0 counts the biases alone."""
    d = {"d=6": 6, "d=2": 2, "d=0": 0}.get(case, 64)
    u, E = torch.zeros(3, d), torch.zeros(5, d)
    if case == "u_repr offset":
        u = torch.zeros(3 * d + 1)[1:].view(3, d)
    elif case == "item_emb offset":
        E = torch.zeros(5 * d + 1)[1:].view(5, d)
    check_supported(u, E)
    t = torch.full((3,), -1.0)
    np.testing.assert_array_equal(rank_positions_dot(u, E, t).numpy(), [4.0, 4.0, 4.0])


@pytest.mark.parametrize("with_bias_gt", [True, False], ids=["bias_gt", "plain"])
def test_rank_positions_at_d10_match_jax(with_bias_gt):
    """A width that is not a multiple of 4 (the kernel's 4-byte copy path)
    against the JAX Pallas kernel in interpret mode and numpy: exact."""
    u, E, t, bias, gt = _inputs(7, 16, 10, 300, with_bias_gt)
    got = rank_positions_dot(_t(u), _t(E), _t(t), bias=_t(bias), gt=_t(gt))
    ref_jax = np.asarray(jax_rank_positions_dot(
        jnp.asarray(u), jnp.asarray(E), jnp.asarray(t), bias=_j(bias), gt=_j(gt),
        item_tile=128, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref_jax)
    np.testing.assert_array_equal(got.numpy(), _numpy_count(u, E, t, bias, gt))


@pytest.mark.parametrize("d", [10, 64])
def test_rank_positions_on_an_unaligned_row_view_match_jax(d):
    """Rows 5.. of a table one float into its buffer (a view whose first row
    is not 16-byte aligned, as a catalog shard's can be) and users one float
    into theirs, against JAX on the same rows: exact."""
    u, E, t, bias, gt = _inputs(8, 16, d, 305, True)

    def one_float_in(x):
        buf = torch.zeros(x.size + 1)
        buf[1:] = torch.from_numpy(x).flatten()
        return buf[1:].view(*x.shape)

    view, u_view = one_float_in(E)[5:], one_float_in(u)
    assert view.data_ptr() % 16 and u_view.data_ptr() % 16
    gt_local = np.clip(gt - 5, 1, 299).astype(np.int32)
    got = rank_positions_dot(u_view, view, _t(t), bias=_t(bias[5:].copy()), gt=_t(gt_local))
    ref_jax = np.asarray(jax_rank_positions_dot(
        jnp.asarray(u), jnp.asarray(E[5:]), jnp.asarray(t), bias=_j(bias[5:].copy()),
        gt=_j(gt_local), item_tile=128, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref_jax)


@pytest.mark.parametrize("m", [2, 3, 7])
@pytest.mark.parametrize("with_bias_gt", [True, False], ids=["bias_gt", "plain"])
def test_shard_counts_with_id_base_sum_to_the_whole_table(m, with_bias_gt):
    """A catalog shard (rows id_base .. id_base + real - 1, the zero rows
    that pad the last shard left out) counts its items with the pad id 0 and
    the gt masked by global id; the shards' counts sum to the whole table's,
    which is JAX's count (the sharded evaluation's merge)."""
    u, E, t, bias, gt = _inputs(5, 16, 8, 301, with_bias_gt)
    il = -(-301 // m)
    total = np.zeros(16, np.float32)
    for r in range(m):
        rows = slice(r * il, min((r + 1) * il, 301))
        got = rank_positions_dot(_t(u), _t(np.ascontiguousarray(E[rows])), _t(t),
                                 bias=None if bias is None else _t(np.ascontiguousarray(bias[rows])),
                                 gt=_t(gt), id_base=r * il)
        scores = u @ E[rows].T + (0 if bias is None else bias[rows])
        ge = scores >= t[:, None]
        ids = np.arange(rows.start, rows.stop)
        ge &= ids[None, :] != 0
        if gt is not None:
            ge &= ids[None, :] != gt[:, None]
        np.testing.assert_array_equal(got.numpy(), ge.sum(1))
        total += got.numpy()
    np.testing.assert_array_equal(total, _numpy_count(u, E, t, bias, gt))
    np.testing.assert_array_equal(total, np.asarray(jax_rank_positions_dot(
        jnp.asarray(u), jnp.asarray(E), jnp.asarray(t), bias=_j(bias), gt=_j(gt),
        item_tile=128, interpret=True)))


def test_id_base_zero_is_the_whole_catalog_and_negative_raises():
    u, E, t, bias, gt = _inputs(6, 8, 4, 50, True)
    args = (_t(u), _t(E), _t(t))
    np.testing.assert_array_equal(
        rank_positions_dot(*args, bias=_t(bias), gt=_t(gt), id_base=0).numpy(),
        rank_positions_dot(*args, bias=_t(bias), gt=_t(gt)).numpy())
    with pytest.raises(ValueError, match="id_base"):
        rank_positions_dot(*args, id_base=-1)
