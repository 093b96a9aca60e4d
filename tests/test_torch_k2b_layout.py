"""K2b's launch layouts at every shape training takes, on the CPU: for every
width d <= 128 and every window T up to ``max_window(d)``, the form
``_bwd_form`` picks and that form's layout as the C entries check it (shared
memory a CTA, the rows a product's register tile covers, the wide form's
cluster of 1, 2 or 4 CTAs and its weight slices, in its float32 and its
bfloat16 build); the wide form's split of a window over a cluster; the
limits ``check_supported`` keeps."""

import pytest

from acf_tpu_torch.ops.sasrec_fused import (
    BWD_ROWS_PER_THREAD, BWD_WIDE_ROWS_PER_THREAD, BWD_WIDE_THREADS, MAX_D, SMEM_LIMIT,
    _bwd_form, _bwd_layout, _bwd_wide_layout, _cluster_pieces, _cluster_rows, _dp,
    _slice_rows, check_supported, max_train_window, max_window,
)

KEYS_PER_LANE = 7  # kMaxKeysPerLane in csrc/sasrec_encoder_bwd.cu: dS's registers


def row_groups(threads, d):
    return threads // (_dp(d) // 4)


@pytest.mark.parametrize("d", range(1, MAX_D + 1))
def test_every_training_shape_has_a_form_that_fits(d):
    assert max_train_window(d) == max_window(d) >= 1
    for t in range(1, max_window(d) + 1):
        form = _bwd_form(t, d)
        assert form in ("tile", "wide")
        if form == "tile":
            users, threads, smem = _bwd_layout(t, d)
            assert d % 4 == 0 and smem <= SMEM_LIMIT
            assert users * t <= BWD_ROWS_PER_THREAD * row_groups(threads, d)
        # the wide form takes every shape, in both builds: unaligned tensors
        # go to it at any T
        assert _bwd_form(t, d, aligned=False) == "wide"
        for bf16 in (False, True):
            cluster, ks, threads, smem = _bwd_wide_layout(t, d, bf16)
            assert cluster in (1, 2, 4) and threads == BWD_WIDE_THREADS[bf16]
            assert smem <= SMEM_LIMIT and ks % 4 == 0 and 4 <= ks <= _slice_rows(d)
            rows = BWD_WIDE_ROWS_PER_THREAD[bf16] * row_groups(threads, d)
            assert _cluster_rows(t, cluster) <= rows
        assert t <= 32 * KEYS_PER_LANE


@pytest.mark.parametrize("c", [1, 2, 4])
def test_cluster_pieces_split_every_window_and_its_causal_work(c):
    """Each rank owns two pieces (s and 2c - 1 - s, ascending), the ranks
    cover the window once, and from T = 50 on no rank meets more than 15 %
    above its share of the causal pairs (none at all where 2c divides T,
    as at the SASRec paper's T = 200)."""
    for t in range(1, 201):
        pieces = _cluster_pieces(t, c)
        assert sorted(i for rows in pieces for i in rows) == list(range(t))
        assert all(rows == sorted(rows) for rows in pieces)
        assert _cluster_rows(t, c) == max(map(len, pieces))
        if t >= 50:
            pairs = [sum(i + 1 for i in rows) for rows in pieces]
            share = t * (t + 1) / 2 / c
            assert max(pairs) <= (1.0 if t % (2 * c) == 0 else 1.15) * share, (t, pairs)


@pytest.mark.parametrize("kw,match", [
    (dict(t=8, d=64, num_heads=2), "single-head"),
    (dict(t=201, d=50, num_heads=1), "1 to 200 items at d=50; got t=201"),
    (dict(t=109, d=128, num_heads=1), "1 to 108 items at d=128; got t=109"),
    (dict(t=8, d=129, num_heads=1), "1 <= d <= 128; got d=129"),
])
def test_the_limits_stay(kw, match):
    for train in (False, True):
        with pytest.raises(ValueError, match=match):
            check_supported(train=train, **kw)
