"""The port's copy of the data path and the metrics against the JAX
package's: identical arrays field by field, metrics bit-equal."""

import dataclasses
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from acf_tpu.data import interactions_from_frame as jax_interactions_from_frame
from acf_tpu.data import load_dataset as jax_load_dataset
from acf_tpu.eval.metrics import mean_metrics as jax_mean_metrics
from acf_tpu.eval.metrics import metrics_from_position as jax_metrics_from_position
from acf_tpu_torch.data import interactions_from_frame, load_dataset
from acf_tpu_torch.eval.metrics import mean_metrics, metrics_from_position
from tests.test_full_rank import make_data

DATA_DIR = str(Path(__file__).resolve().parent.parent / "data")


def assert_same_interactions(a, b):
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=field.name)
            assert x.dtype == y.dtype, field.name
        else:
            assert x == y, field.name


def _make_data_frame(num_users=12, num_items=30, seed=0):
    """The frame ``tests/test_full_rank.py::make_data`` builds."""
    rng = np.random.default_rng(seed)
    rows, t = [], 0
    for u in range(1, num_users):
        for i in rng.choice(np.arange(1, num_items), size=rng.integers(3, 10),
                            replace=True):
            rows.append((u, int(i), t))
            t += 1
    return pd.DataFrame(rows, columns=["uid", "iid", "timestamp"])


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_make_data_frame_matches_jax(seed):
    df = _make_data_frame(seed=seed)
    ours = interactions_from_frame(df, reindex=False)
    assert_same_interactions(ours, make_data(seed=seed))
    assert_same_interactions(ours, jax_interactions_from_frame(df, reindex=False))


@pytest.mark.parametrize("kwargs", [
    {"max_hist_len": 3},
    {"num_negatives": 100, "seed": 2019},
    {"reindex": True, "max_hist_len": 5, "num_negatives": 10, "seed": 7},
], ids=["truncated", "negatives", "reindexed"])
def test_interactions_from_frame_matches_jax(kwargs):
    rng = np.random.default_rng(1)
    n = 600
    df = pd.DataFrame({"uid": rng.integers(5, 60, size=n) * 3,
                       "iid": rng.integers(2, 200, size=n) * 7,
                       "timestamp": rng.permutation(n)})
    kwargs = {"reindex": False, **kwargs}
    assert_same_interactions(interactions_from_frame(df, **kwargs),
                             jax_interactions_from_frame(df, **kwargs))


@pytest.mark.parametrize("eval_mode", ["all", "sample"])
def test_load_test_dataset_matches_jax(eval_mode):
    assert_same_interactions(load_dataset("test", DATA_DIR, eval_mode=eval_mode),
                             jax_load_dataset("test", DATA_DIR, eval_mode=eval_mode))


def test_metrics_bit_equal():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 500, size=257).astype(np.int32)
    pos[:5] = [0, 1, 9, 10, 99]
    num_neg = rng.integers(0, 600, size=257).astype(np.int32)
    for ours, ref in zip(metrics_from_position(pos, num_neg, 100),
                         jax_metrics_from_position(pos, num_neg, 100)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    assert mean_metrics(*metrics_from_position(pos, num_neg), k=10) == \
        jax_mean_metrics(*jax_metrics_from_position(pos, num_neg), k=10)
