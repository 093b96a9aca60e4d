"""The port's offline preprocessing (``acf_tpu_torch/data/process.py``, a
copy of ``acf_tpu/data/process.py``) against the JAX package's on the
CPU: ``tests/test_data.py::test_sort_dup_matches_reference_drop_duplicates``
and ``test_negative_writer_roundtrip`` with both packages' outputs equal
(frames and files byte for byte), read back by the port's loader; the
10-core filter and the consecutive collapse."""

import numpy as np
import pandas as pd
import pytest

from acf_tpu.data import process as jax_process
from acf_tpu_torch.data import load_dataset, process

RATING = ["uid", "iid", "rating", "timestamp"]


def read_rating(path):
    return pd.read_csv(path, sep="\t", header=None, names=RATING)


def same_files(port_dir, jax_dir, names):
    for name in names:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name


def test_sort_dup_matches_reference_drop_duplicates(tmp_path):
    """-sort-dup keeps the row set of the reference's
    ``df.drop_duplicates(['uid','iid'])`` (process_data.py:27), including
    non-consecutive repeats; the consecutive-only collapse is a different
    opt-in; dedup=True routes through the reference semantics."""
    df = pd.DataFrame({"uid": [1, 1, 1, 1, 2, 2, 2],
                       "iid": [5, 7, 5, 7, 6, 6, 8],
                       "timestamp": [10, 20, 30, 40, 1, 2, 3]})
    want = df.sort_values(["uid", "timestamp"]).drop_duplicates(["uid", "iid"])
    got = process.drop_duplicate_pairs(df)
    pd.testing.assert_frame_equal(got.reset_index(drop=True), want.reset_index(drop=True))
    pd.testing.assert_frame_equal(got, jax_process.drop_duplicate_pairs(df))
    assert got["timestamp"].tolist() == [10, 20, 1, 3]
    cons = process.collapse_consecutive_duplicates(df)
    assert cons["timestamp"].tolist() == [10, 20, 30, 40, 1, 3]
    pd.testing.assert_frame_equal(cons, jax_process.collapse_consecutive_duplicates(df))

    for dedup in (True, "consecutive", False):
        for mod, sub in ((process, "port"), (jax_process, "jax")):
            mod.write_rating_files(df, str(tmp_path / f"{sub}{dedup}"), "toy", reindex=False,
                                   dedup=dedup)
        same_files(tmp_path / f"port{dedup}", tmp_path / f"jax{dedup}",
                   ("toy.train.rating", "toy.test.rating"))
    train = read_rating(tmp_path / "portTrue" / "toy.train.rating")
    test = read_rating(tmp_path / "portTrue" / "toy.test.rating")
    assert train[["uid", "iid"]].values.tolist() == [[1, 5], [2, 6]]
    assert test[["uid", "iid"]].values.tolist() == [[1, 7], [2, 8]]


def test_negative_writer_roundtrip(tmp_path):
    """write_negative_file -> the port's loader: the HeDataset format, raw
    0-based ids on disk and +1 on read, aligned by the (u,gt) head field,
    no negative among the user's train items or the held-out item; the
    JAX package's writer gives the same files from the same seed."""
    rng = np.random.default_rng(3)
    rows, t = [], 0
    for u in range(12):
        for i in rng.choice(np.arange(30), size=6, replace=False):
            rows.append((u, int(i), t))
            t += 1
    df = pd.DataFrame(rows, columns=["uid", "iid", "timestamp"])
    process.write_rating_files(df, str(tmp_path / "port"), "rt", reindex=False,
                               num_negatives=7, seed=11)
    jax_process.write_rating_files(df, str(tmp_path / "jax"), "rt", reindex=False,
                                   num_negatives=7, seed=11)
    same_files(tmp_path / "port", tmp_path / "jax",
               ("rt.train.rating", "rt.test.rating", "rt.test.negative"))
    d = load_dataset("rt", str(tmp_path / "port"), eval_mode="sample")
    assert d.test_negatives is not None and d.test_negatives.shape[1] == 7
    lines = (tmp_path / "port" / "rt.test.negative").read_text().strip().split("\n")
    assert len(lines) == 12
    for ln in lines:
        parts = ln.split("\t")
        u_raw, gt_raw = (int(x) for x in parts[0].strip("()").split(","))
        negs_raw = [int(x) for x in parts[1:]]
        assert len(negs_raw) == 7 and len(set(negs_raw)) == 7
        u = u_raw + 1
        assert int(d.test_item[u]) == gt_raw + 1
        np.testing.assert_array_equal(d.test_negatives[u], np.asarray(negs_raw) + 1)
        seen = set(d.hist[u][d.hist[u] > 0].tolist()) | {int(d.test_item[u])}
        assert not (set((np.asarray(negs_raw) + 1).tolist()) & seen)
    with pytest.raises(ValueError, match="candidate negatives"):
        process.write_negative_file(*process.leave_one_out_split(df), str(tmp_path), "x",
                                    num_negatives=30)


def test_core_filter_and_leave_one_out_equal_jax():
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"uid": rng.integers(0, 250, 2000), "iid": rng.integers(0, 60, 2000),
                       "timestamp": rng.permutation(2000)})
    got = process.core_filter(df)
    pd.testing.assert_frame_equal(got, jax_process.core_filter(df))
    assert (got.groupby("uid")["iid"].nunique() >= 10).all() and len(got) < len(df)
    for a, b in zip(process.leave_one_out_split(got), jax_process.leave_one_out_split(got)):
        pd.testing.assert_frame_equal(a, b)
