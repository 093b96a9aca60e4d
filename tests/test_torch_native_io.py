"""The port's native parser (``acf_tpu_torch/data/native_io.py`` over its copy
``acf_tpu_torch/native/acf_native.cpp``) against the JAX package's
(``acf_tpu/data/native_io.py``) and against pandas, on files written in
``tmp_path`` and on ``data/brightkite.txt``; the loaders routed through it
against the JAX package's; and the one difference from the JAX bridge: a
build that fails raises instead of returning ``None``.

Every comparison is exact: both parsers run the same C code on the same
bytes, and pandas reads the same decimal strings."""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from acf_tpu.data import load_dataset as jax_load_dataset
from acf_tpu.data import native_io as jax_native_io
from acf_tpu_torch.data import load_dataset, native_io

ROOT = Path(__file__).resolve().parent.parent
BRIGHTKITE = str(ROOT / "data" / "brightkite.txt")


@pytest.fixture(scope="module", autouse=True)
def jax_bridge(tmp_path_factory):
    """The JAX bridge built into a library of this module's own. Its default
    path, ``~/.cache/acf_tpu/libacf_native.so``, is written in place by g++
    and shared by every test process, so a process that loads it while
    another writes it gets ``None`` for its whole life (``_TRIED``). The
    bridge's state is restored afterwards."""
    lib = str(tmp_path_factory.mktemp("jax_native") / "libacf_native.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_io, "_lib_path", lambda: lib)
        mp.setattr(jax_native_io, "_TRIED", False)
        mp.setattr(jax_native_io, "_LIB", None)
        if jax_native_io.get_lib() is None:
            pytest.fail(f"the JAX bridge's library did not build or load at {lib}")
        yield


def write_two_col(path, seed=0, n=500):
    rng = np.random.default_rng(seed)
    u, i = rng.integers(1, 60, n), rng.integers(1, 90, n)
    path.write_text("".join(f"{a} {b}\n" for a, b in zip(u, i)))
    return u, i


def write_rating(path, seed=0, n=500, users=40, items=70):
    """4 tab-separated columns; ratings with decimals, timestamps near 1e9."""
    rng = np.random.default_rng(seed)
    u, i = rng.integers(0, users, n), rng.integers(0, items, n)
    r = np.round(rng.uniform(0.5, 5.0, n), 3)
    t = rng.integers(10 ** 9, 2 * 10 ** 9, n)
    path.write_text("".join(f"{a}\t{b}\t{c}\t{d}\n" for a, b, c, d in zip(u, i, r, t)))
    return u, i, r, t


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_parse_two_col_equals_jax_and_pandas(tmp_path):
    p = tmp_path / "Video.txt"
    write_two_col(p)
    got = native_io.parse_two_col(str(p))
    assert_same(got, jax_native_io.parse_two_col(str(p)))
    df = pd.read_csv(p, sep=" ", names=["uid", "iid"])
    np.testing.assert_array_equal(got[0], df["uid"].to_numpy())
    np.testing.assert_array_equal(got[1], df["iid"].to_numpy())


def test_parse_two_col_skips_blank_and_short_lines(tmp_path):
    """``tests/test_native_io.py::test_parse_two_col`` plus a line with one
    field and CRLF endings."""
    p = tmp_path / "pairs.txt"
    p.write_text("1 10\n2 20\r\n2 21\n\n7\n3 30\n")
    got = native_io.parse_two_col(str(p))
    assert_same(got, jax_native_io.parse_two_col(str(p)))
    np.testing.assert_array_equal(got[0], [1, 2, 2, 3])
    np.testing.assert_array_equal(got[1], [10, 20, 21, 30])


def test_parse_rating_equals_jax_and_pandas(tmp_path):
    p = tmp_path / "x.train.rating"
    write_rating(p)
    got = native_io.parse_rating(str(p))
    assert_same(got, jax_native_io.parse_rating(str(p)))
    df = pd.read_csv(p, sep="\t", names=["uid", "iid", "rating", "timestamp"])
    for a, col in zip(got, ("uid", "iid", "rating", "timestamp")):
        np.testing.assert_array_equal(a, df[col].to_numpy())


@pytest.mark.parametrize("parser", ["parse_two_col", "parse_rating"])
def test_parsers_equal_jax_on_brightkite(parser):
    """The bundled check-in file: 5 tab-separated fields (uid, timestamp,
    lat, lng, venue). Both parsers read its leading numeric fields the same
    way; the two-column one equals pandas on its first two columns."""
    got = getattr(native_io, parser)(BRIGHTKITE)
    want = getattr(jax_native_io, parser)(BRIGHTKITE)
    assert got is not None and len(got[0]) == 12000
    assert_same(got, want)
    if parser == "parse_two_col":
        df = pd.read_csv(BRIGHTKITE, sep="\t", header=None, usecols=[0, 1])
        np.testing.assert_array_equal(got[0], df[0].to_numpy())
        np.testing.assert_array_equal(got[1], df[1].to_numpy())


@pytest.mark.parametrize("stamp,to_pandas", [("Sat Oct 16 03:48:54", True),
                                             ("2010-10-16 03:48:54", False)])
def test_text_timestamps(tmp_path, stamp, to_pandas):
    """A file the parser mostly cannot read (timestamps that start with a
    letter) returns None in both packages, and the loader takes pandas'
    frame; a date string's leading year parses as a number in both
    (``tests/test_native_io.py::test_parse_rating_rejects_text_timestamps``)."""
    rows = "".join(f"{u}\t{i}\t1\t{stamp}\n" for u, i in ((1, 2), (1, 3), (2, 2), (2, 4)) * 5)
    p = tmp_path / "x.train.rating"
    p.write_text(rows)
    got, want = native_io.parse_rating(str(p)), jax_native_io.parse_rating(str(p))
    if to_pandas:
        assert got is None and want is None
    else:
        assert_same(got, want)
        np.testing.assert_array_equal(got[3], 2010)
    from acf_tpu.data.datasets import _load_rating_tsv as jax_load
    from acf_tpu_torch.data.datasets import _load_rating_tsv

    frame, jframe = _load_rating_tsv(str(p)), jax_load(str(p))
    pd.testing.assert_frame_equal(frame, jframe)
    if to_pandas:
        assert frame["timestamp"].iloc[0] == stamp


def test_caser_windows_equal_jax():
    """``tests/test_native_io.py::test_caser_windows_matches_python``'s
    histories: every window of the port equals the JAX package's."""
    rng = np.random.default_rng(0)
    num_users, width = 12, 10
    hist = np.zeros((num_users, width), np.int32)
    hist_len = np.zeros(num_users, np.int32)
    for u in range(1, num_users):
        n = int(rng.integers(0, width + 1))
        hist_len[u] = n
        if n:
            hist[u, width - n:] = rng.integers(1, 50, size=n)
    for L, T in ((4, 3), (2, 1), (9, 2), (10, 1)):
        got = native_io.caser_windows(hist, hist_len, L, T)
        assert_same(got, jax_native_io.caser_windows(hist, hist_len, L, T))
        assert got[1].shape == (len(got[0]), L) and got[2].shape == (len(got[0]), T)
    with pytest.raises(ValueError, match="hist_len"):
        native_io.caser_windows(hist, hist_len[:-1], 4, 3)  # checked before any pointer passes


@pytest.mark.parametrize("name", ["video", "ml-1m", "x-pre"])
def test_loaders_through_the_parser_equal_jax(tmp_path, name):
    """``load_dataset`` on the two-column files, the ml-1m rating pair and a
    presplit ``-pre`` pair: the port's Interactions equal the JAX package's
    field by field."""
    if name == "video":
        write_two_col(tmp_path / "Video.txt", n=800)
    else:
        base = "ml-1m" if name == "ml-1m" else "x"
        u, i, r, t = write_rating(tmp_path / f"{base}.train.rating", n=800)
        users = np.unique(u)
        (tmp_path / f"{base}.test.rating").write_text(
            "".join(f"{a}\t{b}\t4\t{3 * 10 ** 9}\n" for a, b in zip(users, users % 70)))
    got = load_dataset(name, str(tmp_path))
    want = jax_load_dataset(name, str(tmp_path))
    for field in ("num_users", "num_items", "pairs_u", "pairs_i", "hist", "hist_len",
                  "uniq_count", "test_item", "gt_in_train", "item_count"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        native_io.parse_two_col("/nonexistent/Video.txt")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that cannot run, or one that fails, raises with its
    output (the JAX bridge returns None and pandas parses instead); nothing
    is built at import, and the next call builds again."""
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_io, "CXX", str(tmp_path / "no-such-g++"))
    native_io.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="could not run"):
            native_io.parse_two_col(BRIGHTKITE)
        bad = tmp_path / "bad.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native_io, "CXX", "g++")
        monkeypatch.setattr(native_io, "SOURCE", bad)
        with pytest.raises(RuntimeError, match="failed:"):
            native_io.parse_two_col(BRIGHTKITE)
        assert not list(tmp_path.glob("*.so"))
    finally:
        native_io.library.cache_clear()
