"""ctypes bridge to the port's native data-plane library
(``acf_tpu_torch/native/acf_native.cpp``, the port's copy of the JAX
package's ``native/acf_native.cpp``): a columnar parser for the two-column
``uid iid`` files and the four-column ``.rating`` files, and Caser's sliding
windows.

The library is built at first use, never at import, with
``g++ -O3 -shared -fPIC`` into ``acf_tpu_torch/_build/``, keyed by a hash
of the source and the flags (a changed source gives a new library). Unlike
the JAX package's bridge, which quietly returns ``None`` when the build or
the load fails and lets pandas parse instead, a failed build or load raises
here, with the compiler's output: a loader that fell back silently would
run pandas under the parser's name.

The format rules stay the JAX package's (``acf_tpu/data/native_io.py``):
``parse_rating`` returns ``None`` for a file it mostly cannot parse (fewer
than 99 % of its non-empty lines, e.g. text timestamps), and the loader
hands that file to pandas; lines without the leading numeric fields are
skipped.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "acf_native.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_L = ctypes.c_long
_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PD = ctypes.POINTER(ctypes.c_double)
SIGNATURES = {
    "acf_count_rows": [ctypes.c_char_p],
    "acf_parse2": [ctypes.c_char_p, _P64, _P64, _L],
    "acf_parse4": [ctypes.c_char_p, _P64, _P64, _PD, _P64, _L],
    "acf_caser_windows": [_P32, _P32, _L, _L, _L, _L, _P32, _P32, _P32],
}


def lib_path() -> Path:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libacf_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists; return its path.
    Raises RuntimeError with the compiler's output when it fails or cannot
    run."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / out.name
        cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp_lib)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"{' '.join(cmd)} could not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp_lib, out)  # atomic: concurrent builds agree
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded native library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_long
    return lib


def _ptr64(a):
    return a.ctypes.data_as(_P64)


def _ptr32(a):
    return a.ctypes.data_as(_P32)


def _count_rows(lib, path: str) -> int:
    cap = lib.acf_count_rows(path.encode())
    if cap < 0:
        raise (OSError if os.path.exists(path) else FileNotFoundError)(f"cannot read {path}")
    return cap


def parse_two_col(path: str):
    """(uid, iid) int64 arrays of the first two integer fields of each line
    (lines without two are skipped)."""
    lib = library()
    cap = _count_rows(lib, path)
    u = np.empty(cap, np.int64)
    i = np.empty(cap, np.int64)
    n = lib.acf_parse2(path.encode(), _ptr64(u), _ptr64(i), cap)
    if n < 0:
        raise OSError(f"cannot read {path}")
    return u[:n], i[:n]


def parse_rating(path: str):
    """(uid, iid, rating, timestamp) arrays of a 4-column numeric TSV, or
    None when fewer than 99 % of its lines parse (a file of another format,
    e.g. text timestamps: the caller hands it to pandas)."""
    lib = library()
    cap = _count_rows(lib, path)
    u = np.empty(cap, np.int64)
    i = np.empty(cap, np.int64)
    r = np.empty(cap, np.float64)
    t = np.empty(cap, np.int64)
    n = lib.acf_parse4(path.encode(), _ptr64(u), _ptr64(i), r.ctypes.data_as(_PD),
                       _ptr64(t), cap)
    if n < 0:
        raise OSError(f"cannot read {path}")
    if n < cap * 0.99:  # mostly unparseable → wrong format; let pandas try
        return None
    return u[:n], i[:n], r[:n], t[:n]


def caser_windows(hist: np.ndarray, hist_len: np.ndarray, L: int, target_len: int):
    """(users, seqs [n, L], targets [n, target_len]) int32: every window of
    ``L`` items of each user with more than ``L`` train items, and the up to
    ``target_len`` items after it, front-padded with 0 (reference
    Caser.py:67-91)."""
    lib = library()
    hist = np.ascontiguousarray(hist, np.int32)
    hist_len = np.ascontiguousarray(hist_len, np.int32)
    U, W = hist.shape
    if hist_len.shape != (U,) or L < 1 or target_len < 1:
        raise ValueError(f"caser_windows: hist {hist.shape}, hist_len {hist_len.shape}, "
                         f"L {L}, target_len {target_len}")
    null32 = _P32()
    n = lib.acf_caser_windows(_ptr32(hist), _ptr32(hist_len), U, W, L, target_len,
                              null32, null32, null32)
    users = np.empty(n, np.int32)
    seqs = np.empty((n, L), np.int32)
    tgts = np.empty((n, target_len), np.int32)
    lib.acf_caser_windows(_ptr32(hist), _ptr32(hist_len), U, W, L, target_len,
                          _ptr32(users), _ptr32(seqs), _ptr32(tgts))
    return users, seqs, tgts
