"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes`. Sources compile
in parallel (one ``nvcc -c`` each) and link into
``_build/libacf_kernels_<hash>.so``, where the hash covers the sources and
the flags: a changed source gives a new library, an unchanged one is reused.
The build happens at first use, never at import, and needs no PyTorch
headers, so it takes seconds.

No ``--use_fast_math``: the kernels' comparisons must see the same float32
values as their plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ENCODER_MAX_BLOCKS = 8  # kMaxBlocks in csrc/sasrec_encoder.cuh


# The structs of csrc/sasrec_encoder.cuh, passed by value. EncoderW: one
# pointer per param leaf.
class _DenseW(ctypes.Structure):
    _fields_ = [("w", _P), ("b", _P)]


class _LayerNormW(ctypes.Structure):
    _fields_ = [("gamma", _P), ("beta", _P)]


class _BlockW(ctypes.Structure):
    _fields_ = [("ln1", _LayerNormW), ("wq", _DenseW), ("wk", _DenseW),
                ("wv", _DenseW), ("ln2", _LayerNormW), ("conv1", _DenseW),
                ("conv2", _DenseW), ("ln3", _LayerNormW)]


class EncoderWeights(ctypes.Structure):
    _fields_ = [("pos", _P), ("ln_f", _LayerNormW),
                ("blocks", _BlockW * ENCODER_MAX_BLOCKS), ("num_blocks", _I)]


# DropoutMasks: one uint8 (bool) mask per dropout site, 0 where none, and the
# keep probability.
class DropoutMasks(ctypes.Structure):
    _fields_ = [("emb", _P), ("p", _P * ENCODER_MAX_BLOCKS),
                ("f1", _P * ENCODER_MAX_BLOCKS), ("f2", _P * ENCODER_MAX_BLOCKS),
                ("keep", ctypes.c_float)]


# C entry points: name -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "acf_rank_count": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "acf_rank_count_shard": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "acf_sasrec_encoder_fwd": [EncoderWeights, DropoutMasks, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P],
    "acf_sasrec_encoder_bwd": [EncoderWeights, DropoutMasks, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _P],
    "acf_sasrec_encoder_bwd_ctas": [_I, _I],
    "acf_sasrec_encoder_bwd_wide": [EncoderWeights, DropoutMasks] + [_P] * 6 + [_I] * 7 + [_P],
    "acf_sasrec_encoder_bwd_wide_ctas": [_I, _I],
    # csrc/apl_gen.cu: tensors, then B, I, d, then (1 - w), w, T or (1 - w) / T
    "acf_apl_stats1": [_P] * 5 + [_I] * 3 + [_P],
    "acf_apl_z": [_P] * 11 + [_I] * 3 + [_F] * 3 + [_P],
    "acf_apl_fake": [_P] * 7 + [_I] * 3 + [_P],
    "acf_apl_bigr": [_P] * 15 + [_I] * 3 + [_F] * 3 + [_P],
    "acf_apl_grad": [_P] * 17 + [_I] * 3 + [_F] * 3 + [_P],
}
# K2a's and K2b's bfloat16 forms (csrc/sasrec_encoder_fwd_bf16.cu and
# csrc/sasrec_encoder_bwd_bf16.cu): the float32 forms' entries with the
# suffix _bf16, their arguments the same.
SIGNATURES.update({name + "_bf16": args for name, args in list(SIGNATURES.items())
                   if name.startswith("acf_sasrec_encoder")})


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _sources(csrc: Path = CSRC_DIR):
    return sorted(csrc.glob("*.cu"))


def _digest(sources, csrc: Path = CSRC_DIR) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build(csrc: Path = CSRC_DIR) -> Path:
    """Compile the sources of ``csrc`` (this checkout's, or another's) if
    their library is not built yet; return its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``build.log``.
    """
    sources = _sources(csrc)
    if not sources:
        raise RuntimeError(f"no CUDA sources in {csrc}")
    lib = BUILD_DIR / f"libacf_kernels_{_digest(sources, csrc)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(sources, objs)]
        logs, failed = [], []
        for src, p in zip(sources, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                          *map(str, objs)]))
        (BUILD_DIR / "build.log").write_text(
            f"built {lib.name} in {time.perf_counter() - t0:.2f} s\n" + "\n".join(logs))
        os.replace(tmp_lib, lib)  # atomic: concurrent builders agree
    return lib


def load(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with the argument types of every entry of
    SIGNATURES it has (one built from another checkout may lack some)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = load(build())
    missing = [name for name in SIGNATURES if not hasattr(lib, name)]
    if missing:
        raise RuntimeError(f"the kernel library lacks {missing}")
    return lib
