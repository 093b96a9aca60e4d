"""Per-rank input rows (counterpart of ``acf_tpu/parallel/input_pipeline.py``).

Each data rank holds only its slice of a global batch's leading dimension;
the ranks of one data row (its model ranks) hold the same slice. The index
math is the JAX package's, copied: a length that the ranks do not divide is
padded with the first rows repeated cyclically, so no row is dropped.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def process_rows(n: int, count: int, index: int, axis_size: int = 1):
    """``(start, per, pad)`` of process ``index`` of ``count`` over a
    length-``n`` leading dimension: ``per`` rows each (the ceiling), ``pad``
    wrap rows appended (the first ``pad`` rows repeated at the tail), ``start``
    the offset into the padded array, whose length is a multiple of
    lcm(``count``, ``axis_size``)."""
    m = math.lcm(count, max(axis_size, 1))
    padded = -(-n // m) * m
    per = padded // count
    return index * per, per, padded - n


def process_local_rows(global_data: np.ndarray, count: int, index: int,
                       axis_size: int = 1):
    """(this process's slice, the padded global length). ``pad`` may exceed
    ``n`` on a wide axis, so the wrap rows repeat cyclically."""
    n = global_data.shape[0]
    start, per, pad = process_rows(n, count, index, axis_size)
    if pad:
        wrap = np.resize(global_data, (pad,) + global_data.shape[1:])
        global_data = np.concatenate([global_data, wrap], axis=0)
    return global_data[start:start + per], n + pad


def host_sharded_array(mesh, global_data: np.ndarray, axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``global_data`` over the mesh's ``axis``, on the
    mesh's device."""
    local, _ = process_local_rows(np.asarray(global_data), mesh.shape[axis], mesh.index(axis))
    return torch.as_tensor(np.ascontiguousarray(local), device=mesh.device)


def replicate_result(mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Every rank gets the whole result: the ranks of ``axis`` each hold a
    block ``x`` of one shape; returns the blocks concatenated in the axis's
    order. One ``all_reduce`` of a zero-filled [n, ...] buffer in which each
    rank fills its own slot: the sum of one value and zeros is exact, and
    gloo on CUDA offers ``all_reduce`` and ``broadcast`` only."""
    buf = x.new_zeros((mesh.shape[axis],) + tuple(x.shape))
    buf[mesh.index(axis)] = x
    mesh.all_reduce(buf, axis)
    return buf.reshape((-1,) + tuple(x.shape[1:]))
