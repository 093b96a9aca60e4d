"""Full-catalog rank-position counting (counterpart of
``acf_tpu/ops/ranking.py``).

The leave-one-out evaluator needs, per user, the number of catalog items
scoring >= the held-out item. On a CUDA tensor :func:`rank_positions_dot`
launches the hand-written kernel ``csrc/rank_count.cu`` (K1), which streams
k-slices of user and item tiles through shared memory so the [B, I] score
matrix never exists in device memory; on a CPU tensor it takes
:func:`rank_positions_dot_plain`. The kernel takes any width and any
alignment a float32 tensor has (:func:`check_supported`): it copies the
slices by TMA where d % 4 == 0 and both tables are 16-byte aligned, and 4
bytes at a time otherwise (a width like 50, a row view of a table).

Rounding note: the kernel sums each dot product in its own order (fp32 FMAs
over k), so an item whose score ties the threshold within rounding can flip
by ±1 position against another formulation. The gt itself is masked in the
count, so it is handled exactly.
"""

from __future__ import annotations

import torch


def rank_positions_dot_plain(u_repr, item_emb, thresholds, bias=None, gt=None, id_base=0):
    """Plain PyTorch version of :func:`rank_positions_dot`."""
    scores = u_repr @ item_emb.T
    if bias is not None:
        scores = scores + bias[None, :]
    ge = scores >= thresholds[:, None]
    if id_base == 0:
        ge[:, 0] = False  # pad id
    if gt is not None:
        local = gt.long() - id_base
        inside = (local >= 0) & (local < ge.shape[1])
        rows = torch.arange(ge.shape[0], device=ge.device)
        ge[rows[inside], local[inside]] = False
    return ge.sum(dim=1).to(torch.float32)


def _check(u_repr, item_emb, thresholds, bias, gt):
    if (u_repr.dim() != 2 or item_emb.dim() != 2
            or item_emb.shape[1] != u_repr.shape[1]):
        raise ValueError(f"u_repr must be [B, d] and item_emb [I, d]; got "
                         f"{tuple(u_repr.shape)} and {tuple(item_emb.shape)}")
    b, d = u_repr.shape
    num_items = item_emb.shape[0]
    named = [("u_repr", u_repr, torch.float32, (b, d)),
             ("item_emb", item_emb, torch.float32, (num_items, d)),
             ("thresholds", thresholds, torch.float32, (b,))]
    if bias is not None:
        named.append(("bias", bias, torch.float32, (num_items,)))
    if gt is not None:
        named.append(("gt", gt, torch.int32, (b,)))
    for name, x, dtype, shape in named:
        if x.device != u_repr.device:
            raise ValueError(f"{name} is on {x.device}, u_repr on {u_repr.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_supported(u_repr, item_emb):
    """Raise ``ValueError`` unless K1 takes these [B, d] user rows and [I, d]
    item table: any d (0 too: the scores are the biases), any B and I, and
    any float32 alignment (its slowest copies are of 4 bytes)."""
    for name, x in (("u_repr", u_repr), ("item_emb", item_emb)):
        if x.data_ptr() % 4:
            raise ValueError(f"rank_positions_dot on CUDA needs {name} aligned to its "
                             f"float32 elements")


def rank_positions_dot(u_repr, item_emb, thresholds, bias=None, gt=None, id_base: int = 0):
    """Count catalog items with ``u·e + bias_e >= threshold`` per user.

    Args:
      u_repr: [B, d] float32 user representations.
      item_emb: [I, d] float32 item table.
      thresholds: [B] float32 per-user gt scores.
      bias: optional [I] float32 per-item bias.
      gt: optional [B] int32 per-user item id masked out of the count
          (the held-out item). Defaults to 0 (already excluded as the pad id).
      id_base: the global id of ``item_emb``'s first row (0 for the whole
          catalog; a shard's offset for a catalog shard, whose table is then
          the shard's real rows). ``gt`` and the pad id 0 are global ids.

    Returns:
      [B] float32 counts over all items except id 0 and ``gt`` — callers
      subtract the user's train items via a gathered correction.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``rank_positions_dot.launches``) or raise.
    """
    _check(u_repr, item_emb, thresholds, bias, gt)
    if id_base < 0:
        raise ValueError(f"id_base must be >= 0, got {id_base}")
    dev = u_repr.device
    if dev.type == "cpu":
        return rank_positions_dot_plain(u_repr, item_emb, thresholds, bias, gt, id_base)
    if dev.type != "cuda":
        raise ValueError(f"rank_positions_dot runs on cpu or cuda, not {dev}")
    check_supported(u_repr, item_emb)
    b, d = u_repr.shape
    num_items = item_emb.shape[0]
    out = torch.zeros(b, dtype=torch.int32, device=dev)
    if b == 0 or num_items == 0:
        return out.to(torch.float32)
    from acf_tpu_torch.ops._build import library

    lib = library()
    with torch.cuda.device(dev):
        err = lib.acf_rank_count_shard(
            u_repr.data_ptr(), item_emb.data_ptr(),
            None if bias is None else bias.data_ptr(), thresholds.data_ptr(),
            None if gt is None else gt.data_ptr(), out.data_ptr(),
            b, num_items, d, id_base, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rank_count kernel launch failed: cudaError {err}")
    rank_positions_dot.launches += 1
    return out.to(torch.float32)


rank_positions_dot.launches = 0
