"""SASRec encoder: the plain math, its hand-derived backward, and the K2a
(forward) and K2b (backward) kernels (counterpart of
``acf_tpu/ops/sasrec_fused.py``).

:func:`encoder_math` is the one copy of the encoder forward in the port:
the model's ``encode_math`` and K2a's plain version
:func:`fused_encoder_plain` both call it. :func:`encoder_bwd_math` is the
backward derived by hand, step by step in the order K2b follows; it is
K2b's plain version.

:func:`fused_encoder` is the entry the model calls. Without a graph to
record (inference, or no input needing a gradient) it runs the forward
alone: K2a on a CUDA tensor, the plain version on a CPU tensor. Otherwise it
is a :class:`torch.autograd.Function` whose forward is K2a in its training
form (dropout masks, and a copy of every block's input for the backward)
and whose backward is K2b; on CPU tensors the same function runs
:func:`encoder_math` forward and :func:`encoder_bwd_math` backward. When
only ``x`` needs a gradient, K2b computes dx alone (the inner FGSM gradient
of ASASRec). A CUDA tensor the kernels do not take raises ``ValueError``:
the limits are stated once, in :func:`check_supported`, which computes the
shared-memory sizes with the same formulas the launches use.

K2b has two forms, chosen in one place (:func:`_bwd_form`): the tile form,
whose block holds ~32 rows in shared memory and copies them 16 bytes at a
time, for every window it fits at d % 4 == 0 on 16-byte aligned tensors,
and the wide form (one user's window a thread-block cluster of 1, 2 or 4
CTAs, each holding its share of the rows in shared memory, 4-byte copies;
:func:`_bwd_wide_layout`) for everything else up to K2a's widest window, so
training takes every window and width serving takes. K2a takes any width 1 <= d <= 128: a
row is staged at d rounded up to 4 with zero tails, and its C entry copies
16 bytes at a time where the width and the tensors' alignment allow, 4
bytes otherwise.

Compute dtypes (the JAX kernel's ``cd``, ``acf_tpu/ops/sasrec_fused.py:81-86``):
with ``dtype=torch.bfloat16`` every product takes bfloat16 operands and sums
in float32 (the five dense products always, the attention's from T =
MXU_ATTN_T on), and the backward, the vjp of that, rounds each product's
input gradient and weight gradient once while the cotangent it multiplies
stays float32; LayerNorm, softmax, dropout, biases and the residuals stay
float32, and so does every tensor. The plain versions compute each such
product as a float32 product of values rounded to bfloat16 (exact products,
float32 sums); the kernels' bfloat16 forms (``csrc/*_bf16.cu``, C entries
with the suffix ``_bf16``) do the same in their float32 FMA chains, and
count their launches apart (``fused_encoder.bf16_launches``,
``encoder_bwd.bf16_launches``, ``encoder_bwd.wide_bf16_launches``). At
float32 every rounding is the identity, so that path is what it was.

Rounding note: the kernels sum dot products, softmax denominators,
LayerNorm moments and the weight gradients over users in their own order,
so they agree with their plain versions to f32 rounding, not bit for bit
(``chip_smoke.py`` states its tolerances). K2b sums the weight gradients
in a fixed order without atomics, so two calls on the same inputs give
bit-identical gradients.
"""

from __future__ import annotations

import math

import torch

from acf_tpu_torch.nn.layers import layer_norm
from acf_tpu_torch.ops._build import (
    ENCODER_MAX_BLOCKS, DropoutMasks, EncoderWeights, library,
)

NEG_INF = -(2.0 ** 32) + 1  # the reference's mask value (SASRecLayers.py:208)
LN_EPS = 1e-8
# From this window on, the attention's products take the compute dtype too
# (``_MXU_ATTN_T`` of acf_tpu/ops/sasrec_fused.py:98); below it they sum in
# float32 whatever the dtype.
MXU_ATTN_T = 32

# Kernel limits (csrc/sasrec_encoder_fwd.cu, csrc/sasrec_encoder_bwd.cu).
# 200 is the widest window of the SASRec paper (ML-1M, Kang & McAuley,
# ICDM 2018).
MAX_T = 200
MAX_D = 128
ROWS_PER_BLOCK = 32            # a K2b block groups users until it holds ~32 rows
FWD_ROWS_PER_BLOCK = 16        # a K2a block groups users until it holds ~16 rows
FWD_MAX_ROWS = {256: 4, 512: 8}      # rows of a K2a product's register tile, at most
FWD_BLOCKS_AN_SM = {256: 2, 512: 1}  # K2a blocks an SM that its registers allow
SMEM_LIMIT = 232_448           # shared memory one Hopper block may use (227 KB)
SM_SMEM = 233_472              # shared memory of a Hopper SM (228 KB) ...
BLOCK_RESERVED = 1_024         # ... of which each resident block keeps 1 KB
SLICE_FLOATS = 4096            # floats of W in one staged weight slice (K2a, K2b), at most
BWD_BUFFERS = 7                # [rows, ld] activation buffers of K2b
BWD_THREADS = 512              # K2b's block: 16 warps, one block an SM
BWD_ROWS_PER_THREAD = 3        # rows of a K2b product's register tile, at most
# K2b's wide form's CTA (threads, register-tile rows at most): 16 warps and
# 128 registers a thread in its float32 build; 12 warps and 168 registers in
# its bfloat16 build, whose conversions need more
BWD_WIDE_THREADS = {False: 512, True: 384}
BWD_WIDE_ROWS_PER_THREAD = {False: 2, True: 3}
BWD_CLUSTERS = (1, 2, 4)       # CTAs of a K2b wide-form cluster (one user's window)
BWD_MIN_SLICE = 16             # weight-slice rows the wide form keeps before it grows a cluster
BWD_GROUP_FLOATS = 12          # K2b's user-group scalars in shared memory
BWD_WIDE_HEAD_FLOATS = 16      # ... and the wide form's rows beside them
ROADMAP_ITEM = ("ROADMAP.md Queue 2, 'K2a/K2b: multi-head and longer "
                "windows'")

# Leaves of one encoder block, in the order of the kernels' flat gradient.
BLOCK_LEAVES = (("ln1", ("gamma", "beta")), ("wq", ("w", "b")), ("wk", ("w", "b")),
                ("wv", ("w", "b")), ("ln2", ("gamma", "beta")), ("conv1", ("w", "b")),
                ("conv2", ("w", "b")), ("ln3", ("gamma", "beta")))


# --- forward ----------------------------------------------------------------

def _drop(y, mask, keep: float):
    """Inverted dropout with a precomputed bool mask, ``where(m, y / keep,
    0)`` — a division, as the JAX package's ``_apply_mask``."""
    return y if mask is None else torch.where(mask, y / keep, 0.0)


def _same(x):
    return x


def _to_bf16(x):
    """x rounded to bfloat16 (to nearest, ties to even), held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def compute_rounding(dtype):
    """The rounding of the encoder's products in compute dtype ``dtype``:
    None (or float32) rounds nothing; bfloat16 rounds each product's
    operands, and each product's result in the backward, to bfloat16
    (``_dot`` of ``acf_tpu/ops/sasrec_fused.py:81-86`` and its vjp)."""
    if dtype is None or dtype == torch.float32:
        return _same
    if dtype == torch.bfloat16:
        return _to_bf16
    raise ValueError(f"the encoder computes in float32 or bfloat16, not {dtype}")


def _attn_rounding(r, t: int):
    """The attention's products round like the dense ones from T =
    MXU_ATTN_T on; below it they sum in float32 (the JAX kernel's rule)."""
    return r if t >= MXU_ATTN_T else _same


def _dense(p, x, r):
    """``dense`` (x W + b) with the product's operands rounded by ``r``."""
    return r(x) @ r(p["w"]) + p["b"]


def _block(blk, x, ids_mask, num_heads: int = 1, bm=None, keep: float = 1.0, r=_same):
    """One encoder block (reference SASRecLayers.py:171-319): LN1; causal
    multi-head attention with key and query masking, the probabilities
    dropped after the query masking, the residual onto the normalised input;
    LN2; the FFN with its two dropouts and the residual onto x2; LN3 and the
    ids mask. ``r`` rounds the products' operands (:func:`compute_rounding`).
    Returns (output, cache): the cache holds what the backward reads, so
    :func:`encoder_bwd_math` differentiates exactly the values
    :func:`encoder_math` computed."""
    b, t, d = x.shape
    dh = d // num_heads
    ra = _attn_rounding(r, t)
    q_in = layer_norm(blk["ln1"], x)

    def heads(p):  # [B, T, d] -> [B, H, T, dh]
        return _dense(p, q_in, r).reshape(b, t, num_heads, dh).transpose(1, 2)

    q, k, v = heads(blk["wq"]), heads(blk["wk"]), heads(blk["wv"])
    scores = ra(q) @ ra(k).transpose(-1, -2) / math.sqrt(dh)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    scores = torch.where(causal & ids_mask[:, None, None, :], scores, NEG_INF)
    pb = torch.softmax(scores, dim=-1) * ids_mask[:, None, :, None]  # query masking
    pd = _drop(pb, None if bm is None else bm["p"], keep)
    a = (ra(pd) @ ra(v)).transpose(1, 2).reshape(b, t, d) + q_in
    x2 = layer_norm(blk["ln2"], a)
    z1 = _dense(blk["conv1"], x2, r)
    f1 = _drop(torch.relu(z1), None if bm is None else bm["f1"], keep)
    f = _drop(_dense(blk["conv2"], f1, r), None if bm is None else bm["f2"], keep) + x2
    out = layer_norm(blk["ln3"], f) * ids_mask[:, :, None].to(x.dtype)
    return out, dict(h=x, q_in=q_in, q=q, k=k, v=v, pb=pb, pd=pd, a=a, x2=x2, z1=z1,
                     f1=f1, f=f)


def _input(params, x, ids_mask, masks, keep):
    """The first block's input: (x + pos_emb[-T:]), dropped, times the ids
    mask."""
    t = x.shape[1]
    x = x + params["pos_emb"][-t:]
    return _drop(x, None if masks is None else masks["emb"], keep) * ids_mask[:, :, None].to(x.dtype)


def encoder_math(params, x, ids_mask, num_heads: int = 1, masks=None,
                 keep: float = 1.0, dtype=None):
    """The SASRec encoder (``encode_math`` of the JAX model), in plain
    PyTorch.

    x: [B, T, d] √d-scaled input embeddings; ids_mask: [B, T] bool;
    masks: None (inference) or the model's dropout masks (``emb`` [B, T, d],
    per block ``p`` [B, H, T, T], ``f1`` and ``f2`` [B, T, d], bool), applied
    where ``acf_tpu/models/sasrec.py:299-318`` applies them, with keep
    probability ``keep``; dtype: the products' compute dtype, None (float32)
    or bfloat16, in which each product takes bfloat16 operands and sums in
    float32 (the JAX kernel's ``_encoder_math(cd=bf16)``: the five dense
    products always, the attention's from T = MXU_ATTN_T on) while
    LayerNorm, softmax, dropout, biases and the residuals stay float32.
    Returns [B, T, d] float32. Only reads ``pos_emb``, ``blocks`` and
    ``ln_f``.
    """
    r = compute_rounding(dtype)
    x = _input(params, x, ids_mask, masks, keep)
    for i, blk in enumerate(params["blocks"]):
        x, _ = _block(blk, x, ids_mask, num_heads, None if masks is None else masks["blocks"][i],
                      keep, r)
    return layer_norm(params["ln_f"], x)


def fused_encoder_plain(params, x, ids_mask, masks=None, keep: float = 1.0, dtype=None):
    """Plain PyTorch version of K2a (single head), in compute dtype
    ``dtype``."""
    return encoder_math(params, x, ids_mask, 1, masks, keep, dtype)


# --- backward, derived by hand (K2b's plain version) -------------------------

def _ln_stats(x):
    """(x̂, σ) of LayerNorm's input x: x̂ = (x - mean) / σ and
    σ = sqrt(mean((x - mean)²) + ε), as the forward computes them."""
    xc = x - x.mean(dim=-1, keepdim=True)
    sigma = torch.sqrt(torch.square(xc).mean(dim=-1, keepdim=True) + LN_EPS)
    return xc / sigma, sigma


def _ln_bwd(p, x, dy):
    """y = γ x̂ + β of the LayerNorm whose input is x: returns (dx, dγ, dβ),
    the parameter gradients summed over every row. With dx̂ = dy γ, and
    since x̂ has zero mean and σ depends on x only through the mean of
    squared deviations, dx = (dx̂ - mean(dx̂) - x̂ mean(dx̂ x̂)) / σ."""
    xhat, sigma = _ln_stats(x)
    dxh = dy * p["gamma"]
    dx = (dxh - dxh.mean(dim=-1, keepdim=True)
          - xhat * (dxh * xhat).mean(dim=-1, keepdim=True)) / sigma
    rows = tuple(range(dy.dim() - 1))
    return dx, (dy * xhat).sum(dim=rows), dy.sum(dim=rows)


def _wgrad(x, dy, r=_same):
    """Σ over users and positions of xᵀ dy: the [d, d] kernel gradient of a
    dense layer y = x W + b, with x rounded by ``r`` and the sum too (the
    vjp of a product with rounded operands: the sum over every row is
    rounded once)."""
    d = x.shape[-1]
    return r(r(x).reshape(-1, d).T @ dy.reshape(-1, d))


def _block_bwd(blk, c, ids_mask, bm, keep, dh, weight_grads, r=_same):
    """Backward of one single-head block from its cache (:func:`_block`),
    given the gradient dh of its (masked) output. With a rounding ``r``
    (:func:`compute_rounding`) each product's input gradient and weight
    gradient is rounded once, the cotangent it multiplies is not: the vjp
    of ``_dot`` with bfloat16 operands. Returns (the gradient of its input,
    its leaf gradients or None)."""
    d = dh.shape[-1]
    ra = _attn_rounding(r, dh.shape[1])
    m = ids_mask[:, :, None].to(dh.dtype)
    q, k, v, pb, pd = (c[n][:, 0] for n in ("q", "k", "v", "pb", "pd"))  # the one head
    # h_out = LN3(f) * m; f = drop_f2(f1' W2 + b2) + x2
    df, g3, b3 = _ln_bwd(blk["ln3"], c["f"], dh * m)
    df2 = _drop(df, None if bm is None else bm["f2"], keep)
    # f1' = drop_f1(relu(z1)): relu's gradient is 0 at z1 <= 0, as in JAX
    dz1 = _drop(r(df2 @ r(blk["conv2"]["w"]).T), None if bm is None else bm["f1"], keep) \
        * (c["z1"] > 0)
    dx2 = df + r(dz1 @ r(blk["conv1"]["w"]).T)  # the FFN residual onto x2
    da, g2, b2 = _ln_bwd(blk["ln2"], c["a"], dx2)
    # a = drop_p(P) v + q_in, P = softmax(q kᵀ / √d) * query mask
    dpd = ra(da @ ra(v).transpose(-1, -2))
    dv = ra(ra(pd).transpose(-1, -2) @ da)
    dpb = _drop(dpd, None if bm is None else bm["p"][:, 0], keep) * ids_mask[:, :, None]
    # softmax backward, dS = P ∘ (dP - rowsum(dP ∘ P)): masked queries have
    # dP = 0 and masked keys P = 0 (the reference's -2³²+1 underflows), so
    # both get exactly zero gradient
    ds = pb * (dpb - (dpb * pb).sum(dim=-1, keepdim=True))
    dq = ra(ds @ ra(k) / math.sqrt(d))
    dk = ra(ds.transpose(-1, -2) @ ra(q) / math.sqrt(d))
    dq_in = (da + r(dq @ r(blk["wq"]["w"]).T) + r(dk @ r(blk["wk"]["w"]).T)
             + r(dv @ r(blk["wv"]["w"]).T))  # the attention residual onto q_in
    dh_in, g1, b1 = _ln_bwd(blk["ln1"], c["h"], dq_in)
    if not weight_grads:
        return dh_in, None
    rows = (0, 1)
    g = {"ln1": {"gamma": g1, "beta": b1}}
    for name, dy in (("wq", dq), ("wk", dk), ("wv", dv)):
        g[name] = {"w": _wgrad(c["q_in"], dy, r), "b": dy.sum(dim=rows)}
    g["ln2"] = {"gamma": g2, "beta": b2}
    g["conv1"] = {"w": _wgrad(c["x2"], dz1, r), "b": dz1.sum(dim=rows)}
    g["conv2"] = {"w": _wgrad(c["f1"], df2, r), "b": df2.sum(dim=rows)}
    g["ln3"] = {"gamma": g3, "beta": b3}
    return dh_in, g


def encoder_bwd_math(params, x, ids_mask, masks, keep: float, g,
                     weight_grads: bool = True, dtype=None):
    """The vector-Jacobian product of :func:`encoder_math` (single head, in
    compute dtype ``dtype``) with the cotangent ``g`` [B, T, d], derived by
    hand in the order K2b follows: LN_f's backward, then per block from the
    last its LN3, FFN, LN2, attention and LN1 backward, finally the ids mask
    and the embedding dropout at the input. The forward runs through the
    same code as :func:`encoder_math` and keeps every block's intermediates
    (K2b keeps only the block inputs and rematerialises each block from its
    input). In bfloat16 a weight gradient is rounded once, summed over the
    whole batch (the JAX kernel rounds each of its grid programs' sums and
    adds them in float32: the same function while one program holds every
    user).

    Returns ``(dx, grads)``: dx [B, T, d] and, unless ``weight_grads`` is
    False, the gradients of ``pos_emb[-T:]`` ([T, d], summed over users),
    of every block leaf and of ``ln_f``, summed over users and positions,
    as a tree ``{"pos_emb", "blocks", "ln_f"}``.
    """
    r = compute_rounding(dtype)
    m = ids_mask[:, :, None].to(x.dtype)
    h = _input(params, x, ids_mask, masks, keep)
    caches = []
    for i, blk in enumerate(params["blocks"]):
        h, c = _block(blk, h, ids_mask, 1, None if masks is None else masks["blocks"][i], keep, r)
        caches.append(c)
    dh, gf, bf = _ln_bwd(params["ln_f"], h, g)
    block_grads = []
    for i in reversed(range(len(params["blocks"]))):
        bm = None if masks is None else masks["blocks"][i]
        dh, gb = _block_bwd(params["blocks"][i], caches[i], ids_mask, bm, keep, dh, weight_grads,
                            r)
        block_grads.insert(0, gb)
    dx = _drop(dh * m, None if masks is None else masks["emb"], keep)
    if not weight_grads:
        return dx, None
    return dx, {"pos_emb": dx.sum(dim=0), "blocks": block_grads,
                "ln_f": {"gamma": gf, "beta": bf}}


# --- limits -------------------------------------------------------------------

def _dp(d: int) -> int:
    """The width a kernel stages a row at: d rounded up to 4 (``pad4``)."""
    return -(-d // 4) * 4


def _ld(d: int) -> int:
    return 4 * ((_dp(d) // 4) | 1)  # odd number of 16-byte units per row


def _group(t: int, d: int):
    """(users per block, threads) of K2a: users until the block holds ~16
    rows (two at T=8, so B=512 gives 256 blocks); 512 threads from 128 rows
    on, or where 256 would leave a thread more than FWD_MAX_ROWS[256] rows
    of a product."""
    users = max(1, FWD_ROWS_PER_BLOCK // t)
    rows = users * t
    wide = rows >= 128 or rows > FWD_MAX_ROWS[256] * (256 // (_dp(d) // 4))
    return users, 512 if wide else 256


def _fwd_slice(rows: int, d: int, threads: int) -> int:
    """Rows of W in one of K2a's two staged weight slots: the most, a
    multiple of 4 up to the whole weight (at most SLICE_FLOATS floats of
    it), with which FWD_BLOCKS_AN_SM[threads] blocks still fit an SM; where
    the buffers alone leave no room for that, the most with which one block
    fits. The C entry reads ks back from the bytes."""
    per_block = SM_SMEM // FWD_BLOCKS_AN_SM[threads] - BLOCK_RESERVED
    dp = _dp(d)
    widest = min(dp, SLICE_FLOATS // dp // 4 * 4)
    for limit in (per_block, SMEM_LIMIT):
        for ks in range(widest, 3, -4):
            if _fwd_bytes(rows, d, ks) <= limit:
                return ks
    return 4


def _fwd_bytes(rows: int, d: int, ks: int) -> int:
    """K2a's shared-memory bytes: four [rows, ld] f32 activation buffers (x,
    q, k, v), two [ks, ld] weight slots and the ids mask as bytes
    (``fwd_smem_bytes`` in the C entry)."""
    return 4 * (4 * rows * _ld(d) + 2 * ks * _ld(d) + -(-rows // 4))


def _layout(t: int, d: int, users: int | None = None, threads: int | None = None,
            ks: int | None = None):
    """(users per block, threads, shared-memory bytes) of a K2a launch, in
    :func:`_group`'s geometry and with :func:`_fwd_slice`'s slices unless
    ``users`` and ``threads``, or ``ks``, are given. The C entry refuses
    bytes that are not :func:`_fwd_bytes` of some slice."""
    if users is None:
        users, threads = _group(t, d)
    rows = users * t
    return users, threads, _fwd_bytes(rows, d, ks or _fwd_slice(rows, d, threads))


def _slice_rows(d: int) -> int:
    """Rows of W in one of K2b's staged weight slices: the whole weight up to
    d = 64 (``slice_rows`` in the C source)."""
    dp = _dp(d)
    return min(dp, SLICE_FLOATS // dp // 4 * 4)


def _bwd_slot(d: int, ks: int | None = None) -> int:
    """Floats of one of K2b's two weight slots: a k-slice of ``ks`` rows of W
    (default :func:`_slice_rows`) as rows of W, or as rows of Wᵀ, whichever
    is larger."""
    ks = ks or _slice_rows(d)
    return max(ks * _ld(d), _dp(d) * _ld(ks))


def _bwd_layout(t: int, d: int):
    """(users per block, threads, shared-memory bytes) of a K2b launch: ~32
    rows and 512 threads, one block an SM. The bytes: the user group's
    scalars, seven [rows, ld] f32 buffers (the rematerialised block's six
    and the running gradient), the [rows, Ts] softmax probabilities, two
    weight slots, one score row per warp, the ids mask, a [warps, 2d]
    scratch for the LayerNorm parameter gradients and the probabilities'
    dropout mask as [rows, T] bytes. The C entry recomputes the bytes and
    refuses a launch that disagrees."""
    users = max(1, ROWS_PER_BLOCK // t)
    return users, BWD_THREADS, _bwd_bytes(users, BWD_THREADS, t, d)


def _bwd_bytes(users: int, threads: int, t: int, d: int) -> int:
    """K2b's shared-memory bytes for a block of ``users`` windows and
    ``threads`` threads (``bwd_smem_bytes`` in the C entry)."""
    rows = users * t
    ts = (t + 3) // 4 * 4
    warps = threads // 32
    floats = (BWD_GROUP_FLOATS + BWD_BUFFERS * rows * _ld(d) + rows * ts + 2 * _bwd_slot(d)
              + warps * ts + rows + warps * 2 * d + -(-rows * t // 4))
    return 4 * floats


def _widest(t_max, fits) -> int:
    t = t_max
    while t > 0 and not fits(t):
        t -= 1
    return t


def _fwd_fits(t: int, d: int) -> bool:
    """K2a's block fits one SM, and a product's register tile covers its
    rows (the C entry checks both)."""
    users, threads, smem = _layout(t, d)
    return smem <= SMEM_LIMIT and users * t <= FWD_MAX_ROWS[threads] * (threads // (_dp(d) // 4))


def max_window(d: int) -> int:
    """The widest window K2a takes at width ``d`` (0 if none fits)."""
    return _widest(MAX_T, lambda t: _fwd_fits(t, d))


def _bwd_fits(t: int, d: int) -> bool:
    """K2b's tile form fits one SM, and a product's register tile covers
    its rows (the C entry checks both)."""
    users, threads, smem = _bwd_layout(t, d)
    return smem <= SMEM_LIMIT and users * t <= BWD_ROWS_PER_THREAD * (threads // (_dp(d) // 4))


def _cluster_pieces(t: int, c: int):
    """The positions of a window of ``t`` that each CTA of a K2b wide-form
    cluster of ``c`` owns, by rank: pieces s and 2c - 1 - s of the window
    cut into 2c pieces (``rows_of`` in the C source)."""
    start = [k * t // (2 * c) for k in range(2 * c + 1)]
    return [[*range(start[s], start[s + 1]), *range(start[2 * c - 1 - s], start[2 * c - s])]
            for s in range(c)]


def _cluster_rows(t: int, c: int) -> int:
    """Rows of a window of ``t`` that the busiest CTA of a K2b wide-form
    cluster of ``c`` owns (``cluster_rows`` in the C source)."""
    return max(len(rows) for rows in _cluster_pieces(t, c))


def _bwd_wide_bytes(t: int, d: int, c: int, ks: int, bf16: bool = False) -> int:
    """Shared memory of a CTA of K2b's wide form (``wide_layout`` in the C
    entry): the group's scalars and its rows, seven [R, ld] buffers of its own R
    rows, the window's [T, ld], its rows' [R, Ts] probabilities, two weight
    slots of ``ks`` rows, the window's and its rows' ids masks, the [warps,
    2d] LayerNorm scratch and its rows' dropout masks as bytes ([R, T] and
    two [R, d])."""
    rows, ld, ts = _cluster_rows(t, c), _ld(d), (t + 3) // 4 * 4
    warps = BWD_WIDE_THREADS[bf16] // 32
    floats = (BWD_WIDE_HEAD_FLOATS + BWD_BUFFERS * rows * ld + t * ld + rows * ts
              + 2 * _bwd_slot(d, ks) + t + rows + warps * 2 * d
              + -(-(rows * t + 2 * rows * d) // 4))
    return 4 * floats


def _bwd_wide_layout(t: int, d: int, bf16: bool = False):
    """(cluster size c, weight-slice rows ks, threads, shared-memory bytes)
    of K2b's wide form (its bfloat16 build with ``bf16``): one user's window
    a cluster of c CTAs. The smallest c whose CTA's rows one pass of a
    product's register tile covers and whose bytes fit with slices of at
    least BWD_MIN_SLICE rows (or the whole weight), else the largest cluster
    with the widest slices that fit; None where nothing fits."""
    ks0, threads = _slice_rows(d), BWD_WIDE_THREADS[bf16]
    row_groups = threads // (_dp(d) // 4)
    for c in BWD_CLUSTERS:
        if _cluster_rows(t, c) > BWD_WIDE_ROWS_PER_THREAD[bf16] * row_groups:
            continue
        least = 4 if c == BWD_CLUSTERS[-1] else min(ks0, BWD_MIN_SLICE)
        for ks in range(ks0, least - 1, -4):
            smem = _bwd_wide_bytes(t, d, c, ks, bf16)
            if smem <= SMEM_LIMIT:
                return c, ks, threads, smem
    return None


def _bwd_wide_fits(t: int, d: int) -> bool:
    """K2b's wide form has a layout for windows of ``t`` at width ``d`` in
    both its builds."""
    return all(_bwd_wide_layout(t, d, bf16) is not None for bf16 in (False, True))


def _bwd_form(t: int, d: int, aligned: bool = True) -> str:
    """K2b's form for windows of ``t`` at width ``d``: ``"tile"`` where its
    block of ~32 rows fits and its 16-byte copies take the rows (d % 4 == 0,
    and ``aligned``: g, the saved inputs and the weights 16-byte aligned),
    else ``"wide"``."""
    return "tile" if aligned and d % 4 == 0 and _bwd_fits(t, d) else "wide"


def max_train_window(d: int) -> int:
    """The widest window K2b (and so training) takes at width ``d``: every
    window K2a takes, through K2b's tile form or its wide form."""
    return _widest(max_window(d), lambda t: _bwd_fits(t, d) or _bwd_wide_fits(t, d))


def check_supported(t: int, d: int, num_heads: int, num_blocks: int = 2,
                    train: bool = False):
    """Raise ``ValueError`` unless K2a (and, with ``train``, K2b) takes this
    encoder shape: one head, 1 <= d <= MAX_D, at most ENCODER_MAX_BLOCKS
    blocks and windows of 1 to :func:`max_window` items. K2b takes every
    window K2a takes (:func:`max_train_window`)."""
    if num_heads != 1:
        raise ValueError(f"K2a/K2b are single-head; got num_heads={num_heads} "
                         f"(multi-head is lifted by {ROADMAP_ITEM})")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"K2a/K2b take widths 1 <= d <= {MAX_D}; got d={d} "
                         f"(wider is lifted by {ROADMAP_ITEM})")
    if not 0 <= num_blocks <= ENCODER_MAX_BLOCKS:
        raise ValueError(f"K2a takes at most {ENCODER_MAX_BLOCKS} blocks; "
                         f"got {num_blocks}")
    limit = max_train_window(d) if train else max_window(d)
    if not 1 <= t <= limit:
        raise ValueError(f"K2a/K2b take windows of 1 to {limit} items at d={d}; got "
                         f"t={t} (wider windows are lifted by {ROADMAP_ITEM})")


# --- kernel wrappers ------------------------------------------------------------

def _ptr(name, x, shape, dev, dtype=torch.float32):
    """The data pointer of a tensor a kernel reads, after the checks it
    relies on (dtype, shape, contiguous, on ``dev``, aligned to its element).
    Whether the rows are also 16-byte aligned, so that they can be copied 16
    bytes at a time, the C entries see from the pointers and choose their
    copies by it."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, x on {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % x.element_size():
        raise ValueError(f"{name} must be contiguous and aligned to its element")
    return x.data_ptr()


def _weights(params, t, d, dev):
    """The kernels' weight struct: one pointer per leaf, nothing copied."""
    w = EncoderWeights()
    pos = params["pos_emb"]
    if pos.dim() != 2 or pos.shape[0] < t:
        raise ValueError(f"pos_emb has {tuple(pos.shape)}; the window needs {t} rows")
    w.pos = _ptr("pos_emb[-t:]", pos[-t:], (t, d), dev)
    w.ln_f.gamma = _ptr("ln_f.gamma", params["ln_f"]["gamma"], (d,), dev)
    w.ln_f.beta = _ptr("ln_f.beta", params["ln_f"]["beta"], (d,), dev)
    w.num_blocks = len(params["blocks"])
    for i, blk in enumerate(params["blocks"]):
        dst = w.blocks[i]
        for name in ("ln1", "ln2", "ln3"):
            for leaf in ("gamma", "beta"):
                setattr(getattr(dst, name), leaf,
                        _ptr(f"blocks[{i}].{name}.{leaf}", blk[name][leaf], (d,), dev))
        for name in ("wq", "wk", "wv", "conv1", "conv2"):
            getattr(dst, name).w = _ptr(f"blocks[{i}].{name}.w", blk[name]["w"], (d, d), dev)
            getattr(dst, name).b = _ptr(f"blocks[{i}].{name}.b", blk[name]["b"], (d,), dev)
    return w


def _masks(masks, keep, num_blocks, b, t, d, dev):
    """The kernels' dropout-mask struct (all pointers 0 without masks). The
    masks are bool tensors in the JAX layout, read as uint8."""
    dm = DropoutMasks()
    dm.keep = keep
    if masks is None:
        return dm
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must be in (0, 1]; got {keep}")
    if len(masks["blocks"]) != num_blocks:
        raise ValueError(f"masks hold {len(masks['blocks'])} blocks, params {num_blocks}")
    dm.emb = _ptr("masks.emb", masks["emb"], (b, t, d), dev, torch.bool)
    for i, bm in enumerate(masks["blocks"]):
        dm.p[i] = _ptr(f"masks.blocks[{i}].p", bm["p"], (b, 1, t, t), dev, torch.bool)
        dm.f1[i] = _ptr(f"masks.blocks[{i}].f1", bm["f1"], (b, t, d), dev, torch.bool)
        dm.f2[i] = _ptr(f"masks.blocks[{i}].f2", bm["f2"], (b, t, d), dev, torch.bool)
    return dm


def _check_inputs(x, ids_mask):
    if x.dim() != 3 or tuple(ids_mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"x must be [B, T, d] and ids_mask [B, T]; got "
                         f"{tuple(x.shape)} and {tuple(ids_mask.shape)}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the encoder kernels run on cuda, not {dev}")
    if ids_mask.dtype != torch.bool or ids_mask.device != dev \
            or not ids_mask.is_contiguous():
        raise ValueError("ids_mask must be a contiguous bool tensor on x's device")
    return dev


def _bf16(dtype) -> bool:
    """Whether ``dtype`` selects the kernels' bfloat16 form (raises for a
    dtype the encoder does not compute in)."""
    return compute_rounding(dtype) is _to_bf16


def encoder_fwd(params, x, ids_mask, masks=None, keep: float = 1.0, save: bool = False,
                dtype=None):
    """Launch K2a on CUDA tensors: the encoder forward, with dropout
    ``masks`` when given, in compute dtype ``dtype`` (None or float32: its
    float32 form; bfloat16: its bfloat16 form, which rounds each product's
    operands as :func:`encoder_math` does). With ``save`` it also writes
    each block's input and LN_f's input to a [num_blocks + 1, B, T, d]
    workspace for K2b.

    Returns ``(out, saved)`` (``saved`` is None without ``save``); adds one
    to ``fused_encoder.launches`` (``fused_encoder.bf16_launches`` for the
    bfloat16 form). The caller checks the shape with
    :func:`check_supported`.
    """
    dev = _check_inputs(x, ids_mask)
    bf16 = _bf16(dtype)
    b, t, d = x.shape
    nb = len(params["blocks"])
    x_ptr = _ptr("x", x, (b, t, d), dev)
    weights = _weights(params, t, d, dev)
    dm = _masks(masks, keep, nb, b, t, d, dev)
    out = torch.empty(b, t, d, dtype=torch.float32, device=dev)
    saved = torch.empty(nb + 1, b, t, d, dtype=torch.float32, device=dev) if save else None
    if b == 0:
        return out, saved
    users, threads, smem = _layout(t, d)
    entry = "acf_sasrec_encoder_fwd_bf16" if bf16 else "acf_sasrec_encoder_fwd"
    with torch.cuda.device(dev):
        err = getattr(library(), entry)(
            weights, dm, x_ptr, ids_mask.data_ptr(), out.data_ptr(),
            0 if saved is None else saved.data_ptr(), b, t, d,
            users, threads, smem, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sasrec_encoder_fwd{'_bf16' if bf16 else ''} kernel launch failed: "
                           f"cudaError {err}")
    if bf16:
        fused_encoder.bf16_launches += 1
    else:
        fused_encoder.launches += 1
    return out, saved


def grad_size(num_blocks: int, t: int, d: int) -> int:
    """Floats of K2b's flat gradient: per block the leaves of
    :data:`BLOCK_LEAVES` (5 (d² + d) + 6 d), then ``ln_f`` (2 d), then the
    ``pos_emb[-T:]`` rows (T d)."""
    return num_blocks * (5 * d * d + 11 * d) + 2 * d + t * d


def _grad_tree(flat, num_blocks, t, d):
    """Views of K2b's flat gradient as ``{"pos_emb", "blocks", "ln_f"}``."""
    off = 0

    def take(*shape):
        nonlocal off
        n = math.prod(shape)
        view = flat[off:off + n].view(*shape)
        off += n
        return view

    blocks = []
    for _ in range(num_blocks):
        blk = {}
        for name, leaves in BLOCK_LEAVES:
            blk[name] = {leaf: take(d, d) if leaf == "w" else take(d) for leaf in leaves}
        blocks.append(blk)
    ln_f = {"gamma": take(d), "beta": take(d)}
    return {"pos_emb": take(t, d), "blocks": blocks, "ln_f": ln_f}


def encoder_bwd(params, x, ids_mask, g, saved=None, masks=None, keep: float = 1.0,
                weight_grads: bool = True, dtype=None):
    """The encoder backward (K2b): ``(dx, grads)`` as :func:`encoder_bwd_math`
    returns them, in compute dtype ``dtype``.

    CPU tensors take the plain version (``saved`` is not needed). CUDA
    tensors launch K2b, which reads ``saved``, the block inputs that K2a's
    training form wrote for the same params, x, ids mask, masks and dtype:
    its tile form where :func:`_bwd_form` says so, adding one to
    ``encoder_bwd.launches`` (``encoder_bwd.bf16_launches`` for its
    bfloat16 form), else its wide form, adding one to
    ``encoder_bwd.wide_launches`` (``encoder_bwd.wide_bf16_launches``).
    Without ``weight_grads`` the kernel computes dx alone and skips its
    reduction pass.
    """
    if x.device.type == "cpu":
        return encoder_bwd_math(params, x, ids_mask, masks, keep, g, weight_grads, dtype=dtype)
    dev = _check_inputs(x, ids_mask)
    bf16 = _bf16(dtype)
    suffix = "_bf16" if bf16 else ""
    b, t, d = x.shape
    nb = len(params["blocks"])
    check_supported(t, d, 1, nb, train=True)
    if saved is None:
        raise ValueError("K2b needs the block inputs saved by encoder_fwd(save=True)")
    g_ptr = _ptr("g", g, (b, t, d), dev)
    s_ptr = _ptr("saved", saved, (nb + 1, b, t, d), dev)
    weights = _weights(params, t, d, dev)
    dm = _masks(masks, keep, nb, b, t, d, dev)
    dx = torch.empty(b, t, d, dtype=torch.float32, device=dev)
    n_grad = grad_size(nb, t, d)
    flat = torch.empty(n_grad, dtype=torch.float32, device=dev) if weight_grads else None
    if b == 0:
        return dx, None if flat is None else _grad_tree(flat, nb, t, d)
    aligned = all(p % 16 == 0 for p in (g_ptr, s_ptr, weights.pos)) and all(
        v.data_ptr() % 16 == 0 for v in _flat_leaves(params))
    if _bwd_form(t, d, aligned) == "wide":
        _bwd_wide(weights, dm, ids_mask, g_ptr, s_ptr, dx, flat, b, t, d, n_grad, dev, suffix)
        if bf16:
            encoder_bwd.wide_bf16_launches += 1
        else:
            encoder_bwd.wide_launches += 1
        return dx, None if flat is None else _grad_tree(flat, nb, t, d)
    users, threads, smem = _bwd_layout(t, d)
    lib = library()
    with torch.cuda.device(dev):
        groups = -(-b // users)
        ctas = (min(groups, getattr(lib, f"acf_sasrec_encoder_bwd_ctas{suffix}")(threads, smem))
                if weight_grads else groups)
        if ctas <= 0:
            raise RuntimeError(f"K2b cannot run a {threads}-thread block with {smem} "
                               f"bytes of shared memory on {dev}")
        partial = (torch.empty(ctas, n_grad, dtype=torch.float32, device=dev)
                   if weight_grads else None)
        err = getattr(lib, f"acf_sasrec_encoder_bwd{suffix}")(
            weights, dm, ids_mask.data_ptr(), g_ptr, s_ptr, dx.data_ptr(),
            0 if partial is None else partial.data_ptr(),
            0 if flat is None else flat.data_ptr(), b, t, d, users, threads, smem, ctas,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sasrec_encoder_bwd{suffix} kernel launch failed: cudaError {err}")
    if bf16:
        encoder_bwd.bf16_launches += 1
    else:
        encoder_bwd.launches += 1
    return dx, None if flat is None else _grad_tree(flat, nb, t, d)


encoder_bwd.launches = 0
encoder_bwd.wide_launches = 0
encoder_bwd.bf16_launches = 0
encoder_bwd.wide_bf16_launches = 0


def _bwd_wide(weights, dm, ids_mask, g_ptr, s_ptr, dx, flat, b, t, d, n_grad, dev, suffix=""):
    """Launch K2b's wide form (its bfloat16 form with ``suffix`` "_bf16"):
    a persistent grid of as many whole clusters as the card runs at once (at
    most one a user), each CTA with its partial slice of the weight
    gradients unless ``flat`` is None."""
    cluster, ks, threads, smem = _bwd_wide_layout(t, d, bf16=suffix == "_bf16")
    lib = library()
    with torch.cuda.device(dev):
        fit = getattr(lib, f"acf_sasrec_encoder_bwd_wide_ctas{suffix}")(cluster, smem)
        ctas = min(b, fit // cluster) * cluster
        if ctas <= 0:
            raise RuntimeError(f"K2b's wide form cannot run a cluster of {cluster} "
                               f"{threads}-thread CTAs with {smem} bytes of shared memory each "
                               f"on {dev} (cudaError {-fit if fit < 0 else 0})")
        partial = (torch.empty(ctas, n_grad, dtype=torch.float32, device=dev)
                   if flat is not None else None)
        err = getattr(lib, f"acf_sasrec_encoder_bwd_wide{suffix}")(
            weights, dm, ids_mask.data_ptr(), g_ptr, s_ptr, dx.data_ptr(),
            0 if partial is None else partial.data_ptr(),
            0 if flat is None else flat.data_ptr(), b, t, d, cluster, ks, smem, ctas,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sasrec_encoder_bwd_wide{suffix} kernel launch failed: "
                           f"cudaError {err}")


# --- the autograd function --------------------------------------------------------

def _flat_leaves(params):
    """Every encoder leaf except the pos rows, in :data:`BLOCK_LEAVES` order
    per block, then ``ln_f``."""
    out = [blk[name][leaf] for blk in params["blocks"]
           for name, leaves in BLOCK_LEAVES for leaf in leaves]
    return out + [params["ln_f"]["gamma"], params["ln_f"]["beta"]]


def _tree_from(pos, leaves):
    it = iter(leaves)
    blocks = [{name: {leaf: next(it) for leaf in names} for name, names in BLOCK_LEAVES}
              for _ in range((len(leaves) - 2) // 16)]
    return {"pos_emb": pos, "blocks": blocks, "ln_f": {"gamma": next(it), "beta": next(it)}}


class _Encoder(torch.autograd.Function):
    """Inputs (ids_mask, masks, keep, dtype, x, pos rows, *leaves): the
    forward is K2a's training form (CPU: :func:`encoder_math`), the backward
    K2b (CPU: :func:`encoder_bwd_math`), both in compute dtype ``dtype``.
    The ids mask and the masks get no gradient."""

    @staticmethod
    def forward(ctx, ids_mask, masks, keep, dtype, x, pos, *leaves):
        params = _tree_from(pos, leaves)
        if x.device.type == "cpu":
            out, saved = fused_encoder_plain(params, x, ids_mask, masks, keep, dtype), None
        else:
            out, saved = encoder_fwd(params, x, ids_mask, masks, keep, save=True, dtype=dtype)
        ctx.save_for_backward(ids_mask, x, pos, *leaves)
        ctx.masks, ctx.keep, ctx.dtype, ctx.blocks_in = masks, keep, dtype, saved
        return out

    @staticmethod
    def backward(ctx, g):
        ids_mask, x, pos, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad
        weight_grads = any(need[5:])
        dx, grads = encoder_bwd(_tree_from(pos, leaves), x, ids_mask, g.contiguous(),
                                ctx.blocks_in, ctx.masks, ctx.keep, weight_grads, dtype=ctx.dtype)
        ctx.blocks_in = None
        if grads is None:
            rest = [None] * (1 + len(leaves))
        else:
            rest = [grads["pos_emb"]] + _flat_leaves(grads)
            rest = [r if n else None for r, n in zip(rest, need[5:])]
        return (None, None, None, None, dx if need[4] else None, *rest)


def fused_encoder(model, params, x, ids_mask, masks=None, dtype=None):
    """The SASRec encoder (``encode_math`` of the JAX model, one head).

    Args:
      model: the SASRec model (reads ``num_heads`` and ``dropout_rate``).
      params: its params (``pos_emb``, ``blocks``, ``ln_f`` are read).
      x: [B, T, d] float32 √d-scaled input embeddings.
      ids_mask: [B, T] bool, True where the window holds an item.
      masks: None, or the dropout masks of ``model._dropout_masks``.
      dtype: the products' compute dtype, None (float32) or bfloat16
        (:func:`encoder_math`), as ``fused_encoder(..., dtype=)`` of
        ``acf_tpu/ops/sasrec_fused.py:336``.

    Returns [B, T, d] float32, differentiable in x and every encoder leaf.
    CPU tensors take the plain versions; CUDA tensors launch K2a (and K2b
    in the backward, in the form :func:`_bwd_form` gives), each in its form
    for ``dtype``, or raise ``ValueError``.
    """
    if x.dim() != 3 or tuple(ids_mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"x must be [B, T, d] and ids_mask [B, T]; got "
                         f"{tuple(x.shape)} and {tuple(ids_mask.shape)}")
    compute_rounding(dtype)
    b, t, d = x.shape
    keep = 1.0 - model.dropout_rate
    pos = params["pos_emb"][-t:]
    leaves = _flat_leaves(params)
    graph = torch.is_grad_enabled() and any(
        v.requires_grad for v in (x, pos, *leaves))
    check_supported(t, d, model.num_heads, len(params["blocks"]), train=graph)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_encoder runs on cpu or cuda, not {x.device}")
    if graph:
        return _Encoder.apply(ids_mask, masks, keep, dtype, x, pos, *leaves)
    if x.device.type == "cpu":
        return fused_encoder_plain(params, x, ids_mask, masks, keep, dtype)
    return encoder_fwd(params, x, ids_mask, masks, keep, dtype=dtype)[0]


fused_encoder.launches = 0
fused_encoder.bf16_launches = 0
