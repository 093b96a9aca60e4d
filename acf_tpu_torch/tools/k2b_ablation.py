"""Where the time of K2b (SASRec's encoder backward, ``acf_sasrec_encoder_bwd``
in ``csrc/sasrec_encoder_bwd.cu``) goes: variants of the kernel with parts of
its work taken out, timed side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k2b_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``sasrec_encoder_bwd.cu`` with the
``sasrec_encoder.cuh`` and ``sasrec_encoder_fwd.cu`` of the same commit
beside it (default: this checkout's, as ``head``). A variant's text is the
header, the backward and the forward in one translation unit, so a variant
may change the header's products and K2a is built with it. ``ablation.run``
builds these variants of each (in the build directory; nothing in ``csrc/``
changes) and times its ``acf_sasrec_encoder_bwd`` at B = 512, d = 64, two
blocks, T = 50 and T = 8, with dropout masks, with torch.profiler's device
time, the reduction pass included where it runs:

  as_is        the kernel as it is (the full form: dx and every gradient);
  no_wload     the products' weights are a constant, not read from memory;
  no_attn_bwd  the attention backward (dV, dS, dQ, dK) is skipped;
  no_remat     the rematerialised forward of each block is skipped;
  no_reduce    the C entry returns before the reduction pass;
  ldg_weights  (the staged form) the products read their weights with __ldg
               from device memory, as the kernel of commit 202a5d5 did, not the
               staged slots (nothing is staged);
  three_products (the staged form) dq_in's three dY Wᵀ products run one
               after the other with a barrier between, not as one pass;
  late_partial (the staged form) the weight gradients read their partial
               slice's earlier values after the rows, not before;
  dx_only      the as-is build's dx-only form (the kernel's own mode: no
               weight gradients, no partials, no reduction);
  k2a          K2a's training form (masks, block inputs saved) of the
               as-is build;
  two_blocks   (T=8, the staged form) the as-is build with two users and
               256 threads a block, two blocks an SM, where the layout
               gives four users and 512 threads, one block an SM.

A variant applies where its text substitutions match the source exactly
once; each form of the kernel that was measured has its own (``FORMS``),
told apart by a line only it has (and every variant of it keeps), and its
own launch layout (``LAYOUTS``).
An earlier kernel is compared by giving its file, e.g. ``--source
202a5d5=DIR/sasrec_encoder_bwd.cu`` with ``git show
202a5d5:acf_tpu_torch/csrc/<file>`` of the three files written to DIR;
rounds time the sources in turns on one card. Each ``as_is`` is checked
against ``encoder_bwd_math`` (users near a ReLU kink get a zero cotangent,
as in ``chip_smoke.py``), for two calls giving the same bits and for its
dx-only form giving the full form's dx bit for bit.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from acf_tpu_torch.tools import ablation, k2a_ablation

TOL = 1e-4  # chip_smoke.py's K2B_TOL, of the tree's scale
KINK = 2e-5  # chip_smoke.py's KINK
B, D, WINDOWS = 512, 64, (50, 8)
HEADER, FWD = "sasrec_encoder.cuh", "sasrec_encoder_fwd.cu"
INCLUDE = f'#include "{HEADER}"\n'

# (old, new) text substitutions per variant, for each form of the kernel.
_REMAT_WLOAD = (
    "      float4 w0, w1, w2, w3;  // W[k + i][c0..c0+3], i = 0..3\n"
    "      if (TRANS) {             // from Wᵀ: rows c0..c0+3 of W, columns k..k+3\n"
    "        const float4 a = ldg4(W + (c0 + 0) * d + k);\n"
    "        const float4 b = ldg4(W + (c0 + 1) * d + k);\n"
    "        const float4 c = ldg4(W + (c0 + 2) * d + k);\n"
    "        const float4 f = ldg4(W + (c0 + 3) * d + k);\n"
    "        w0 = make_float4(a.x, b.x, c.x, f.x);\n"
    "        w1 = make_float4(a.y, b.y, c.y, f.y);\n"
    "        w2 = make_float4(a.z, b.z, c.z, f.z);\n"
    "        w3 = make_float4(a.w, b.w, c.w, f.w);\n"
    "      } else {\n"
    "        w0 = ldg4(W + (k + 0) * d + c0);\n"
    "        w1 = ldg4(W + (k + 1) * d + c0);\n"
    "        w2 = ldg4(W + (k + 2) * d + c0);\n"
    "        w3 = ldg4(W + (k + 3) * d + c0);\n"
    "      }\n")
_CONST_W = ("      const float4 w0 = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);  // no weight reads\n"
            "      const float4 w1 = w0, w2 = w0, w3 = w0;\n")
_REMAT_ATTN = (
    "      attn_bwd_dv(P, pm, keep, G, A, M, R, T, Ts, d, ld);\n"
    "      __syncthreads();\n"
    "      attn_bwd_ds(P, S, pm, keep, G, V, M, R, T, Ts, d, ld);\n"
    "      __syncthreads();\n"
    "      attn_bwd_dq(P, K, X2, M, R, T, Ts, d, ld);\n"
    "      attn_bwd_dk(P, Q, F1, M, R, T, Ts, d, ld);\n"
    "      __syncthreads();\n")
_REMAT_FWD = "      block_forward(p, bufs, pm, f1m, f2m, keep, true, R, T, Ts, d, ld);\n"
_REDUCE = "  sasrec_encoder_bwd_reduce<<<grid, 256, 0, s>>>(partial, ctas, n_grad, grad);\n"
_STAGED_WLOAD = (
    "          w[j] = *reinterpret_cast<const float4*>(\n"
    "              TRANS ? sw + (cg + groups * j) * pp.ldk + kk : sw + (kk + j) * ld + 4 * cg);\n")
_STAGED_COPIES = [
    ("      cp_async16(dst + kk * ld + c, W.w + static_cast<size_t>(k0 + kk) * d + c);\n", ""),
    ("      cp_async16(dst + c * pp.ldk + kk, W.w + static_cast<size_t>(c) * d + k0 + kk);\n", "")]
_STAGED_ATTN = (
    "      attn_bwd_dv(P, dm.p[blk] == nullptr ? nullptr : PM, dm.keep, G, X0, M, gs->R, T, Ts, d, ld);\n"
    "      __syncthreads();\n"
    "      attn_bwd_ds(P, S, dm.p[blk] == nullptr ? nullptr : PM, dm.keep, G, X4, M, gs->R, T, Ts, d,\n"
    "                  ld);\n"
    "      __syncthreads();\n"
    "      attn_bwd_dqk(P, X3, X2, X1, X5, M, gs->R, T, Ts, d, ld);\n"
    "      __syncthreads();\n")
_STAGED_FWD = (
    "      ln_rows<ALIGNED>(saved + (blk * plane + gs->row0) * d, d, nullptr, X1, p.ln1, gs->R, d,\n"
    "                       ld);  // q_in\n"
    "      dense<false, 1, ALIGNED>(pp, {X1}, {p.wq.w}, WRef{p.wk.w, false}, X2, epi(p.wq.b),\n"
    "                               gs->R, d, ld);\n"
    "      dense<false, 1, ALIGNED>(pp, {X1}, {p.wk.w}, WRef{p.wv.w, false}, X3, epi(p.wk.b),\n"
    "                               gs->R, d, ld);\n"
    "      dense<false, 1, ALIGNED>(pp, {X1}, {p.wv.w}, WRef{p.conv1.w, false}, X4, epi(p.wv.b),\n"
    "                               gs->R, d, ld);\n"
    "      __syncthreads();\n"
    "      attention_fwd(X2, X3, X4, X1, X0, S, P, dm.p[blk] == nullptr ? nullptr : PM, dm.keep, M,\n"
    "                    gs->R, T, Ts, d, ld);\n"
    "      __syncthreads();\n"
    "      ln_rows<ALIGNED>(X0, ld, nullptr, X1, p.ln2, gs->R, d, ld);  // x2\n"
    "      dense<false, 1, ALIGNED>(\n"
    "          pp, {X1}, {p.conv1.w}, WRef{p.conv2.w, false}, X5,\n"
    "          epi(p.conv1.b, true, mask_rows(dm.f1[blk], gs->row0, d), dm.keep), gs->R, d, ld);  // F1\n"
    "      dense<false, 1, ALIGNED>(\n"
    "          pp, {X5}, {p.conv2.w}, WRef{p.conv2.w, true}, X1,\n"
    "          epi(p.conv2.b, false, mask_rows(dm.f2[blk], gs->row0, d), dm.keep, nullptr, X1), gs->R,\n"
    "          d, ld);  // F\n")
_STAGED_LDG = (
    "          w[j] = TRANS ? ldg4(W[p] + (cg + groups * j) * d + k0 + kk)\n"
    "                       : ldg4(W[p] + (k0 + kk + j) * d + 4 * cg);  // weights from device memory\n")
_STAGED_TRIPLE = (
    "      dense<true, 3, ALIGNED>(pp, {X1, X5, X0}, {p.wq.w, p.wk.w, p.wv.w}, next, G,\n"
    "                              epi(nullptr, false, nullptr, 1.f, nullptr, G), gs->R, d, ld);\n")
_STAGED_THREE = (
    "      dense<true, 1, ALIGNED>(pp, {X1}, {p.wq.w}, WRef{p.wk.w, true}, G,\n"
    "                              epi(nullptr, false, nullptr, 1.f, nullptr, G), gs->R, d, ld);\n"
    "      __syncthreads();\n"
    "      dense<true, 1, ALIGNED>(pp, {X5}, {p.wk.w}, WRef{p.wv.w, true}, G,\n"
    "                              epi(nullptr, false, nullptr, 1.f, nullptr, G), gs->R, d, ld);\n"
    "      __syncthreads();\n"
    "      dense<true, 1, ALIGNED>(pp, {X0}, {p.wv.w}, next, G,\n"
    "                              epi(nullptr, false, nullptr, 1.f, nullptr, G), gs->R, d, ld);\n")
_STAGED_PREFETCH = [
    ("          prev[p][i][j] = first || !inside(i, j) ? 0.f : wp[p][(k0 + i) * d + c0 + j];\n",
     "          prev[p][i][j] = 0.f;\n"),
    ("            wp[p][(k0 + i) * d + c0 + j] = first ? acc[p][i][j] : prev[p][i][j] + acc[p][i][j];\n",
     "            wp[p][(k0 + i) * d + c0 + j] =  // the partial read after the rows\n"
     "                first ? acc[p][i][j] : wp[p][(k0 + i) * d + c0 + j] + acc[p][i][j];\n")]
_STAGED_REDUCE = (
    "  sasrec_encoder_bwd_reduce<<<blocks, kReduceOuts * kReduceSlices, 0, s>>>(partial, ctas, n_grad,\n"
    "                                                                        grad, nb, d);\n")
FORMS = {
    # commits 9f43932 to 202a5d5: ten buffers, the forward's own block_forward
    # for the rematerialisation, weights read with __ldg inside the products
    "remat": ("constexpr int kBuffers = 10;  // BWD_BUFFERS in ops/sasrec_fused.py\n", {
        "no_wload": [(_REMAT_WLOAD, _CONST_W)],
        "no_attn_bwd": [(_REMAT_ATTN, "      // no attention backward\n")],
        "no_remat": [(_REMAT_FWD, "      // no rematerialisation\n")],
        "no_reduce": [(_REDUCE, "")],
    }),
    # seven buffers, 512 threads, weights staged through two shared slots
    # with cp.async, weight gradients on every thread
    "staged": ("constexpr int kBuffers = 7;          // BWD_BUFFERS in ops/sasrec_fused.py\n", {
        "no_wload": [(_STAGED_WLOAD, "          w[j] = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);"
                                     "  // no weight reads\n"), *_STAGED_COPIES],
        "no_attn_bwd": [(_STAGED_ATTN, "      // no attention backward\n")],
        "no_remat": [(_STAGED_FWD, "      // no rematerialisation\n")],
        "no_reduce": [(_STAGED_REDUCE, "")],
        "ldg_weights": [(_STAGED_WLOAD, _STAGED_LDG), *_STAGED_COPIES],
        "three_products": [(_STAGED_TRIPLE, _STAGED_THREE)],
        "late_partial": _STAGED_PREFETCH,
    }),
}


def _remat_layout(t: int, d: int):
    """(users, threads, bytes) of the ``remat`` form's launch (its
    ``_bwd_layout``)."""
    users = max(1, 32 // t)
    threads = 512 if users * t >= 128 else 256
    rows, ts, warps, ld = users * t, (t + 3) // 4 * 4, threads // 32, 4 * ((d // 4) | 1)
    return users, threads, 4 * (10 * rows * ld + rows * ts + warps * ts + rows + warps * 2 * d)


def _staged_layout(t: int, d: int):
    from acf_tpu_torch.ops.sasrec_fused import _bwd_layout

    return _bwd_layout(t, d)


LAYOUTS = {"remat": _remat_layout, "staged": _staged_layout}


def read(path: str) -> str:
    """The header, the backward and (where it lies beside them) the forward
    of one commit as one text: the headers in place of the backward's
    include, the forward appended without its own."""
    src = Path(path)
    if src.read_text().count(INCLUDE) != 1:
        raise SystemExit(f"{src} does not include {HEADER} once")
    seen = set()
    text = ablation.read_source(src, seen)
    if (src.parent / FWD).exists():
        text += "\n" + ablation.read_source(src.parent / FWD, seen)
    return text


def variants(source: str) -> dict[str, str]:
    return ablation.variants(source, FORMS, "sasrec_encoder_bwd_kernel")


def form_of(text: str) -> str:
    return next(name for name, (marker, _) in FORMS.items() if text.count(marker) == 1)


def near_kink_users(params, x, mask, masks, keep):
    """[B] bool: users with an unmasked row holding a ReLU pre-activation
    within KINK of 0 in the plain forward (``chip_smoke.py``'s test)."""
    from acf_tpu_torch.ops.sasrec_fused import _block, _input

    h = _input(params, x, mask, masks, keep)
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for i, blk in enumerate(params["blocks"]):
        h, c = _block(blk, h, mask, 1, masks["blocks"][i], keep)
        near |= ((c["z1"].abs() <= KINK) & mask[:, :, None]).flatten(1).any(dim=1)
    return near


def inputs(dev, t, seed=0):
    """Random weights (2 blocks, biases and LayerNorms moved off their init
    values), full windows of ``t`` items, dropout masks, a cotangent (zero
    for users near a ReLU kink) and the block inputs from the plain
    forward."""
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.ops.sasrec_fused import _block, _input

    model = SASRec(100, 1000, D, maxlen=max(WINDOWS))
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(g, device=dev)
    for p in params["blocks"] + [params]:
        for name, leaf in p.items():
            for key in ("gamma", "beta", "b"):
                if name != "item_emb" and isinstance(leaf, dict) and key in leaf:
                    leaf[key] += 0.1 * torch.randn(D, generator=g, device=dev)
    seq = torch.randint(1, 1000, (B, t), generator=g, device=dev)
    x, mask = params["item_emb"][seq] * math.sqrt(D), seq != 0
    keep = 1.0 - model.dropout_rate
    masks = model._dropout_masks(g, B, t)
    cot = torch.randn(B, t, D, generator=g, device=dev)
    cot[near_kink_users(params, x, mask, masks, keep)] = 0.0
    h = _input(params, x, mask, masks, keep)
    saved = []
    for i, blk in enumerate(params["blocks"]):
        saved.append(h)
        h, _ = _block(blk, h, mask, 1, masks["blocks"][i], keep)
    return dict(params=params, x=x, mask=mask, masks=masks, keep=keep, cot=cot,
                saved=torch.stack([*saved, h]).contiguous())


def caller(lib, x, weight_grads=True, layout=None):
    """A function that launches ``acf_sasrec_encoder_bwd`` of ``lib`` once
    on ``x``, in ``layout`` (users, threads, bytes) or that of its form,
    and returns (dx, flat gradient) or (dx,) without ``weight_grads``."""
    from acf_tpu_torch.ops.sasrec_fused import _masks, _weights, grad_size

    t, nb, dev = x["x"].shape[1], len(x["params"]["blocks"]), x["x"].device
    users, threads, smem = layout or LAYOUTS[form_of(lib.text)](t, D)
    groups = -(-B // users)
    ctas = min(groups, lib.acf_sasrec_encoder_bwd_ctas(threads, smem)) if weight_grads else groups
    if ctas <= 0:
        raise SystemExit(f"K2b does not fit: {threads} threads, {smem} bytes")
    n_grad = grad_size(nb, t, D)
    dx = torch.empty(B, t, D, device=dev)
    flat = torch.empty(n_grad, device=dev) if weight_grads else None
    partial = torch.empty(ctas, n_grad, device=dev) if weight_grads else None
    args = [_weights(x["params"], t, D, dev), _masks(x["masks"], x["keep"], nb, B, t, D, dev),
            x["mask"], x["cot"], x["saved"], dx, 0 if partial is None else partial,
            0 if flat is None else flat, B, t, D, users, threads, smem, ctas]
    return ablation.launcher(lib.acf_sasrec_encoder_bwd, args, "acf_sasrec_encoder_bwd",
                             (dx, flat) if weight_grads else (dx,))


def k2a_caller(lib, x):
    """A function that launches K2a's training form of ``lib`` once on ``x``,
    in the launch layout of the form of K2a that ``lib`` holds
    (``k2a_ablation.LAYOUTS``)."""
    from acf_tpu_torch.ops.sasrec_fused import _masks, _weights

    t, nb, dev = x["x"].shape[1], len(x["params"]["blocks"]), x["x"].device
    users, threads, smem = k2a_ablation.LAYOUTS[k2a_ablation.form_of(lib.text)](t, D)
    out = torch.empty(B, t, D, device=dev)
    saved = torch.empty(nb + 1, B, t, D, device=dev)
    args = [_weights(x["params"], t, D, dev), _masks(x["masks"], x["keep"], nb, B, t, D, dev),
            x["x"], x["mask"], out, saved, B, t, D, users, threads, smem]
    return ablation.launcher(lib.acf_sasrec_encoder_fwd, args, "acf_sasrec_encoder_fwd",
                             (out, saved))


def setup(dev):
    from acf_tpu_torch.ops.sasrec_fused import _flat_leaves, encoder_bwd_math

    cases = {}
    for t in WINDOWS:
        x = inputs(dev, t)
        dx, grads = encoder_bwd_math(x["params"], x["x"], x["mask"], x["masks"], x["keep"],
                                     x["cot"])
        flat = torch.cat([v.flatten() for v in [*_flat_leaves(grads), grads["pos_emb"]]])
        cases[f"T={t}"] = ({"dx": dx, "grad": flat},
                           lambda lib, x=x: caller(lib, x),
                           lambda lib, x=x: {"dx_only": caller(lib, x, False),
                                             "k2a": k2a_caller(lib, x), **two_blocks(lib, x)})
    return cases


def two_blocks(lib, x):
    """At T=8 the staged form's other candidate layout: two users and 256
    threads a block, two blocks an SM (256 blocks at B=512)."""
    from acf_tpu_torch.ops.sasrec_fused import _bwd_bytes

    t = x["x"].shape[1]
    if form_of(lib.text) != "staged" or t != 8:
        return {}
    return {"two_blocks": caller(lib, x, layout=(2, 256, _bwd_bytes(2, 256, t, D)))}


def check(outputs, extras):
    return [("dx-only form gives the full form's dx",
             torch.equal(extras["dx_only"]()[0], outputs[0]))]


if __name__ == "__main__":
    ablation.run(__doc__, "sasrec_encoder_bwd_kernel", variants, setup, check,
                 source="sasrec_encoder_bwd.cu", prefix="acf_sasrec_encoder_", tol=TOL,
                 shape=f"B={B} d={D} nb=2 T in {WINDOWS}, dropout masks", read=read)
