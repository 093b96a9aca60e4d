"""Where the time of K2a (SASRec's encoder forward, ``acf_sasrec_encoder_fwd``
in ``csrc/sasrec_encoder_fwd.cu``) goes: variants of the kernel with parts of
its work taken out, timed side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k2a_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``sasrec_encoder_fwd.cu`` with the
``sasrec_encoder.cuh`` of the same commit beside it (default: this
checkout's, as ``head``). A variant's text is the forward with its header
inlined, so a variant may change the header's steps. ``ablation.run``
builds these variants of each (in the build directory; nothing in ``csrc/``
changes) and times its training form (dropout masks, block inputs saved) at
B = 512, d = 64, two blocks, T = 50 and T = 8, with torch.profiler's device
time:

  as_is        the kernel as it is;
  no_wload     the products' weights are a constant, not read from memory
               (the staged form: nothing is staged);
  no_attn      the attention is skipped, leaving its residual (q_in);
  no_ln        every LayerNorm is a copy (times the ids mask where it has one);
  no_saved     the block inputs are not written to ``saved``;
  regs128      (the ldg form) the kernel under ``__launch_bounds__(256, 2)``:
               128 registers a thread, where the form declares 512 threads
               and two blocks an SM, so 64 registers for every launch;
  regs80       (the staged form) the 256-thread kernel built for three
               blocks an SM (80 registers a thread), not two (128);
  ldg_weights  (the staged form) the products read their weights with __ldg
               from device memory, as the ldg form does, not the staged slots
               (nothing is staged);
  no_pv        (the staged form) the attention forms its weights but skips
               their sum over v;
  keys7        (the staged form) the attention built for 7 keys a lane (the
               widest windows) at every window, not for 2 up to T=64: its
               loops over a lane's keys unrolled seven times;
  inference    the as-is build's inference form (no masks, nothing saved);
  <layout>     (the staged form) the as-is build in another launch layout
               (``OTHER_LAYOUTS``: at T=50 slices of 40 rows, so that three
               blocks an SM fit beside the buffers (with ``regs80``'s
               registers they would run three), or two or four users and 512
               threads a block; at T=8 four users a block, as the ldg form
               has it, or one).

A variant applies where its text substitutions match the source exactly
once; each form of the kernel that was measured has its own (``FORMS``),
told apart by a line only it has (and every variant of it keeps), and its
own launch layout (``LAYOUTS``). An earlier kernel is compared by giving
its file, e.g. ``--source 6a7587e=DIR/sasrec_encoder_fwd.cu`` with ``git
show 6a7587e:acf_tpu_torch/csrc/<file>`` of both files written to DIR;
rounds time the sources in turns on one card. Each ``as_is`` is checked
against ``fused_encoder_plain`` (its output) and the plain block inputs
(its ``saved``) within ``K2A_TOL`` of their scale, and for two calls giving
the same bits.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from acf_tpu_torch.tools import ablation

TOL = 1e-4  # chip_smoke.py's K2A_TOL, of the output's scale
B, D, WINDOWS = 512, 64, (50, 8)
HEADER = "sasrec_encoder.cuh"
INCLUDE = f'#include "{HEADER}"\n'

# (old, new) text substitutions per variant, for each form of the kernel.
_LDG_WLOAD = (
    "        w0 = ldg4(W + (k + 0) * d + c0);\n"
    "        w1 = ldg4(W + (k + 1) * d + c0);\n"
    "        w2 = ldg4(W + (k + 2) * d + c0);\n"
    "        w3 = ldg4(W + (k + 3) * d + c0);\n")
_LDG_CONST_W = ("        w0 = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);  // no weight reads\n"
                "        w1 = w0; w2 = w0; w3 = w0;\n")
_LDG_LN = [
    ("    const float mean = warp_sum(s) / d;\n", "    const float mean = 0.f;  // no LayerNorm\n"),
    ("    const float denom = sqrtf(warp_sum(q) / d + kEps);\n", "    const float denom = 1.f;\n"),
    ("        dst[r * dld + c] = (__ldg(p.gamma + c) * (v[m] - mean) / denom + __ldg(p.beta + c)) * keep;\n",
     "        dst[r * dld + c] = v[m] * keep;  // a copy\n")]
_STAGED_WLOAD = (
    "          w[j] = *reinterpret_cast<const float4*>(\n"
    "              TRANS ? sw + (cg + groups * j) * pp.ldk + kk : sw + (kk + j) * ld + 4 * cg);\n")
_STAGED_COPIES = [
    ("      cp_async16(dst + kk * ld + c, W.w + static_cast<size_t>(k0 + kk) * d + c);\n", ""),
    ("      cp_async16(dst + c * pp.ldk + kk, W.w + static_cast<size_t>(c) * d + k0 + kk);\n", "")]
_STAGED_LDG = (
    "          w[j] = TRANS ? ldg4(W[p] + (cg + groups * j) * d + k0 + kk)\n"
    "                       : ldg4(W[p] + (k0 + kk + j) * d + 4 * cg);  // weights from device memory\n")
_STAGED_LN = [
    ("    const float mean = half_sum(s) / d;\n", "    const float mean = 0.f;  // no LayerNorm\n"),
    ("    const float denom = sqrtf(half_sum(q) / d + kEps);\n", "    const float denom = 1.f;\n"),
    ("      const float4 y = make_float4((g.x * (v[m].x - mean) / denom + b.x) * keep,\n"
     "                                   (g.y * (v[m].y - mean) / denom + b.y) * keep,\n"
     "                                   (g.z * (v[m].z - mean) / denom + b.z) * keep,\n"
     "                                   (g.w * (v[m].w - mean) / denom + b.w) * keep);\n",
     "      const float4 y = make_float4(v[m].x * keep, v[m].y * keep, v[m].z * keep,\n"
     "                                   v[m].w * keep);  // a copy\n")]
FORMS = {
    # commits 1de220a to 6a7587e: four buffers and a score row per warp,
    # weights read with __ldg inside the products, 64 registers a thread
    "ldg": ("  const BlockBufs bufs{X, X, Q, K, V, X, X, Q, K, nullptr, S, M};\n", {
        "no_wload": [(_LDG_WLOAD, _LDG_CONST_W)],
        "no_attn": [("  attention_rows(b.Q, b.K, b.V, b.A, b.S, b.M, R, T, Ts, d, ld, pm, keep, b.P);\n",
                     "  // no attention\n")],
        "no_ln": _LDG_LN,
        "no_saved": [("    if (saved != nullptr) {  // the block's input, for K2b\n",
                      "    if (false) {  // no saved copies\n"),
                     ("  if (saved != nullptr) {  // LN_f's input\n", "  if (false) {\n")],
        "regs128": [("__global__ void __launch_bounds__(kMaxThreads, 2)\n",
                     "__global__ void __launch_bounds__(256, 2)\n")],
    }),
    # four buffers, the weights staged through two shared slots with
    # cp.async (the header's product, shared with K2b), scores in
    # registers, 128 registers a thread at 256 and 512 threads
    "staged": ("  Pipe pp{SW, ks * ld, 0, false, ks, 0};\n", {
        "no_wload": [(_STAGED_WLOAD, "          w[j] = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);"
                                     "  // no weight reads\n"), *_STAGED_COPIES],
        "no_attn": [("    if (T <= 64)\n"
                     "      attention_rows<2>(Q, K, V, X, M, R, T, d, ld, pm, dm.keep);\n"
                     "    else\n"
                     "      attention_rows<kMaxKeysPerLane>(Q, K, V, X, M, R, T, d, ld, pm, dm.keep);\n",
                     "    // no attention\n")],
        "no_ln": _STAGED_LN,
        "no_saved": [
            ("    ln_pairs<ALIGNED>(X, saved == nullptr ? nullptr : saved + (blk * plane + row0) * d, d, "
             "X, ld,\n", "    ln_pairs<ALIGNED>(X, nullptr, d, X, ld,  // no saved copy\n"),
            ("  ln_pairs<ALIGNED>(X, saved == nullptr ? nullptr : saved + (nb * plane + row0) * d, d,\n",
             "  ln_pairs<ALIGNED>(X, nullptr, d,  // no saved copy\n")],
        "ldg_weights": [(_STAGED_WLOAD, _STAGED_LDG), *_STAGED_COPIES],
        "regs80": [("__global__ void __launch_bounds__(THREADS, fwd_blocks_an_sm(THREADS))\n",
                    "__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 3 : 1)\n")],
        "no_pv": [("    for (int c0 = 0; c0 <= i; c0 += chunk) {\n",
                   "    for (int c0 = 0; c0 < 0; c0 += chunk) {  // no weighted sum of v\n")],
        "keys7": [("    if (T <= 64)\n      attention_rows<2>(", "    if (false)\n      attention_rows<2>(")],
    }),
}


def _ldg_layout(t: int, d: int):
    """(users, threads, bytes) of the ``ldg`` form's launch (its
    ``_layout``): ~32 rows a block, 512 threads from 128 rows on, four
    [rows, ld] buffers, a score row of T a warp and the ids mask as
    floats."""
    users = max(1, 32 // t)
    threads = 512 if users * t >= 128 else 256
    rows, ts, ld = users * t, (t + 3) // 4 * 4, 4 * ((d // 4) | 1)
    return users, threads, 4 * (4 * rows * ld + threads // 32 * ts + rows)


def _staged_layout(t: int, d: int, users: int | None = None, threads: int | None = None,
                   ks: int | None = None):
    from acf_tpu_torch.ops.sasrec_fused import _layout

    return _layout(t, d, users, threads, ks)


LAYOUTS = {"ldg": _ldg_layout, "staged": _staged_layout}
# Other launch layouts of the staged form, timed beside its own: (users,
# threads, slice rows or None for the layout's own) a block at each window.
OTHER_LAYOUTS = {50: {"three_an_sm": (1, 256, 40), "two_users": (2, 512, None),
                      "four_users": (4, 512, None)},
                 8: {"four_users": (4, 256, None), "one_user": (1, 256, None)}}


def read(path: str) -> str:
    """The forward of one commit with its headers inlined."""
    if Path(path).read_text().count(INCLUDE) != 1:
        raise SystemExit(f"{path} does not include {HEADER} once")
    return ablation.read_source(path)


def variants(source: str) -> dict[str, str]:
    return ablation.variants(source, FORMS, "sasrec_encoder_fwd_kernel")


def form_of(text: str) -> str:
    return next(name for name, (marker, _) in FORMS.items() if text.count(marker) == 1)


def inputs(dev, t, seed=0):
    """Random weights (2 blocks, biases and LayerNorms moved off their init
    values), full windows of ``t`` items, dropout masks, and the plain
    output and block inputs."""
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.nn.layers import layer_norm
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
    h = _input(params, x, mask, masks, keep)
    saved = []
    for i, blk in enumerate(params["blocks"]):
        saved.append(h)
        h, _ = _block(blk, h, mask, 1, masks["blocks"][i], keep)
    return dict(params=params, x=x, mask=mask, masks=masks, keep=keep,
                out=layer_norm(params["ln_f"], h), saved=torch.stack([*saved, h]).contiguous())


def caller(lib, x, train=True, layout=None):
    """A function that launches ``acf_sasrec_encoder_fwd`` of ``lib`` once on
    ``x``, in ``layout`` (users, threads, bytes) or that of its form: the
    training form (masks, block inputs saved) returns (out, saved), the
    inference form (out,)."""
    from acf_tpu_torch.ops.sasrec_fused import _masks, _weights

    t, nb, dev = x["x"].shape[1], len(x["params"]["blocks"]), x["x"].device
    users, threads, smem = layout or LAYOUTS[form_of(lib.text)](t, D)
    out = torch.empty(B, t, D, device=dev)
    saved = torch.empty(nb + 1, B, t, D, device=dev) if train else None
    args = [_weights(x["params"], t, D, dev),
            _masks(x["masks"] if train else None, x["keep"], nb, B, t, D, dev),
            x["x"], x["mask"], out, 0 if saved is None else saved, B, t, D, users, threads, smem]
    return ablation.launcher(lib.acf_sasrec_encoder_fwd, args, "acf_sasrec_encoder_fwd",
                             (out, saved) if train else (out,))


def other_layouts(lib, x):
    """The staged form's other candidate layouts at this window."""
    t = x["x"].shape[1]
    if form_of(lib.text) == "ldg":
        return {}
    layout = LAYOUTS[form_of(lib.text)]
    return {name: caller(lib, x, layout=layout(t, D, users, threads, ks))
            for name, (users, threads, ks) in OTHER_LAYOUTS.get(t, {}).items()}


def setup(dev):
    cases = {}
    for t in WINDOWS:
        x = inputs(dev, t)
        cases[f"T={t}"] = ({"out": x["out"], "saved": x["saved"]},
                           lambda lib, x=x: caller(lib, x),
                           lambda lib, x=x: {"inference": caller(lib, x, train=False),
                                             **other_layouts(lib, x)})
    return cases


if __name__ == "__main__":
    ablation.run(__doc__, "sasrec_encoder_fwd_kernel", variants, setup,
                 source="sasrec_encoder_fwd.cu", prefix="acf_sasrec_encoder_fwd", tol=TOL,
                 shape=f"B={B} d={D} nb=2 T in {WINDOWS}, dropout masks", read=read)
