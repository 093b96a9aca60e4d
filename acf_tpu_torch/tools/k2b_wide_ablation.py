"""Where the time of K2b's wide form goes (``acf_sasrec_encoder_bwd_wide`` in
``csrc/sasrec_encoder_bwd.cu``, SASRec's encoder backward for every shape
its tile form does not take): variants of the kernel with parts of its work
taken out or its layout changed, timed side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k2b_wide_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``sasrec_encoder_bwd.cu`` with the
``sasrec_encoder.cuh`` and ``cp_async.cuh`` of the same commit beside it
(default: this checkout's, as ``head``); a variant's text is the backward
with its headers inlined. ``ablation.run`` builds these variants of each (in
the build directory; nothing in ``csrc/`` changes) and times the wide form
at B = 512, two blocks, full windows with dropout masks: T = 200 at d = 50
(the SASRec paper's ML-1M shape) and d = 64, and T = 50 at d = 50 (which
d % 4 != 0 sends to the wide form), by torch.profiler's device time, the
reduction pass included where it runs. Two forms (``FORMS``):

``workspace`` (commits ff82a88 to f5941ac: one user a block of 256 threads,
its seven buffers and probabilities in a device workspace, the products in
chunks of the tile form's rows, each chunk streaming the whole weight):

  as_is        the kernel as it is (dx and every gradient);
  one_slice    every block works in the first block's slice of the
               workspace, so its traffic stays in L2 (outputs wrong): the
               cost of the workspace's traffic;
  no_wload     the products' weights a constant, their 4-byte copies gone:
               the cost of streaming each weight once a chunk;
  no_attn_bwd  the attention backward (dV, dS, dQ, dK) skipped;
  stamps       clock64() summed between the phase boundaries (below);

``cluster`` (one user's window a thread-block cluster of 512-thread CTAs,
everything of a CTA's rows in its shared memory):

  as_is, no_wload, stamps   as above;
  no_attn      every attention step skipped (the gathers, the scores and
               softmax, PV, the dV and dK shares and their sums, dS, dQ);
  no_dsmem     the gathers of k and v and the sums of the ranks' shares
               skipped (every read of another CTA's shared memory);
  warps8       256 threads a CTA (8 warps an SM) with three-row register
               tiles, the same cluster and slices: the cost of half the
               warps (timed where three rows a thread cover a CTA's rows);

and, beside each ``as_is``, its own build's dx-only mode (``dx_only``) and,
beside the first source's, the plain version ``encoder_bwd_math``
(``plain``), so that one call times the kernels against it in turns.

``stamps``: thread 0 of every CTA adds the clock64() cycles since the last
boundary to its phase's count (``PHASES``: the workspace form's seven a
block and a user; the cluster form's 24, each attention step, gather and
cluster barrier apart). The report prints each
phase's share of a CTA's cycles, averaged over the CTAs. Each ``as_is`` is
checked against ``encoder_bwd_math`` (users near a ReLU kink get a zero
cotangent, as in ``chip_smoke.py``), for two calls giving the same bits and
for its dx-only mode giving the full form's dx bit for bit. The earlier
kernel is compared by giving its file, e.g. ``--source
f5941ac=DIR/sasrec_encoder_bwd.cu`` with ``git archive f5941ac
acf_tpu_torch/csrc`` unpacked into DIR; rounds time the sources in turns.
"""

from __future__ import annotations

import ctypes
import math

import torch

from acf_tpu_torch.ops import _build
from acf_tpu_torch.tools import ablation, k2b_ablation

TOL = 1e-4  # chip_smoke.py's K2B_TOL, of the output's scale
B = 512
CASES = ((50, 200), (64, 200), (50, 50))  # (d, T)
# the phases between the stamps, by the stamp that ends each; the workspace
# form stamps 1 to 7 of its own, the cluster form 1 to 23
PHASES = {
    "workspace": ("user start", "LN1, q/k/v", "attention fwd", "FFN fwd", "FFN bwd",
                  "attention bwd", "q/k/v grads, dq_in, LN1ᵀ", "input, dpos"),
    "cluster": ("user start", "masks staged", "LN1, q/k/v", "cluster barrier 1", "gather k",
                "scores, softmax", "gather v", "PV", "FFN fwd", "FFN bwd", "dV shares",
                "cluster barrier 2", "dV sums", "cluster barrier 3", "gather v", "dS",
                "gather k", "dQ", "dK shares", "cluster barrier 4", "dK sums",
                "LN1 again, q/k/v grads", "dq_in, LN1ᵀ", "input, dpos",
                "user start: ids, g, LN_f's input, LN_fᵀ"),
}
STAMPS = 32  # phases a CTA's stamps hold
MAX_CTAS = 1024  # CTAs the stamps record

# The stamps variant's definitions, put before the source.
_STAMPS = f"""#define ACF_STAMP(k) acf_stamp(k)
__device__ unsigned long long acf_stamps[{MAX_CTAS}][{STAMPS}];
__device__ unsigned long long acf_stamp_last[{MAX_CTAS}];
__device__ __forceinline__ void acf_stamp(int k) {{
  if (threadIdx.x != 0 || blockIdx.x >= {MAX_CTAS}) return;
  const unsigned long long t = clock64();
  acf_stamps[blockIdx.x][k] += t - acf_stamp_last[blockIdx.x];
  acf_stamp_last[blockIdx.x] = t;
}}
// Copies the first n CTAs' counts to out and zeroes every count.
extern "C" int acf_stamps_take(unsigned long long* out, int n) {{
  static unsigned long long zero[{MAX_CTAS} * {STAMPS}];
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, acf_stamps, n * {STAMPS} * sizeof(zero[0]));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(acf_stamps, zero, sizeof(zero));
  return e;
}}
"""
_STAMP_AT = "struct DenseW { const float* w; const float* b; };\n"  # at global scope, once

# the workspace form's phase boundaries, (line, the line with a stamp before it)
_WS_STAMPS = [
    ("    __syncthreads();  // the previous group is done with every buffer and with gs\n",
     "    __syncthreads();  // the previous group is done with every buffer and with gs\n"
     "    ACF_STAMP(0);\n"),
    ("      attention_fwd(X2, X3, X4, X1, X0, S, P,",
     "      ACF_STAMP(1);\n      attention_fwd(X2, X3, X4, X1, X0, S, P,"),
    ("      ln_rows<ALIGNED>(X0, ld, nullptr, X1, p.ln2, gs->R, d, ld);  // x2\n",
     "      ACF_STAMP(2);\n      ln_rows<ALIGNED>(X0, ld, nullptr, X1, p.ln2, gs->R, d, ld);  // x2\n"),
    ("          d, ld);  // F\n      __syncthreads();\n",
     "          d, ld);  // F\n      __syncthreads();\n      ACF_STAMP(3);\n"),
    ("      ln_bwd_rows(X0, G, p.ln2, nullptr, LS, gs->R, d, ld);  // G = dA\n      __syncthreads();\n",
     "      ln_bwd_rows(X0, G, p.ln2, nullptr, LS, gs->R, d, ld);  // G = dA\n      __syncthreads();\n"
     "      ACF_STAMP(4);\n"),
    ("      attn_bwd_dqk(P, X3, X2, X1, X5, M, gs->R, T, Ts, d, ld);\n      __syncthreads();\n",
     "      attn_bwd_dqk(P, X3, X2, X1, X5, M, gs->R, T, Ts, d, ld);\n      __syncthreads();\n"
     "      ACF_STAMP(5);\n"),
    ("      if (gs->part != nullptr) ln_grad_flush(LS, leaf(gs->part, blk, kLn1, d), gs->first, d);\n",
     "      if (gs->part != nullptr) ln_grad_flush(LS, leaf(gs->part, blk, kLn1, d), gs->first, d);\n"
     "      ACF_STAMP(6);\n"),
    ("        add_to(pos + idx, s, gs->first);\n      }\n    }\n",
     "        add_to(pos + idx, s, gs->first);\n      }\n    }\n    ACF_STAMP(7);\n"),
]
_ANY_COPIES = [
    ("        cp_async_n<4>(dst + kk * ld + c, W.w + (valid ? (k0 + kk) * d + c : 0), valid ? 4 : 0);\n",
     "        (void)valid;  // no weight copies\n"),
    ("        cp_async_n<4>(dst + c * pp.ldk + kk, W.w + (valid ? c * d + k0 + kk : 0), valid ? 4 : 0);\n",
     "        (void)valid;  // no weight copies\n")]
_NO_WLOAD = [(k2b_ablation._STAGED_WLOAD,
              "          w[j] = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);  // no weight reads\n"),
             *_ANY_COPIES]
_CL_FWD_ATTN = (
    "      gather(F, X3, T, c, d, ld);  // the window's keys\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(4);\n"
    "      cl_softmax(X2, F, P, MO, MF, hs->rw, T, Ts, d, ld);\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(5);\n"
    "      gather(F, X4, T, c, d, ld);  // the window's values\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(6);\n"
    "      if (d <= 64)  // A\n"
    "        cl_rows<2>(true, P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, F, X1, X0, MO, hs->rw,\n"
    "                   T, Ts, d, ld);\n"
    "      else\n"
    "        cl_rows<4>(true, P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, F, X1, X0, MO, hs->rw,\n"
    "                   T, Ts, d, ld);\n")
_CL_BWD_ATTN = (
    "      if (d <= 64)\n"
    "        cl_partials<2>(true, P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, G, F, MF, hs->rw,\n"
    "                       T, Ts, d, ld);\n"
    "      else\n"
    "        cl_partials<4>(true, P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, G, F, MF, hs->rw,\n"
    "                       T, Ts, d, ld);\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(10);\n"
    "      cg::this_cluster().sync();  // every rank's shares are in its F\n"
    "      ACF_STAMP(11);\n"
    "      cl_combine(F, X0, false, hs->rw, T, c, d, ld);\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(12);\n"
    "      cg::this_cluster().sync();  // no rank reads another's F any more\n"
    "      ACF_STAMP(13);\n"
    "      gather(F, X4, T, c, d, ld);  // the window's values again\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(14);\n"
    "      cl_ds(P, dm.p[blk] == nullptr ? nullptr : PMs, dm.keep, G, F, MO, MF, hs->rw, T, Ts, d, ld);\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(15);\n"
    "      gather(F, X3, T, c, d, ld);  // the window's keys again\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(16);\n"
    "      if (d <= 64)  // dQ\n"
    "        cl_rows<2>(false, P, nullptr, 0.f, F, nullptr, X1, MO, hs->rw, T, Ts, d, ld);\n"
    "      else\n"
    "        cl_rows<4>(false, P, nullptr, 0.f, F, nullptr, X1, MO, hs->rw, T, Ts, d, ld);\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(17);\n"
    "      if (d <= 64)\n"
    "        cl_partials<2>(false, P, nullptr, 0.f, X2, F, MF, hs->rw, T, Ts, d, ld);\n"
    "      else\n"
    "        cl_partials<4>(false, P, nullptr, 0.f, X2, F, MF, hs->rw, T, Ts, d, ld);\n"
    "      __syncthreads();\n"
    "      ACF_STAMP(18);\n"
    "      cg::this_cluster().sync();  // shares in place; every rank is done with X3 and X4\n"
    "      ACF_STAMP(19);\n"
    "      cl_combine(F, X5, true, hs->rw, T, c, d, ld);\n")
_CL_DSMEM = [(line, "") for line in (
    "      gather(F, X3, T, c, d, ld);  // the window's keys\n",
    "      gather(F, X4, T, c, d, ld);  // the window's values\n",
    "      cl_combine(F, X0, false, hs->rw, T, c, d, ld);\n",
    "      gather(F, X4, T, c, d, ld);  // the window's values again\n",
    "      gather(F, X3, T, c, d, ld);  // the window's keys again\n",
    "      cl_combine(F, X5, true, hs->rw, T, c, d, ld);\n")]
_CL_WARPS8 = [
    ("constexpr int kWideThreads = kBf16 ? 384 : kMaxThreads;",
     "constexpr int kWideThreads = kBf16 ? 384 : 256;"),
    ("constexpr int kWideRowsPerThread = kBf16 ? 3 : 2;",
     "constexpr int kWideRowsPerThread = 3;"),
]
FORMS = {
    "workspace": ("constexpr int kWideThreads = 256;    // BWD_WIDE_THREADS: the wide form's block, "
                  "255 registers\n", {
        "one_slice": [("  float* X0 = WIDE ? work + blockIdx.x * wide_work_floats(rows, ld, Ts)\n",
                       "  float* X0 = WIDE ? work + 0 * wide_work_floats(rows, ld, Ts)  // one slice\n")],
        "no_wload": _NO_WLOAD,
        "no_attn_bwd": [(k2b_ablation._STAGED_ATTN, "      // no attention backward\n")],
        "stamps": [(_STAMP_AT, _STAMPS + _STAMP_AT), *_WS_STAMPS],
    }),
    "cluster": ("constexpr int kClusterMax = 4;       // the wide form's largest cluster "
                "(BWD_CLUSTERS)\n", {
        "no_wload": _NO_WLOAD,
        "no_attn": [(_CL_FWD_ATTN, "      // no attention forward\n"),
                    (_CL_BWD_ATTN, "      // no attention backward\n")],
        "no_dsmem": _CL_DSMEM,
        "warps8": _CL_WARPS8,
        "stamps": [(_STAMP_AT, _STAMPS + _STAMP_AT)],
    }),
}
# the workspace form's C entry: (weights, masks, ids, g, saved, dx, partial,
# grad, work, B, T, d, threads, smem, ctas, stream)
_WS_ARGS = [_build.EncoderWeights, _build.DropoutMasks] + [ctypes.c_void_p] * 7 \
    + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def variants(source: str) -> dict[str, str]:
    return ablation.variants(source, FORMS, "sasrec_encoder_bwd_kernel")


def form_of(text: str) -> str:
    return next(name for name, (marker, _) in FORMS.items() if text.count(marker) == 1)


def inputs(dev, d, t, seed=0):
    """Random weights (2 blocks, biases and LayerNorms moved off their init
    values), full windows of ``t`` items at width ``d``, dropout masks, a
    cotangent (zero for users near a ReLU kink) and the block inputs from
    the plain forward."""
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.ops.sasrec_fused import _block, _input

    model = SASRec(100, 1000, d, maxlen=t)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(g, device=dev)
    for p in params["blocks"] + [params]:
        for name, leaf in p.items():
            for key in ("gamma", "beta", "b"):
                if name != "item_emb" and isinstance(leaf, dict) and key in leaf:
                    leaf[key] += 0.1 * torch.randn(d, generator=g, device=dev)
    seq = torch.randint(1, 1000, (B, t), generator=g, device=dev)
    x, mask = params["item_emb"][seq] * math.sqrt(d), seq != 0
    keep = 1.0 - model.dropout_rate
    masks = model._dropout_masks(g, B, t)
    cot = torch.randn(B, t, d, generator=g, device=dev)
    cot[k2b_ablation.near_kink_users(params, x, mask, masks, keep)] = 0.0
    h = _input(params, x, mask, masks, keep)
    saved = []
    for i, blk in enumerate(params["blocks"]):
        saved.append(h)
        h, _ = _block(blk, h, mask, 1, masks["blocks"][i], keep)
    return dict(params=params, x=x, mask=mask, masks=masks, keep=keep, cot=cot,
                saved=torch.stack([*saved, h]).contiguous())


def caller(lib, x, weight_grads=True):
    """A function that launches the wide form of ``lib`` once on ``x`` in the
    launch layout of its form, returning (dx, flat gradient) or (dx,)
    without ``weight_grads``; None where the build does not take the shape
    (``warps8`` past three rows a thread)."""
    from acf_tpu_torch.ops.sasrec_fused import (
        BWD_GROUP_FLOATS, _bwd_slot, _bwd_wide_layout, _cluster_rows, _dp, _ld, _masks,
        _weights, grad_size,
    )

    b, t, d = x["x"].shape
    nb, dev = len(x["params"]["blocks"]), x["x"].device
    n_grad = grad_size(nb, t, d)
    dx = torch.empty(b, t, d, device=dev)
    flat = torch.empty(n_grad, device=dev) if weight_grads else None
    head = [_weights(x["params"], t, d, dev), _masks(x["masks"], x["keep"], nb, b, t, d, dev),
            x["mask"], x["cot"], x["saved"], dx]
    fn = lib.acf_sasrec_encoder_bwd_wide
    if form_of(lib.text) == "workspace":
        fn.argtypes = _WS_ARGS
        ts, warps = (t + 3) // 4 * 4, 8
        smem = 4 * (BWD_GROUP_FLOATS + 2 * _bwd_slot(d) + warps * ts + t + warps * 2 * d)
        ctas = min(b, lib.acf_sasrec_encoder_bwd_wide_ctas(256, smem))
        work = torch.empty(ctas, t * (7 * _ld(d) + ts), device=dev)
        tail = [work, b, t, d, 256, smem, ctas]
    else:
        cluster, ks, threads, smem = _bwd_wide_layout(t, d)
        if "constexpr int kWideThreads = kBf16 ? 384 : 256;" in lib.text:  # warps8
            if _cluster_rows(t, cluster) > 3 * (256 // (_dp(d) // 4)):
                return None
            smem -= 4 * (threads // 32 - 8) * 2 * d
        fit = lib.acf_sasrec_encoder_bwd_wide_ctas(cluster, smem)
        ctas = min(b, fit // cluster) * cluster
        tail = [b, t, d, cluster, ks, smem, ctas]
    if tail[-1] <= 0:
        raise SystemExit(f"the wide form of this build does not fit at T={t} d={d}")
    partial = torch.empty(tail[-1], n_grad, device=dev) if weight_grads else None
    args = [*head, 0 if partial is None else partial, 0 if flat is None else flat, *tail]
    return ablation.launcher(fn, args, "acf_sasrec_encoder_bwd_wide",
                             (dx, flat) if weight_grads else (dx,))


_INPUTS = {}
_PLAIN_TIMED = set()  # the cases whose plain version one source's extras already time


def plain_once(case, x):
    """{"plain": a call of ``encoder_bwd_math`` on ``x``} the first time a
    case asks (beside the first source's ``as_is``), else {}."""
    from acf_tpu_torch.ops.sasrec_fused import encoder_bwd_math

    if case in _PLAIN_TIMED:
        return {}
    _PLAIN_TIMED.add(case)
    return {"plain": lambda: encoder_bwd_math(x["params"], x["x"], x["mask"], x["masks"],
                                              x["keep"], x["cot"])}


def setup(dev):
    from acf_tpu_torch.ops.sasrec_fused import _flat_leaves, encoder_bwd_math

    cases = {}
    for n, (d, t) in enumerate(CASES):
        x = _INPUTS[d, t] = inputs(dev, d, t, seed=n)
        dx, grads = encoder_bwd_math(x["params"], x["x"], x["mask"], x["masks"], x["keep"],
                                     x["cot"])
        flat = torch.cat([v.flatten() for v in [*_flat_leaves(grads), grads["pos_emb"]]])
        case = f"d={d} T={t}"
        cases[case] = ({"dx": dx, "grad": flat},
                       lambda lib, x=x: caller(lib, x),
                       lambda lib, x=x, case=case: {"dx_only": caller(lib, x, False),
                                                    **plain_once(case, x)})
    return cases


def check(outputs, extras):
    return [("dx-only form gives the full form's dx",
             torch.equal(extras["dx_only"]()[0], outputs[0]))]


def report(libs):
    """Each stamps build's phase split: the share of a CTA's cycles in each
    phase, averaged over the CTAs that ran, and the cycles a CTA."""
    for key, lib in libs.items():
        if not key.endswith(":stamps"):
            continue
        take = lib.acf_stamps_take
        take.argtypes = [ctypes.c_void_p, ctypes.c_int]
        names = PHASES[form_of(lib.text)]
        for (d, t), x in _INPUTS.items():
            call = caller(lib, x)
            counts = torch.zeros(MAX_CTAS, STAMPS, dtype=torch.int64)
            call()
            take(counts.data_ptr(), MAX_CTAS)  # the counts of the second call start at 0
            call()
            if take(counts.data_ptr(), MAX_CTAS) != 0:
                raise SystemExit(f"{key}: reading the stamps failed")
            phases = counts[:, 1:len(names)].double()  # phase 0: the gap before a user
            ran = phases.sum(dim=1) > 0
            share = (phases[ran] / phases[ran].sum(dim=1, keepdim=True)).mean(0)
            print(f"{key} d={d} T={t}: {int(ran.sum())} CTAs; cycles a CTA "
                  f"{float(phases[ran].sum(dim=1).mean()):.4g}; phase shares: "
                  + ", ".join(f"{name} {float(v):.3f}" for name, v in zip(names[1:], share)))


if __name__ == "__main__":
    ablation.run(__doc__, "sasrec_encoder_bwd_kernel", variants, setup, check,
                 source="sasrec_encoder_bwd.cu", prefix="acf_sasrec_encoder_", tol=TOL,
                 shape=f"B={B} nb=2, (d, T) in {CASES}, dropout masks",
                 read=ablation.read_source, report=report)
