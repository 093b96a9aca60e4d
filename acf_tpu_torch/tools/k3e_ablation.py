"""Where the time of K3e (APL's generator gradient pass, ``acf_apl_grad`` in
``csrc/apl_gen.cu``) goes: variants of the kernel with parts of its work
taken out, timed side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k3e_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``apl_gen.cu`` (default: this checkout's, as
``head``). ``ablation.run`` builds these variants of each (in the build
directory; nothing in ``csrc/`` changes) and times its ``acf_apl_grad`` at
APL's geometry (B = 512, d = 64, I = 23,701) with torch.profiler's device
time, the dP partials' merge included:

  as_is        the kernel as it is;
  no_loads     z and ``member`` are not read (constants instead);
  no_math      z and ``member`` are read, but dlogits is
               ``logit + c + z + member`` (no exp, no division, no per-row
               scalar);
  neither      both;
  no_grads     the dQ and dP loops are replaced by one store a thread of
               the sum of its dlogits, so the products, the epilogue and the
               staging stay and the two gradient products go;
  k3d          ``acf_apl_bigr`` of the as-is build: the same two products
               and per-element arithmetic in K3d's own loop.

A variant applies where its text substitutions match the source exactly
once; each form of grad_kernel that was measured has its own (``FORMS``),
told apart by a line only it has. An earlier kernel is compared by giving
its file, e.g. ``--source c4f09ae=PATH`` with ``git show
c4f09ae:acf_tpu_torch/csrc/apl_gen.cu`` written to PATH; rounds time the
sources in turns on one card. Each ``as_is`` is checked against
``apl_grad_plain``, for two calls giving the same bits and for a zero pad
row of dQ.
"""

from __future__ import annotations

import math

import torch

from acf_tpu_torch.tools import ablation, k3d_ablation

# (old, new) text substitutions per variant, for each form of grad_kernel.
_DIRECT_CALL = (
    "            float probs, r;\n"
    "            r_of(lg[i][j], c[i][j], item, (size_t)row * g.I + item, i, s, member, z, omw,\n"
    "                 w, coef, probs, r);\n"
    "            dl = __fmul_rn(probs, r - rR[i]);\n")
_DIRECT_GRADS = (
    "    // dQ[item] += sum_u dlogits[u][item] P_g[u]: items ty + 16i, columns tx + 16j\n"
    "#pragma unroll 4\n"
    "    for (int u = 0; u < kTile; ++u) {\n"
    "      float dv[kSub];\n"
    "#pragma unroll\n"
    "      for (int i = 0; i < kSub; ++i) dv[i] = sD[u * kLdD + ty + kLanes * i];\n"
    "#pragma unroll\n"
    "      for (int j = 0; j < kCols; ++j) {\n"
    "        const int col = tx + kLanes * j;\n"
    "        if (col < g.d) {\n"
    "          const float p = sPg[u * g.ld + col];\n"
    "#pragma unroll\n"
    "          for (int i = 0; i < kSub; ++i) dq[i][j] = fmaf(dv[i], p, dq[i][j]);\n"
    "        }\n"
    "      }\n"
    "    }\n"
    "\n"
    "    // dP partial of this item tile: users ty + 16i, columns tx + 16j\n"
    "#pragma unroll\n"
    "    for (int j = 0; j < kCols; ++j) {\n"
    "      const int col = tx + kLanes * j;\n"
    "      if (col >= g.d) continue;\n"
    "      float dp[kSub] = {0.f, 0.f, 0.f, 0.f};\n"
    "#pragma unroll 4\n"
    "      for (int it = 0; it < kTile; ++it) {\n"
    "        const float q = sQg[it * g.ld + col];\n"
    "#pragma unroll\n"
    "        for (int i = 0; i < kSub; ++i) dp[i] = fmaf(sD[(ty + kLanes * i) * kLdD + it], q, dp[i]);\n"
    "      }\n"
    "#pragma unroll\n"
    "      for (int i = 0; i < kSub; ++i) {\n"
    "        const int row = u0 + ty + kLanes * i;\n"
    "        if (row < g.B) part_dP[((size_t)blockIdx.x * g.B + row) * g.d + col] = dp[i];\n"
    "      }\n"
    "    }\n")


def _sum_store(target: str) -> str:
    """One store a thread of the sum of the 16 dlogits it wrote to sD, at
    row u0 + ty, column tx of ``target`` (this item tile's partial)."""
    return ("    {  // no dQ or dP: one store a thread of its dlogits' sum\n"
            "      float s_ = 0.f;\n"
            "      for (int i = 0; i < kSub; ++i)\n"
            "        for (int j = 0; j < kSub; ++j) s_ += sD[(ty + kLanes * i) * kLdD + tx + kLanes * j];\n"
            f"      if (u0 + ty < g.B && tx < g.d) {target}[(size_t)(u0 + ty) * g.d + tx] = s_;\n"
            "    }\n")


_STAGED_STAGE = ("    stage_runs(sZe, z, kNoiseLd, u0, i0, g);\n"
                 "    stage_runs(sMe, member, kMemLd, u0, i0, g);\n")
_STAGED_CONSTANTS = [("sMe[r * kMemLd + mshift + col];", "(uint8_t)(j & 1);"),
                     ("sZe[r * kNoiseLd + shift + col];", "0.25f * j;")]
_STAGED_MATH = (
    "          float probs, rv;\n"
    "          probs_r(lg[i][j], c[i][j], zv, mem, s1, s2, omw, w, coef, probs, rv);\n"
    "          dl = __fmul_rn(probs, rv - rR);\n")
_STAGED_NO_MATH = "          dl = lg[i][j] + c[i][j] + zv + (float)mem;\n"
FORMS = {
    # commits 1f1bed5 to c4f09ae: r_of reads z and member from device memory
    # inside the epilogue, the row scalars live in registers
    "direct": ("    RowScalars s;\n", {
        "no_loads": [("member[at], s.nu[i]", "(uint8_t)(item & 1), s.nu[i]"),
                     ("expf(z[at] - s.m2[i])", "expf(0.25f * (item & 3) - s.m2[i])")],
        "no_math": [(_DIRECT_CALL, "            const size_t at = (size_t)row * g.I + item;\n"
                                   "            dl = lg[i][j] + c[i][j] + z[at] + (float)member[at];\n")],
        "neither": [(_DIRECT_CALL, "            dl = lg[i][j] + c[i][j] + 0.25f * (item & 3)"
                                   " + (float)(item & 1);\n")],
        "no_grads": [(_DIRECT_GRADS, _sum_store("(part_dP + (size_t)blockIdx.x * g.B * g.d)"))],
    }),
    # z, member and the row scalars staged through shared memory, the next
    # user tile in flight, register-tiled dQ and dP loops
    "staged": ("    stage_runs(sZe, z, kNoiseLd, u0, i0, g);\n", {
        "no_loads": [(_STAGED_STAGE, ""), *_STAGED_CONSTANTS],
        "no_math": [(_STAGED_MATH, _STAGED_NO_MATH)],
        "neither": [(_STAGED_STAGE, ""), *_STAGED_CONSTANTS, (_STAGED_MATH, _STAGED_NO_MATH)],
        "no_grads": [("      grad_dq<kC>(sD, sPg, g.ld, g.d, ty, tx, dq);\n", ""),
                     ("      grad_dp<kC>(sD, sQg, g.ld, g.d, ty, tx, u0, g.B, part, g.d);\n",
                      _sum_store("part"))],
    }),
}


def variants(source: str) -> dict[str, str]:
    return ablation.variants(source, FORMS, "grad_kernel")


def caller(lib, x):
    """A function that launches ``acf_apl_grad`` of ``lib`` once on ``x``
    (with its ``R``) and returns (dQ, dP)."""
    (b, d), num_items = x["pu_g"].shape, x["Qg"].shape[0]
    dev = x["pu_g"].device
    dQ = torch.empty(num_items, d, device=dev)
    dP = torch.empty(b, d, device=dev)
    part = torch.empty(math.ceil(num_items / 64), b, d, device=dev)
    w = ablation.W
    args = [*(x[k] for k in k3d_ablation.CHAIN), x["R"], dQ, dP, part, b, num_items, d,
            1.0 - w, w, (1.0 - w) / ablation.T]
    return ablation.launcher(lib.acf_apl_grad, args, "acf_apl_grad", (dQ, dP))


def setup(dev):
    from acf_tpu_torch.ops.apl_gen_fused import apl_bigr_plain, apl_grad_plain

    x = k3d_ablation.inputs(dev, *ablation.SHAPE)
    chain = [x[k] for k in k3d_ablation.CHAIN]
    x["R"] = apl_bigr_plain(*chain, w=ablation.W, temperature=ablation.T)
    want = apl_grad_plain(*chain, x["R"], w=ablation.W, temperature=ablation.T)
    return (dict(zip(("dQ", "dP"), want)), lambda lib: caller(lib, x),
            lambda lib: {"k3d": k3d_ablation.caller(lib, x, "bigr")})


if __name__ == "__main__":
    ablation.run(__doc__, "grad_kernel", variants, setup,
                 check=lambda out, _: [("dQ's pad row 0", not out[0][0].any())])
