"""Where the time of K3d (APL's <probs, r> pass, ``acf_apl_bigr`` in
``csrc/apl_gen.cu``) goes: variants of the kernel with parts of its work
taken out, timed side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k3d_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``apl_gen.cu`` (default: this checkout's, as
``head``). ``ablation.run`` builds these variants of each (in the build
directory; nothing in ``csrc/`` changes) and times its ``acf_apl_bigr`` at
APL's geometry (B = 512, d = 64, I = 23,701) with torch.profiler's device
time, the partials' merge included:

  as_is        the kernel as it is;
  no_loads     z and ``member`` are not read (constants instead);
  no_math      z and ``member`` are read, but r is ``logit + c + z + member``
               and probs 1 (no exp, no division, no per-row scalar);
  neither      both: the two products, the loop and the merge;
  k3a, k3c     ``acf_apl_stats1`` and ``acf_apl_fake`` of the as-is build:
               one product each, K3c's with its z read.

A variant applies where its text substitutions match the source exactly
once; each form of bigr_kernel that was measured has its own (``FORMS``),
told apart by a line only it has. An earlier kernel is compared by giving
its file, e.g. ``--source 3f2900e=PATH`` with ``git show
3f2900e:acf_tpu_torch/csrc/apl_gen.cu`` written to PATH; rounds time the
sources in turns on one card. Each ``as_is`` is checked against
``apl_bigr_plain`` and for two calls giving the same bits.
"""

from __future__ import annotations

import torch

from acf_tpu_torch.tools import ablation

# (old, new) text substitutions per variant, for each form of bigr_kernel.
_R_OF_MATH = (
    "  probs = probs_of(logit, item, s.m1[i], s.l1[i]);\n"
    "  const float mixed = mixed_of(probs, member[at], s.nu[i], omw, w);\n"
    "  const float sz = expf(z[at] - s.m2[i]) / s.l2[i];\n"
    "  const float t = __fmul_rn(s.a[i], c - s.fake[i]);\n"
    "  r = __fmul_rn(__fmul_rn(coef, sz), t) / __fadd_rn(mixed, kEps);\n")
_STAGED_STAGE = ("    stage_runs(sZ, z, kNoiseLd, u0, i0, g);\n"
                 "    stage_runs(sM, member, kMemLd, u0, i0, g);\n")
_STAGED_CONSTANTS = [("sM[r * kMemLd + mshift + col];", "(uint8_t)(j & 1);"),
                     ("sZ[r * kNoiseLd + shift + col];", "0.25f * j;")]
_STAGED_MATH = (
    "          float probs, rv;\n"
    "          probs_r(lg[i][j], c[i][j], zv, mem, s1, s2, omw, w, coef, probs, rv);\n"
    "          acc_r[i] = fmaf(probs, rv, acc_r[i]);\n")
_STAGED_NO_MATH = "          acc_r[i] += lg[i][j] + c[i][j] + zv + (float)mem;\n"
FORMS = {
    # commits 1f1bed5 and 3f2900e: chunk_loop's two products, r_of reading
    # z and member from device memory inside the epilogue
    "direct": ("  chunk_loop<2>(pu_g, Qg, pu_c, Qc, g,\n", {
        "no_loads": [("member[at], s.nu[i]", "(uint8_t)(item & 1), s.nu[i]"),
                     ("expf(z[at] - s.m2[i])", "expf(0.25f * (item & 3) - s.m2[i])")],
        "no_math": [(_R_OF_MATH, "  probs = 1.f;\n  r = logit + c + z[at] + (float)member[at];\n")],
        "neither": [(_R_OF_MATH, "  probs = 1.f;\n"
                                 "  r = logit + c + 0.25f * (item & 3) + (float)(item & 1);\n")],
    }),
    # z and member staged through shared memory, row scalars in shared memory
    "staged": ("    stage_runs(sZ, z, kNoiseLd, u0, i0, g);\n", {
        "no_loads": [(_STAGED_STAGE, ""), *_STAGED_CONSTANTS],
        "no_math": [(_STAGED_MATH, _STAGED_NO_MATH)],
        "neither": [(_STAGED_STAGE, ""), *_STAGED_CONSTANTS, (_STAGED_MATH, _STAGED_NO_MATH)],
    }),
}
CHAIN = ("pu_g", "Qg", "pu_c", "Qc", "member", "nuniq", "z", "m1", "l1", "m2", "l2", "a",
         "fake")


def variants(source: str) -> dict[str, str]:
    return ablation.variants(source, FORMS, "bigr_kernel")


def inputs(dev, b, d, num_items, seed=0):
    """K3d's inputs: random tables, a membership with duplicates and left
    padding, Gumbel noise, a cotangent ``a``, and the upstream passes' outputs
    from their plain versions."""
    from acf_tpu_torch.models.apl import gumbel, membership
    from acf_tpu_torch.ops import apl_gen_fused as ops

    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: 0.4 * torch.randn(*shape, generator=g, device=dev)
    hist = torch.randint(1, num_items, (b, 12), generator=g, device=dev, dtype=torch.int32)
    hist[:, :2] = 0
    member, nuniq = membership(hist, num_items)
    x = dict(pu_g=f(b, d), Qg=f(num_items, d), pu_c=f(b, d), Qc=f(num_items, d),
             member=member, nuniq=nuniq)
    gn = gumbel(torch.rand(b, num_items, generator=g, device=dev))
    x["m1"], x["l1"] = ops.apl_stats1_plain(x["pu_g"], x["Qg"])
    x["z"], x["m2"], x["l2"] = ops.apl_z_plain(x["pu_g"], x["Qg"], member, nuniq, gn, x["m1"],
                                               x["l1"], w=ablation.W,
                                               temperature=ablation.T)
    x["a"] = f(b)
    x["fake"] = ops.apl_fake_plain(x["pu_c"], x["Qc"], x["z"], x["m2"], x["l2"])
    return x


def caller(lib, x, kernel):
    """A function that launches ``kernel`` (bigr, k3a or k3c) of ``lib`` once
    on ``x`` and returns its outputs (k3a's m1 and l1, the others' one)."""
    from acf_tpu_torch.ops.apl_gen_fused import chunks

    (b, d), num_items = x["pu_g"].shape, x["Qg"].shape[0]
    dev = x["pu_g"].device
    out = torch.empty(b, device=dev)
    out2 = torch.empty(b, device=dev)
    part = torch.empty(2, chunks(num_items), b, device=dev)
    w = ablation.W
    fn, args = {
        "k3a": (lib.acf_apl_stats1, [x["pu_g"], x["Qg"], out, out2, part, b, num_items, d]),
        "k3c": (lib.acf_apl_fake, [x["pu_c"], x["Qc"], x["z"], x["m2"], x["l2"], out, part, b,
                                   num_items, d]),
        "bigr": (lib.acf_apl_bigr, [*(x[k] for k in CHAIN), out, part, b, num_items, d,
                                    1.0 - w, w, (1.0 - w) / ablation.T]),
    }[kernel]
    return ablation.launcher(fn, args, kernel, (out, out2) if kernel == "k3a" else (out,))


def setup(dev):
    from acf_tpu_torch.ops.apl_gen_fused import apl_bigr_plain

    x = inputs(dev, *ablation.SHAPE)
    want = apl_bigr_plain(*(x[k] for k in CHAIN), w=ablation.W, temperature=ablation.T)
    return ({"R": want}, lambda lib: caller(lib, x, "bigr"),
            lambda lib: {k: caller(lib, x, k) for k in ("k3a", "k3c")})


if __name__ == "__main__":
    ablation.run(__doc__, "bigr_kernel", variants, setup)
