"""Where the time of K3b (APL's z pass, ``acf_apl_z`` in ``csrc/apl_gen.cu``)
goes: variants of the kernel with parts of its work taken out, timed side by
side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k3b_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``apl_gen.cu`` (default: this checkout's, as
``head``). ``ablation.run`` builds these variants of each (in the build
directory; nothing in ``csrc/`` changes) and times its ``acf_apl_z`` at
APL's geometry (B = 512, d = 64, I = 23,701) with torch.profiler's device
time, the partials' merge included:

  as_is        the kernel as it is;
  no_store     z is not written (the statistics still are);
  no_loads     the Gumbel noise and ``member`` are not read (constants instead);
  no_traffic   both, which leaves the product and the arithmetic;
  no_math      the noise and ``member`` are read and z written, but z is
               ``logit + noise + member`` (no exp, log or division);
  k3a          ``acf_apl_stats1`` of the as-is build, the same product and
               statistics with no [B, I] traffic at all.

A variant applies where its text substitutions match the source exactly
once; each form of z_kernel that was measured has its own (``FORMS``),
told apart by a line only it has. An earlier kernel is compared by giving
its file, e.g. ``--source 1f1bed5=PATH`` with ``git show
1f1bed5:acf_tpu_torch/csrc/apl_gen.cu`` written to PATH; rounds time the
sources in turns on one card. Each ``as_is`` is checked against
``apl_z_plain`` and for two calls giving the same bits.
"""

from __future__ import annotations

import torch

from acf_tpu_torch.tools import ablation

# (old, new) text substitutions per variant, for each form of z_kernel.
_DIRECT_MIXED = (
    "          const float mixed = mixed_of(probs_of(acc[i][j], item, rm1[i], rl1[i]),\n"
    "                                       member[at], rnu[i], omw, w);\n"
    "          v[j] = __fadd_rn(logf(__fadd_rn(mixed, kEps)), gn[at]) / T;\n")
_STAGED_STAGE = ("    stage_runs(sN + buf * noise_f, gn, kNoiseLd, u0, t * kTile, g);\n"
                 "    stage_runs(sM + buf * kTile * kMemLd, member, kMemLd, u0, t * kTile, g);\n")
_STAGED_STORE = "          z[(size_t)row * g.I + item] = v[j];\n"
_STAGED_CONSTANTS = [("cm[r * kMemLd + mshift[i] + c];", "(uint8_t)(j & 1);"),
                     ("cn[r * kNoiseLd + shift[i] + c];", "0.25f * j;")]
FORMS = {
    # commit 1f1bed5: the noise and member read, z stored, element by element
    "direct": ("          z[at] = v[j];\n", {
        "no_store": [("          z[at] = v[j];\n", "")],
        "no_loads": [("member[at], rnu[i]", "(uint8_t)(j & 1), rnu[i]"),
                     ("gn[at]) / T;", "0.25f * j) / T;")],
        "no_traffic": [("          z[at] = v[j];\n", ""),
                       ("member[at], rnu[i]", "(uint8_t)(j & 1), rnu[i]"),
                       ("gn[at]) / T;", "0.25f * j) / T;")],
        "no_math": [(_DIRECT_MIXED,
                     "          v[j] = __fadd_rn(acc[i][j], gn[at]) + (float)member[at];\n")],
    }),
    # 16-byte noise units, z stored from registers, no division an element
    "staged": (_STAGED_STORE, {
        "no_store": [(_STAGED_STORE, "")],
        "no_loads": [(_STAGED_STAGE, ""), *_STAGED_CONSTANTS],
        "no_traffic": [(_STAGED_STORE, ""), (_STAGED_STAGE, ""), *_STAGED_CONSTANTS],
        # the arithmetic before the store becomes dead code
        "no_math": [(_STAGED_STORE, "          v[j] = __fadd_rn(acc[i][j], noise) + (float)mem;\n"
                     + _STAGED_STORE)],
    }),
}


def variants(source: str) -> dict[str, str]:
    return ablation.variants(source, FORMS, "z_kernel")


def inputs(dev, b, d, num_items, seed=0):
    from acf_tpu_torch.models.apl import gumbel, membership
    from acf_tpu_torch.ops.apl_gen_fused import apl_stats1_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    hist = torch.randint(1, num_items, (b, 12), generator=g, device=dev, dtype=torch.int32)
    hist[:, :2] = 0
    member, nuniq = membership(hist, num_items)
    x = dict(pu=0.4 * torch.randn(b, d, generator=g, device=dev),
             Qg=0.4 * torch.randn(num_items, d, generator=g, device=dev),
             member=member, nuniq=nuniq,
             gn=gumbel(torch.rand(b, num_items, generator=g, device=dev)))
    x["m1"], x["l1"] = apl_stats1_plain(x["pu"], x["Qg"])
    return x


def caller(lib, x, kernel):
    """A function that launches ``kernel`` (z or k3a) of ``lib`` once on
    ``x`` and returns (z, m2, l2)."""
    from acf_tpu_torch.ops.apl_gen_fused import chunks

    (b, d), num_items = x["pu"].shape, x["Qg"].shape[0]
    dev = x["pu"].device
    z = torch.empty(b, num_items, device=dev)
    m2, l2 = torch.empty(b, device=dev), torch.empty(b, device=dev)
    part = torch.empty(2, chunks(num_items), b, device=dev)
    if kernel == "k3a":
        fn, args = lib.acf_apl_stats1, [x["pu"], x["Qg"], m2, l2, part, b, num_items, d]
    else:
        fn, args = lib.acf_apl_z, [x["pu"], x["Qg"], x["member"], x["nuniq"], x["gn"], x["m1"],
                                   x["l1"], z, m2, l2, part, b, num_items, d, 1.0 - ablation.W,
                                   ablation.W, ablation.T]
    return ablation.launcher(fn, args, kernel, (z, m2, l2))


def setup(dev):
    from acf_tpu_torch.ops.apl_gen_fused import apl_z_plain

    x = inputs(dev, *ablation.SHAPE)
    want = apl_z_plain(x["pu"], x["Qg"], x["member"], x["nuniq"], x["gn"], x["m1"], x["l1"],
                       w=ablation.W, temperature=ablation.T)
    return (dict(zip(("z", "m2", "l2"), want)), lambda lib: caller(lib, x, "z"),
            lambda lib: {"k3a": caller(lib, x, "k3a")})


if __name__ == "__main__":
    ablation.run(__doc__, "z_kernel", variants, setup)
