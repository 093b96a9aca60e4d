"""Where the time of K3c (APL's fake pass, ``acf_apl_fake`` in
``csrc/apl_gen.cu``) goes: variants of the kernel with parts of its work
taken out, timed side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k3c_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``apl_gen.cu`` (default: this checkout's, as
``head``). ``ablation.run`` builds these variants of each (in the build
directory; nothing in ``csrc/`` changes) and times its ``acf_apl_fake`` at
APL's geometry (B = 512, d = 64, I = 23,701) with torch.profiler's device
time, the partials' merge included:

  as_is        the kernel as it is;
  no_loads     z is not read (a constant instead);
  no_math      z is read, but fake sums ``c + z`` (no exp, no scaling, no
               per-row scalar);
  neither      both: the product, the loop and the merge;
  k3a          ``acf_apl_stats1`` of the as-is build: the same grid and
               product with no [B, I] traffic.

A variant applies where its text substitutions match the source exactly
once; each form of fake_kernel that was measured has its own (``FORMS``),
told apart by a line only it has. An earlier kernel is compared by giving
its file, e.g. ``--source 71a986b=PATH`` with ``git show
71a986b:acf_tpu_torch/csrc/apl_gen.cu`` written to PATH; rounds time the
sources in turns on one card. Each ``as_is`` is checked against
``apl_fake_plain`` and for two calls giving the same bits.
"""

from __future__ import annotations

from acf_tpu_torch.tools import ablation, k3d_ablation

# (old, new) text substitutions per variant, for each form of fake_kernel.
_DIRECT_MATH = ("          const float s = expf(z[(size_t)row * g.I + item] - rm2[i]) / rl2[i];\n"
                "          f[i] = fmaf(s, acc[i][j], f[i]);\n")
_STAGED_STAGE = "    stage_runs(sZc + buf * zc_f, z, kNoiseLd, u0, t * kTile, g);\n"
_STAGED_CONSTANT = ("cz[r * kNoiseLd + shift[i] + c];", "0.25f * j;")
_STAGED_MATH = ("          const float s = __fmul_rn(expf(zv - rm2[i]), il2[i]);\n"
                "          f[i] = fmaf(s, acc[i][j], f[i]);\n")
_STAGED_NO_MATH = "          f[i] += acc[i][j] + zv;\n"
FORMS = {
    # commits 1f1bed5 to 71a986b: chunk_loop's product, z read from device
    # memory inside the epilogue, one division an element
    "direct": ("          const float s = expf(z[(size_t)row * g.I + item] - rm2[i]) / rl2[i];\n", {
        "no_loads": [("expf(z[(size_t)row * g.I + item] - rm2[i])", "expf(0.25f * j - rm2[i])")],
        "no_math": [(_DIRECT_MATH, "          f[i] += acc[i][j] + z[(size_t)row * g.I + item];\n")],
        "neither": [(_DIRECT_MATH, "          f[i] += acc[i][j] + 0.25f * j;\n")],
    }),
    # z staged through shared memory behind the product, a per-row 1/l2
    "staged": (_STAGED_STAGE, {
        "no_loads": [(_STAGED_STAGE, ""), _STAGED_CONSTANT],
        "no_math": [(_STAGED_MATH, _STAGED_NO_MATH)],
        "neither": [(_STAGED_STAGE, ""), _STAGED_CONSTANT, (_STAGED_MATH, _STAGED_NO_MATH)],
    }),
}


def variants(source: str) -> dict[str, str]:
    return ablation.variants(source, FORMS, "fake_kernel")


def setup(dev):
    x = k3d_ablation.inputs(dev, *ablation.SHAPE)
    return ({"fake": x["fake"]}, lambda lib: k3d_ablation.caller(lib, x, "k3c"),
            lambda lib: {"k3a": k3d_ablation.caller(lib, x, "k3a")})


if __name__ == "__main__":
    ablation.run(__doc__, "fake_kernel", variants, setup)
