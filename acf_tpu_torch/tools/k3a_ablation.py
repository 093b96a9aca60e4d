"""Where the time of K3a (APL's softmax-statistics pass, ``acf_apl_stats1``
in ``csrc/apl_gen.cu``) goes: variants of the kernel with parts of its work
taken out, timed side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k3a_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``apl_gen.cu`` (default: this checkout's, as
``head``). ``ablation.run`` builds these variants of each (in the build
directory; nothing in ``csrc/`` changes) and times its ``acf_apl_stats1`` at
APL's geometry (B = 512, d = 64, I = 23,701) with torch.profiler's device
time, the partials' merge (``stat_combine``) included where it runs:

  as_is        the kernel as it is;
  no_merge     the C entry returns before it launches ``stat_combine``;
  no_math      the absorb is a plain sum of the products (no max, no expf,
               no mask; m held at 0, so the merge still does its whole work);
  neither      both: the product and the loop alone;
  k3c          ``acf_apl_fake`` of the as-is build: the same grid and
               product, z staged, and a ``sum_combine``.

A variant applies where its text substitutions match the source exactly
once; each form of stats1_kernel that was measured has its own (``FORMS``),
told apart by a line only it has. An earlier kernel is compared by giving
its file, e.g. ``--source 69f9b76=PATH`` with ``git show
69f9b76:acf_tpu_torch/csrc/apl_gen.cu`` written to PATH; rounds time the
sources in turns on one card. Each ``as_is`` is checked against
``apl_stats1_plain`` and for two calls giving the same bits.
"""

from __future__ import annotations

from acf_tpu_torch.tools import ablation, k3d_ablation

# (old, new) text substitutions per variant, for each form of stats1_kernel.
_NO_MERGE = [("  return (int)combine_stats(part, m1, l1, g, st);\n",
              "  return (int)cudaSuccess;  // no merge\n")]
_PLAIN_SUM = ("    for (int i = 0; i < kSub; ++i) {  // no absorb: a plain sum\n"
              "      m[i] = 0.f;\n"
              "      l[i] += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];\n"
              "    }\n")
_CHUNK_MATH = "    for (int i = 0; i < kSub; ++i) stat_absorb(m[i], l[i], acc[i], live);\n"
_OWN_MATH = (
    "    if (t == 0 || t + 1 == g.n_tiles) {\n"
    "      bool live[kSub];\n"
    "#pragma unroll\n"
    "      for (int j = 0; j < kSub; ++j) {\n"
    "        const int item = t * kTile + tx + kLanes * j;\n"
    "        live[j] = item > 0 && item < g.I;  // the pad id and the ragged tail\n"
    "      }\n"
    "#pragma unroll\n"
    "      for (int i = 0; i < kSub; ++i) stat_absorb<true>(m[i], l[i], acc[i], live);\n"
    "    } else {\n"
    "#pragma unroll\n"
    "      for (int i = 0; i < kSub; ++i) stat_absorb<false>(m[i], l[i], acc[i]);\n"
    "    }\n")
FORMS = {
    # commits 1f1bed5 to 69f9b76: chunk_loop's product, an absorb that
    # rescales every 4 values and masks every tile, a one-thread-a-row merge
    "chunk": ("  chunk_loop(pu, Qg, g, [&]", {
        "no_merge": _NO_MERGE,
        "no_math": [(_CHUNK_MATH, _PLAIN_SUM)],
        "neither": [*_NO_MERGE, (_CHUNK_MATH, _PLAIN_SUM)],
    }),
    # a loop of its own, a rescale only when the max grows, masks on the
    # catalog's edge tiles alone, merges spread over many threads
    "own_loop": ("      for (int i = 0; i < kSub; ++i) stat_absorb<false>(m[i], l[i], acc[i]);\n", {
        "no_merge": _NO_MERGE,
        "no_math": [(_OWN_MATH, "#pragma unroll\n" + _PLAIN_SUM)],
        "neither": [*_NO_MERGE, (_OWN_MATH, "#pragma unroll\n" + _PLAIN_SUM)],
    }),
}


def variants(source: str) -> dict[str, str]:
    return ablation.variants(source, FORMS, "stats1_kernel")


def setup(dev):
    x = k3d_ablation.inputs(dev, *ablation.SHAPE)
    return ({"m1": x["m1"], "l1": x["l1"]}, lambda lib: k3d_ablation.caller(lib, x, "k3a"),
            lambda lib: {"k3c": k3d_ablation.caller(lib, x, "k3c")})


if __name__ == "__main__":
    ablation.run(__doc__, "stats1_kernel", variants, setup)
