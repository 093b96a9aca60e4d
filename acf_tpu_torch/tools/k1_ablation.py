"""Where the time of K1 (the full-catalog rank counter, ``acf_rank_count`` in
``csrc/rank_count.cu``) goes: variants of the kernel with one design choice
swapped, timed side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k1_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``rank_count.cu`` (default: this checkout's, as
``head``), with the headers it includes beside it. ``ablation.run`` builds
these variants of each (in the build directory; nothing in ``csrc/``
changes) and times the kernel alone (torch.profiler's device time of
``rank_count_kernel``) at B = 512, d = 64, with a bias and the gt masked, at
I = 23,701 (MF-BPR's evaluation tile at Video scale) and I = 3,707 (SASRec's
maxlen-50 evaluation at the ml-1m shape). Each variant of the flat form (the
redesign) changes one of its "ablation" constants or the code of one design
choice:

  as_is           the kernel as it is: 128 x 256 units (8 x 16 a thread, one
                  block an SM) at I = 23,701, 128 x 128 (8 x 8, two blocks an
                  SM) at I = 3,707;
  narrow_only     128 x 128 units at every shape;
  wide_only       128 x 256 units at every shape;
  tile4x4         4 x 4 register tiles, 64 x 64 units (the split form's tile);
  items64         8 x 4 register tiles, 128 x 64 units: a quarter of a wide
                  unit's items, and so of its work between barriers;
  slice16         16 k a ring slot, not 32;
  stages3         three ring slots, two slices ahead, not two;
  bias_ldg        the bias read from device memory in the epilogue, not staged;
  split_grid      a grid of user tiles x item splits (as many blocks as are
                  resident), each block walking the item tiles of its split, as
                  the split form does, not a flat list;
  users_resident  the user tile loaded whole (a box a slice) when a block
                  starts a user tile, the items alone streaming with k (its
                  shared memory grows with d: checked up to d = 128);
  unroll2         the k loop unrolled twice (the narrow shape spills);
and, with work taken out (their counts are wrong, and not checked):
  no_copies       no boxes into the ring (the product reads stale slots);
  no_bload        no item reads: each item float4 is a user float4 already read;
  no_epilogue     no compares: the sums are added up as integers.

The split form (commit 950a8bf and before: 64 x 64 tiles, 4 x 4 a thread,
the user tile resident, item tiles through two buffers and two barriers, the
bias read in the epilogue, a grid of user tiles x item splits) is timed by
giving its file, e.g. ``--source 950a8bf=DIR/rank_count.cu`` with ``git show
950a8bf:acf_tpu_torch/csrc/rank_count.cu`` written to DIR.

Every variant but those three keeps each dot product's FMA chain over k in
order, so before any timing every such build (each form, each variant) must
give the same counts
as the first ``--source``'s as-is build, bit for bit, on every case of
``K1_SHAPES`` with and without bias and gt, and that build's counts must
equal the plain version's but for users off by 1 at a near tie (a score
within 1e-5 of the threshold), as ``chip_smoke.py`` holds K1.
"""

from __future__ import annotations

import torch

from acf_tpu_torch.tools import ablation

B, D, ITEMS = 512, 64, (23_701, 3_707)
# (B, I, d) of the cases K1 is checked on (here and in chip_smoke.py): the
# evaluation's tiles, one user, ragged user tiles (127, 129, 513 against 128
# a unit), ragged item tiles (2, 129 against 128, 23,700 and 40,000 against
# 256), the narrowest width, the widest the split form took (256) and beyond
# it (260: k slices of 32, 32, ..., 4). The cases with at least as many
# 128 x 256 units as SMs take them (I = 23,700 and 40,000), the rest 128 x 128.
K1_SHAPES = ((8, 300, D), (8, 23_700, D), (512, 300, D), (512, 23_700, D),
             (100, 1_000, 8), (100, 1_000, 36), (513, 3_707, D),
             (1, 2, 4), (1, 129, 256), (127, 2, 260), (127, 129, 128),
             (129, 2, 128), (129, 129, 4), (513, 2, 256), (513, 129, 260),
             (513, 23_700, 36), (129, 40_000, 260))

# (old, new) text substitutions of each variant of the flat form: one of its
# "ablation" constants, or the code of one design choice.
_NARROW_ONLY = ("wide_units >= sms ? launch<Wide>", "false ? launch<Wide>")
_FLAT = {
    "narrow_only": [_NARROW_ONLY],
    "wide_only": [("wide_units >= sms ? launch<Wide>", "true ? launch<Wide>")],
    "tile4x4": [("constexpr int kRU = 8;", "constexpr int kRU = 4;"),
                ("using Narrow = Shape<8, 2>;", "using Narrow = Shape<4, 2>;"), _NARROW_ONLY],
    "items64": [("using Narrow = Shape<8, 2>;", "using Narrow = Shape<4, 2>;"), _NARROW_ONLY],
    "slice16": [("constexpr int kSliceK = 32;", "constexpr int kSliceK = 16;")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "bias_ldg": [
        ("      valid = a.bias != nullptr && item < a.I;\n",
         "      valid = false;  // the bias is read in the epilogue\n"),
        ("        const float bj = x[tx + 16 * j];\n",
         "        const float bj = a.bias != nullptr ? __ldg(a.bias + item) : 0.f;\n")],
    "split_grid": [
        ("  const int first = static_cast<int>(static_cast<long long>(blockIdx.x) * a.n_units / "
         "gridDim.x);\n"
         "  const int end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * a.n_units / "
         "gridDim.x);\n"
         "  return {first, 1, end - first};\n",
         "  const int splits = gridDim.x / (a.n_units / a.n_item_tiles);  // user tiles x splits\n"
         "  const int y = blockIdx.x % splits;\n"
         "  return {static_cast<int>(blockIdx.x / splits) * a.n_item_tiles + y, splits,\n"
         "          (a.n_item_tiles - y + splits - 1) / splits};\n"),
        ("  const int rounds = (a.n_units + slots - 1) / slots;  // units the longest run takes\n"
         "  const int grid = (a.n_units + rounds - 1) / rounds;\n",
         "  const int splits = min((slots + user_tiles - 1) / user_tiles, a.n_item_tiles);\n"
         "  const int grid = user_tiles * splits;\n")],
    "users_resident": [
        ("  static constexpr int kExtra = (kItems + kUsers) * kLdk;\n",
         "  static constexpr int kExtra = kItems * kLdk;  // no user rows in a slot\n"),
        ("  static constexpr unsigned kSlotTx = (kItems + kUsers) * kLdk * 4;  // bytes of its two "
         "boxes\n",
         "  static constexpr unsigned kSlotTx = kItems * kLdk * 4;  // its item box\n"),
        ("    tma_box(slot + S::kItems * kLdk, &tm_u, ks * kSliceK, u0, bar);\n", ""),
        ("    for (int i = 0; i < kStages; ++i) mbar_init(bars + i);\n",
         "    for (int i = 0; i <= kStages; ++i) mbar_init(bars + i);  // and the user tile's\n"),
        ("  int run = 0;  // this lane's user's count over the block's units of its user tile\n",
         "  int run = 0;  // this lane's user's count over the block's units of its user tile\n"
         "  int resident = -1;    // the user tile in shared memory\n"
         "  unsigned loads = 0;  // its loads so far\n"),
        ("    slice_dot<kRI>(acc, cur + (kItems + ty) * kLdk, kLdk, cur + tx * kLdk,\n"
         "                   min(kSliceK, a.d - k0));\n",
         "    float* sU = smem + kStages * S::kSlotFloats + 32;  // after the barriers: a box a slice\n"
         "    if (ut != resident) {  // every thread is past the previous slice\n"
         "      if (threadIdx.x == 0) {\n"
         "        mbar_expect_tx(bars + kStages, a.n_slices * kUsers * kLdk * 4);\n"
         "        for (int q = 0; q < a.n_slices; ++q)\n"
         "          tma_box(sU + q * kUsers * kLdk, &tm_u, q * kSliceK, ut * kUsers, bars + kStages);\n"
         "      }\n"
         "      mbar_wait(bars + kStages, loads++ & 1);\n"
         "      resident = ut;\n"
         "    }\n"
         "    slice_dot<kRI>(acc, sU + (ks * kUsers + ty) * kLdk, kLdk, cur + tx * kLdk,\n"
         "                   min(kSliceK, a.d - k0));\n"),
        ("  const size_t smem = kStages * (S::kSlotFloats * sizeof(float) + sizeof(uint64_t));\n",
         "  const size_t smem = kStages * S::kSlotFloats * sizeof(float) + 128 +\n"
         "                      static_cast<size_t>(a.n_slices) * kUsers * kLdk * sizeof(float);\n")],
    "unroll2": [("#pragma unroll 1\n  for (int k = 0; k < kn; k += 4) {\n",
                 "#pragma unroll 2\n  for (int k = 0; k < kn; k += 4) {\n")],
    # work taken out (the counts change): where the time goes
    "no_copies": [
        ("    mbar_expect_tx(bar, S::kSlotTx);\n"
         "    tma_box(slot, &tm_e, ks * kSliceK, i0, bar);\n"
         "    tma_box(slot + S::kItems * kLdk, &tm_u, ks * kSliceK, u0, bar);\n",
         "    mbar_expect_tx(bar, 0);  // no copies\n")],
    "no_bload": [("      const float4 b = *reinterpret_cast<const float4*>(sb + 16 * j * kLdk + k);\n",
                  "      const float4 b = a[j % kRU];  // no item reads\n")],
    "no_epilogue": [
        ("        for (int i = 0; i < kRU; ++i) c[i] += (acc[i][j] + bj >= t[i] && item != g[i]) ? 1 : 0;\n",
         "        for (int i = 0; i < kRU; ++i) c[i] += __float_as_int(acc[i][j]);  // no compares\n")],
}
CHANGE_COUNTS = ("no_copies", "no_bload", "no_epilogue")  # not held to the as-is counts
# The widest d a variant's shared memory holds (the whole user tile, a box a
# slice); the cross-check leaves it out of wider cases.
MAX_D = {"users_resident": 128}
FORMS = {
    # commit 950a8bf and before: 64 x 64 tiles, two item buffers, user tiles x item splits
    "split": ("constexpr int kBU = 64;                    // users per block\n", {}),
    # the redesign: 128 x 256 or 128 x 128 units in a flat list, k slices
    # through a ring of two by TMA
    "flat": ("  static constexpr int kSlotFloats = kExtra + kItems + 2 * kUsers;\n", _FLAT),
}


def variants(source: str) -> dict[str, str]:
    return ablation.variants(source, FORMS, "rank_count_kernel")


def near_tie_items(u, E, t, bias, gt, b):
    """Items of user ``b`` whose f32 score lies within 1e-5 of the
    threshold, relative to max(|t|, 1) (items 0 and gt excluded)."""
    s = E @ u[b]
    if bias is not None:
        s = s + bias
    near = (s - t[b]).abs() <= 1e-5 * max(abs(float(t[b])), 1.0)
    near[0] = False
    if gt is not None:
        near[int(gt[b])] = False
    return int(near.sum())


def inputs(g, b, n_items, d, with_bias_gt=True, dev="cuda"):
    """Standard-normal users, items, thresholds (and bias), gt ids in [1, I)."""
    u = torch.randn(b, d, generator=g, device=dev)
    E = torch.randn(n_items, d, generator=g, device=dev)
    t = torch.randn(b, generator=g, device=dev)
    bias = torch.randn(n_items, generator=g, device=dev) if with_bias_gt else None
    gt = (torch.randint(1, n_items, (b,), generator=g, device=dev, dtype=torch.int32)
          if with_bias_gt else None)
    return u, E, t, bias, gt


def caller(lib, x):
    """A function that zeroes the counts and launches ``acf_rank_count`` of
    ``lib`` once on ``x`` (u, E, t, bias, gt); timed by its kernel alone."""
    u, E, t, bias, gt = x
    out = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
    args = [u, E, 0 if bias is None else bias, t, 0 if gt is None else gt, out,
            u.shape[0], E.shape[0], u.shape[1]]
    launch = ablation.launcher(lib.acf_rank_count, args, "acf_rank_count", (out,))

    def call():
        out.zero_()
        return launch()

    call.only = "rank_count_kernel"
    return call


def plain_counts(x):
    """The plain version's counts of ``x`` as int32."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot_plain

    u, E, t, bias, gt = x
    return rank_positions_dot_plain(u, E, t, bias=bias, gt=gt).to(torch.int32)


def near_tie_rule(x, got, plain) -> bool:
    """Counts equal the plain ones but for users off by 1 at a near tie."""
    u, E, t, bias, gt = x
    diff = (got - plain).abs()
    return all(float(diff[row]) <= 1 and near_tie_items(u, E, t, bias, gt, row) > 0
               for row in torch.nonzero(diff > 0).flatten().tolist())


def cross_check(libs):
    """Every build against the first as-is build, bit for bit, and that build
    against the plain version, on every ``K1_SHAPES`` case."""
    ref = next(key for key in libs if key.endswith(":as_is"))
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for b, n_items, d in K1_SHAPES:
        for with_bias_gt in (False, True):
            x = inputs(g, b, n_items, d, with_bias_gt)
            counts = {key: caller(lib, x)()[0].clone() for key, lib in libs.items()
                      if key.split(":")[1] not in CHANGE_COUNTS
                      and d <= MAX_D.get(key.split(":")[1], d)}
            plain = plain_counts(x)
            label = f"B={b} I={n_items} d={d} bias+gt={with_bias_gt}"
            off = [key for key, c in counts.items() if not torch.equal(c, counts[ref])]
            out.append((f"{label}: {ref} against the plain version, off by 1 at near ties "
                        f"only ({int((counts[ref] != plain).sum())} users)",
                        near_tie_rule(x, counts[ref], plain)))
            out.append((f"{label}: every build's counts equal {ref}'s"
                        + (f" (not {', '.join(off)})" if off else ""), not off))
    return out


def setup(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    cases = {}
    for n_items in ITEMS:
        u, E, _, bias, gt = inputs(g, B, n_items, D)
        t = ((u * E[gt.long()]).sum(dim=1) + bias[gt.long()]).contiguous()  # the gt's score
        x = (u, E, t, bias, gt)
        want = {"counts": plain_counts(x)}
        cases[f"I={n_items}"] = (want, lambda lib, x=x: caller(lib, x),
                                 lambda lib, u=u, E=E: {"matmul": lambda: torch.matmul(u, E.T)})
    return cases


if __name__ == "__main__":
    ablation.run(__doc__, "rank_count_kernel", variants, setup, source="rank_count.cu",
                 prefix="acf_rank_count", tol=None, cross_check=cross_check,
                 shape=f"B={B} d={D} I in {ITEMS}, bias and gt")
