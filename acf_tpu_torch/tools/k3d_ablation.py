"""Where the time of K3d (APL's <probs, r> pass, ``acf_apl_bigr`` in
``csrc/apl_gen.cu``) goes: variants of the kernel with parts of its work
taken out, timed side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k3d_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``apl_gen.cu`` (default: this checkout's, as
``head``). For each, the script writes these variants into the build
directory (nothing in ``csrc/`` changes), builds each with ``nvcc`` (all at
once, through ``k3b_ablation.build_all``) and times its ``acf_apl_bigr`` at
APL's geometry (B = 512, d = 64, I = 23,701) with torch.profiler's device
time, the partials' merge included:

  as_is        the kernel as it is;
  no_loads     z and ``member`` are not read (constants instead);
  no_math      z and ``member`` are read, but r is ``logit + c + z + member``
               and probs 1 (no exp, no division, no per-row scalar);
  neither      both: the two products, the loop and the merge;
  k3a, k3c     ``acf_apl_stats1`` and ``acf_apl_fake`` of the as-is build:
               one product each, in the loop K3a and K3c share.

A variant applies where its text substitutions match the source exactly
once; each form of bigr_kernel that was measured has its own (``FORMS``),
told apart by a line only it has. An earlier kernel is compared by giving
its file, e.g. ``--source 3f2900e=PATH`` with ``git show
3f2900e:acf_tpu_torch/csrc/apl_gen.cu`` written to PATH. Rounds run every
variant in turn, forward then backward, so sources are compared in turns on
one card. Each ``as_is`` is checked against ``apl_bigr_plain`` and for two
calls giving the same bits; the other variants compute something else on
purpose.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from acf_tpu_torch.ops import _build
from acf_tpu_torch.tools.k3b_ablation import TOL, build_all, device_ms

# (old, new) text substitutions per variant, for each form of bigr_kernel.
_R_OF_MATH = (
    "  probs = probs_of(logit, item, s.m1[i], s.l1[i]);\n"
    "  const float mixed = mixed_of(probs, member[at], s.nu[i], omw, w);\n"
    "  const float sz = expf(z[at] - s.m2[i]) / s.l2[i];\n"
    "  const float t = __fmul_rn(s.a[i], c - s.fake[i]);\n"
    "  r = __fmul_rn(__fmul_rn(coef, sz), t) / __fadd_rn(mixed, kEps);\n")
_STAGED_STAGE = ("    stage_runs(sZ, z, kNoiseLd, u0, i0, g);\n"
                 "    stage_runs(sM, member, kMemLd, u0, i0, g);\n")
_STAGED_CONSTANTS = [("sM[r * kMemLd + shift + col];", "(uint8_t)(j & 1);"),
                     ("sZ[r * kNoiseLd + shift + col];", "0.25f * j;")]
_STAGED_MATH = (
    "          const float aux = mem == 0   ? 0.f\n"
    "                            : mem == 1 ? s1.z\n"
    "                                       : __fmul_rn(w, (float)mem) / s1.w;\n"
    "          const float probs = __fmul_rn(expf(lg[i][j] - s1.x), s1.y);\n"
    "          const float mixed = __fadd_rn(__fmul_rn(omw, probs), aux);\n"
    "          const float sz = __fmul_rn(expf(zv - s2.x), s2.y);\n"
    "          const float tt = __fmul_rn(s2.z, c[i][j] - s2.w);\n"
    "          const float rv = __fmul_rn(__fmul_rn(coef, sz), tt) / __fadd_rn(mixed, kEps);\n"
    "          acc_r[i] = fmaf(probs, rv, acc_r[i]);\n")
_STAGED_NO_MATH = "          acc_r[i] += lg[i][j] + c[i][j] + zv + (float)mem;\n"
FORMS = {
    # commits 1f1bed5 and 3f2900e: chunk_loop's two products, r_of reading
    # z and member from device memory inside the epilogue (r_of is K3e's too,
    # which these variants do not time)
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
SHAPE = (512, 64, 23_701)
W, T = 0.2, 0.2


def variants(source: str) -> dict[str, str]:
    """{variant: source text} of every variant of the form ``source`` has."""
    for marker, form in FORMS.values():
        if source.count(marker) != 1:
            continue
        out = {"as_is": source}
        for name, subs in form.items():
            text = source
            for old, new in subs:
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: {old!r} does not match exactly once")
                text = text.replace(old, new)
            out[name] = text
        return out
    raise SystemExit("no known form of bigr_kernel matches this source")


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
                                               x["l1"], w=W, temperature=T)
    x["a"] = f(b)
    x["fake"] = ops.apl_fake_plain(x["pu_c"], x["Qc"], x["z"], x["m2"], x["l2"])
    return x


def caller(lib, x, kernel):
    """A function that launches ``kernel`` (bigr, k3a or k3c) of ``lib`` once
    on ``x`` and returns its output."""
    from acf_tpu_torch.ops.apl_gen_fused import chunks

    (b, d), num_items = x["pu_g"].shape, x["Qg"].shape[0]
    dev = x["pu_g"].device
    out = torch.empty(b, device=dev)
    out2 = torch.empty(b, device=dev)
    part = torch.empty(2, chunks(num_items), b, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn, args = {
        "k3a": (lib.acf_apl_stats1, [x["pu_g"], x["Qg"], out, out2, part, b, num_items, d]),
        "k3c": (lib.acf_apl_fake, [x["pu_c"], x["Qc"], x["z"], x["m2"], x["l2"], out, part, b,
                                   num_items, d]),
        "bigr": (lib.acf_apl_bigr, [*(x[k] for k in ("pu_g", "Qg", "pu_c", "Qc", "member",
                                                     "nuniq", "z", "m1", "l1", "m2", "l2", "a",
                                                     "fake")),
                                    out, part, b, num_items, d, 1.0 - W, W, (1.0 - W) / T]),
    }[kernel]

    def call():  # reads `args`, which keeps the scratch `part` alive
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
        if err != 0:
            raise SystemExit(f"{kernel} launch failed: cudaError {err}")
        return out

    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a copy of apl_gen.cu (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shape", type=int, nargs=3, default=SHAPE, metavar=("B", "d", "I"))
    ap.add_argument("--json", type=Path, help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3d_ablation needs a CUDA GPU")
    sources = dict(s.split("=", 1) for s in args.source) or {"head": str(_build.CSRC_DIR /
                                                                         "apl_gen.cu")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    texts = {f"{label}:{name}": text for label, path in sources.items()
             for name, text in variants(Path(path).read_text()).items()}
    libs = build_all(texts, kernel="bigr_kernel")

    from acf_tpu_torch.ops.apl_gen_fused import apl_bigr_plain

    dev = torch.device("cuda", 0)
    b, d, num_items = args.shape
    x = inputs(dev, b, d, num_items)
    want = apl_bigr_plain(*(x[k] for k in ("pu_g", "Qg", "pu_c", "Qc", "member", "nuniq", "z",
                                           "m1", "l1", "m2", "l2", "a", "fake")),
                          w=W, temperature=T)
    scale = float(want.abs().max())
    calls, first = {}, None
    for key, lib in libs.items():
        calls[key] = caller(lib, x, "bigr")
        if key.endswith(":as_is"):
            got = calls[key]().clone()
            again = calls[key]().clone()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            print(f"{key} R: max |kernel - plain| {err:.3e} of scale {scale:.4g}; two calls "
                  f"bit-identical: {torch.equal(got, again)}")
            if not (err <= TOL * scale and torch.equal(got, again)):
                raise SystemExit(f"{key}: R disagrees with apl_bigr_plain or between calls")
            if first is None:
                first = key, got
            else:
                print(f"{key} and {first[0]}: R bit-identical: {torch.equal(got, first[1])}")
            for kernel in ("k3a", "k3c"):
                calls[key.replace(":as_is", f":{kernel}")] = caller(lib, x, kernel)
    samples = {key: [] for key in calls}
    order = list(calls)
    for rnd in range(args.rounds):
        for key in (order if rnd % 2 == 0 else order[::-1]):
            samples[key].append(device_ms(calls[key]))
    print(f"device ms per call at B={b} d={d} I={num_items} (torch.profiler, 50 calls a "
          f"sample, rounds forward then backward):")
    for key, s in samples.items():
        print(f"  {key:24s} " + "  ".join(f"{v:.4f}" for v in s)
              + f"   mean {sum(s) / len(s):.4f}")
    result = {"card": card.strip(), "shape": [b, d, num_items], "timer": "profiler",
              "ms": samples}
    print(json.dumps(result))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
