"""Where the time of K3b (APL's z pass, ``acf_apl_z`` in ``csrc/apl_gen.cu``)
goes: variants of the kernel with parts of its work taken out, timed side by
side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m acf_tpu_torch.tools.k3b_ablation [--source LABEL=PATH ...]

Each ``--source`` is a copy of ``apl_gen.cu`` (default: this checkout's, as
``head``). For each, the script writes these variants into the build
directory (nothing in ``csrc/`` changes), builds each with ``nvcc`` (all at
once) and times its ``acf_apl_z`` at APL's geometry (B = 512, d = 64,
I = 23,701) with torch.profiler's device time, the partials' merge included:

  as_is        the kernel as it is;
  no_store     z is not written (the statistics still are);
  no_loads     the Gumbel noise and ``member`` are not read (constants instead);
  no_traffic   both, which leaves the product and the arithmetic;
  no_math      the noise and ``member`` are read and z written, but z is
               ``logit + noise + member`` (no exp, log or division);
  k3a          ``acf_apl_stats1`` of the as-is build, the same product and
               statistics with no [B, I] traffic at all.

A variant applies where its text substitutions match the source exactly
once; each form of z_kernel that was measured has its own (``FORMS``). An
earlier kernel is compared by giving its file, e.g. ``--source
1f1bed5=PATH`` with ``git show 1f1bed5:acf_tpu_torch/csrc/apl_gen.cu``
written to PATH. Rounds run every variant in turn, forward then backward,
so sources are compared in turns on one card. ``as_is`` is checked against
``apl_z_plain``, and each later ``as_is`` is compared bit for bit with the
first; the other variants compute something else on purpose.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from acf_tpu_torch.ops import _build

# (old, new) text substitutions per variant, for each form of z_kernel.
_DIRECT_MIXED = (
    "          const float mixed = mixed_of(probs_of(acc[i][j], item, rm1[i], rl1[i]),\n"
    "                                       member[at], rnu[i], omw, w);\n"
    "          v[j] = __fadd_rn(logf(__fadd_rn(mixed, kEps)), gn[at]) / T;\n")
_STAGED_STAGE = ("    stage_runs(sN + buf * noise_f, gn, kNoiseLd, u0, t * kTile, g);\n"
                 "    stage_runs(sM + buf * kTile * kMemLd, member, kMemLd, u0, t * kTile, g);\n")
_STAGED_STORE = "          z[(size_t)row * g.I + item] = v[j];\n"
_STAGED_CONSTANTS = [("cm[r * kMemLd + shift[i] + c];", "(uint8_t)(j & 1);"),
                     ("cn[r * kNoiseLd + shift[i] + c];", "0.25f * j;")]
FORMS = {
    # commit 1f1bed5: the noise and member read, z stored, element by element
    "direct": {
        "no_store": [("          z[at] = v[j];\n", "")],
        "no_loads": [("member[at], rnu[i]", "(uint8_t)(j & 1), rnu[i]"),
                     ("gn[at]) / T;", "0.25f * j) / T;")],
        "no_traffic": [("          z[at] = v[j];\n", ""),
                       ("member[at], rnu[i]", "(uint8_t)(j & 1), rnu[i]"),
                       ("gn[at]) / T;", "0.25f * j) / T;")],
        "no_math": [(_DIRECT_MIXED,
                     "          v[j] = __fadd_rn(acc[i][j], gn[at]) + (float)member[at];\n")],
    },
    # 16-byte noise units, z stored from registers, no division an element
    "staged": {
        "no_store": [(_STAGED_STORE, "")],
        "no_loads": [(_STAGED_STAGE, ""), *_STAGED_CONSTANTS],
        "no_traffic": [(_STAGED_STORE, ""), (_STAGED_STAGE, ""), *_STAGED_CONSTANTS],
        # the arithmetic before the store becomes dead code
        "no_math": [(_STAGED_STORE, "          v[j] = __fadd_rn(acc[i][j], noise) + (float)mem;\n"
                     + _STAGED_STORE)],
    },
}
TOL = 1e-4  # chip_smoke.py's APL_TOL, of the output's scale


def variants(source: str) -> dict[str, str]:
    """{variant: source text} of every variant whose substitutions match."""
    out = {"as_is": source}
    for form in FORMS.values():
        if not all(source.count(old) == 1 for subs in form.values() for old, _ in subs):
            continue
        for name, subs in form.items():
            text = source
            for old, new in subs:
                text = text.replace(old, new)
            out[name] = text
        return out
    raise SystemExit("no known form of z_kernel matches this source")


def ptxas_lines(log: str, kernel: str) -> list[str]:
    """``-Xptxas -v``'s lines (registers, spills, shared memory) of one kernel."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            inside = kernel in line
            if "Function properties" not in line:
                continue
        if inside:
            out.append(line.split(":", 1)[-1].strip())
    return out


def build_all(texts: dict[str, str], kernel: str) -> dict[str, ctypes.CDLL]:
    """One shared library per variant, compiled in parallel; prints the
    ptxas lines of ``kernel`` for each."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for key, text in texts.items():
        digest = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + text).encode()).hexdigest()[:16]
        src, lib = out_dir / f"{digest}.cu", out_dir / f"{digest}.so"
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", str(src), "-o", str(lib)]
        jobs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{log}")
        print(f"built {key}: {kernel} " + " | ".join(ptxas_lines(log, kernel)))
        libs[key] = ctypes.CDLL(str(lib))
        for name in (n for n in _build.SIGNATURES if n.startswith("acf_apl_")):
            fn = getattr(libs[key], name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
    return libs


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
    """A function that launches ``kernel`` of ``lib`` once on ``x``."""
    from acf_tpu_torch.ops.apl_gen_fused import chunks

    (b, d), num_items = x["pu"].shape, x["Qg"].shape[0]
    dev = x["pu"].device
    z = torch.empty(b, num_items, device=dev)
    m2, l2 = torch.empty(b, device=dev), torch.empty(b, device=dev)
    part = torch.empty(2, chunks(num_items), b, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "k3a":
        args = [x["pu"], x["Qg"], m2, l2, part, b, num_items, d]
        fn = lib.acf_apl_stats1
    else:
        args = [x["pu"], x["Qg"], x["member"], x["nuniq"], x["gn"], x["m1"], x["l1"], z, m2,
                l2, part, b, num_items, d, 0.8, 0.2, 0.2]
        fn = lib.acf_apl_z

    def call():  # reads `args`, which keeps the scratch `part` alive
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
        if err != 0:
            raise SystemExit(f"{kernel} launch failed: cudaError {err}")
        return z, m2, l2

    return call


def device_ms(fn, iters=50, warmup=10) -> float:
    """Mean device milliseconds per call (torch.profiler, every kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    if total <= 0:
        raise SystemExit("the profiler saw no device time")
    return total / 1e3 / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a copy of apl_gen.cu (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shape", type=int, nargs=3, default=(512, 64, 23_701),
                    metavar=("B", "d", "I"))
    ap.add_argument("--json", type=Path, help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3b_ablation needs a CUDA GPU")
    sources = dict(s.split("=", 1) for s in args.source) or {"head": str(_build.CSRC_DIR /
                                                                         "apl_gen.cu")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    texts = {f"{label}:{name}": text for label, path in sources.items()
             for name, text in variants(Path(path).read_text()).items()}
    libs = build_all(texts, kernel="z_kernel")

    from acf_tpu_torch.ops.apl_gen_fused import apl_z_plain

    dev = torch.device("cuda", 0)
    b, d, num_items = args.shape
    x = inputs(dev, b, d, num_items)
    want = apl_z_plain(x["pu"], x["Qg"], x["member"], x["nuniq"], x["gn"], x["m1"], x["l1"],
                       w=0.2, temperature=0.2)
    calls, first = {}, None
    for key, lib in libs.items():
        calls[key] = caller(lib, x, "z")
        if key.endswith(":as_is"):
            got = calls[key]()
            torch.cuda.synchronize()
            for name, g_, w_ in zip(("z", "m2", "l2"), got, want):
                err, scale = float((g_ - w_).abs().max()), float(w_.abs().max())
                print(f"{key} {name}: max |kernel - plain| {err:.3e} of scale {scale:.4g}")
                if not err <= TOL * scale:
                    raise SystemExit(f"{key} {name} disagrees with apl_z_plain")
            if first is None:
                first = key, got
            else:
                same = all(torch.equal(a, c) for a, c in zip(got, first[1]))
                print(f"{key} and {first[0]}: z, m2, l2 bit-identical: {same}")
            calls[key.replace(":as_is", ":k3a")] = caller(lib, x, "k3a")
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
