"""Whether K3a–K3e (``csrc/apl_gen.cu``) give the same bits as another
checkout's: both libraries run the same inputs through this checkout's
wrappers, and every output of the five passes and their merges (m1, l1, z,
m2, l2, fake, R, dQ, dP) must be equal bit for bit. A change that must
leave the aligned path as it was (a new form beside it, a refactor) is held
to that here; then each pass is timed on both libraries in turns.

Run on a machine with a CUDA card, from the repo root, with the other
checkout's kernel source unpacked somewhere, e.g.::

    mkdir -p parent && git archive HEAD~1 acf_tpu_torch/csrc/apl_gen.cu \\
        acf_tpu_torch/csrc/cp_async.cuh | tar -x -C parent
    python -m acf_tpu_torch.tools.k3_identity parent/acf_tpu_torch/csrc

Cases: B = 512, I = 23,701 (APL's geometry at Video scale) at d = 64, 36
and 128, the widths the kernels took before any width did. Prints a line a
case, then each pass's device time a launch (its merge included) on each
library, in the order other, this, this, other; exits non-zero at the first
difference.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from acf_tpu_torch.ops import _build, apl_gen_fused

CASES = (64, 36, 128)  # d
B, I = 512, 23_701
# each pass's kernels, as a profile names them: the pass and its merge
PASS_KERNELS = {"apl_stats1": ("stats1_kernel", "stat_combine"),
                "apl_z": ("z_kernel", "stat_combine"),
                "apl_fake": ("fake_kernel", "sum_combine"),
                "apl_bigr": ("bigr_kernel", "sum_combine"),
                "apl_grad": ("grad_kernel", "sum_combine")}
W, T = 0.2, 0.2


def inputs(dev, d, seed):
    """One generator step's inputs: tables with logits of a few units,
    12-entry histories with duplicates and left padding, user 0 with no
    positives, Gumbel noise and a cotangent ``a``."""
    from acf_tpu_torch.models.apl import gumbel, membership

    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: 0.4 * torch.randn(*shape, generator=g, device=dev)
    hist = torch.randint(1, I, (B, 12), generator=g, device=dev, dtype=torch.int32)
    hist[:, :3] = hist[:, 3:6].clone()
    hist[:, :2] = 0
    hist[0] = 0
    member, nuniq = membership(hist, I)
    return dict(pu_g=f(B, d), Qg=f(I, d), pu_c=f(B, d), Qc=f(I, d), member=member, nuniq=nuniq,
                gnoise=gumbel(torch.rand(B, I, generator=g, device=dev)), a=f(B))


def run_pass(name, x, up):
    """One pass through its wrapper on ``x`` and the outputs ``up`` of the
    passes before it; its outputs as a tuple."""
    ops = apl_gen_fused
    wt = dict(w=W, temperature=T)
    if name == "apl_stats1":
        return ops.apl_stats1(x["pu_g"], x["Qg"])
    m1, l1 = up["apl_stats1"]
    if name == "apl_z":
        return ops.apl_z(x["pu_g"], x["Qg"], x["member"], x["nuniq"], x["gnoise"], m1, l1, **wt)
    z, m2, l2 = up["apl_z"]
    if name == "apl_fake":
        return (ops.apl_fake(x["pu_c"], x["Qc"], z, m2, l2),)
    chain = (x["pu_g"], x["Qg"], x["pu_c"], x["Qc"], x["member"], x["nuniq"], z, m1, l1, m2, l2,
             x["a"], up["apl_fake"][0])
    if name == "apl_bigr":
        return (ops.apl_bigr(*chain, **wt),)
    return ops.apl_grad(*chain, up["apl_bigr"][0], **wt)


def chain(x):
    """K3a–K3e in order, each fed the outputs of the ones before it."""
    out = {}
    for name in PASS_KERNELS:
        out[name] = run_pass(name, x, out)
    torch.cuda.synchronize()
    return out


def pass_ms(name, x, up, iters=20):
    """Device milliseconds a call of pass ``name``: the mean time a launch of
    its kernel and of its merge (torch.profiler), or None where the profiler
    saw neither."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run_pass(name, x, up)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run_pass(name, x, up)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    times = [next((e.self_device_time_total / 1e3 / e.count for e in events if k in e.key), None)
             for k in PASS_KERNELS[name]]
    return None if None in times else sum(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", help="the other checkout's acf_tpu_torch/csrc")
    ap.add_argument("--rounds", type=int, default=2, help="timing rounds (0: none)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_identity needs a CUDA card")
    dev = torch.device("cuda", 0)
    libs = {"this checkout": _build.library(),
            args.csrc: _build.load(_build.build(Path(args.csrc).resolve()))}
    real = apl_gen_fused.library
    try:
        for n, d in enumerate(CASES):
            x = inputs(dev, d, seed=n)
            got = {}
            for label, lib in libs.items():
                apl_gen_fused.library = lambda lib=lib: lib
                got[label] = chain(x)
            mine, theirs = got.values()
            differ = [f"{name}[{i}]" for name in mine
                      for i, (a, b) in enumerate(zip(mine[name], theirs[name]))
                      if not torch.equal(a, b)]
            print(f"K3 d={d} B={B} I={I}: "
                  + ("every output bit-identical" if not differ else f"differ: {differ}"))
            if differ:
                sys.exit(1)
            if d != CASES[0] or args.rounds <= 0:
                continue
            order = [args.csrc, "this checkout", "this checkout", args.csrc] * args.rounds
            times = {label: {name: [] for name in PASS_KERNELS} for label in libs}
            for label in order:
                apl_gen_fused.library = lambda lib=libs[label]: lib
                for name in PASS_KERNELS:
                    times[label][name].append(pass_ms(name, x, mine))
            for label, by_pass in times.items():
                print(f"K3 d={d} device ms a call on {label}: " + ", ".join(
                    f"{name} " + " ".join("n/a" if t is None else f"{t:.4f}" for t in ts)
                    for name, ts in by_pass.items()))
    finally:
        apl_gen_fused.library = real


if __name__ == "__main__":
    main()
