"""What the kernel ablation tools (``k3a_ablation`` to ``k3e_ablation``,
``k2b_ablation``) share: variants of one CUDA source made by text
substitution, built in parallel with ``nvcc``, checked against the plain
version and timed in turns on one card.

Each tool gives its ``FORMS``: for each form of its kernel that was
measured, a marker (a line only that form has) and the (old, new)
substitutions of each variant. ``run`` is the command line every tool
shares:

    python -m acf_tpu_torch.tools.<tool> [--source LABEL=PATH ...]
        [--rounds N] [--json PATH]

A tool names its source file (``apl_gen.cu`` by default), the prefix of
the C entries it binds, the tolerance of its checks and the label of the
shapes it times. A source's ``#include "..."`` of a header beside it is
inlined (``read_source``), so a variant builds alone in the build directory.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path

import torch

from acf_tpu_torch.ops import _build

TOL = 1e-4  # chip_smoke.py's APL_TOL, of the output's scale
SHAPE = (512, 64, 23_701)  # APL's B, d and I at Video scale
W, T = 0.2, 0.2  # APL's p_aux and temperature
PROFILER_TRIES = 3  # chip_smoke.py's
APL = dict(source="apl_gen.cu", prefix="acf_apl_", tol=TOL,
           shape=f"B={SHAPE[0]} d={SHAPE[1]} I={SHAPE[2]}")


_LOCAL_INCLUDE = re.compile(r'^#include "([^"]+)"\n', re.MULTILINE)


def read_source(path, seen: set | None = None) -> str:
    """The text of the CUDA source at ``path`` with each ``#include "X"`` of a
    file beside it replaced by that file's text, recursively and each file
    once (names in ``seen`` are already in: their includes are dropped)."""
    src = Path(path)
    seen = set() if seen is None else seen

    def inline(match):
        name = match.group(1)
        if name in seen:
            return ""
        seen.add(name)
        header = src.parent / name
        if not header.exists():
            raise SystemExit(f"{src} includes {name}, which is not beside it")
        return read_source(header, seen)

    return _LOCAL_INCLUDE.sub(inline, src.read_text())


def variants(source: str, forms: dict, kernel: str) -> dict[str, str]:
    """{variant: source text} of every variant of the form ``source`` has
    (the one whose marker it holds exactly once)."""
    for marker, form in forms.values():
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
    raise SystemExit(f"no known form of {kernel} matches this source")


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


def build_all(texts: dict[str, str], kernel: str, prefix: str = "acf_apl_"
              ) -> dict[str, ctypes.CDLL]:
    """One shared library per variant, compiled in parallel, its C entries
    named ``prefix...`` bound; prints the ptxas lines of ``kernel`` for
    each. Each library keeps its source text as ``lib.text``."""
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
        libs[key].text = texts[key]
        for name in (n for n in _build.SIGNATURES if n.startswith(prefix)):
            fn = getattr(libs[key], name, None)  # a unit holds some of the entries
            if fn is None:
                continue
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
    return libs


def launcher(fn, args, name, outputs):
    """A function that calls the C entry ``fn`` once on ``args`` (tensors
    passed as pointers, then the current stream) and returns ``outputs``.
    It reads ``args``, which keeps the scratch tensors among them alive."""
    stream = torch.cuda.current_stream(outputs[0].device).cuda_stream

    def call():
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
        if err != 0:
            raise SystemExit(f"{name} launch failed: cudaError {err}")
        return outputs

    return call


def device_ms(fn, iters=50, warmup=10, only: str | None = None) -> float:
    """Mean device milliseconds per call (torch.profiler): every kernel's, or
    with ``only`` those whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(PROFILER_TRIES):  # CUPTI now and then returns a session with no device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and (only is None or only in e.key))
        if total > 0:
            return total / 1e3 / iters
    raise SystemExit(f"the profiler saw no device time in {PROFILER_TRIES} sessions")


def run(doc: str, kernel: str, variants_of, setup, check=lambda outputs, extras: [], *,
        source: str = APL["source"], prefix: str = APL["prefix"], tol: float | None = APL["tol"],
        shape: str = APL["shape"], read=read_source, cross_check=None, report=None) -> None:
    """The command line of an ablation tool (``doc`` is its docstring).

    Builds every variant (``variants_of(text)``) of every ``--source`` (a
    copy of ``csrc/<source>``; ``read(path)`` gives the text to build),
    printing ``kernel``'s ptxas lines and binding the C entries named
    ``prefix...``. ``setup(dev)`` makes the inputs once and returns
    ``(want, call_of, extras_of)``, or a dict {case label: that} to time
    several shapes: ``want`` maps each output's name to its plain value,
    ``call_of(lib)`` launches the kernel under study once and returns its
    outputs in that order, and ``extras_of(lib)`` gives {label: call} of
    other calls of an as-is build, timed beside it (a call with an ``only``
    attribute is timed by the kernels whose name holds it). Each ``as_is`` must
    agree with ``want`` within ``tol`` of its scale (``tol`` None: the
    difference is printed, and ``check`` judges it), give the same bits on
    two calls and pass ``check(outputs, extras)``, a list of (what, ok);
    the other variants compute something else on purpose. Before any of
    that, ``cross_check(libs)`` (if given) returns (what, ok) pairs over
    every build. ``call_of(lib)`` may return None for a build that does not
    take the case (it is not timed there). Rounds time every call in turn,
    forward then backward; then ``report(libs)``, if given, prints what it
    reads from the builds."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help=f"LABEL=PATH of a copy of {source} (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", type=Path, help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the ablation tools need a CUDA GPU")
    sources = dict(s.split("=", 1) for s in args.source) or {"head": str(_build.CSRC_DIR / source)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    texts = {f"{label}:{name}": text for label, path in sources.items()
             for name, text in variants_of(read(path)).items()}
    libs = build_all(texts, kernel, prefix)
    for what, ok in (cross_check(libs) if cross_check else []):
        print(f"{what}: {ok}")
        if not ok:
            raise SystemExit(f"not {what}")

    cases = setup(torch.device("cuda", 0))
    if not isinstance(cases, dict):
        cases = {"": cases}
    calls = {}
    for case, (want, call_of, extras_of) in cases.items():
        first = None
        for key, lib in libs.items():
            name = f"{case} {key}".strip()
            call = call_of(lib)
            if call is None:
                continue
            calls[name] = call
            if not key.endswith(":as_is"):
                continue
            extras = extras_of(lib)
            got = [t.clone() for t in calls[name]()]
            again = [t.clone() for t in calls[name]()]
            torch.cuda.synchronize()
            for (out, w_), g_ in zip(want.items(), got):
                err, scale = float((g_ - w_).abs().max()), float(w_.abs().max())
                print(f"{name} {out}: max |kernel - plain| {err:.3e} of scale {scale:.4g}")
                if tol is not None and not err <= tol * scale:
                    raise SystemExit(f"{name} {out} disagrees with its plain version")
            for what, ok in [("two calls bit-identical",
                              all(torch.equal(g_, a_) for g_, a_ in zip(got, again))),
                             *check(got, extras)]:
                print(f"{name}: {what}: {ok}")
                if not ok:
                    raise SystemExit(f"{name}: not {what}")
            if first is None:
                first = name, got
            else:
                same = all(torch.equal(g_, f_) for g_, f_ in zip(got, first[1]))
                print(f"{name} and {first[0]}: {', '.join(want)} bit-identical: {same}")
            for label, call in extras.items():
                calls[name.replace(":as_is", f":{label}")] = call
    samples = {key: [] for key in calls}
    order = list(calls)
    for rnd in range(args.rounds):
        for key in (order if rnd % 2 == 0 else order[::-1]):
            samples[key].append(device_ms(calls[key], only=getattr(calls[key], "only", None)))
    print(f"device ms per call at {shape} (torch.profiler, 50 calls a sample, rounds forward "
          f"then backward):")
    width = max(24, *map(len, samples))
    for key, s in samples.items():
        print(f"  {key:{width}s} " + "  ".join(f"{v:.4f}" for v in s)
              + f"   mean {sum(s) / len(s):.4f}")
    result = {"card": card.strip(), "shape": shape, "timer": "profiler", "ms": samples}
    print(json.dumps(result))
    if report is not None:
        report(libs)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
