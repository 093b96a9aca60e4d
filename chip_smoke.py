#!/usr/bin/env python3
"""GPU smoke run of the acf_tpu_torch port (PyTorch + hand-written CUDA).

Run from the root of a checkout on a machine with one NVIDIA GPU (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, any failure exits non-zero:

  1. card   — ``nvidia-smi`` name and power limit, torch's device name;
  2. build  — compile every kernel in ``acf_tpu_torch/csrc`` with nvcc;
  3. K1     — the rank-count kernel against its plain PyTorch version on
              standard-normal inputs, B in {8, 512}, I in {300, 23700},
              d = 64 (plus two narrower widths), with and without bias
              and gt;
  4. eval   — MF-BPR (d = 64, random weights from a seed) on a synthetic
              Video-shaped dataset (31k users x 23.7k items, ~300k
              interactions): ``FullRankEvaluator.evaluate_model`` through
              K1, checked against the dense ``positions(score_all)`` path,
              timed; K1 timed alone at the path's shapes;
  5. serve  — ``recommend`` top-10 for every user, checked against a dense
              ``score_all`` + mask + ``torch.topk`` on 256 users, timed.

The last two lines of standard output are a ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``. With no GPU, or when the
``acf_tpu_torch`` package is not beside this script, it fails before
printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, no sparsity, at the 700 W limit)
FP32_FLOPS = 67e12      # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

D = 64                  # MF-BPR width of the headline model
VIDEO_USERS, VIDEO_ITEMS, VIDEO_INTERACTIONS = 31_000, 23_700, 300_000
BATCH_USERS = 512


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def device_events(fn, calls: int = 1):
    """Run ``fn`` ``calls`` times under torch.profiler; return the averaged
    device-side events (kernels, copies, fills) with nonzero device time.
    The CPU ops that launched them, which report the same time again, are
    left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def device_ms(fn, iters: int = 50, warmup: int = 10) -> float:
    """Mean device milliseconds per call of ``fn``: the summed durations of
    the kernels it runs, so host launch gaps between calls do not count."""
    for _ in range(warmup):
        fn()
    total_us = sum(e.self_device_time_total for e in device_events(fn, iters))
    check(total_us > 0, "the profiler saw no device time")
    return total_us / 1e3 / iters


def elapsed_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` launched back to back, between
    two CUDA events: device time plus any wait for the host to enqueue."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def best_wall_s(fn, reps: int = 3) -> float:
    """Best-of-``reps`` host seconds of ``fn`` ending in a synchronize,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


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


K1_SHAPES = ((8, 300, D), (8, 23_700, D), (512, 300, D), (512, 23_700, D),
             (100, 1_000, 8), (100, 1_000, 36))  # (B, I, d)


def check_k1(dev, shapes=K1_SHAPES):
    """K1 against its plain version. Returns the max |count difference|."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot, rank_positions_dot_plain

    g = torch.Generator(device=dev).manual_seed(0)
    before = rank_positions_dot.launches
    max_err = 0.0
    cases = 0
    for b, n_items, d in shapes:
        for with_bias_gt in (False, True):
            u = torch.randn(b, d, generator=g, device=dev)
            E = torch.randn(n_items, d, generator=g, device=dev)
            t = torch.randn(b, generator=g, device=dev)
            bias = (torch.randn(n_items, generator=g, device=dev)
                    if with_bias_gt else None)
            gt = (torch.randint(1, n_items, (b,), generator=g, device=dev,
                                dtype=torch.int32) if with_bias_gt else None)
            got = rank_positions_dot(u, E, t, bias=bias, gt=gt)
            ref = rank_positions_dot_plain(u, E, t, bias=bias, gt=gt)
            diff = (got - ref).abs()
            max_err = max(max_err, float(diff.max()))
            differing = torch.nonzero(diff > 0).flatten().tolist()
            for row in differing:
                check(float(diff[row]) <= 1.0,
                      f"K1 B={b} I={n_items}: user {row} off by {float(diff[row])}")
                check(near_tie_items(u, E, t, bias, gt, row) > 0,
                      f"K1 B={b} I={n_items}: user {row} differs with no near tie")
            cases += 1
            print(f"K1 B={b} I={n_items} d={d} bias+gt={with_bias_gt}: "
                  f"{len(differing)} of {b} users differ by 1 at near ties")
    check(rank_positions_dot.launches - before == cases,
          "K1 launch counter did not move once per case")
    return max_err


def make_video_shaped(seed: int = 0, users=VIDEO_USERS, items=VIDEO_ITEMS,
                      n=VIDEO_INTERACTIONS):
    """Synthetic interactions with Video's shape, drawn like the JAX
    package's bench (uniform users and items, chronological rows)."""
    import pandas as pd  # the port's data module reads frames

    from acf_tpu_torch.data import interactions_from_frame

    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "uid": rng.integers(1, users + 1, size=n),
        "iid": rng.integers(1, items + 1, size=n),
        "timestamp": np.arange(n, dtype=np.int64),
    })
    return interactions_from_frame(df, reindex=False, max_hist_len=512)


def run_eval(dev, data, d=D, batch_users=BATCH_USERS):
    """Phase 4 correctness: returns (model, params, evaluator, launches)."""
    from acf_tpu_torch.eval import FullRankEvaluator
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.ops.ranking import rank_positions_dot

    model = MFBPR(data.num_users, data.num_items, d)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0), device=dev)
    ev = FullRankEvaluator(data, batch_users=batch_users, device=dev)
    n_tiles = math.ceil(len(ev.users) / ev.batch_users)

    rank_positions_dot.launches = 0
    res = ev.evaluate_model(model, params)  # the main path
    launches = rank_positions_dot.launches
    check(launches == n_tiles,
          f"evaluate_model launched K1 {launches} times for {n_tiles} user tiles")

    fs = model.factored_scorer()
    pos_f = ev.positions_factored(fs[0], fs[1], params)
    pos_d = ev.positions(model.score_all, params)
    delta = np.abs(pos_f.astype(np.int64) - pos_d)
    exact = float((delta == 0).mean())
    print(f"eval: {len(ev.users)} users, {n_tiles} tiles, K1 launches {launches}; "
          f"factored vs dense positions: max |d| {int(delta.max())}, "
          f"{exact:.6f} exact")
    check(int(delta.max()) <= 2, "factored and dense positions differ by more than 2")
    check(exact >= 0.99, "fewer than 99% of users have exact positions")
    dense = ev.evaluate(model.score_all, params)
    for name, a, b in zip(("HR@10", "NDCG@10", "AUC"), res.at_k(10), dense.at_k(10)):
        check(abs(a - b) <= 1e-3, f"{name} factored {a} vs dense {b}")
        check(math.isfinite(a), f"{name} is not finite")
    hr, ndcg, auc = res.at_k(10)
    print(f"eval metrics (random init): HR@10 {hr:.6f}  NDCG@10 {ndcg:.6f}  "
          f"AUC {auc:.6f}")
    check(res.hr.shape == (len(ev.users), ev.K) and res.auc.shape == (len(ev.users),),
          "EvalResult has the wrong shape")
    return model, params, ev, launches


def check_serving(dev, model, params, data, k=10, batch_users=BATCH_USERS,
                  n_check=256):
    """Phase 5 correctness: recommend() against a dense top-k."""
    from acf_tpu_torch.ops.topk import NEG, recommend

    users = np.arange(1, data.num_users, dtype=np.int32)
    sc, it = recommend(model, params, data, users, k=k, batch_users=batch_users,
                       device=dev)
    check(sc.shape == (len(users), k) and it.shape == (len(users), k),
          "recommend returned the wrong shape")
    check(np.isfinite(sc).all() and (sc > NEG).all(), "recommend scores not finite")
    hist = data.hist[users]
    check(not (it[:, :, None] == hist[:, None, :]).any(), "a train item was recommended")
    check((it > 0).all() and (it < data.num_items).all(), "item id out of range")

    rows = np.random.default_rng(1).choice(len(users), size=n_check, replace=False)
    ub = torch.as_tensor(users[rows], device=dev)
    hb = torch.as_tensor(hist[rows], device=dev)
    scores = model.score_all(params, ub, hb)
    scores[:, 0] = NEG
    scores[torch.arange(n_check, device=dev)[:, None], hb.long()] = NEG
    ref_s, ref_i = torch.topk(scores, k + 1, dim=1)
    ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
    got_s, got_i = sc[rows], it[rows]
    np.testing.assert_allclose(got_s, ref_s[:, :k], rtol=1e-5, atol=1e-9)
    ties = 0
    for r in range(n_check):
        tol = 1e-6 * float(np.abs(ref_s[r]).max())
        for j in np.nonzero(got_i[r] != ref_i[r, :k])[0]:
            neighbours = [ref_s[r, j - 1]] if j > 0 else []
            neighbours.append(ref_s[r, j + 1])
            check(min(abs(ref_s[r, j] - x) for x in neighbours) <= tol,
                  f"serving user {users[rows[r]]} slot {j}: item "
                  f"{got_i[r, j]} vs {ref_i[r, j]} without a tie")
            ties += 1
    print(f"serve: {len(users)} users, top-{k}; {n_check} checked against dense "
          f"top-k, {ties} slots differ only at ties")
    return users


def k1_timing(dev, model, params, ev):
    """K1 alone at the main path's shapes (one user tile of the Video-shaped
    evaluation), beside its plain version and one torch.matmul of the same
    product. Returns the kernel's entry for the kernels line (without
    launches and max_abs_err)."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot, rank_positions_dot_plain

    users = ev._users_d[:ev.batch_users]
    gt = ev._gt_d[:ev.batch_users].contiguous()
    reprs = params["P"][users].contiguous()
    table = params["Q"]
    t = (reprs * table[gt.long()]).sum(dim=1).contiguous()
    b, d = reprs.shape
    n_items = table.shape[0]
    ms = device_ms(lambda: rank_positions_dot(reprs, table, t, gt=gt))
    plain_ms = device_ms(lambda: rank_positions_dot_plain(reprs, table, t, gt=gt))
    library_ms = device_ms(lambda: torch.matmul(reprs, table.T))
    back_to_back_ms = elapsed_ms(lambda: rank_positions_dot(reprs, table, t, gt=gt))
    flops = 2.0 * b * n_items * d
    nbytes = 4.0 * (b * d + n_items * d + 3 * b)  # u, E, t, gt in; counts out
    bound_s = max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
    bound_by = "operations" if flops / FP32_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
    print(f"K1 device time at B={b} I={n_items} d={d}: kernel {ms:.4f} ms "
          f"({flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"torch.matmul of the product {library_ms:.4f} ms, bound "
          f"{bound_s * 1e3:.4f} ms ({bound_by}); K1 wrapper back to back "
          f"{back_to_back_ms:.4f} ms per call (CUDA events)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": library_ms}


def device_breakdown(label, fn, wall_s, top=6):
    """One call of ``fn`` under torch.profiler: the device's busy time against
    the unprofiled wall time ``wall_s``, and the largest device consumers."""
    events = device_events(fn)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        print(f"{label}: the profiler saw no device time (idle share not measured)")
        return
    print(f"{label}: device busy {busy_ms:.4f} ms of {wall_s * 1e3:.4f} ms wall, "
          f"idle share {1.0 - busy_ms / (wall_s * 1e3):.4f}; largest:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms {e.count:6d} x {e.key[:100]}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    if not (ROOT / "acf_tpu_torch" / "csrc").is_dir():
        fail(f"the acf_tpu_torch package is not beside {Path(__file__).name}")
    import acf_tpu_torch
    from acf_tpu_torch.ops import _build
    from acf_tpu_torch.ops.ranking import rank_positions_dot

    check(Path(acf_tpu_torch.__file__).resolve().parent == ROOT / "acf_tpu_torch",
          f"acf_tpu_torch imported from {acf_tpu_torch.__file__}, not this checkout")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} ready in {time.perf_counter() - t0:.2f} s")
    log = _build.BUILD_DIR / "build.log"
    if log.exists():
        print(log.read_text().strip())

    # 3. K1 against its plain version
    max_err = check_k1(dev)

    # 4. the slice at full width: full-catalog evaluation
    t0 = time.perf_counter()
    data = make_video_shaped()
    print(f"data: {data.num_users} users x {data.num_items} items, "
          f"{data.num_pairs} train pairs, built in {time.perf_counter() - t0:.2f} s")
    model, params, ev, launches = run_eval(dev, data)
    eval_s = best_wall_s(lambda: ev.evaluate_model(model, params))
    print(f"eval: evaluate_model best of 3 {eval_s:.4f} s for {len(ev.users)} users")
    fs = model.factored_scorer()
    pos_s = best_wall_s(lambda: ev.positions_factored(fs[0], fs[1], params))
    print(f"eval: of which positions_factored (device tiles + one transfer) "
          f"{pos_s:.4f} s, host metrics and the rest {eval_s - pos_s:.4f} s")
    device_breakdown("eval", lambda: ev.evaluate_model(model, params), eval_s)
    entry = k1_timing(dev, model, params, ev)

    # 5. serving
    users = check_serving(dev, model, params, data)
    from acf_tpu_torch.ops.topk import recommend
    serve_s = best_wall_s(lambda: recommend(model, params, data, users, k=10,
                                            batch_users=BATCH_USERS, device=dev))
    print(f"serve: recommend best of 3 {serve_s:.4f} s, "
          f"{len(users) / serve_s:.1f} users/s")
    device_breakdown("serve", lambda: recommend(model, params, data, users, k=10,
                                                batch_users=BATCH_USERS, device=dev),
                     serve_s)

    kernels = [{
        "name": "rank_count", "route": "cuda",
        "source": "acf_tpu_torch/csrc/rank_count.cu",
        "replaces": "acf_tpu/ops/ranking.py:39",
        "launches": launches, "max_abs_err": max_err, **entry,
    }]
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
    check(rank_positions_dot.launches > 0, "K1 never launched")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
