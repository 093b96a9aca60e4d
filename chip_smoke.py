#!/usr/bin/env python3
"""GPU smoke run of the acf_tpu_torch port (PyTorch + hand-written CUDA).

Run from the root of a checkout on a machine with one NVIDIA GPU (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, any failure exits non-zero:

  1. card   — ``nvidia-smi`` name and power limit, torch's device name;
  2. build  — compile every kernel in ``acf_tpu_torch/csrc`` with nvcc and
              print its ``-Xptxas -v`` lines; K1 (with and without TMA), K2a
              (both width paths), K2b (both forms), its reduction, every K3
              kernel in each of its builds (``APL_BUILDS``) and the merges
              of their partials must spill nothing, and
              so must K2a's and K2b's bfloat16 forms (their own units);
  3. K1     — the rank-count kernel against its plain PyTorch version on
              standard-normal inputs at every ``K1_SHAPES`` case
              (``acf_tpu_torch/tools/k1_ablation.py``: B in {8, 512} x I in
              {300, 23700} at d = 64, two narrower widths, and the edges of
              its units (128 users x 128 or 256 items): B in {1, 127, 129,
              513}, I in {2, 129, 3707, 23700, 40000}, d in {4, 36, 128, 256,
              260}), with and without bias and gt, two calls bit-identical;
              then off its TMA path (``K1_ANY_SHAPES``: d = 50 at the ml-1m
              and Video tiles, d in {10, 6, 1, 0}, and users and table one
              float off 16-byte alignment at d = 64 and 50);
  4. eval   — MF-BPR (d = 64, random weights from a seed) on a synthetic
              Video-shaped dataset (31k users x 23.7k items, ~300k
              interactions): ``FullRankEvaluator.evaluate_model`` through
              K1, checked against the dense ``positions(score_all)`` path,
              timed; K1 timed alone at the path's shape (B = 512, I =
              23,701) and at the ml-1m shape of phase 7 (I = 3,707), its
              kernel alone too;
  5. serve  — ``recommend`` top-10 for every user, checked against a dense
              ``score_all`` + mask + ``torch.topk`` on 256 users, timed;
  6. K2a    — the SASRec encoder-forward kernel against its plain PyTorch
              version, T in {1, 8, 23, 31, 32, 50, 200} x B in {7, 512} at
              d = 64 and d = 36, and the widest window at d = 128
              (``max_window(128)``, B in {7, 133}), then off its 16-byte
              path: T in {1, 8, 50, 200} x B in {7, 512} at d = 50 and 10,
              and x one float off alignment at d = 64; each batch with a
              left-padded and an all-padding window; ``fused_encoder`` must
              raise ValueError for T = 201 at d = 64, for num_heads = 2 and
              for d = 132;
  7. SASRec (d = 64, 2 blocks, 1 head, random weights from a seed) at
              maxlen 50 on a synthetic ml-1m-shaped set (6,040 users x
              3,706 items, 994k rows: every window is T = 50):
              ``evaluate_model`` through K2a and K1 once per user tile,
              checked against the dense path, timed;
  8. the same at maxlen 8 (the protocol geometry) on the Video-shaped set;
  9. ``recommend`` top-10 for every user of the maxlen-50 set (K2a once per
              batch), checked like phase 5, timed;
 10. K2a alone at B = 512, d = 64, T in {8, 50, 200}, in its inference
              and training forms, beside its plain version and its bound;
 11. K2a's dropout form against its plain version, T in {1, 8, 33, 50} x
              B in {7, 512} at d = 64 and d = 36, and the widest windows (T =
              200 at d = 64, ``max_window(128)`` at d = 128; B in {7, 133}),
              T = 200 at d = 50 and T = 33 at d = 10,
              padded windows, masks drawn once per case and shared; the
              saved block inputs against the plain ones, and LN_f of the
              saved LN_f input must give the output;
 12. K2b (the encoder backward) against its plain versions,
              ``encoder_bwd_math`` and torch.autograd through
              ``encoder_math``: dx and every leaf, with and without masks, in
              its dx-only mode; its tile form at T in {8, 50} (d = 64, B =
              512), at T = 1 and the widest windows (T = 74 and its limit 79
              at d = 64, T = 40 and its limit 44 at d = 128; B = 64) and two
              short cases at d = 36, B = 7; its wide form
              (``K2B_WIDE_CASES``: T in {80, 128, 200} at d = 50 and 64, T =
              50 at d = 50, T = 108 at d = 128, B = 64, clusters of 1, 2 and
              4 CTAs; T = 8 at d = 50; T = 50 at d = 64 with every block
              weight one float off alignment); over the tree and
              leaf by leaf (the key biases, whose gradient is analytically
              zero, must be rounding noise); two calls bit-identical, each
              form's launch counter moved; ``ValueError`` for T = 201, for
              num_heads = 2 and for d = 132;
 13. ASASRec training at maxlen 50 on the ml-1m-shaped set: the launches of
              a clean step (K2a 1, K2b 1) and of an asasrec step (2 and 2),
              the step's loss and every gradient leaf against the same step
              through the plain encoder, then ``fit_two_phase`` (1 clean
              epoch, 1 asasrec epoch, 11 steps each at batch 512, an
              evaluation after each) with its launches counted;
 14. training timing: ASASRec examples/s at maxlen 8 (Video shape, 60
              steps an epoch) and maxlen 50 (best of 3 epochs after a
              warm-up), the device's idle share and top operations of one
              step, and K2a (training and inference forms) and K2b alone at
              B = 512, d = 64, T in {8, 50} beside their plain versions and
              bounds (K2b in its full and dx-only forms, and its reduction
              pass per launch);
 15. K3a-K3e (APL's generator chain) against their plain versions at APL's
              geometry (B = 512, d = 64, I = 23,701), a ragged case
              (B = 7, d = 36, I = 1,100), K3b-K3e's staging edges
              (B = 65, d = 64, I = 131), the widest whole-row tables (B = 70,
              d = 128, I = 517), d = 50 at APL's geometry and every width of
              ``APL_WIDTHS`` (1 to 512: the 4-byte form and k slices; B =
              70, I = 517), histories with duplicates and a user with no
              positives: every output, two calls bit-identical; every input
              one element off its buffer (``APL_UNALIGNED``): the aligned
              inputs' bits; ``ValueError`` outside the limits (dtype, shape,
              contiguity) with no launch;
 16. APL on the Video-shaped set: MF-BPR pretrained one epoch with
              Adagrad(0.05, 0.1) through the pair trainer, its tables handed
              to APL's generator (the start NDCG must be MF-BPR's), one APL
              epoch (each K3 kernel once per generator step) and its
              evaluation through K1, counters read around them; both players
              moved, the critic's pad row did not; one generator step
              through the kernels against the same step through the plain
              passes (loss, gP, gQ);
 17. APL timing: each K3 kernel alone beside its plain version, the
              torch.matmul of its products and its bound; one generator and
              one critic step's device busy and idle time; the generator
              step's launches one line each in launch order, then each
              merge of the partials alone; APL epochs' seconds and
              examples/s, every sample printed; each pass at d = 64, 52, 50
              and 256 (``APL_TIMED_WIDTHS``) beside its plain version, its
              products' torch.matmul and its bound;
 18. APR on the ml-1m-shaped set (MF-BPR d = 64, batch 512,
              Adagrad(0.05, 0.1), eps 0.5, reg_adv 1; ``bench.py:66-85``):
              ``fit_two_phase`` (1 clean epoch, then 1 APR epoch with the
              slots reset and every step on the closed form, an evaluation
              through K1 after each, its launches counted); at the params it
              leaves, one step's closed-form gradients against autograd on
              the card and against the CPU's closed form on the same batch
              (its duplicate rows counted), and one step each of APR, DNS
              (dns = 3), PGD (adv_steps = 3), random mode and PointwiseMF on
              the card against the same step on the CPU with the same draws;
              ``FGSMAdversarial(MFBPR)`` against the built-in APR's autograd
              step; one ``FGSMAdversarial(SASRec)`` step at maxlen 50
              through the trainer's ``seq_train_step`` (K2a 3 and K2b 3
              launches) against the same step through the plain encoder,
              ReLU's kink handled as in phases 12-13;
 19. APR timing: examples/s of 2 epochs after a warm-up (both samples and
              the slower, host clock), one step's wall time, launches,
              device busy and idle time and largest device operations,
              beside the card's name and power limit;
 20. the command line (``acf_tpu_torch.cli.main``) at d = 64, batch 512:
              the reference's files written from a seed (``Video.txt``,
              31,000 users x 23,700 items, 300,000 rows; ``ml-1m.*.rating``,
              6,040 x 3,706, 994,000 + 6,040 rows), each parsed by the native
              parser and by pandas (equal, both timed); in-process runs of
              APR on the ml-1m files (2 epochs, the adversarial phase from
              epoch 1; K1 24 launches) and of AMF, AMF2, ABPR and ANeuMF on
              the Video file (1 epoch each; K1 61 launches each but ANeuMF,
              which evaluates densely), each ``.out`` file checked (the
              ``Load data done`` counts against pandas' own, an evaluated
              line an epoch, the K sweep, the ``End.`` line); the sequence
              zoo's runs on the Video file (``ZOO_CLI``: GRU4Rec, DREAM and
              DREAM-TF at maxlen 8, Caser and DRCF at 5, DSIN as 2 sessions
              of 4, one epoch each, and Caser under ``--fgsm`` one clean and
              one adversarial epoch; K1 61 launches an evaluation, none for
              DRCF and DSIN); then, after a
              warm-up epoch, one AMF, ABPR and ANeuMF step on the card against
              the same step on the CPU from the same params, Adam states and
              draws (``APR_TOL`` of the update's scale plus an ulp of the
              largest param);
 21. the adversaries' timing: examples/s of one epoch after the warm-up
              (host clock), one step's launches,
              wall time, device busy and idle time; the Video-scale NeuMF
              evaluation's seconds and device busy time;
 22. the sequence zoo on the Video-shaped set of phase 4 at its full width
              (d = 64, batch 512, Adam(1e-3), DSIN Adam(1e-4); GRU4Rec with
              the bpr, top1 and ce losses and DREAM at maxlen 8, Caser and
              DRCF at 5, DSIN as 2 sessions of 4 with and without
              ``bi_evolution``, ``FGSMAdversarial`` around GRU4Rec and
              Caser): per configuration one step's loss and gradient on the
              card against the CPU from the same params, batch and masks
              (``ZOO_TOL``; under the wrapper its deltas first, then the
              step at the CPU's deltas), examples/s of one epoch after a
              warm-up (Caser on its own sliding-window epoch), one step's
              launches, wall time and device busy and idle time, and one
              ``evaluate_model`` with K1 counted (61 launches for the
              factored models, checked against the dense path; 0 for DRCF
              and DSIN, dense, timed beside their products' FLOP); then
              ``SessionStream`` on 512 slots over 8 events with a reset,
              each push's top-10 against ``torch.topk`` of the dense scores
              of its state, and its users/s;
 23. the single-device remainder at full width: the sparse row-space
              APR step (``SparseMFBPR``, the configuration of phase 18,
              ``dedup="auto"``) on the ml-1m-shaped set: ``fit_two_phase``
              (1 clean + 1 APR epoch, the slots reset, row 0 of both tables
              and both slots bit for bit around each epoch, K1 24 launches),
              one clean and one APR step against the CPU, the sort program
              and the dense pair step (``APR_TOL``), examples/s of 2 epochs
              and one step's launches and busy share; IRGAN (d = 64, batch
              512, SGD(0.001), T 0.2, lambda 0.2) on the Video-shaped set:
              for the pointwise and the pairwise D one D and one G step
              against the CPU on injected draws, an epoch with both pad rows
              kept, 2 timed epochs, one D and one G step profiled, an
              evaluation through K1 (61); the naive baselines' dense
              evaluations (every position equal to the CPU's, timed); the
              command line on phase 20's files (``apr
              --sparse``, ``bpr --sparse --dedup sort``, ``irgan`` with and
              without ``--irgan_pair``, ``pop mrv mfv av``, K1 counted) and
              its refusals with the JAX CLI's messages;
 24. determinism: one APR epoch at the ml-1m shape (the dense closed form)
              and one APL epoch at the Video shape, each run twice from one
              seed, every param and optimizer slot bit for bit (the count of
              differing elements of each leaf printed);
 25. the mesh (``acf_tpu_torch/parallel/``): ``apr --mesh 1x1`` through the
              command line on NCCL (a group of one process) on phase 20's
              ml-1m file, K1 counted, its params and evaluation against phase
              20's single-device run (``APR_TOL``); then two ranks on the one
              card over gloo with CUDA tensors (``parallel/launch.py``),
              meshes 1x2 and 2x1 launched at once (four ranks; the rank
              functions are ``tests/torch_rank_cases.py``):
              ``sharded_lookup`` against the dense gather
              and its gradient (exact), MF-BPR positions at Video scale
              through K1 with ``id_base`` (equal to one device's for every
              user), top-10 of 4,096 users against ``recommend`` (but at
              ties), the sharded APR step, the data-parallel trainer and
              the sparse mesh epoch (each ``fit_two_phase``'s protocol at
              the ml-1m shape: 150 clean steps, then 150 APR steps whose
              stats must carry ``acc_adv``; ``APR_TOL``, the ranks' params
              bit-equal), the adversarial
              SASRec step at maxlen 50 through K2a and K2b (``STEP_TOL``);
              a rank that never launched K1, K2a or K2b fails the phase. Its
              wall times are gloo staging through the host, not NCCL or
              multi-GPU times;
 26. every model under a mesh: two gloo ranks on the card at 1x2 and 2x1,
              launched at once: K3a-K3e on each data rank's rows of one
              Video-shaped APL generator batch (B=512 a rank at 1x2, 256 at
              2x1) against their plain versions (``APL_TOL``), the pad
              item's gradient 0; then, each against one device's run from
              the same seed (``MESH_UPDATE_TOL`` on the update, the
              discriminators at ``MESH_ADAM_TOL``, the stats, every rank's
              state bit for bit, the factored ones' sharded evaluation):
              APL's 4 critic and 4 generator steps at the Video shape (K3
              4 launches a rank), 3 steps each of IRGAN, AMF, ABPR,
              ANeuMF, NeuMF, GRU4Rec, DREAM, DRCF, DSIN, MostPopular and
              the FGSM wrapper over MF-BPR, and Caser's epoch of a
              1,500-user set; then ``apl`` and ``irgan --mesh 1x1`` through
              the command line on NCCL against the same runs without it
              (params and evaluation equal, K1 61);
 27. row-sharded storage: APR, APL and ASASRec on shards bit-equal to the
              unsharded mesh runs, the sharded evaluation from the stored
              item shard, the 2,000,000-item memory run, a 2x2 ``"dcp"``
              snapshot restored onto 2x2, 1x1 and 1x2;
 28. (run on phase 20's files, between phases 20 and 21) the SASRec
              paper's ML-1M shape through the command line: ``asasrec --d
              50 --maxlen 200`` (one clean and one adversarial epoch, batch
              512) and ``bpr --d 50`` (one epoch) on the ml-1m files, every
              counter zeroed before each run and read after it: K2a, K2b's
              wide form and K1 (24) must launch in the first, K1 (12) alone
              in the second; each run's evaluation at its trained params
              against the dense path; one clean and one asasrec step at that
              shape through the kernels against the plain step
              (``STEP_TOL``); then K1 off TMA (d = 50; d = 64 one float off),
              K2a at d = 50, T = 200 and K2b's wide form at T = 200, d = 50
              and 64 (B = 512, full and dx-only) timed beside their plain
              versions and bounds; ``apl --d 50``, the same under ``--mesh
              1x1`` and ``apl --d 10`` on the Video file (one epoch each):
              every K3 kernel once a generator step, K1 61, the mesh run
              bit-equal to the one without;
 29. (run on phase 20's files, after phase 28) SASRec's bfloat16 training
              path: K2a's and K2b's bfloat16 forms against their plain
              bfloat16 versions at B = 512 (d = 64, T in {8, 50}: K2b's tile
              form; d = 50, T = 200: its wide form), K2a's inference and
              training forms with its saved block inputs, K2b full and
              dx-only, every tree within ``BF16_TOL`` of its scale and nearer
              its plain bfloat16 version than its plain float32 one in mean
              (``BF16_MEAN_RATIO``), two calls bit-identical, only the
              bfloat16 counters moved; each kernel's
              float32 and bfloat16 forms timed in turns at (64, 50) and (50,
              200) beside the plain bfloat16 versions and bounds at the bf16
              tensor-core peak; then ``asasrec --train_dtype bfloat16`` through
              the command line on the ml-1m files at d = 64, maxlen 50, at d =
              50, maxlen 200 and under ``--mesh 1x1`` (NCCL), each training
              only through the bfloat16 forms and evaluating through the
              float32 K2a and K1, the first's evaluation against the dense
              path, the mesh run's params against the first's.

Kernel times come from torch.profiler's device time. A measurement whose
profile holds no device time in three sessions is timed with CUDA events
instead (calls back to back, host gaps included), says so in the log, and its
kernel's entry names ``"timer": "cuda_events"``; a step's busy and idle
breakdown is then printed as not measured. The last two lines of standard output are a
``{"kernels": [...]}`` JSON object and ``{"ok": true, "device": {...}}``.
With no GPU, or when the ``acf_tpu_torch`` package is not beside this
script, it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, no sparsity, at the 700 W limit)
FP32_FLOPS = 67e12      # float32 outside the tensor cores
BF16_FLOPS = 989e12     # bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12

D = 64                  # MF-BPR width of the headline model
VIDEO_USERS, VIDEO_ITEMS, VIDEO_INTERACTIONS = 31_000, 23_700, 300_000
ML1M_USERS, ML1M_ITEMS, ML1M_INTERACTIONS = 6_040, 3_706, 994_000
BATCH_USERS = 512


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


_LAP = [time.perf_counter()]


def lap(phases: str):
    """Print the seconds since the previous lap (the run's start for the
    first), so the log shows what each phase costs."""
    now = time.perf_counter()
    print(f"phases {phases}: {now - _LAP[0]:.1f} s")
    _LAP[0] = now


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# Profiler sessions tried per measurement before it is timed with CUDA
# events instead: CUPTI's tracing has been seen to return a session with no
# device events at all, partway through a run that had traced earlier phases.
PROFILER_TRIES = 3
# One entry per measurement that fell back to CUDA events; kernel entries
# compare its length before and after their timing to name their timer.
EVENT_TIMED: list[str] = []


def device_events(fn, calls: int = 1, in_order: bool = False):
    """Run ``fn`` ``calls`` times under torch.profiler; return the averaged
    device-side events (kernels, copies, fills) with nonzero device time, or
    with ``in_order`` each launch's own event in launch order. The CPU ops
    that launched them, which report the same time again, are left out. A
    session with no device event is run again, up to ``PROFILER_TRIES``
    sessions (one once a measurement has fallen back); an empty list means
    none of them saw the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(1 if EVENT_TIMED else PROFILER_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        if in_order:
            events = sorted((e for e in prof.events()
                             if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                            key=lambda e: e.time_range.start)
        else:
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if events:
            return events
    return []


# Calls profiled per plain version (hundreds of small launches each, whose
# profiler events take seconds to collect at 50 calls); a kernel gets 50.
PLAIN_ITERS = 10


def device_ms(fn, iters: int = 50, warmup: int = 10) -> float:
    """Mean device milliseconds per call of ``fn``: the summed durations of
    the kernels it runs, so host launch gaps between calls do not count.
    Where the profiler sees no device time, the mean time of ``iters`` calls
    back to back between two CUDA events instead (``elapsed_ms``), noted in
    ``EVENT_TIMED``."""
    for _ in range(warmup):
        fn()
    events = device_events(fn, iters)
    if events:
        return sum(e.self_device_time_total for e in events) / 1e3 / iters
    ms = elapsed_ms(fn, iters, warmup=0)
    check(ms > 0, "neither the profiler nor CUDA events saw device time")
    EVENT_TIMED.append(f"{ms:.4f} ms")
    print(f"timer: the profiler saw no device time; CUDA events time the next "
          f"measurement at {ms:.4f} ms per call")
    return ms


def kernel_ms(fn, name: str, iters: int = 50):
    """Mean device milliseconds per launch of the kernel of ``fn`` whose name
    holds ``name`` (torch.profiler over ``iters`` calls), or None where the
    profiler saw no device time."""
    for e in device_events(fn, iters):
        if name in e.key:
            return e.self_device_time_total / 1e3 / e.count
    return None


def launches_ms(fn, names, iters: int = 10) -> float:
    """Device milliseconds per call of ``fn`` whose work is one launch of
    each kernel in ``names``: the sum of each kernel's mean time a launch
    (``kernel_ms``), so a profiler session that lost some launches, which
    ``device_ms`` would read as a faster call, still averages the launches it
    saw. Where the profiler sees none of a kernel, ``device_ms``."""
    for _ in range(2):
        fn()
    times = [kernel_ms(fn, name, iters) for name in names]
    return sum(times) if None not in times else device_ms(fn, iters, 2)


def timer_since(mark: int) -> str:
    """The timer of the measurements taken since ``len(EVENT_TIMED)`` was
    ``mark``: "profiler", or "cuda_events" where any of them fell back."""
    return "profiler" if len(EVENT_TIMED) == mark else "cuda_events"


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


def check_k1_shards(dev, g, b=512, n_items=23_700, d=D):
    """K1 on catalog shards (``id_base``, the sharded evaluation's form): the
    table split into m shards of ceil(I / m) rows (the last one's real rows
    only), each shard's counts against the plain version with its
    ``id_base`` (off by 1 at near ties only) and the shards' counts summed
    against the whole table's kernel counts, exactly: the kernel sums every
    dot product in one order whatever the table it is in."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot, rank_positions_dot_plain

    u = torch.randn(b, d, generator=g, device=dev)
    E = torch.randn(n_items, d, generator=g, device=dev)
    t = torch.randn(b, generator=g, device=dev)
    bias = torch.randn(n_items, generator=g, device=dev)
    gt = torch.randint(1, n_items, (b,), generator=g, device=dev, dtype=torch.int32)
    whole = rank_positions_dot(u, E, t, bias=bias, gt=gt)
    for m in (2, 3, 7):
        il = -(-n_items // m)
        total = torch.zeros_like(whole)
        for r in range(m):
            rows = slice(r * il, min((r + 1) * il, n_items))
            got = rank_positions_dot(u, E[rows], t, bias=bias[rows], gt=gt, id_base=r * il)
            ref = rank_positions_dot_plain(u, E[rows], t, bias=bias[rows], gt=gt, id_base=r * il)
            check(float((got - ref).abs().max()) <= 1.0,
                  f"K1 shard {r} of {m}: counts differ from the plain version by more than 1")
            total += got
        check(torch.equal(total, whole),
              f"K1 over {m} shards: the summed counts differ from the whole table's")
        print(f"K1 B={b} I={n_items} d={d} over {m} shards (id_base): the shards' counts sum to "
              "the whole table's exactly")


# (B, I, d, offset) of K1's checks off its TMA path (4-byte copies): the
# SASRec paper's width d = 50 at the ml-1m and Video evaluation tiles,
# narrower widths down to 1 and d = 0 (the biases alone), and with
# ``offset`` the users one float into their buffer and the table the rows
# 5.. of a buffer one float in (a catalog shard's view), at d = 64 and 50.
K1_ANY_SHAPES = ((512, 3_707, 50, False), (512, 23_701, 50, False), (129, 2_000, 10, False),
                 (100, 1_000, 6, False), (7, 129, 1, False), (7, 129, 0, False),
                 (512, 3_707, 64, True), (513, 23_701, 50, True))


def k1_any_inputs(g, dev, b, n_items, d, offset):
    """Standard-normal users, table, thresholds, bias and gt; with ``offset``
    the users and table as views one float off 16-byte alignment."""
    def rows(n):
        if not offset:
            return torch.randn(n, d, generator=g, device=dev)
        buf = torch.randn(n * d + 5 * d + 1, generator=g, device=dev)
        return buf[1:].view(n + 5, d)[5:] if n == n_items else buf[1:n * d + 1].view(n, d)

    u, E = rows(b), rows(n_items)
    t = torch.randn(b, generator=g, device=dev)
    bias = torch.randn(n_items, generator=g, device=dev)
    gt = torch.randint(1, n_items, (b,), generator=g, device=dev, dtype=torch.int32)
    return u, E, t, bias, gt


def check_k1(dev):
    """K1 against its plain version on every ``K1_SHAPES`` case (B, I, d;
    ``acf_tpu_torch/tools/k1_ablation.py``) and every ``K1_ANY_SHAPES`` case
    (its copies without TMA), two calls bit for bit. Returns the max |count
    difference|."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot, rank_positions_dot_plain
    from acf_tpu_torch.tools.k1_ablation import K1_SHAPES, near_tie_items

    g = torch.Generator(device=dev).manual_seed(0)
    before = rank_positions_dot.launches
    max_err = 0.0
    cases = 0
    for b, n_items, d in K1_SHAPES:
        for with_bias_gt in (False, True):
            u = torch.randn(b, d, generator=g, device=dev)
            E = torch.randn(n_items, d, generator=g, device=dev)
            t = torch.randn(b, generator=g, device=dev)
            bias = (torch.randn(n_items, generator=g, device=dev)
                    if with_bias_gt else None)
            gt = (torch.randint(1, n_items, (b,), generator=g, device=dev,
                                dtype=torch.int32) if with_bias_gt else None)
            got = rank_positions_dot(u, E, t, bias=bias, gt=gt)
            check(torch.equal(got, rank_positions_dot(u, E, t, bias=bias, gt=gt)),
                  f"K1 B={b} I={n_items} d={d}: two calls differ")
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
                  f"{len(differing)} of {b} users differ by 1 at near ties; "
                  f"two calls bit-identical")
    for b, n_items, d, offset in K1_ANY_SHAPES:
        u, E, t, bias, gt = k1_any_inputs(g, dev, b, n_items, d, offset)
        aligned = d > 0 and d % 4 == 0 and u.data_ptr() % 16 == 0 and E.data_ptr() % 16 == 0
        check(not aligned, f"K1 B={b} I={n_items} d={d}: the case is on the TMA path")
        got = rank_positions_dot(u, E, t, bias=bias, gt=gt)
        check(torch.equal(got, rank_positions_dot(u, E, t, bias=bias, gt=gt)),
              f"K1 B={b} I={n_items} d={d} offset={offset}: two calls differ")
        diff = (got - rank_positions_dot_plain(u, E, t, bias=bias, gt=gt)).abs()
        max_err = max(max_err, float(diff.max()))
        differing = torch.nonzero(diff > 0).flatten().tolist()
        for row in differing:
            check(float(diff[row]) <= 1.0 and near_tie_items(u, E, t, bias, gt, row) > 0,
                  f"K1 B={b} I={n_items} d={d} offset={offset}: user {row} off by "
                  f"{float(diff[row])} with no near tie")
        cases += 1
        print(f"K1 without TMA B={b} I={n_items} d={d} views one float off={offset}: "
              f"{len(differing)} of {b} users differ by 1 at near ties; two calls bit-identical")
    check(rank_positions_dot.launches - before == 2 * cases,
          "K1 launch counter did not move once per call")
    check_k1_shards(dev, g)
    return max_err


def make_synthetic(users, items, n, seed: int = 0):
    """Synthetic interactions drawn like the JAX package's bench
    (``bench.py:41-57``: uniform users and items, chronological rows,
    ``max_hist_len=512``)."""
    import pandas as pd  # the port's data module reads frames

    from acf_tpu_torch.data import interactions_from_frame

    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "uid": rng.integers(1, users + 1, size=n),
        "iid": rng.integers(1, items + 1, size=n),
        "timestamp": np.arange(n, dtype=np.int64),
    })
    return interactions_from_frame(df, reindex=False, max_hist_len=512)


def check_against_dense(label, ev, model, params, res):
    """Factored positions (the kernels) against the dense
    ``positions(score_all)`` path, and the metrics of ``res`` against the
    dense evaluation."""
    fs = model.factored_scorer()
    pos_f = ev.positions_factored(fs[0], fs[1], params)
    pos_d = ev.positions(model.score_all, params)
    delta = np.abs(pos_f.astype(np.int64) - pos_d)
    exact = float((delta == 0).mean())
    print(f"{label}: factored vs dense positions: max |d| {int(delta.max())}, "
          f"{exact:.6f} exact")
    check(int(delta.max()) <= 2, f"{label}: factored and dense positions differ by more than 2")
    check(exact >= 0.99, f"{label}: fewer than 99% of users have exact positions")
    dense = ev.evaluate(model.score_all, params)
    for name, a, b in zip(("HR@10", "NDCG@10", "AUC"), res.at_k(10), dense.at_k(10)):
        check(abs(a - b) <= 1e-3, f"{label}: {name} factored {a} vs dense {b}")
        check(math.isfinite(a), f"{label}: {name} is not finite")
    hr, ndcg, auc = res.at_k(10)
    print(f"{label} metrics (random init): HR@10 {hr:.6f}  NDCG@10 {ndcg:.6f}  "
          f"AUC {auc:.6f}")
    check(res.hr.shape == (len(ev.users), ev.K) and res.auc.shape == (len(ev.users),),
          f"{label}: EvalResult has the wrong shape")


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
    print(f"eval: {len(ev.users)} users, {n_tiles} tiles, K1 launches {launches}")
    check_against_dense("eval", ev, model, params, res)
    return model, params, ev, launches


def check_serving(dev, model, params, data, label="serve", counter=None, k=10,
                  batch_users=BATCH_USERS, n_check=256):
    """recommend() for every user against a dense top-k. With ``counter`` (a
    kernel wrapper), the recommend call must launch it once per batch."""
    from acf_tpu_torch.ops.topk import NEG, recommend

    users = np.arange(1, data.num_users, dtype=np.int32)
    if counter is not None:
        counter.launches = 0
    sc, it = recommend(model, params, data, users, k=k, batch_users=batch_users,
                       device=dev)  # the main path
    if counter is not None:
        batches = math.ceil(len(users) / batch_users)
        check(counter.launches == batches, f"{label}: recommend launched "
              f"{counter.__name__} {counter.launches} times for {batches} batches")
        print(f"{label}: {counter.__name__} launches {counter.launches} for "
              f"{batches} batches")
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
                  f"{label} user {users[rows[r]]} slot {j}: item "
                  f"{got_i[r, j]} vs {ref_i[r, j]} without a tie")
            ties += 1
    print(f"{label}: {len(users)} users, top-{k}; {n_check} checked against dense "
          f"top-k, {ties} slots differ only at ties")
    return users


def k1_work(b, n_items, d):
    """(bound ms, bound_by) of K1 on [b, d] users and an [n_items, d] table:
    2·B·I·d FLOP; u, E, t and gt read, the counts written."""
    return bound(2.0 * b * n_items * d, 4.0 * (b * d + n_items * d + 3 * b))


def k1_line(label, reprs, table, t, gt):
    """Times K1 on these inputs (the wrapper's device time, its kernel's alone,
    back to back), its plain version and one torch.matmul of the product;
    prints them beside the bound and returns the entry's numbers."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot, rank_positions_dot_plain

    b, d = reprs.shape
    n_items = table.shape[0]
    ms = device_ms(lambda: rank_positions_dot(reprs, table, t, gt=gt))
    alone_ms = kernel_ms(lambda: rank_positions_dot(reprs, table, t, gt=gt), "rank_count_kernel")
    plain_ms = device_ms(lambda: rank_positions_dot_plain(reprs, table, t, gt=gt), PLAIN_ITERS)
    library_ms = device_ms(lambda: torch.matmul(reprs, table.T))
    back_to_back_ms = elapsed_ms(lambda: rank_positions_dot(reprs, table, t, gt=gt))
    bound_ms, bound_by = k1_work(b, n_items, d)
    alone = "not measured" if alone_ms is None else f"{alone_ms:.4f} ms"
    print(f"K1 device time {label} at B={b} I={n_items} d={d}: wrapper {ms:.4f} ms "
          f"({2.0 * b * n_items * d / (ms * 1e-3) / 1e12:.2f} TFLOP/s; the kernel alone "
          f"{alone}), plain {plain_ms:.4f} ms, torch.matmul of the product {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}); K1 wrapper back to back "
          f"{back_to_back_ms:.4f} ms per call (CUDA events)")
    return {"ms": ms, "kernel_alone_ms": alone_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def k1_timing(dev, model, params, ev):
    """K1 alone at the main paths' shapes: one user tile of the Video-shaped
    MF-BPR evaluation, and B=512 against the ml-1m-shaped table of the
    SASRec maxlen-50 evaluation (I = 3,707; standard-normal rows, the
    thresholds the gt's scores). Returns the kernel's entry for the kernels
    line (without launches and max_abs_err); the ml-1m numbers under
    ``"ml1m"``."""
    users = ev._users_d[:ev.batch_users]
    gt = ev._gt_d[:ev.batch_users].contiguous()
    reprs = params["P"][users].contiguous()
    table = params["Q"]
    t = (reprs * table[gt.long()]).sum(dim=1).contiguous()
    mark = len(EVENT_TIMED)
    entry = k1_line("(MF-BPR eval tile, Video shape)", reprs, table, t, gt)
    g = torch.Generator(device=dev).manual_seed(2)
    reprs = torch.randn(ev.batch_users, D, generator=g, device=dev)
    table = torch.randn(ML1M_ITEMS + 1, D, generator=g, device=dev)
    gt = torch.randint(1, ML1M_ITEMS + 1, (ev.batch_users,), generator=g, device=dev,
                       dtype=torch.int32)
    t = (reprs * table[gt.long()]).sum(dim=1).contiguous()
    entry["ml1m"] = k1_line("(ml-1m shape)", reprs, table, t, gt)
    entry["timer"] = timer_since(mark)
    return entry


def device_breakdown(label, fn, wall_s, top=6):
    """One call of ``fn`` under torch.profiler: the device's busy time against
    the unprofiled wall time ``wall_s``, and the largest device consumers."""
    events = device_events(fn)
    if not events:
        print(f"{label}: device busy and idle share not measured (the profiler saw no "
              f"device time); {wall_s * 1e3:.4f} ms wall")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"{label}: device busy {busy_ms:.4f} ms of {wall_s * 1e3:.4f} ms wall, "
          f"idle share {1.0 - busy_ms / (wall_s * 1e3):.4f}; largest:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms {e.count:6d} x {e.key[:100]}")


def time_eval(label, ev, model, params):
    """Evaluation seconds (best of 3), the share of the device tiles, and the
    device's busy and idle time in one evaluation."""
    eval_s = best_wall_s(lambda: ev.evaluate_model(model, params))
    print(f"{label}: evaluate_model best of 3 {eval_s:.4f} s for {len(ev.users)} users")
    fs = model.factored_scorer()
    pos_s = best_wall_s(lambda: ev.positions_factored(fs[0], fs[1], params))
    print(f"{label}: of which positions_factored (device tiles + one transfer) "
          f"{pos_s:.4f} s, host metrics and the rest {eval_s - pos_s:.4f} s")
    device_breakdown(label, lambda: ev.evaluate_model(model, params), eval_s)


def time_serving(label, dev, model, params, data, users):
    """Bulk top-10 seconds (best of 3), users/s and the device's idle share."""
    from acf_tpu_torch.ops.topk import recommend

    def serve():
        return recommend(model, params, data, users, k=10, batch_users=BATCH_USERS,
                         device=dev)

    serve_s = best_wall_s(serve)
    print(f"{label}: recommend best of 3 {serve_s:.4f} s, "
          f"{len(users) / serve_s:.1f} users/s")
    device_breakdown(label, serve, serve_s)


# --- SASRec (K2a) --------------------------------------------------------------

K2A_WINDOWS = (1, 8, 23, 31, 32, 50, 200)
K2A_WIDTHS = (64, 36)
# Widths off K2a's 16-byte path (rows staged at d rounded up to 4, zero
# tails): the SASRec and Caser papers' d = 50 and a narrow 10, at
# K2A_ANY_WINDOWS (200: the SASRec paper's ML-1M window).
K2A_ANY_WIDTHS = (50, 10)
K2A_ANY_WINDOWS = (1, 8, 50, 200)
K2A_EDGE_BATCH = (7, 133)  # the widest windows: 133 blocks, one more than an H100's SMs
# Max |kernel - plain| of the encoder outputs. Both run in f32 but sum the
# d-term products, the softmax denominators and the LayerNorm moments in
# different orders; the outputs are LayerNorm'd to unit scale, so 1e-4 is
# about 1000 f32 ulps of a unit value: room for the rounding of two blocks
# of 64-term sums scaled by LayerNorm's 1/sigma, and far below what a wrong
# mask, residual or weight moves (O(0.1) and more).
K2A_TOL = 1e-4


def sasrec_model(dev, num_users, num_items, maxlen, d=D, seed=0, jitter=False):
    """SASRec (2 blocks, 1 head) with random weights from ``seed``. With
    ``jitter`` the LayerNorm gammas and betas and the dense biases are moved
    off their init constants (N(0, 0.1) noise), so a comparison sees every
    leaf."""
    from acf_tpu_torch.models.sasrec import SASRec

    model = SASRec(num_users, num_items, d, maxlen=maxlen)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(g, device=dev)
    if jitter:
        for p in params["blocks"] + [params]:
            for name, leaf in p.items():
                if name in ("ln1", "ln2", "ln3", "ln_f"):
                    leaf["gamma"] += 0.1 * torch.randn(d, generator=g, device=dev)
                    leaf["beta"] += 0.1 * torch.randn(d, generator=g, device=dev)
                elif name in ("wq", "wk", "wv", "conv1", "conv2"):
                    leaf["b"] += 0.1 * torch.randn(d, generator=g, device=dev)
    return model, params


def k2a_inputs(dev, params, b, t, d, g, padded=True):
    """(x, ids_mask) for ``b`` windows of ``t`` random items; with ``padded``
    row 0 is left-padded (its first half is item 0) and the last row is all
    item 0."""
    num_items = params["item_emb"].shape[0]
    seq = torch.randint(1, num_items, (b, t), generator=g, device=dev)
    if padded:
        seq[0, : t // 2] = 0
        seq[-1] = 0
    return params["item_emb"][seq] * math.sqrt(d), seq != 0


def k2a_cases(windows):
    """(d, T, B) of K2a's checks: ``windows`` x B in {7, 512} at each of
    K2A_WIDTHS, then the widest window at d = 128 (``max_window(128)``) at
    K2A_EDGE_BATCH."""
    from acf_tpu_torch.ops.sasrec_fused import max_window

    wide = max_window(128)
    return ([(d, t, b) for d in K2A_WIDTHS for t in windows for b in (7, 512)]
            + [(128, wide, b) for b in K2A_EDGE_BATCH])


def one_float_off(x):
    """A copy of ``x`` one float into a buffer of its own: the same values
    in a tensor that is not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.flatten()
    return buf[1:].view(x.shape)


def check_k2a(dev):
    """Phase 6: K2a against its plain version, and its refusals. Returns the
    max |difference| over all cases."""
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.ops.sasrec_fused import fused_encoder, fused_encoder_plain

    g = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0
    models = {}
    cases = ([(d, t, b, False) for d, t, b in k2a_cases(K2A_WINDOWS)]
             + [(d, t, b, False) for d in K2A_ANY_WIDTHS for t in K2A_ANY_WINDOWS
                for b in (7, 512)] + [(D, 50, 512, True)])
    for d, t, b, offset in cases:
        if d not in models:
            models[d] = sasrec_model(dev, 100, 1000, max(K2A_WINDOWS), d=d, jitter=True)
        model, params = models[d]
        x, mask = k2a_inputs(dev, params, b, t, d, g)
        if offset:  # x one float off 16-byte alignment: the 4-byte path at d % 4 == 0
            x = one_float_off(x)
        before = fused_encoder.launches
        got = fused_encoder(model, params, x, mask)
        torch.cuda.synchronize()
        check(fused_encoder.launches == before + 1,
              f"K2a d={d} T={t} B={b}: the launch counter did not move once")
        ref = fused_encoder_plain(params, x, mask)
        check(bool(torch.isfinite(got).all()), f"K2a d={d} T={t} B={b}: not finite")
        err = float((got - ref).abs().max())
        max_err = max(max_err, err)
        print(f"K2a d={d} T={t} B={b}{' x one float off' if offset else ''}: max |kernel - "
              f"plain| {err:.3e} (outputs up to {float(ref.abs().max()):.3f})")
        check(err <= K2A_TOL, f"K2a d={d} T={t} B={b}: max |d| {err} > {K2A_TOL}")

    refused = (("T=201 at d=64", SASRec(100, 1000, D, maxlen=201), 201, D),
               ("num_heads=2", SASRec(100, 1000, D, maxlen=50, num_heads=2), 50, D),
               ("d=132", SASRec(100, 1000, 132, maxlen=50), 50, 132))
    for label, model, t, d in refused:
        _, params = sasrec_model(dev, 100, 1000, max(K2A_WINDOWS), d=d)
        x, mask = k2a_inputs(dev, params, 4, t, d, g, padded=False)
        before = fused_encoder.launches
        try:
            fused_encoder(model, params, x, mask)
        except ValueError as e:
            print(f"K2a {label}: raises ValueError as it should: {e}")
        else:
            fail(f"K2a {label}: fused_encoder did not raise")
        check(fused_encoder.launches == before, f"K2a {label}: launched anyway")
    return max_err


def k2a_work(b, t, d, num_blocks):
    """FLOP and bytes of one K2a call on full windows: the five d x d
    products (10 d² per row and block) and the causal attention over the
    T(T+1)/2 pairs j <= i (2 (T+1) d per row and block); x in, out, the ids
    mask and every weight once."""
    flops = b * t * num_blocks * (10 * d * d + 2 * (t + 1) * d)
    weights = num_blocks * (5 * (d * d + d) + 6 * d) + t * d + 2 * d
    return float(flops), 4.0 * (2 * b * t * d + weights) + b * t


def k2a_timing(dev, windows=(8, 50, 200), b=BATCH_USERS, main_t=50):
    """Phase 10: K2a alone at B=512, d=64 on full windows (every id nonzero,
    so the causal-pair count is exactly what the data needs), in its
    inference form beside its plain version, then its training form.
    Returns the inference entry at the main path's shape (T=50)."""
    from acf_tpu_torch.ops.sasrec_fused import fused_encoder, fused_encoder_plain

    model, params = sasrec_model(dev, 100, 1000, max(windows))
    g = torch.Generator(device=dev).manual_seed(2)
    entry = None
    for t in windows:
        x, mask = k2a_inputs(dev, params, b, t, D, g, padded=False)
        mark = len(EVENT_TIMED)
        ms = device_ms(lambda: fused_encoder(model, params, x, mask))
        plain_ms = device_ms(lambda: fused_encoder_plain(params, x, mask), PLAIN_ITERS, 2)
        flops, nbytes = k2a_work(b, t, D, model.num_blocks)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"K2a device time at B={b} T={t} d={D}: kernel {ms:.4f} ms "
              f"({flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, {bound_ms / ms:.3f} of "
              f"the bound), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
        if t == main_t:
            entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, "timer": timer_since(mark)}
        k2a_train_line(dev, model, params, x, mask, g)
    return entry


def k2a_train_line(dev, model, params, x, mask, g):
    """Prints K2a's training form (dropout masks, block inputs saved) alone
    on these inputs beside its bound; returns its device ms."""
    from acf_tpu_torch.ops.sasrec_fused import encoder_fwd

    b, t, _ = x.shape
    keep = 1.0 - model.dropout_rate
    masks = model._dropout_masks(g, b, t)
    ms = device_ms(lambda: encoder_fwd(params, x, mask, masks, keep, save=True))
    (flops, nbytes), _ = k2_train_work(b, t, D, model.num_blocks)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"K2a training form (dropout, saving block inputs) at B={b} T={t} d={D}: {ms:.4f} ms "
          f"({bound_ms / ms:.3f} of the bound), bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return ms


def run_sasrec_eval(dev, label, data, maxlen):
    """Phases 7 and 8: SASRec (d=64, 2 blocks, 1 head, random weights from
    seed 0) through ``evaluate_model``: K2a and K1 once per user tile,
    checked against the dense path, timed. Returns (model, params, K2a
    launches)."""
    from acf_tpu_torch.eval import FullRankEvaluator
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.ops.sasrec_fused import fused_encoder

    model, params = sasrec_model(dev, data.num_users, data.num_items, maxlen)
    ev = FullRankEvaluator(data, batch_users=BATCH_USERS, device=dev)
    n_tiles = math.ceil(len(ev.users) / ev.batch_users)
    fused_encoder.launches = rank_positions_dot.launches = 0
    res = ev.evaluate_model(model, params)  # the main path
    k2a, k1 = fused_encoder.launches, rank_positions_dot.launches
    check(k2a == k1 == n_tiles, f"{label}: K2a launched {k2a} and K1 {k1} times "
          f"for {n_tiles} user tiles")
    print(f"{label}: SASRec maxlen {maxlen}, windows of T={min(maxlen, data.hist.shape[1])}; "
          f"{len(ev.users)} users, {n_tiles} tiles, K2a launches {k2a}, K1 launches {k1}")
    check_against_dense(label, ev, model, params, res)
    time_eval(label, ev, model, params)
    return model, params, k2a


def sasrec_phases(dev, video_data):
    """Phases 6-10. Returns (phase 6's max error, phase 10's T=50 entry, the
    ml-1m-shaped data)."""
    from acf_tpu_torch.ops.sasrec_fused import fused_encoder

    max_err = check_k2a(dev)
    lap("6")

    t0 = time.perf_counter()
    data = make_synthetic(ML1M_USERS, ML1M_ITEMS, ML1M_INTERACTIONS)
    print(f"data: {data.num_users} users x {data.num_items} items, {data.num_pairs} "
          f"train pairs, histories {data.hist.shape[1]} wide, built in "
          f"{time.perf_counter() - t0:.2f} s")
    check(data.hist.shape[1] >= 50, "the ml-1m-shaped histories are narrower than 50")
    model, params, _ = run_sasrec_eval(dev, "sasrec50 eval", data, maxlen=50)
    run_sasrec_eval(dev, "sasrec8 eval", video_data, maxlen=8)
    lap("7-8")

    users = check_serving(dev, model, params, data, label="sasrec50 serve",
                          counter=fused_encoder)
    time_serving("sasrec50 serve", dev, model, params, data, users)
    lap("9")

    entry = k2a_timing(dev)
    lap("10")
    return max_err, entry, data


# --- SASRec training: K2a's dropout form and K2b ------------------------------

K2_TRAIN_WINDOWS = (1, 8, 33, 50)
# K2b against its plain versions, leaf by leaf: max |kernel - plain| over a
# tree of gradients (dx alone, or every weight leaf) divided by the largest
# |plain| entry of that tree. Both run in f32; the kernel sums each weight
# gradient over up to 25,600 rows per block in another order (per block of
# users, then the blocks in order) and backpropagates through two blocks of
# LayerNorm, whose 1/sigma amplifies rounding; some entries are
# analytically zero (the key bias) and rounding noise on both sides, so the
# error is measured against the tree's scale. 1e-4 is ~1000 f32 ulps of
# that scale, far below what a wrong mask, residual or transposed weight
# moves (O(1) of the scale).
K2B_TOL = 1e-4
# The training step (loss and every gradient leaf) through the kernels
# against the same step through the plain encoder, by the same measure: the
# loss to rtol 1e-5, the gradient tree to 1e-4 of its scale.
STEP_TOL = 1e-4
TRAIN_BATCH = 512
# ReLU's gradient jumps at 0. Two f32 forwards of the same inputs (the
# kernel's and the plain version's) round a pre-activation differently by
# ~1e-6 here, so a unit that close to 0 may be gated open on one side and
# shut on the other: both are correct subgradients, and one such flip moves
# a gradient tree by ~1e-3 of its L2 norm (measured in f32 against f64).
# The comparisons of phases 12 and 13 leave out the users that hold a unit
# within KINK of 0 in the plain forward (20x the largest forward difference
# phase 11 sees): phase 12 gives them a zero cotangent, phase 13 replaces
# their rows of the batch with another user's.
KINK = 2e-5
# Leaf by leaf, each by its own largest |plain| entry: 1e-3, ten times the
# tree's tolerance, since a leaf's own scale may be 1/10 of the tree's. The
# key biases are left out of it: softmax ignores a per-row constant, so
# their gradient is analytically zero and both sides hold rounding noise,
# which must stay below 1e-5 of the tree's scale (KEY_BIAS_TOL). By their
# own scale two correct backwards disagree there by O(1).
K2B_LEAF_TOL = 1e-3
KEY_BIAS_TOL = 1e-5


def leaf_names(num_blocks):
    """Names of [pos rows, *_flat_leaves] in order."""
    from acf_tpu_torch.ops.sasrec_fused import BLOCK_LEAVES

    return (["pos_emb"] + [f"blocks/{i}/{name}/{leaf}" for i in range(num_blocks)
                           for name, leaves in BLOCK_LEAVES for leaf in leaves]
            + ["ln_f/gamma", "ln_f/beta"])


def leaf_report(label, leaves, ref):
    """Phase 12's leaf-by-leaf check of ``leaves`` against ``ref``."""
    names = leaf_names((len(ref) - 3) // 16)
    scale = max(float(r.abs().max()) for r in ref)
    own = {n: float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)
           for a, r, n in zip(leaves, ref, names) if not n.endswith("/wk/b")}
    worst = max(own, key=own.get)
    keyb = [(float(a.abs().max()) / scale, float(r.abs().max()) / scale)
            for a, r, n in zip(leaves, ref, names) if n.endswith("/wk/b")]
    kernel_kb, plain_kb = max(k for k, _ in keyb), max(p for _, p in keyb)
    print(f"{label}: leaf by its own scale, worst {worst} {own[worst]:.2e}; key-bias "
          f"gradients (analytically 0) up to {kernel_kb:.1e} (kernel) and {plain_kb:.1e} "
          f"(plain) of the tree's scale")
    check(own[worst] <= K2B_LEAF_TOL, f"{label}: leaf {worst} differs by {own[worst]:.3e} "
          f"of its own scale > {K2B_LEAF_TOL}")
    check(kernel_kb <= KEY_BIAS_TOL and plain_kb <= KEY_BIAS_TOL,
          f"{label}: a key-bias gradient is not rounding noise ({kernel_kb}, {plain_kb})")


def mean_abs(got, ref):
    """Mean |got - ref| over every entry of two lists of tensors."""
    return (sum(float((a - b).abs().sum()) for a, b in zip(got, ref))
            / sum(b.numel() for b in ref))


def tree_err(got, ref):
    """(max |got - ref| over a list of tensors, that / max |ref|)."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    return err, err / max(scale, 1e-30)


def check_close(label, got, ref, top):
    """``got`` against ``ref`` (lists of tensors) within APR_TOL of ref's
    scale plus an ulp of ``top``: an update read back as new - old params
    resolves only to an ulp of the largest entry it was added to. Returns
    the line that reports it."""
    err, r = tree_err(got, ref)
    scale = max(float(x.abs().max()) for x in ref)
    bound_ = APR_TOL * scale + torch.finfo(torch.float32).eps * top
    check(err <= bound_, f"{label}: max |d| {err:.3e} > {bound_:.3e}")
    return f"max |d| {err:.3e} ({r:.2e} of its scale {scale:.3e}; bound {bound_:.3e})"


def near_kink_users(params, x, mask, masks, keep):
    """[B] bool: users with an unmasked row holding a ReLU pre-activation
    within KINK of 0 in the plain forward."""
    from acf_tpu_torch.ops.sasrec_fused import _block, _input

    h = _input(params, x, mask, masks, keep)
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for i, blk in enumerate(params["blocks"]):
        h, c = _block(blk, h, mask, 1, None if masks is None else masks["blocks"][i], keep)
        near |= ((c["z1"].abs() <= KINK) & mask[:, :, None]).flatten(1).any(dim=1)
    return near


def check_k2a_dropout(dev):
    """Phase 11: K2a's dropout form (saving the block inputs, as training
    runs it) against its plain version, at the training windows and the
    widest windows K2a takes. Returns the max |difference|."""
    from acf_tpu_torch.nn.layers import layer_norm
    from acf_tpu_torch.ops.sasrec_fused import (
        _block, _input, encoder_fwd, fused_encoder, fused_encoder_plain,
    )

    g = torch.Generator(device=dev).manual_seed(11)
    max_err = 0.0
    models = {}
    for d, t, b in (k2a_cases(K2_TRAIN_WINDOWS)
                    + [(64, max(K2A_WINDOWS), b) for b in K2A_EDGE_BATCH]
                    + [(50, max(K2A_ANY_WINDOWS), 133), (10, 33, 7)]):
        if d not in models:
            models[d] = sasrec_model(dev, 100, 1000, max(K2A_WINDOWS), d=d, jitter=True)
        model, params = models[d]
        keep = 1.0 - model.dropout_rate
        x, mask = k2a_inputs(dev, params, b, t, d, g)
        masks = model._dropout_masks(g, b, t)
        before = fused_encoder.launches
        got, saved = encoder_fwd(params, x, mask, masks, keep, save=True)
        torch.cuda.synchronize()
        check(fused_encoder.launches == before + 1,
              f"K2a dropout d={d} T={t} B={b}: the launch counter did not move once")
        ref = fused_encoder_plain(params, x, mask, masks, keep)
        check(bool(torch.isfinite(got).all()), f"K2a dropout d={d} T={t} B={b}: not finite")
        err = float((got - ref).abs().max())
        h, blocks_in = _input(params, x, mask, masks, keep), []
        for i, blk in enumerate(params["blocks"]):
            blocks_in.append(h)
            h, _ = _block(blk, h, mask, 1, masks["blocks"][i], keep)
        saved_err = float((saved - torch.stack([*blocks_in, h])).abs().max())
        again = float((layer_norm(params["ln_f"], saved[-1]) - got).abs().max())
        max_err = max(max_err, err, saved_err)
        print(f"K2a dropout d={d} T={t} B={b}: max |kernel - plain| {err:.3e}; saved block "
              f"inputs {saved_err:.3e}; LN_f(saved LN_f input) vs output {again:.3e}")
        check(err <= K2A_TOL, f"K2a dropout d={d} T={t} B={b}: max |d| {err} > {K2A_TOL}")
        check(saved_err <= K2A_TOL and again <= K2A_TOL,
              f"K2a dropout d={d} T={t} B={b}: the saved inputs are wrong")
    return max_err


def k2b_refs(params, x, mask, masks, keep, g):
    """K2b's two plain versions: encoder_bwd_math, and torch.autograd
    through encoder_math; each as [dx] and [pos rows, *leaves]."""
    from acf_tpu_torch.ops.sasrec_fused import (
        _flat_leaves, _tree_from, encoder_bwd_math, encoder_math,
    )

    dx, grads = encoder_bwd_math(params, x, mask, masks, keep, g)
    t = x.shape[1]
    leaves = [v.detach().clone().requires_grad_(True) for v in _flat_leaves(params)]
    pos = params["pos_emb"][-t:].detach().clone().requires_grad_(True)
    xs = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        out = encoder_math(_tree_from(pos, leaves), xs, mask, 1, masks, keep)
        auto = torch.autograd.grad(out, [xs, pos, *leaves], g)
    return ([dx], [grads["pos_emb"], *_flat_leaves(grads)]), ([auto[0]], list(auto[1:]))


def tile_window(d):
    """The widest window of K2b's tile form at width ``d`` (0 if none)."""
    from acf_tpu_torch.ops.sasrec_fused import _bwd_form, max_window

    return max([t for t in range(1, max_window(d) + 1) if _bwd_form(t, d) == "tile"],
               default=0)


# K2b's wide form against its plain versions: windows past the tile form's
# (79 at d = 64, 100 at d = 48 to 52) up to the SASRec paper's 200, at its
# d = 50 and at 64 (clusters of 2 and 4), the paper's d at T = 50 (a cluster
# of 1), and the widest window at d = 128 (max_window(128)).
K2B_WIDE_CASES = (tuple((d, t) for d in (50, 64) for t in (80, 128, 200))
                  + ((50, 50), (128, 108)))


def check_k2b(dev):
    """Phase 12: K2b in both forms against its plain versions, its
    determinism and its refusals. Returns the max |difference| against
    encoder_bwd_math of the tile form and of the wide form."""
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.ops.sasrec_fused import (
        _bwd_form, _flat_leaves, encoder_bwd, encoder_fwd, fused_encoder, max_window,
    )

    g = torch.Generator(device=dev).manual_seed(12)
    max_err = {"tile": 0.0, "wide": 0.0}
    check(max_window(128) == K2B_WIDE_CASES[-1][1], "max_window(128) moved: update the cases")
    # (d, T, B, masks): the training windows; T = 1; the widest windows K2b
    # took before its seven-buffer layout (74 at d = 64, 40 at d = 128) and
    # the widest of its tile form; short ragged cases at d = 36; then the
    # wide form: K2B_WIDE_CASES, a short window at d = 50 (off the tile
    # form's 16-byte copies) and the main path's shape with every block
    # weight one float off 16-byte alignment ("offset")
    cases = ((64, 8, 512, True), (64, 8, 512, False), (64, 50, 512, True),
             (64, 50, 512, False), (64, 1, 64, True), (64, 74, 64, True),
             (64, tile_window(64), 64, True), (128, 40, 64, True),
             (128, tile_window(128), 64, True), (36, 13, 7, True), (36, 8, 7, False),
             *((d, t, 64, True) for d, t in K2B_WIDE_CASES), (50, 200, 64, False),
             (50, 8, 7, False), (64, 50, 64, "offset"))
    for d, t, b, with_masks in cases:
        model, params = sasrec_model(dev, 100, 1000, max(t, 50), d=d, jitter=True)
        if with_masks == "offset":
            for blk in params["blocks"]:
                for name in ("wq", "wk", "wv", "conv1", "conv2"):
                    blk[name]["w"] = one_float_off(blk[name]["w"])
        keep = 1.0 - model.dropout_rate
        x, mask = k2a_inputs(dev, params, b, t, d, g)
        masks = model._dropout_masks(g, b, t) if with_masks else None
        cot = torch.randn(b, t, d, generator=g, device=dev)
        near = near_kink_users(params, x, mask, masks, keep)
        cot[near] = 0.0
        _, saved = encoder_fwd(params, x, mask, masks, keep, save=True)
        form = "wide" if with_masks == "offset" else _bwd_form(t, d)
        before = (encoder_bwd.launches, encoder_bwd.wide_launches)
        dx, grads = encoder_bwd(params, x, mask, cot, saved, masks, keep)
        dx2, grads2 = encoder_bwd(params, x, mask, cot, saved, masks, keep)
        dx_only, none = encoder_bwd(params, x, mask, cot, saved, masks, keep, weight_grads=False)
        torch.cuda.synchronize()
        label = f"K2b ({form} form) d={d} T={t} B={b} masks={with_masks}"
        moved = (encoder_bwd.launches - before[0], encoder_bwd.wide_launches - before[1])
        check(moved == ((3, 0) if form == "tile" else (0, 3)),
              f"{label}: the launch counters moved {moved}, not 3 times its form's")
        leaves = [grads["pos_emb"], *_flat_leaves(grads)]
        leaves2 = [grads2["pos_emb"], *_flat_leaves(grads2)]
        check(torch.equal(dx, dx2) and all(torch.equal(a, c) for a, c in zip(leaves, leaves2)),
              f"{label}: two calls are not bit-identical")
        check(none is None and torch.equal(dx_only, dx), f"{label}: the dx-only mode differs")
        check(bool(torch.isfinite(dx).all()) and all(bool(torch.isfinite(v).all()) for v in leaves),
              f"{label}: not finite")
        (m_dx, m_leaves), (a_dx, a_leaves) = k2b_refs(params, x, mask, masks, keep, cot)
        errs = {"dx vs bwd_math": tree_err([dx], m_dx), "leaves vs bwd_math": tree_err(leaves, m_leaves),
                "dx vs autograd": tree_err([dx], a_dx), "leaves vs autograd": tree_err(leaves, a_leaves)}
        max_err[form] = max(max_err[form], errs["dx vs bwd_math"][0],
                            errs["leaves vs bwd_math"][0])
        print(f"{label}: {int(near.sum())} users near a ReLU kink get a zero cotangent; "
              + "; ".join(f"{k} max |d| {e:.3e} ({r:.2e} of scale)" for k, (e, r) in errs.items())
              + "; bit-identical over two calls; dx-only equal")
        for k, (_, r) in errs.items():
            check(r <= K2B_TOL, f"{label}: {k} {r:.3e} of scale > {K2B_TOL}")
        leaf_report(f"{label} vs bwd_math", leaves, m_leaves)

    # refusals: one window beyond K2a's widest, two heads, d past 128
    wide = max_window(D) + 1
    refused = ((f"T={wide} at d={D} in training", SASRec(100, 1000, D, maxlen=wide), wide, D),
               ("num_heads=2 in training", SASRec(100, 1000, D, maxlen=50, num_heads=2), 50, D),
               ("d=132 in training", SASRec(100, 1000, 132, maxlen=50), 50, 132))
    for label, model, t, d in refused:
        _, params = sasrec_model(dev, 100, 1000, wide, d=d)
        x, mask = k2a_inputs(dev, params, 4, t, d, g, padded=False)
        before = (fused_encoder.launches, encoder_bwd.launches, encoder_bwd.wide_launches)
        try:
            fused_encoder(model, params, x.requires_grad_(True), mask)
        except ValueError as e:
            print(f"K2b {label}: raises ValueError as it should: {e}")
        else:
            fail(f"K2b {label}: fused_encoder did not raise")
        check((fused_encoder.launches, encoder_bwd.launches, encoder_bwd.wide_launches) == before,
              f"K2b {label}: launched anyway")
    return max_err


def plain_encoder_model(model):
    """A copy of ``model`` whose encode_core is the plain math under torch
    autograd (the same masks when training), for the step comparison."""
    import copy

    plain = copy.copy(model)

    def encode_core(params, x, ids_mask, train=False, generator=None, masks=None, dtype=None):
        return plain.encode_math(params, x, ids_mask, masks if train else None, dtype)

    plain.encode_core = encode_core
    return plain


def check_training_step(dev, data, maxlen=50, d=D):
    """Phase 13, first half (and phase 28 at the SASRec paper's shape): one
    clean and one asasrec step at the main path's shapes, through the
    kernels (K2b in the form its shape takes) and through the plain
    encoder."""
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.utils.tree import tree_leaves, tree_map
    from acf_tpu_torch.ops.sasrec_fused import _bwd_form, encoder_bwd, fused_encoder
    from acf_tpu_torch.sampling import sample_seq_window_batch

    hist = torch.as_tensor(data.hist, device=dev)
    eligible = torch.as_tensor(np.nonzero(data.hist_len >= 2)[0].astype(np.int32), device=dev)
    for adversarial, per_step in ((False, 1), (True, 2)):
        label = f"{'asasrec' if adversarial else 'sasrec'} step (maxlen {maxlen}, d={d})"
        model = SASRec(data.num_users, data.num_items, d, maxlen=maxlen, adversarial=adversarial)
        g = torch.Generator(device=dev).manual_seed(13)
        params = model.init_params(g, device=dev)
        users, window, neg = sample_seq_window_batch(g, hist, eligible, maxlen, data.num_items,
                                                     TRAIN_BATCH)
        masks = model._dropout_masks(g, TRAIN_BATCH, maxlen)
        # the encoder passes of the step: training (with the masks) and, for
        # asasrec, the clean FGSM linearisation; users near a kink in either
        # are replaced by copies of the other users' rows
        x = params["item_emb"][window[:, :-1]] * math.sqrt(d)
        ids = window[:, :-1] != 0
        near = near_kink_users(params, x, ids, masks, 1.0 - model.dropout_rate)
        if adversarial:
            near |= near_kink_users(params, x, ids, None, 1.0)
        ok = torch.nonzero(~near).flatten()
        rep = ok[torch.arange(int(near.sum()), device=dev) % len(ok)]
        for rows in (users, window, neg, masks["emb"],
                     *(m for bm in masks["blocks"] for m in bm.values())):
            rows[near] = rows[rep]
        batch = (users, window, neg)

        def value_and_grads(m):
            prm = tree_map(lambda x: x.detach().requires_grad_(True), params)
            loss, aux = m.loss_window(prm, batch, masks=masks)
            return loss.detach(), aux, torch.autograd.grad(loss, tree_leaves(prm))

        fused_encoder.launches = encoder_bwd.launches = encoder_bwd.wide_launches = 0
        loss, aux, grads = value_and_grads(model)
        torch.cuda.synchronize()
        k2a, k2b = fused_encoder.launches, encoder_bwd.launches + encoder_bwd.wide_launches
        form = _bwd_form(maxlen, d)
        own = encoder_bwd.wide_launches if form == "wide" else encoder_bwd.launches
        check(k2a == per_step and k2b == own == per_step,
              f"{label}: K2a launched {k2a} and K2b {k2b} times ({own} in its {form} form), "
              f"not {per_step} each")
        p_loss, p_aux, p_grads = value_and_grads(plain_encoder_model(model))
        check(math.isfinite(float(loss)), f"{label}: loss not finite")
        rel = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
        err, scale_err = tree_err(grads, p_grads)
        print(f"{label}: {int(near.sum())} of {TRAIN_BATCH} users near a ReLU kink replaced; "
              f"K2a {k2a}, K2b ({form} form) {k2b} launches; loss {float(loss):.6f} vs plain "
              f"{float(p_loss):.6f} (rel {rel:.2e}); aux "
              + ", ".join(f"{k} {float(v):.6f}/{float(p_aux[k]):.6f}" for k, v in sorted(aux.items()))
              + f"; every gradient leaf max |d| {err:.3e} ({scale_err:.2e} of scale)")
        check(rel <= 1e-5, f"{label}: loss differs from the plain step by {rel}")
        check(scale_err <= STEP_TOL, f"{label}: gradients differ by {scale_err} of scale")


def lines_writer():
    """An OutputWriter that keeps its lines (``.lines``) and prints them, all
    but the K = 1..100 sweep, which is counted, not shown."""
    from acf_tpu_torch.utils.io import OutputWriter

    class Lines(OutputWriter):
        def __init__(self):
            super().__init__(None, None)
            self.lines = []

        def line(self, output):
            self.lines.append(output)
            if not output.startswith("K = "):
                print(f"  {output}")

    return Lines()


def run_fit_two_phase(dev, data, maxlen=50):
    """Phase 13, second half: ``fit_two_phase`` (1 clean epoch, then 1
    asasrec epoch with the Adam slots carried), an evaluation after each,
    all counters read around it. Returns (K2a, K2b, K1 launches)."""
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.ops.sasrec_fused import encoder_bwd, fused_encoder
    from acf_tpu_torch.train import TrainConfig, adam, fit_two_phase
    from acf_tpu_torch.train import trainer as trainer_mod

    stats = []
    real_run_epoch = trainer_mod.Trainer.run_epoch

    def run_epoch(self):
        out = real_run_epoch(self)
        stats.append(out)
        return out

    clean = SASRec(data.num_users, data.num_items, D, maxlen=maxlen)
    adv = SASRec(data.num_users, data.num_items, D, maxlen=maxlen, adversarial=True, eps=0.5,
                 reg_adv=1.0)
    writer = lines_writer()
    n_steps = int((data.hist_len >= 1).sum()) // TRAIN_BATCH
    tiles = math.ceil(len(data.eval_users()) / BATCH_USERS)
    trainer_mod.Trainer.run_epoch = run_epoch
    try:
        fused_encoder.launches = encoder_bwd.launches = rank_positions_dot.launches = 0
        t0 = time.perf_counter()
        best = fit_two_phase(clean, adv, data, adam(1e-3, b2=0.98),
                             TrainConfig(batch_size=TRAIN_BATCH, epochs=2, verbose=1),
                             adv_epoch=1, writer=writer, reset_opt=False)  # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2a, k2b, k1 = fused_encoder.launches, encoder_bwd.launches, rank_positions_dot.launches
    finally:
        trainer_mod.Trainer.run_epoch = real_run_epoch
    print(f"fit_two_phase maxlen {maxlen}: {n_steps} steps per epoch, {tiles} eval tiles; "
          f"{wall:.2f} s; K2a launches {k2a}, K2b {k2b}, K1 {k1}; best epoch {best['epoch']} "
          f"NDCG@10 {best['ndcg']:.6f}")
    check(k2a == n_steps * (1 + 2) + 2 * tiles and k2b == n_steps * (1 + 2) and k1 == 2 * tiles,
          f"fit_two_phase: launches K2a {k2a}, K2b {k2b}, K1 {k1} are not "
          f"{n_steps * 3 + 2 * tiles}, {n_steps * 3}, {2 * tiles}")
    epochs = [ln for ln in writer.lines if ln.startswith("Epoch ") and "HR =" in ln]
    check(len(epochs) == 2 and not any("NaN" in ln for ln in writer.lines),
          "fit_two_phase: not two evaluated epochs")
    check(sum(ln.startswith("K = ") for ln in writer.lines) == 100,
          "fit_two_phase: no K = 1..100 sweep at the end")
    check(len(stats) == 2 and all(math.isfinite(v) for s in stats for v in s.values()),
          f"fit_two_phase: non-finite epoch stats {stats}")
    check("loss_adv" not in stats[0] and "loss_adv" in stats[1],
          "fit_two_phase: the phases did not run clean then asasrec")
    print(f"fit_two_phase epoch stats: {stats}")
    check(math.isfinite(best["ndcg"]) and best["epoch"] == 1, "fit_two_phase: no best epoch")
    return k2a, k2b, k1


def k2_train_work(b, t, d, nb, masks=True):
    """(K2a training-form FLOP, bytes), (K2b FLOP, bytes) on full windows.
    K2a: the inference count plus the masks read and the block inputs
    written. K2b: the backward's own B T nb (20 d² + 4 (T+1) d) FLOP (ten
    d x d products, dP, dV, dQ, dK over the causal pairs; the
    rematerialised forward is not counted); g, the saved inputs, the masks,
    the ids mask and the weights read once, dx and the gradients written
    once."""
    from acf_tpu_torch.ops.sasrec_fused import grad_size

    fwd_flops, fwd_bytes = k2a_work(b, t, d, nb)
    mask_bytes = b * (t * d + nb * (2 * t * d + t * t)) if masks else 0
    saved_bytes = 4.0 * (nb + 1) * b * t * d
    weights = nb * (5 * (d * d + d) + 6 * d) + t * d + 2 * d
    bwd_flops = float(b * t * nb * (20 * d * d + 4 * (t + 1) * d))
    bwd_bytes = (4.0 * (2 * b * t * d + weights + grad_size(nb, t, d)) + saved_bytes
                 + mask_bytes + b * t)
    return (fwd_flops, fwd_bytes + mask_bytes + saved_bytes), (bwd_flops, bwd_bytes)


def bound(flops, nbytes):
    ops_s, bytes_s = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def k2_train_timing(dev, windows=(8, 50), b=TRAIN_BATCH, main_t=50):
    """Phase 14: K2a's training form and K2b alone at B=512, d=64 on full
    windows with dropout masks, beside their plain versions (K2a:
    fused_encoder_plain; K2b: encoder_bwd_math, which rematerialises the
    forward as K2b does). Returns the two kernel entries at T=50."""
    from acf_tpu_torch.ops.sasrec_fused import (
        encoder_bwd, encoder_bwd_math, encoder_fwd, fused_encoder_plain,
    )

    g = torch.Generator(device=dev).manual_seed(14)
    entries = {}
    for t in windows:
        model, params = sasrec_model(dev, 100, 1000, t)
        keep = 1.0 - model.dropout_rate
        x, mask = k2a_inputs(dev, params, b, t, D, g, padded=False)
        masks = model._dropout_masks(g, b, t)
        cot = torch.randn(b, t, D, generator=g, device=dev)
        _, saved = encoder_fwd(params, x, mask, masks, keep, save=True)
        mark = len(EVENT_TIMED)
        fwd_ms = device_ms(lambda: encoder_fwd(params, x, mask, masks, keep, save=True))
        fwd_plain = device_ms(lambda: fused_encoder_plain(params, x, mask, masks, keep),
                              PLAIN_ITERS, 2)
        fwd_timer, mark = timer_since(mark), len(EVENT_TIMED)
        bwd_ms = device_ms(lambda: encoder_bwd(params, x, mask, cot, saved, masks, keep))
        dx_ms = device_ms(lambda: encoder_bwd(params, x, mask, cot, saved, masks, keep,
                                              weight_grads=False))
        reduce_ms = kernel_ms(lambda: encoder_bwd(params, x, mask, cot, saved, masks, keep),
                              "sasrec_encoder_bwd_reduce")
        bwd_plain = device_ms(lambda: encoder_bwd_math(params, x, mask, masks, keep, cot),
                              PLAIN_ITERS, 2)
        inf_ms = device_ms(lambda: encoder_fwd(params, x, mask))
        (ff, fb), (bf, bb) = k2_train_work(b, t, D, model.num_blocks)
        fwd_bound, fwd_by = bound(ff, fb)
        bwd_bound, bwd_by = bound(bf, bb)
        inf_bound, inf_by = bound(*k2a_work(b, t, D, model.num_blocks))
        print(f"K2a inference form at B={b} T={t} d={D}: {inf_ms:.4f} ms ({inf_bound / inf_ms:.3f} "
              f"of the bound), bound {inf_bound:.4f} ms ({inf_by})")
        print(f"K2a training form (dropout, saving block inputs) at B={b} T={t} d={D}: "
              f"{fwd_ms:.4f} ms ({fwd_bound / fwd_ms:.3f} of the bound), plain {fwd_plain:.4f} ms, "
              f"bound {fwd_bound:.4f} ms ({fwd_by}: {ff / 1e9:.3f} GFLOP, {fb / 1e6:.2f} MB)")
        print(f"K2b at B={b} T={t} d={D}: {bwd_ms:.4f} ms ({bwd_bound / bwd_ms:.3f} of the bound; "
              f"{bf / (bwd_ms * 1e-3) / 1e12:.2f} TFLOP/s of its own work), dx-only {dx_ms:.4f} ms, "
              f"the reduction pass "
              + ("not measured" if reduce_ms is None else f"{reduce_ms:.4f} ms per launch")
              + f", plain {bwd_plain:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_by}: {bf / 1e9:.3f} "
              f"GFLOP, {bb / 1e6:.2f} MB)")
        if t == main_t:
            entries["fwd"] = {"ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fwd_bound,
                              "bound_by": fwd_by, "library_ms": None, "timer": fwd_timer}
            entries["bwd"] = {"ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": bwd_bound,
                              "bound_by": bwd_by, "library_ms": None, "dx_only_ms": dx_ms,
                              "reduce_ms": reduce_ms, "timer": timer_since(mark)}
    return entries["fwd"], entries["bwd"]


def time_training(label, dev, data, maxlen, reps=3):
    """Phase 14: ASASRec examples/s (best of ``reps`` epochs after a warm-up
    epoch), and one step's device busy and idle time with its largest
    device operations."""
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.sampling import sample_seq_window_batch
    from acf_tpu_torch.train import TrainConfig, Trainer, adam
    from acf_tpu_torch.train.trainer import seq_train_step

    model = SASRec(data.num_users, data.num_items, D, maxlen=maxlen, adversarial=True, eps=0.5,
                   reg_adv=1.0)
    tr = Trainer(model, data, adam(1e-3, b2=0.98),
                 TrainConfig(batch_size=TRAIN_BATCH, verbose=10 ** 9))
    tr.run_epoch()  # warm-up, for the epochs and the profiled step below
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.run_epoch()  # ends in a host transfer of the epoch's stats
        samples.append(time.perf_counter() - t0)
    examples = tr.num_batches * TRAIN_BATCH
    check(all(math.isfinite(v) for v in stats.values()), f"{label}: non-finite stats {stats}")
    print(f"{label}: ASASRec maxlen {maxlen}, {tr.num_batches} steps of {TRAIN_BATCH} an epoch: "
          f"best {examples / min(samples):.1f} examples/s; samples "
          + ", ".join(f"{examples / s:.1f}" for s in samples)
          + " examples/s (" + ", ".join(f"{s:.4f}" for s in samples) + " s)")

    def step():
        batch = sample_seq_window_batch(tr.generator, tr.dev["hist"], tr.dev["eligible"], maxlen,
                                        data.num_items, TRAIN_BATCH)
        tr.params, tr.opt_state, _ = seq_train_step(model, tr.optimizer, tr.params,
                                                    tr.opt_state, batch, tr.generator)

    step_s = min(samples) / tr.num_batches
    print(f"{label}: one step {step_s * 1e3:.4f} ms (the best epoch over its steps)")
    device_breakdown(f"{label} step", step, step_s, top=12)
    return examples / min(samples)


def training_phases(dev, ml1m_data, video_data):
    """Phases 11-14. Returns the K2a and K2b entries of the kernels line
    (without K2a's phase-6 error, which the caller merges) and the wide
    form's max |difference| in phase 12."""
    fwd_err = check_k2a_dropout(dev)
    lap("11")
    bwd_err = check_k2b(dev)
    lap("12")
    check_training_step(dev, ml1m_data)
    k2a, k2b, _ = run_fit_two_phase(dev, ml1m_data)
    lap("13")
    time_training("train8", dev, video_data, maxlen=8)
    time_training("train50", dev, ml1m_data, maxlen=50)
    lap("14 (training)")
    fwd, bwd = k2_train_timing(dev)
    lap("14 (kernels)")
    k2a_entry = {"name": "sasrec_encoder_fwd", "route": "cuda",
                 "source": "acf_tpu_torch/csrc/sasrec_encoder_fwd.cu",
                 "replaces": "acf_tpu/ops/sasrec_fused.py:225", "launches": k2a,
                 "max_abs_err": fwd_err, **fwd}
    k2b_entry = {"name": "sasrec_encoder_bwd", "route": "cuda",
                 "source": "acf_tpu_torch/csrc/sasrec_encoder_bwd.cu",
                 "replaces": "acf_tpu/ops/sasrec_fused.py:236", "launches": k2b,
                 "max_abs_err": bwd_err["tile"], **bwd}
    return k2a_entry, k2b_entry, bwd_err["wide"]


# --- APL: the generator chain K3a-K3e -------------------------------------------

# Each K3 output against its plain version on the same inputs (every kernel
# is fed the kernel outputs of the passes before it), max |kernel - plain|
# divided by the largest |plain| entry of that output. Both run in f32; the
# kernels sum d-term products with FMAs in k order, the softmax statistics
# per 256-item chunk merged in chunk order, fake, R and dP over item tiles,
# dQ over users, all in another order than cuBLAS and torch's reductions;
# exp and log round alike on both sides. 1e-4 is ~800 f32 ulps of an
# output's scale: room for sums over 23,701 items and 512 users and for the
# 1/(mixed + 1e-20) factor of r, which magnifies the rounding of items of
# small probability; far below what a wrong mask (column 0, the ragged
# tail), a wrong merge of the chunks or a swapped table moves (O(1) of the
# scale).
APL_TOL = 1e-4
# (B, d, I): APL's geometry; a ragged case; one user tile plus a row and two
# item tiles plus 3 items, where the [B, I] rows start at every offset within a
# 16-byte unit (f32) and a 4-byte word (uint8); the widest whole-row table
# (MAX_WHOLE_D), where K3e's shared memory is the largest, with odd I; APL's
# geometry at d = 50 (`apl --d 50`); then every form at two user tiles (one
# ragged) by nine item tiles (odd I): the 4-byte copies and zero tails of d
# % 4 != 0 (1, 3, 10, 50) and the k slices past MAX_WHOLE_D (130: a slice of
# 4 columns; 200; 256; 512)
APL_WIDTHS = (1, 3, 10, 50, 130, 200, 256, 512)
APL_CASES = ((512, D, 23_701), (7, 36, 1_100), (65, 64, 131), (70, 128, 517), (512, 50, 23_701),
             *((70, d, 517) for d in APL_WIDTHS))
# (B, d, I) of the unaligned views: every input one element off its
# buffer's start (the float32 ones 4 bytes, member 1 byte; z too, for K3c-K3e)
# in the whole-row form at d = 64 and 50 and in the sliced one at d = 200
APL_UNALIGNED = ((65, 64, 131), (70, 50, 517), (70, 200, 517))
APL_PRODUCTS = {"apl_stats1": 1, "apl_z": 1, "apl_fake": 1, "apl_bigr": 2, "apl_grad": 4}
# Kernels whose ptxas lines must show no stack frame and no spill: K1 (with
# and without TMA), K2a (both thread counts, both width paths), K2b (both
# forms; the wide form's build by its own mangled name, so its lines must be
# there) and its reduction, the K3 passes and the merges of their partials.
K2B_WIDE_BUILD = "sasrec_encoder_bwd_kernel_cluster"  # the wide form's cluster kernel
# the wide form's steps kept out of line: its gathers through distributed
# shared memory ("6gather" in its mangled name) and its sums of the ranks'
# shares (in both forms), its dS step (in the bfloat16 form)
K2B_WIDE_STEPS = ("6gather", "cl_combine")
NO_SPILL_KERNELS = ("rank_count_kernel", "sasrec_encoder_fwd_kernel", "sasrec_encoder_bwd_kernel",
                    K2B_WIDE_BUILD, *K2B_WIDE_STEPS, "sasrec_encoder_bwd_reduce", "stats1_kernel",
                    "z_kernel", "fake_kernel", "bigr_kernel", "grad_kernel", "stat_combine",
                    "sum_combine")
# K2a's and K2b's bfloat16 forms: the same kernels under the same names,
# built by units of their own, whose sections of the build log must show
# each of them, spilling nothing (and the steps the bfloat16 form keeps out
# of line: the tile form's rematerialised attention, the wide form's dS)
BF16_UNITS = {"sasrec_encoder_fwd_bf16.cu": ("sasrec_encoder_fwd_kernel",),
              "sasrec_encoder_bwd_bf16.cu": ("sasrec_encoder_bwd_kernel", K2B_WIDE_BUILD,
                                             "sasrec_encoder_bwd_reduce", "attention_fwd",
                                             "cl_ds", *K2B_WIDE_STEPS)}
# The pass kernels of apl_gen.cu, by their names in a profile ("...::z_kernel<0>(...")
APL_PASS_KERNELS = {"stats1_kernel": "K3a", "z_kernel": "K3b", "fake_kernel": "K3c",
                    "bigr_kernel": "K3d", "grad_kernel": "K3e"}
# Each build of the K3 kernels by its mangled name: every pass in its three
# forms (template argument 0 kAligned, 1 kAny, 2 kSliced), K3e's whole-row
# forms at 4 and 8 register columns; each must be in the build log, spilling
# nothing
APL_BUILDS = tuple(f"{k}ILi{f}EE" for k in ("stats1_kernel", "z_kernel", "fake_kernel",
                                             "bigr_kernel") for f in range(3)) + tuple(
    f"grad_kernelILi{c}ELi{f}EE" for c, f in ((4, 0), (8, 0), (4, 1), (8, 1), (4, 2)))

APL_REPLACES = {"apl_stats1": 67, "apl_z": 83, "apl_fake": 111, "apl_bigr": 141,
                "apl_grad": 157}  # acf_tpu/ops/apl_gen_fused.py lines of the TPU kernels


def check_no_spill(log):
    """Phase 2: the ptxas lines of K1, K2a, K2b, its reduction, the K3
    kernels and their merges in the build log show no stack frame and no spill
    (their designs keep their tiles and row scalars in registers and shared
    memory)."""
    from acf_tpu_torch.tools.ablation import ptxas_lines

    sections = {}
    for part in log.split("\n== ")[1:]:
        name, _, text = part.partition("\n")
        sections[name.strip()] = text
    checks = [("", kernel, log) for kernel in NO_SPILL_KERNELS + APL_BUILDS] + [
        (f" ({unit})", kernel, sections.get(unit, "")) for unit, kernels in BF16_UNITS.items()
        for kernel in kernels]
    for where, kernel, text in checks:
        lines = [x for x in ptxas_lines(text, kernel) if "spill" in x]
        check(bool(lines) and all(x.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                               "0 bytes spill loads") for x in lines),
              f"{kernel}{where}: ptxas reports a stack frame or spills: {lines}")
    print(f"ptxas: {', '.join(NO_SPILL_KERNELS)} spill nothing (the K3 kernels in every "
          f"build: {', '.join(APL_BUILDS)}); in the bfloat16 units, "
          + "; ".join(f"{unit}: {', '.join(kernels)}" for unit, kernels in BF16_UNITS.items())
          + " spill nothing")


def apl_inputs(dev, b, d, num_items, seed):
    """One generator step's inputs, drawn from ``seed``: tables with logits
    of a few units, 12-entry histories with duplicates and left padding,
    user 0 with no positives, Gumbel noise and a cotangent ``a``."""
    from acf_tpu_torch.models.apl import gumbel, membership

    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: 0.4 * torch.randn(*shape, generator=g, device=dev)
    hist = torch.randint(1, num_items, (b, 12), generator=g, device=dev, dtype=torch.int32)
    hist[:, :3] = hist[:, 3:6].clone()
    hist[:, :2] = 0
    hist[0] = 0
    member, nuniq = membership(hist, num_items)
    return dict(pu_g=f(b, d), Qg=f(num_items, d), pu_c=f(b, d), Qc=f(num_items, d),
                member=member, nuniq=nuniq,
                gnoise=gumbel(torch.rand(b, num_items, generator=g, device=dev)), a=f(b))


def check_apl_kernels(dev):
    """Phase 15: K3a-K3e against their plain versions at every case of
    ``APL_CASES``, two calls bit-identical; on the views of ``APL_UNALIGNED``
    the aligned inputs' bits; the refusals. Returns {kernel: max
    |difference|}."""
    from acf_tpu_torch.ops.apl_gen_fused import KERNELS, apl_gen_forward

    apl_chain = rank_cases().apl_chain  # K3a-K3e in order, or the plain versions alone
    names = list(APL_PRODUCTS)
    max_err = dict.fromkeys(names, 0.0)
    for b, d, num_items in APL_CASES:
        x = apl_inputs(dev, b, d, num_items, seed=15)
        before = [k.launches for k in KERNELS]
        got = apl_chain(x)
        again = apl_chain(x)
        torch.cuda.synchronize()
        label = f"K3 B={b} d={d} I={num_items}"
        check([k.launches - n for k, n in zip(KERNELS, before)] == [2] * 5,
              f"{label}: a launch counter did not move twice")
        for name in names:
            check(all(torch.equal(a, c) for a, c in zip(got[name], again[name])),
                  f"{label} {name}: two calls are not bit-identical")
        plain = apl_chain(x, up=got)
        parts = []
        for name in names:
            for i, (k, p) in enumerate(zip(got[name], plain[name])):
                check(k.shape == p.shape and bool(torch.isfinite(k).all()),
                      f"{label} {name}[{i}]: shape {tuple(k.shape)} or not finite")
                err = float((k - p).abs().max())
                scale = float(p.abs().max())
                max_err[name] = max(max_err[name], err)
                parts.append(f"{name}[{i}] {err:.2e} ({err / max(scale, 1e-30):.2e} of {scale:.3g})")
                check(err <= APL_TOL * scale,
                      f"{label} {name}[{i}]: max |kernel - plain| {err} > {APL_TOL} x {scale}")
        print(f"{label}: max |kernel - plain| " + "; ".join(parts)
              + "; bit-identical over two calls")
        check(not got["apl_grad"][0][0].any(), f"{label}: the pad item got a gradient")

    cases = rank_cases()
    for b, d, num_items in APL_UNALIGNED:
        x = apl_inputs(dev, b, d, num_items, seed=15)
        want = apl_chain(x)
        off = {k: one_float_off(v) for k, v in x.items()}
        before = [k.launches for k in KERNELS]
        got = {}
        for name, kernel in zip(names, KERNELS):  # K3b's outputs one element off too
            up = dict(got, apl_z=tuple(map(one_float_off, got["apl_z"]))) if got.get("apl_z") \
                else got
            got[name] = cases.apl_pass(name, off, up, kernel)
        torch.cuda.synchronize()
        label = f"K3 B={b} d={d} I={num_items} (every view one element off)"
        check([k.launches - n for k, n in zip(KERNELS, before)] == [1] * 5,
              f"{label}: a launch counter did not move once")
        check(all(v.data_ptr() % 16 for v in off.values()), f"{label}: a view is 16-byte aligned")
        for name in names:
            check(all(torch.equal(a, c) for a, c in zip(got[name], want[name])),
                  f"{label} {name}: not the aligned inputs' bits")
        print(f"{label}: every output bit-identical to the aligned inputs'")

    x = apl_inputs(dev, 8, 36, 300, seed=16)
    refused = (
        ("a float32 member", dict(x, member=x["member"].float())),
        ("a transposed table", dict(x, Qg=x["Qg"].T.contiguous().T)),
        ("I=1", dict(x, Qg=x["Qg"][:1].contiguous(), Qc=x["Qc"][:1].contiguous(),
                     member=x["member"][:, :1].contiguous(),
                     gnoise=x["gnoise"][:, :1].contiguous())),
    )
    for label, bad in refused:
        before = [k.launches for k in KERNELS]
        try:
            apl_gen_forward(bad["pu_g"], bad["Qg"], bad["pu_c"], bad["Qc"], bad["member"],
                            bad["nuniq"], bad["gnoise"], w=0.2, temperature=0.2)
        except ValueError as e:
            print(f"K3 {label}: raises ValueError as it should: {e}")
        else:
            fail(f"K3 {label}: apl_gen_forward did not raise")
        check([k.launches for k in KERNELS] == before, f"K3 {label}: launched anyway")
    return max_err


def apl_work(name, b, d, num_items):
    """(FLOP, bytes) one K3 call needs: its [B, d] x [d, I] products, each
    input read once and each output written once (member as uint8; the
    elementwise exp and log are not counted)."""
    flops = APL_PRODUCTS[name] * 2.0 * b * num_items * d
    tables = 4.0 * (b * d + num_items * d)  # one user block and one item table
    bi = float(b * num_items)
    nbytes = {
        "apl_stats1": tables + 4 * 2 * b,
        "apl_z": tables + bi + 4 * bi + 4 * bi + 4 * 6 * b,  # member, noise in; z out
        "apl_fake": tables + 4 * bi + 4 * 3 * b,
        "apl_bigr": 2 * tables + bi + 4 * bi + 4 * 9 * b,
        "apl_grad": 2 * tables + bi + 4 * bi + 4 * 10 * b + 4.0 * (num_items * d + b * d),
    }[name]
    return flops, nbytes


class GenStepThroughPlain:
    """Within the block, APL's generator step runs the plain passes on the
    card (the kernels' own plain versions, composed as the wrappers compose
    the kernels), for the step comparison."""

    def __enter__(self):
        from acf_tpu_torch.models import apl as apl_mod
        from acf_tpu_torch.ops import apl_gen_fused as ops

        def forward(pu_g, Qg, pu_c, Qc, member, nuniq, gnoise, *, w, temperature):
            m1, l1 = ops.apl_stats1_plain(pu_g, Qg)
            z, m2, l2 = ops.apl_z_plain(pu_g, Qg, member, nuniq, gnoise, m1, l1, w=w,
                                        temperature=temperature)
            fake = ops.apl_fake_plain(pu_c, Qc, z, m2, l2)
            return fake, (Qg, Qc, member, z, m1, l1, m2, l2, fake)

        def backward(pu_g, pu_c, nuniq, a, res, *, w, temperature):
            Qg, Qc, member, z, m1, l1, m2, l2, fake = res
            chain = (pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake)
            R = ops.apl_bigr_plain(*chain, w=w, temperature=temperature)
            dQ, dP = ops.apl_grad_plain(*chain, R, w=w, temperature=temperature)
            return dP, dQ

        self.mod = apl_mod
        self.saved = (apl_mod.apl_gen_forward, apl_mod.apl_gen_backward)
        apl_mod.apl_gen_forward, apl_mod.apl_gen_backward = forward, backward
        return self

    def __exit__(self, *exc):
        self.mod.apl_gen_forward, self.mod.apl_gen_backward = self.saved


def apl_step_batch(tr, data, seed):
    """One batch of the trainer's pairs, its histories and its Gumbel noise."""
    from acf_tpu_torch.models.apl import gumbel

    g = torch.Generator(device=tr.device).manual_seed(seed)
    idx = torch.randperm(data.num_pairs, generator=g, device=tr.device)[:TRAIN_BATCH]
    u, i = tr.dev["pairs_u"][idx], tr.dev["pairs_i"][idx]
    return u, i, tr.dev["hist"][u], gumbel(torch.rand(TRAIN_BATCH, data.num_items, generator=g,
                                                      device=tr.device))


def run_apl(dev, data):
    """Phase 16: the pretrained protocol at Video scale. MF-BPR pretrained
    one epoch (Adagrad(0.05, 0.1), the pair trainer), its tables handed to
    APL's generator, one APL epoch (every K3 kernel once per generator
    step) and its evaluation through K1, all counters read around it; one
    generator step through the kernels against the same step through the
    plain passes. Returns (trainer, launches by kernel name, epoch seconds)."""
    from acf_tpu_torch.models.apl import APL
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.ops.apl_gen_fused import KERNELS
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.train import TrainConfig, Trainer, adagrad, sgd

    cfg = TrainConfig(batch_size=TRAIN_BATCH, verbose=10 ** 9)
    t0 = time.perf_counter()
    pre = Trainer(MFBPR(data.num_users, data.num_items, D), data,
                  adagrad(0.05, initial_accumulator_value=0.1), cfg)
    pre_stats = pre.run_epoch()
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    bpr = pre.evaluate().at_k(10)
    check(all(math.isfinite(v) for v in pre_stats.values()), f"MF-BPR pretraining: {pre_stats}")
    print(f"apl: MF-BPR pretrained 1 epoch ({pre.num_batches} steps of {TRAIN_BATCH}, "
          f"Adagrad(0.05, 0.1)) in {pre_s:.2f} s: {pre_stats}; HR@10 {bpr[0]:.6f} "
          f"NDCG@10 {bpr[1]:.6f} AUC {bpr[2]:.6f}")

    model = APL(data.num_users, data.num_items, D)
    tr = Trainer(model, data, sgd(0.05), cfg)
    tr.params["g"] = {k: v.clone() for k, v in pre.params.items()}
    start = tr.evaluate().at_k(10)
    check(abs(start[1] - bpr[1]) < 1e-6, f"apl: start NDCG {start[1]} is not MF-BPR's {bpr[1]}")
    c_pad = tr.params["c"]["Q"][0].clone()
    p0 = {side: tr.params[side]["P"].clone() for side in ("g", "c")}
    tiles = math.ceil(len(tr.evaluator.users) / tr.evaluator.batch_users)

    for k in KERNELS:
        k.launches = 0
    rank_positions_dot.launches = 0
    t0 = time.perf_counter()
    stats = tr.run_epoch()  # the main path: an APL epoch ...
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    after = tr.evaluate().at_k(10)  # ... and its evaluation
    launches = {k.__name__: k.launches for k in KERNELS}
    k1 = rank_positions_dot.launches
    print(f"apl: one epoch of {tr.num_batches} critic and {tr.num_batches} generator steps "
          f"in {epoch_s:.2f} s: {stats}; after it HR@10 {after[0]:.6f} NDCG@10 {after[1]:.6f} "
          f"AUC {after[2]:.6f} (start NDCG@10 {start[1]:.6f} = MF-BPR's); launches "
          + ", ".join(f"{n} {c}" for n, c in launches.items()) + f", K1 {k1}")
    check(all(c == tr.num_batches for c in launches.values()),
          f"apl: K3 launches {launches}, not {tr.num_batches} each")
    check(k1 == tiles, f"apl: the evaluation launched K1 {k1} times for {tiles} tiles")
    check(all(math.isfinite(v) for v in stats.values()), f"apl: non-finite stats {stats}")
    check(all(math.isfinite(v) for v in after), f"apl: non-finite metrics {after}")
    pad_move = float((tr.params["c"]["Q"][0] - c_pad).abs().max())
    moved = {side: float((tr.params[side]["P"] - p0[side]).abs().max()) for side in p0}
    print(f"apl: the critic's pad row moved by {pad_move:.3e}; the players' user tables by "
          + ", ".join(f"{side} {v:.3e}" for side, v in moved.items()))
    check(all(v > 0 for v in moved.values()), f"apl: a player did not move {moved}")
    check(pad_move <= 1e-7, "apl: the critic's pad row moved (the fake one-hot leaks onto item 0)")

    u, i, hist_rows, gn = apl_step_batch(tr, data, seed=16)
    g, c = tr.params["g"], tr.params["c"]
    before = [k.launches for k in KERNELS]
    loss, grads = model.gen_step(g, c, u, i, hist_rows, gn)
    torch.cuda.synchronize()
    check([k.launches - n for k, n in zip(KERNELS, before)] == [1] * 5,
          "apl: one generator step did not launch each K3 kernel once")
    with GenStepThroughPlain():
        p_loss, p_grads = model.gen_step(g, c, u, i, hist_rows, gn)
    check([k.launches - n for k, n in zip(KERNELS, before)] == [1] * 5,
          "apl: the plain step launched a kernel")
    rel = abs(float(loss) - float(p_loss)) / max(abs(float(p_loss)), 1e-30)
    errs = {n: tree_err([grads[n]], [p_grads[n]]) for n in ("P", "Q")}
    print(f"apl generator step (B={TRAIN_BATCH}): loss {float(loss):.8f} vs plain "
          f"{float(p_loss):.8f} (rel {rel:.2e}); "
          + "; ".join(f"g{n} max |d| {e:.3e} ({r:.2e} of scale)" for n, (e, r) in errs.items()))
    check(rel <= 1e-5, f"apl: the generator loss differs from the plain step by {rel}")
    for n, (_, r) in errs.items():
        check(r <= APL_TOL, f"apl: g{n} differs from the plain step by {r} of scale")
    return tr, launches, epoch_s


def apl_timing(dev, tr, data, first_epoch_s, reps=2):
    """Phase 17: each K3 kernel alone at B=512, d=64, I=23,701 beside its
    plain version, one torch.matmul of its products and its bound; one
    generator and one critic step's device time; the APL epoch's seconds and
    examples/s. Returns {kernel: entry fields}."""
    from acf_tpu_torch.ops import apl_gen_fused as ops

    cases = rank_cases()
    b, d, num_items = APL_CASES[0]
    x = apl_inputs(dev, b, d, num_items, seed=17)
    got = cases.apl_chain(x)
    mark = len(EVENT_TIMED)
    matmul_ms = device_ms(lambda: torch.matmul(x["pu_g"], x["Qg"].T))
    matmul_timer = timer_since(mark)
    entries, chain_ms, bound_sum = {}, 0.0, 0.0
    for name in APL_PRODUCTS:
        kernel, plain = getattr(ops, name), getattr(ops, name + "_plain")
        mark = len(EVENT_TIMED)
        ms = device_ms(lambda: cases.apl_pass(name, x, got, kernel))
        plain_ms = device_ms(lambda: cases.apl_pass(name, x, got, plain), PLAIN_ITERS, 2)
        bound_ms, bound_by = bound(*apl_work(name, b, d, num_items))
        library_ms = APL_PRODUCTS[name] * matmul_ms
        chain_ms += ms
        bound_sum += bound_ms
        print(f"{name} device time at B={b} I={num_items} d={d}: kernel {ms:.4f} ms "
              f"({bound_ms / ms:.3f} of the bound), plain {plain_ms:.4f} ms, torch.matmul of "
              f"its {APL_PRODUCTS[name]} product(s) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})")
        timer = timer_since(mark) if matmul_timer == "profiler" else matmul_timer
        entries[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms, "timer": timer}
    fn_bound = max(4 * 2.0 * b * num_items * d / FP32_FLOPS,
                   (4.0 * (2 * b * num_items) + 4.0 * 2 * (b * d + num_items * d)
                    + b * num_items + 4.0 * b * num_items) / HBM_BYTES_PER_S) * 1e3
    print(f"K3 chain: {chain_ms:.4f} ms in all; bound of the chain as designed (the five "
          f"passes' bounds) {bound_sum:.4f} ms; bound of the chain as a function (4 products, "
          f"z written and read once, noise and member read once) {fn_bound:.4f} ms")

    model = tr.model
    u, i, hist_rows, gn = apl_step_batch(tr, data, seed=17)
    g, c = tr.params["g"], tr.params["c"]
    cu = torch.rand(TRAIN_BATCH, data.num_items, device=dev)

    def gen_step():
        with torch.no_grad():
            return model.gen_step(g, c, u, i, hist_rows, gn)

    def critic_step():
        return model.critic_step(c, {}, g, u, i, cu)

    for label, fn in (("apl generator step", gen_step), ("apl critic step", critic_step)):
        wall_s = best_wall_s(fn, reps=5)
        device_breakdown(label, fn, wall_s, top=8)
    launch_lines("apl generator step", gen_step)

    samples = [first_epoch_s]
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.run_epoch()  # ends in a host transfer of the epoch's stats
        samples.append(time.perf_counter() - t0)
    check(all(math.isfinite(v) for v in stats.values()), f"apl timing: non-finite stats {stats}")
    examples = tr.num_batches * TRAIN_BATCH
    print(f"apl epoch ({tr.num_batches} critic + {tr.num_batches} generator steps of "
          f"{TRAIN_BATCH}): samples " + ", ".join(f"{s:.4f}" for s in samples)
          + " s (the first is phase 16's epoch); "
          + ", ".join(f"{examples / s:.1f}" for s in samples) + " examples/s")
    return entries


# Phase 17's widths beside d = 64 at APL's geometry: `apl --d 50` (4-byte
# copies, zero tails), d = 52 (the same staged rows of 52 floats by 16-byte
# copies: what the 4-byte copies cost) and d = 256 (four k slices)
APL_TIMED_WIDTHS = (64, 52, 50, 256)


def apl_width_timing(dev):
    """Phase 17, the widths: each K3 pass (its merge included, by
    ``launches_ms``: the mean a launch of each) at B = 512, I = 23,701 and d
    in ``APL_TIMED_WIDTHS``, in one run, beside its plain version, one
    torch.matmul of its products and its bound at that d. Returns {d:
    {kernel: fields}}."""
    from acf_tpu_torch.ops import apl_gen_fused as ops
    from acf_tpu_torch.tools.k3_identity import PASS_KERNELS

    cases = rank_cases()
    b, num_items = BATCH_USERS, APL_CASES[0][2]
    out = {}
    for d in APL_TIMED_WIDTHS:
        x = apl_inputs(dev, b, d, num_items, seed=17)
        got = cases.apl_chain(x)
        mark = len(EVENT_TIMED)
        matmul_ms = device_ms(lambda: torch.matmul(x["pu_g"], x["Qg"].T))
        out[d] = {}
        for name in APL_PRODUCTS:
            kernel, plain = getattr(ops, name), getattr(ops, name + "_plain")
            ms = launches_ms(lambda: cases.apl_pass(name, x, got, kernel), PASS_KERNELS[name])
            plain_ms = device_ms(lambda: cases.apl_pass(name, x, got, plain), PLAIN_ITERS, 2)
            bound_ms, bound_by = bound(*apl_work(name, b, d, num_items))
            library_ms = APL_PRODUCTS[name] * matmul_ms
            out[d][name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": library_ms}
            print(f"{name} at B={b} I={num_items} d={d}: kernel {ms:.4f} ms a call (its "
                  f"merge included; {bound_ms / ms:.3f} of the bound), plain {plain_ms:.4f} ms, "
                  f"torch.matmul of its {APL_PRODUCTS[name]} product(s) {library_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
        for name in APL_PRODUCTS:
            out[d][name]["timer"] = timer_since(mark)
    print("K3 at d = 50 against d = 64, a call: " + ", ".join(
        f"{name} {out[50][name]['ms'] / out[64][name]['ms']:.3f}" for name in APL_PRODUCTS)
        + f" (50/64 = {50 / 64:.3f}); against d = 52: " + ", ".join(
        f"{name} {out[50][name]['ms'] / out[52][name]['ms']:.3f}" for name in APL_PRODUCTS)
        + "; at d = 256: " + ", ".join(
        f"{name} {out[256][name]['ms'] / out[64][name]['ms']:.3f}" for name in APL_PRODUCTS)
        + f" (256/64 = {256 / 64:.3f}); card {card_line()}")
    return out


def launch_lines(label, fn):
    """One call of ``fn`` under torch.profiler: every device event (kernel,
    copy, fill) on a line of its own in launch order, with its device time;
    then each merge of the partials (``stat_combine``, ``sum_combine``) alone,
    named by the K3 pass launched just before it."""
    launches = device_events(fn, in_order=True)
    if not launches:
        print(f"{label}: launches not measured (the profiler saw no device time)")
        return
    print(f"{label}: {len(launches)} device launches in launch order:")
    merges, last_pass = [], None
    for n, e in enumerate(launches):
        ms = e.device_time_total / 1e3
        note = ""
        if "stat_combine" in e.name or "sum_combine" in e.name:
            merges.append((last_pass, ms))
            note = f"  (the merge of {last_pass})"
        else:
            last_pass = next((k for kernel, k in APL_PASS_KERNELS.items()
                              if f"::{kernel}" in e.name), last_pass)
        print(f"  {n:3d} {ms:9.4f} ms {e.name[:100]}{note}")
    print(f"{label}: the merges, one launch each: "
          + ", ".join(f"{k} {ms:.4f}" for k, ms in merges)
          + f" ms ({sum(ms for _, ms in merges):.4f} ms in all)")


def apl_phases(dev, data):
    """Phases 15-17. Returns the five K3 entries of the kernels line."""
    max_err = check_apl_kernels(dev)
    lap("15")
    tr, launches, epoch_s = run_apl(dev, data)
    lap("16")
    timing = apl_timing(dev, tr, data, epoch_s)
    widths = apl_width_timing(dev)
    lap("17")
    return [{"name": name, "route": "cuda", "source": "acf_tpu_torch/csrc/apl_gen.cu",
             "replaces": f"acf_tpu/ops/apl_gen_fused.py:{APL_REPLACES[name]}",
             "launches": launches[name], "max_abs_err": max_err[name], **timing[name],
             **{f"at_d{d}": widths[d][name] for d in APL_TIMED_WIDTHS}}
            for name in APL_PRODUCTS]


# --- APR: MF-BPR's adversarial half of the main path ----------------------------

# The APR configuration of bench.py:66-85: MF-BPR d = 64, batch 512,
# Adagrad(0.05, initial_accumulator_value=0.1), then eps 0.5, reg_adv 1.
APR = dict(eps=0.5, reg_adv=1.0)
# Two computations of one APR step, by the max |a - b| over a tree (the P and
# Q gradients, or the update one Adagrad step makes) divided by the largest
# |b| entry: the closed form against autograd on the card, the card against
# the CPU on the same draws. Both run in f32 but sum duplicate rows in
# another order (the equality-matrix products against autograd's dense
# scatter; the card's index_add_ adds with atomics, in an order of its own),
# and FGSM normalizes each row's sum, so an ulp of a row's gradient turns its
# delta by ulp / |row|. 1e-5 is ~100 ulps of the tree's scale; a duplicate
# row left out of the sum, a reg term missing or a sign flipped moves 1e-2
# of it and more. An update is read back as new - old params, which
# resolves it only to an ulp of the param it was added to, so its bound adds
# one ulp of the largest param (PointwiseMF's mean loss moves params ~1e-2
# by updates ~1e-6). Losses to rtol 1e-5. Accuracies (f32 means of a sign
# over B pairs) may differ by 1/B: a pair whose scores tie within rounding
# counts on one side only.
APR_TOL = 1e-5
# Timed epochs after a warm-up: two in phases 19 and 23, one in 21 and 22,
# so that the run stays well inside its time limit as phases are added;
# medians are the benchmark's to take (ROADMAP item 7).
APR_EPOCHS = 2


def apr_draws(data, seed, dns=1, rounds=8):
    """One step's draws from ``seed``, on the CPU: pair indices [B] and
    negative candidates [R, B] ([dns, R, B] with DNS)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randperm(data.num_pairs, generator=g)[:TRAIN_BATCH]
    shape = (rounds, TRAIN_BATCH) if dns <= 1 else (dns, rounds, TRAIN_BATCH)
    return idx, torch.randint(1, data.num_items, shape, generator=g, dtype=torch.int32)


def apr_batch(tdata, idx, cands):
    """(users, pos, neg) of the drawn pairs on ``tdata``'s device."""
    from acf_tpu_torch.sampling import negatives_from_draws

    dev = tdata["pairs_u"].device
    idx = idx.to(dev)
    u, pos = tdata["pairs_u"][idx], tdata["pairs_i"][idx]
    return u, pos, negatives_from_draws(cands.to(dev), tdata["hist"][u])


def check_stats(label, got, ref):
    """Aux values of one step on two sides: losses to rtol 1e-5, accuracies
    within 1/B."""
    check(set(got) == set(ref), f"{label}: aux {sorted(got)} vs {sorted(ref)}")
    for k, v in ref.items():
        d = abs(float(got[k]) - float(v))
        if k.startswith("acc"):
            check(d <= 1.0 / TRAIN_BATCH + 1e-7, f"{label}: {k} {got[k]} vs {v}")
        else:
            check(math.isfinite(float(got[k])) and d <= 1e-5 * abs(float(v)),
                  f"{label}: {k} {got[k]} vs {v}")


def apr_step(model, params, tdata, idx, cands, noise=None):
    """One Adagrad(0.05, 0.1) step of ``model`` from fresh slots on the
    params' device: the pair epoch (``make_pair_epoch_fn``, one batch) with
    these draws injected; with ``noise`` (random mode), the loss the epoch
    differentiates at that noise. Returns ([update of P, of Q], stats)."""
    from acf_tpu_torch.train import adagrad
    from acf_tpu_torch.train.optim import grad_update
    from acf_tpu_torch.train.trainer import make_pair_epoch_fn

    opt = adagrad(0.05, initial_accumulator_value=0.1)
    dev = params["P"].device
    if noise is None:
        epoch = make_pair_epoch_fn(model, opt, TRAIN_BATCH, 1)
        new, _, stats = epoch(params, opt.init(params), tdata, None, idx.to(dev)[None],
                              cands.to(dev)[None])
    else:
        batch = apr_batch(tdata, idx, cands)
        noise = tuple(x.to(dev) for x in noise)
        new, _, _, aux = grad_update(opt, params, opt.init(params),
                                     lambda prm: model.loss(prm, batch, noise=noise))
        stats = {k: float(v.detach()) for k, v in aux.items()}
    return [(new[k] - params[k]).cpu() for k in ("P", "Q")], stats


def run_apr_fit_two_phase(data):
    """Phase 18, first part: ``fit_two_phase`` as the README's quick start
    runs it (one clean MF-BPR epoch, then one APR epoch with the Adagrad
    slots reset, an evaluation through K1 after each), the counters read
    around it. Returns (the trainer, K1's launches)."""
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.train import TrainConfig, adagrad, fit_two_phase
    from acf_tpu_torch.train import trainer as trainer_mod

    clean = MFBPR(data.num_users, data.num_items, D)
    adv = MFBPR(data.num_users, data.num_items, D, adversarial=True, **APR)
    closed = []
    real_closed = adv._apr_manual_grads

    def counted(*args):
        closed.append(1)
        return real_closed(*args)

    adv._apr_manual_grads = counted  # what adv.manual_grads hands the epoch
    stats, seen = [], {}
    Trainer = trainer_mod.Trainer
    real_run, real_switch = Trainer.run_epoch, Trainer.switch_model

    def run_epoch(self):
        stats.append(real_run(self))
        return stats[-1]

    def switch_model(self, model, reset_opt=True):
        real_switch(self, model, reset_opt)
        slots = self.opt_state["sum_of_squares"].values()
        seen.update(trainer=self, slots=(min(float(v.min()) for v in slots),
                                         max(float(v.max()) for v in slots)))

    writer = lines_writer()
    tiles = math.ceil(len(data.eval_users()) / BATCH_USERS)
    Trainer.run_epoch, Trainer.switch_model = run_epoch, switch_model
    try:
        rank_positions_dot.launches = 0
        t0 = time.perf_counter()
        best = fit_two_phase(clean, adv, data, adagrad(0.05, initial_accumulator_value=0.1),
                             TrainConfig(batch_size=TRAIN_BATCH, epochs=2, verbose=1),
                             adv_epoch=1, writer=writer)  # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = rank_positions_dot.launches
    finally:
        Trainer.run_epoch, Trainer.switch_model = real_run, real_switch
    tr = seen["trainer"]
    print(f"apr fit_two_phase: {tr.num_batches} steps of {TRAIN_BATCH} an epoch, {tiles} eval "
          f"tiles; {wall:.2f} s; K1 launches {k1}; closed-form steps {len(closed)}; slots after "
          f"the switch {seen['slots']}; best epoch {best['epoch']} NDCG@10 {best['ndcg']:.6f}")
    print(f"apr fit_two_phase epoch stats: {stats}")
    check(k1 == 2 * tiles, f"apr fit_two_phase: K1 launched {k1} times, not {2 * tiles}")
    check(len(closed) == tr.num_batches, f"apr fit_two_phase: {len(closed)} closed-form steps "
          f"in an epoch of {tr.num_batches}")
    check(all(abs(v - 0.1) < 1e-7 for v in seen["slots"]),
          f"apr fit_two_phase: the Adagrad slots were not reset at the switch {seen['slots']}")
    epochs = [ln for ln in writer.lines if ln.startswith("Epoch ") and "HR =" in ln]
    check(len(epochs) == 2 and not any("NaN" in ln for ln in writer.lines),
          "apr fit_two_phase: not two evaluated epochs")
    check(sum(ln.startswith("K = ") for ln in writer.lines) == 100,
          "apr fit_two_phase: no K = 1..100 sweep at the end")
    check(len(stats) == 2 and all(math.isfinite(v) for s in stats for v in s.values()),
          f"apr fit_two_phase: non-finite epoch stats {stats}")
    check(set(stats[0]) == {"loss", "acc"}
          and set(stats[1]) == {"loss", "acc", "loss_adv", "acc_adv"},
          "apr fit_two_phase: the phases did not run clean then APR")
    check(math.isfinite(best["ndcg"]) and best["epoch"] == 1, "apr fit_two_phase: no best epoch")
    return tr, k1


def check_apr_steps(tr):
    """Phase 18, second part, at the params ``fit_two_phase`` left: one APR
    step's closed form against autograd on the card and against the CPU's
    closed form on the same batch; one step each of APR, DNS (dns = 3, on
    APR), PGD (adv_steps = 3), random mode and PointwiseMF on the card
    against the same step on the CPU with the same draws. Returns the APR
    batch."""
    from acf_tpu_torch.models.mf import MFBPR, PointwiseMF, _trunc_normal

    data = tr.data
    U, I = data.num_users, data.num_items
    params = {k: v.detach() for k, v in tr.params.items()}
    cpu_params = {k: v.cpu() for k, v in params.items()}
    cpu_data = {k: v.cpu() for k, v in tr.dev.items()}
    apr = MFBPR(U, I, D, adversarial=True, **APR)

    idx, cands = apr_draws(data, seed=18)
    batch = apr_batch(tr.dev, idx, cands)
    users, pos, neg = batch
    items2 = torch.cat([pos, neg])
    both = len(set(pos.tolist()) & set(neg.tolist()))
    print(f"apr batch: {TRAIN_BATCH - int(torch.unique(users).numel())} duplicate user slots, "
          f"{2 * TRAIN_BATCH - int(torch.unique(items2).numel())} duplicate item slots of "
          f"{2 * TRAIN_BATCH}, {both} items both a positive and a negative")
    g_closed, aux_closed = apr.manual_grads(params, batch)
    prm = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, aux_auto = apr.loss(prm, batch)
    g_auto = torch.autograd.grad(loss, [prm["P"], prm["Q"]])
    aux_auto = {k: v.detach() for k, v in aux_auto.items()}
    g_cpu, aux_cpu = apr.manual_grads(cpu_params, tuple(x.cpu() for x in batch))
    closed = [g_closed["P"], g_closed["Q"]]
    e_auto = tree_err(closed, g_auto)
    e_cpu = tree_err([g.cpu() for g in closed], [g_cpu["P"], g_cpu["Q"]])
    print(f"apr closed form on the card: vs autograd max |d| {e_auto[0]:.3e} ({e_auto[1]:.2e} of "
          f"scale), vs the CPU's closed form {e_cpu[0]:.3e} ({e_cpu[1]:.2e}); aux "
          + ", ".join(f"{k} {float(v):.6f}/{float(aux_auto[k]):.6f}/{float(aux_cpu[k]):.6f}"
                      for k, v in sorted(aux_closed.items())) + " (closed/autograd/CPU)")
    check_stats("apr closed form vs autograd", aux_closed, aux_auto)
    check_stats("apr closed form vs the CPU", aux_closed, aux_cpu)
    for label, (_, r) in (("autograd", e_auto), ("the CPU", e_cpu)):
        check(r <= APR_TOL, f"apr closed form vs {label}: {r:.3e} of scale > {APR_TOL}")

    top = max(float(v.abs().max()) for v in cpu_params.values())
    g = torch.Generator().manual_seed(19)
    noise = (_trunc_normal(g, (U, D), 0.01), _trunc_normal(g, (I, D), 0.01))
    cases = (("apr", apr, 1, None),
             ("dns=3 apr", MFBPR(U, I, D, adversarial=True, dns=3, **APR), 3, None),
             ("adv_steps=3", MFBPR(U, I, D, adversarial=True, adv_steps=3, **APR), 1, None),
             ("random mode", MFBPR(U, I, D, adversarial=True, adv_mode="random", **APR), 1,
              noise),
             ("PointwiseMF", PointwiseMF(U, I, D), 1, None))
    for n, (label, model, dns, nz) in enumerate(cases):
        idx, cands = apr_draws(data, seed=20 + n, dns=dns)
        upd, stats = apr_step(model, params, tr.dev, idx, cands, nz)
        upd_cpu, stats_cpu = apr_step(model, cpu_params, cpu_data, idx, cands, nz)
        line = check_close(f"{label} step: the card's update vs the CPU's", upd, upd_cpu, top)
        print(f"{label} step, card vs CPU (same draws): update {line}; "
              + ", ".join(f"{k} {stats[k]:.6f}/{stats_cpu[k]:.6f}" for k in sorted(stats)))
        check_stats(f"{label} step", stats, stats_cpu)
    return batch


def check_fgsm_mf(tr, batch):
    """Phase 18: ``FGSMAdversarial(MFBPR)`` against the built-in APR's
    autograd step at reg = 0 on the card: the loss, aux and both
    gradients."""
    from acf_tpu_torch.adversarial import FGSMAdversarial
    from acf_tpu_torch.models.mf import MFBPR

    U, I = tr.data.num_users, tr.data.num_items
    out = {}
    for label, model in (("apr", MFBPR(U, I, D, adversarial=True, **APR)),
                         ("wrapper", FGSMAdversarial(U, I, D, base=MFBPR(U, I, D), **APR))):
        prm = {k: v.detach().clone().requires_grad_(True) for k, v in tr.params.items()}
        loss, aux = model.loss(prm, batch)
        out[label] = ({k: float(v.detach()) for k, v in aux.items()},
                      torch.autograd.grad(loss, [prm["P"], prm["Q"]]))
    err, r = tree_err(out["wrapper"][1], out["apr"][1])
    print(f"FGSMAdversarial(MFBPR) vs APR on the card: gradients max |d| {err:.3e} ({r:.2e} of "
          f"scale); " + ", ".join(f"{k} {v:.6f}/{out['apr'][0][k]:.6f}"
                                  for k, v in sorted(out["wrapper"][0].items())))
    check_stats("FGSMAdversarial(MFBPR) vs APR", out["wrapper"][0], out["apr"][0])
    check(r <= APR_TOL, f"FGSMAdversarial(MFBPR): gradients differ from APR's by {r:.3e}")


def drop_kink_units(params, x, ids, masks, keep):
    """Drops (in ``masks``, in place) every FFN unit of an unmasked row whose
    ReLU pre-activation lies within KINK of 0 in the plain forward, block by
    block, since a block's input depends on the masks before it. A dropped
    unit passes nothing forward or back on either side, so its gate cannot
    differ between them. Returns the count dropped."""
    from acf_tpu_torch.ops.sasrec_fused import _block, _input

    h = _input(params, x, ids, masks, keep)
    dropped = 0
    for i, blk in enumerate(params["blocks"]):
        bm = masks["blocks"][i]
        _, c = _block(blk, h, ids, 1, bm, keep)
        near = (c["z1"].abs() <= KINK) & ids[:, :, None]
        bm["f1"] &= ~near
        dropped += int(near.sum())
        h, _ = _block(blk, h, ids, 1, bm, keep)
    return dropped


@torch.no_grad()
def fgsm_sasrec_inputs(dev, data, base, plain, params, maxlen):
    """A batch and the dropout masks of the clean and the perturbed pass,
    with the rule of phases 12-13 for ReLU near 0: users near a kink in the
    linearization's forward (no dropout) get another user's rows; units near
    a kink in the clean training pass, and then in the perturbed pass (its
    inputs moved by the plain wrapper's deltas), are dropped. Returns
    (batch = (users, window, neg), masks, adv_masks, users replaced, units
    dropped)."""
    from acf_tpu_torch.sampling import sample_seq_window_batch
    from acf_tpu_torch.utils.tree import tree_leaves

    g = torch.Generator(device=dev).manual_seed(18)
    hist = torch.as_tensor(data.hist, device=dev)
    eligible = torch.as_tensor(np.nonzero(data.hist_len >= 2)[0].astype(np.int32), device=dev)
    users, window, neg = sample_seq_window_batch(g, hist, eligible, maxlen, data.num_items,
                                                 TRAIN_BATCH)
    masks = base._dropout_masks(g, TRAIN_BATCH, maxlen)
    adv_masks = base._dropout_masks(g, TRAIN_BATCH, maxlen)
    keep = 1.0 - base.dropout_rate
    scale = math.sqrt(D)
    near = near_kink_users(params, params["item_emb"][window[:, :-1]] * scale,
                           window[:, :-1] != 0, None, 1.0)
    ok = torch.nonzero(~near).flatten()
    rep = ok[torch.arange(int(near.sum()), device=dev) % len(ok)]
    for rows in (users, window, neg, *tree_leaves(masks), *tree_leaves(adv_masks)):
        rows[near] = rows[rep]
    seq = window[:, :-1]
    ids = seq != 0
    dropped = drop_kink_units(params, params["item_emb"][seq] * scale, ids, masks, keep)
    delta = plain.deltas(params, (users, seq, window[:, 1:], neg))
    dropped += drop_kink_units(params, (params["item_emb"] + delta["item_emb"])[seq] * scale,
                               ids, adv_masks, keep)
    return (users, window, neg), masks, adv_masks, int(near.sum()), dropped


class GradTap:
    """An optimizer that keeps the gradient tree the step hands it, then
    applies ``opt``'s update."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = grads
        return self.opt.update(grads, state, params)


def check_fgsm_sasrec(dev, data, maxlen=50):
    """Phase 18: one training step of ``FGSMAdversarial(SASRec)`` (d = 64,
    2 blocks, dropout 0.5) at maxlen 50 through the trainer's own step
    (``seq_train_step``, which takes the wrapper's ``loss`` on the expanded
    batch): K2a three times (the clean pass, the linearization, the
    perturbed pass) and K2b three times (the linearization's dx-only); its
    aux and every leaf of the gradient it hands the optimizer against the
    same step through the plain encoder."""
    from acf_tpu_torch.adversarial import FGSMAdversarial
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.ops.sasrec_fused import encoder_bwd, fused_encoder
    from acf_tpu_torch.train import adam
    from acf_tpu_torch.train.trainer import seq_train_step
    from acf_tpu_torch.utils.tree import tree_leaves

    base = SASRec(data.num_users, data.num_items, D, maxlen=maxlen)
    wrap = FGSMAdversarial(data.num_users, data.num_items, D, base=base, **APR)
    plain = FGSMAdversarial(data.num_users, data.num_items, D, base=plain_encoder_model(base),
                            **APR)
    params = base.init_params(torch.Generator(device=dev).manual_seed(18), device=dev)
    batch, masks, adv_masks, replaced, dropped = fgsm_sasrec_inputs(dev, data, base, plain,
                                                                    params, maxlen)

    def step(model):
        opt = GradTap(adam(1e-3))
        new, _, aux = seq_train_step(model, opt, params, opt.init(params), batch,
                                     masks=masks, adv_masks=adv_masks)
        check(all(bool(torch.isfinite(v).all()) for v in tree_leaves(new)),
              "FGSMAdversarial(SASRec): the step's params are not finite")
        return {k: float(v) for k, v in aux.items()}, tree_leaves(opt.grads)

    fused_encoder.launches = encoder_bwd.launches = 0
    aux, grads = step(wrap)  # the wrapper's step through the kernels
    torch.cuda.synchronize()
    k2a, k2b = fused_encoder.launches, encoder_bwd.launches
    p_aux, p_grads = step(plain)
    check((fused_encoder.launches, encoder_bwd.launches) == (k2a, k2b),
          "FGSMAdversarial(SASRec): the plain step launched a kernel")
    err, r = tree_err(grads, p_grads)
    rel = {k: abs(aux[k] - p_aux[k]) / abs(p_aux[k]) for k in ("loss", "loss_adv")}
    print(f"FGSMAdversarial(SASRec) step through seq_train_step (maxlen {maxlen}, "
          f"B={TRAIN_BATCH}): {replaced} users near a ReLU kink in the linearization replaced, "
          f"{dropped} units near one in the training passes dropped; K2a {k2a}, K2b {k2b} "
          "launches; aux "
          + ", ".join(f"{k} {v:.6f}/{p_aux[k]:.6f}" for k, v in sorted(aux.items()))
          + f" (loss rel {rel['loss']:.2e}, loss_adv rel {rel['loss_adv']:.2e}); every leaf of "
          f"the gradient handed to the optimizer max |d| {err:.3e} ({r:.2e} of scale)")
    check(k2a == 3 and k2b == 3, f"FGSMAdversarial(SASRec): K2a {k2a}, K2b {k2b}, not 3 and 3")
    check(all(math.isfinite(aux[k]) for k in aux), f"FGSMAdversarial(SASRec): aux {aux}")
    for k, v in rel.items():
        check(v <= 1e-5, f"FGSMAdversarial(SASRec): {k} rel {v}")
    check(r <= STEP_TOL, f"FGSMAdversarial(SASRec): gradients differ by {r:.3e} of scale")


def time_apr(data):
    """Phase 19: APR examples/s over ``APR_EPOCHS`` epochs after a warm-up
    epoch (host clock around ``Trainer.run_epoch``, which ends in a host
    transfer of the epoch's stats), every sample and their median; one
    step's wall time, device busy and idle time, launches and largest device
    operations, beside the card's name and power limit."""
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.sampling import sample_pair_epoch, uniform_negatives
    from acf_tpu_torch.train import TrainConfig, Trainer, adagrad
    from acf_tpu_torch.train.trainer import pair_train_step

    model = MFBPR(data.num_users, data.num_items, D, adversarial=True, **APR)
    tr = Trainer(model, data, adagrad(0.05, initial_accumulator_value=0.1),
                 TrainConfig(batch_size=TRAIN_BATCH, verbose=10 ** 9))
    tr.run_epoch()  # warm-up
    samples = []
    for _ in range(APR_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.run_epoch()
        samples.append(time.perf_counter() - t0)
    check(all(math.isfinite(v) for v in stats.values()), f"apr timing: non-finite stats {stats}")
    examples = tr.num_batches * TRAIN_BATCH
    median_s = sorted(samples)[len(samples) // 2]
    card = card_line()
    print(f"apr timing ({card}): {tr.num_batches} steps of {TRAIN_BATCH} an epoch; median "
          f"{examples / median_s:.1f} examples/s; samples "
          + ", ".join(f"{examples / s:.1f}" for s in samples)
          + " examples/s (" + ", ".join(f"{s:.4f}" for s in samples) + " s); timer: host clock "
          "around Trainer.run_epoch, which ends in a host transfer")

    batches = sample_pair_epoch(tr.generator, data.num_pairs, TRAIN_BATCH, tr.num_batches)
    step_n = [0]

    def step():
        idx = batches[step_n[0] % tr.num_batches]
        step_n[0] += 1
        u, pos = tr.dev["pairs_u"][idx], tr.dev["pairs_i"][idx]
        neg = uniform_negatives(tr.generator, tr.dev["hist"][u], data.num_items)
        tr.params, tr.opt_state, _ = pair_train_step(model, tr.optimizer, tr.params, tr.opt_state,
                                                     (u, pos, neg), tr.generator,
                                                     model.manual_grads)

    step_s = median_s / tr.num_batches
    alone_s = best_wall_s(step, reps=20)
    print(f"apr step ({card}): {step_s * 1e3:.4f} ms in the median epoch over its steps, "
          f"{alone_s * 1e3:.4f} ms alone (best of 20, each ending in a synchronize)")
    launches = device_events(step, in_order=True)
    print(f"apr step: {len(launches)} device launches" if launches
          else "apr step: launches not measured (the profiler saw no device time)")
    device_breakdown(f"apr step ({card})", step, step_s, top=10)


def apr_phases(dev, data):
    """Phases 18-19 on the ml-1m-shaped set. Returns K1's launches in APR's
    fit_two_phase."""
    tr, k1 = run_apr_fit_two_phase(data)
    batch = check_apr_steps(tr)
    check_fgsm_mf(tr, batch)
    check_fgsm_sasrec(dev, data)
    lap("18")
    time_apr(data)
    lap("19")
    return k1


# --- The command line and the popularity adversaries ----------------------------

# The popularity adversaries' configuration of the CLI (acf_tpu/cli/main.py:
# 214-230): Adam(0.001) for the recommender and the discriminators, w 0.001,
# pp 0.2; d = 64, batch 512 on the Video file.
POP_MODELS = ("amf", "abpr", "aneumf")
POP_EPOCHS = 1  # timed epochs (see APR_EPOCHS)
# The zoo's CLI runs on the Video file: (model, epochs, flags); Caser under
# --fgsm one clean and one adversarial epoch.
ZOO_CLI = (("gru4rec", 1, ["--maxlen", "8"]), ("dream", 1, ["--maxlen", "8"]),
           ("dream-tf", 1, ["--maxlen", "8"]), ("caser", 1, ["--maxlen", "5"]),
           ("drcf", 1, ["--maxlen", "5"]), ("dsin", 1, ["--maxlen", "8", "--sess_count", "2"]),
           ("caser", 2, ["--maxlen", "5", "--fgsm", "--adv_epoch", "1"]))


def write_reference_files(root: Path, seed: int = 20):
    """The reference's file formats from a seed, drawn like ``bench.py:41-57``
    (uniform users and items, rows in chronological order): ``Video.txt``
    (31,000 users x 23,700 items, 300,000 rows of ``uid iid``) and
    ``ml-1m.train.rating`` (6,040 x 3,706, 994,000 rows of ``uid iid rating
    timestamp``) with ``ml-1m.test.rating`` (one later row a user). Returns
    the frames as written."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    video = pd.DataFrame({"uid": rng.integers(1, VIDEO_USERS + 1, VIDEO_INTERACTIONS),
                          "iid": rng.integers(1, VIDEO_ITEMS + 1, VIDEO_INTERACTIONS)})
    video.to_csv(root / "Video.txt", sep=" ", header=False, index=False)
    n = ML1M_INTERACTIONS
    train = pd.DataFrame({"uid": rng.integers(1, ML1M_USERS + 1, n),
                          "iid": rng.integers(1, ML1M_ITEMS + 1, n),
                          "rating": rng.integers(1, 6, n),
                          "timestamp": 978_300_000 + np.arange(n, dtype=np.int64)})
    test = pd.DataFrame({"uid": np.arange(1, ML1M_USERS + 1),
                         "iid": rng.integers(1, ML1M_ITEMS + 1, ML1M_USERS),
                         "rating": rng.integers(1, 6, ML1M_USERS),
                         "timestamp": 978_300_000 + n + np.arange(ML1M_USERS, dtype=np.int64)})
    for name, df in (("train", train), ("test", test)):
        df.to_csv(root / f"ml-1m.{name}.rating", sep="\t", header=False, index=False)
    return video, pd.concat([train, test], ignore_index=True)


def expected_counts(df):
    """The ``Load data done`` numbers of a frame, by pandas alone: users and
    items (each with the pad id 0), unique train pairs (every row but each
    user's last, in time order) and test users."""
    if "timestamp" in df:
        df = df.sort_values(["uid", "timestamp"], kind="stable")
    else:
        df = df.sort_values("uid", kind="stable")
    last = ~df["uid"].duplicated(keep="last")
    train = df[~last].drop_duplicates(["uid", "iid"])
    return (df["uid"].nunique() + 1, df["iid"].nunique() + 1, len(train),
            int(last.sum()))


def check_parsers(root: Path):
    """The native parser against pandas on both files, each timed."""
    import pandas as pd

    from acf_tpu_torch.data import native_io

    for path, parse, cols, sep in (
            (root / "Video.txt", native_io.parse_two_col, ["uid", "iid"], " "),
            (root / "ml-1m.train.rating", native_io.parse_rating,
             ["uid", "iid", "rating", "timestamp"], "\t")):
        t0 = time.perf_counter()
        got = parse(str(path))
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        df = pd.read_csv(path, sep=sep, names=cols)
        pandas_s = time.perf_counter() - t0
        check(got is not None and len(got) == len(cols), f"native parser refused {path.name}")
        for a, col in zip(got, cols):
            check(np.array_equal(a, df[col].to_numpy()),
                  f"native parser and pandas differ on {path.name} column {col}")
        print(f"parse {path.name} ({len(df)} rows): native {native_s:.4f} s, pandas "
              f"{pandas_s:.4f} s ({pandas_s / native_s:.1f}x), equal on every column "
              "(host clock)")


def run_cli(root: Path, argv, counts, epochs, counter=None, tag=None):
    """``acf_tpu_torch.cli.main.main`` in-process on the files under ``root``
    (its echo of the log kept off the terminal; its outputs under
    ``out/<tag>``, by default the model and its mode flags), the .out file
    checked: the ``Load data done`` line with ``counts``, one evaluated line
    an epoch and the ``End.`` line. Returns (seconds, launches of
    ``counter`` in the run, the last trainer the run fitted)."""
    import contextlib
    import io

    from acf_tpu_torch.cli.main import main as cli_main
    from acf_tpu_torch.train import Trainer

    opath = root / "out" / (tag or "_".join([argv[1]] + [a.lstrip("-") for a in argv if a in (
        "--fgsm", "--sparse", "--irgan_pair", "--mesh")]))
    fitted, real_fit = [], Trainer.fit

    def fit(self, *args, **kwargs):
        fitted.append(self)
        return real_fit(self, *args, **kwargs)

    if counter is not None:
        counter.launches = 0
    Trainer.fit = fit
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            best = cli_main([*argv, "--path", str(root), "--opath", f"{opath}/"])  # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.fit = real_fit
    launches = counter.launches if counter is not None else None
    outs = sorted(opath.glob("*.out"))
    check(len(outs) == 1, f"cli {argv}: {len(outs)} .out files")
    lines = outs[0].read_text().splitlines()
    want = "Load data done. #user=%d, #item=%d, #train=%d, #test=%d" % counts
    epoch_lines = [ln for ln in lines if ln.startswith("Epoch ") and "HR =" in ln]
    print(f"cli {' '.join(argv)}: {wall:.2f} s (host clock, data loading included); "
          + (f"K1 launches {launches}; " if counter is not None else "")
          + f"best epoch {best['epoch']} NDCG@10 {best['ndcg']:.6f}")
    for ln in [lines[0], *epoch_lines, lines[-1]]:
        print(f"  {ln}")
    check(lines[0] == want, f"cli {argv}: {lines[0]!r}, expected {want!r}")
    check(len(epoch_lines) == epochs and not any("NaN" in ln for ln in lines),
          f"cli {argv}: {len(epoch_lines)} evaluated epochs, expected {epochs}")
    check(lines[-1].startswith("End. Best Iteration ") and math.isfinite(best["ndcg"]),
          f"cli {argv}: no End. line")
    check(sum(ln.startswith("K = ") for ln in lines) == 100, f"cli {argv}: no K sweep")
    check(any(f.suffix == ".hr" for f in opath.iterdir()), f"cli {argv}: no .hr file")
    return wall, launches, fitted[-1]


def cli_runs(root: Path, video, ml1m):
    """Phase 20, the CLI: APR on the ml-1m files (2 epochs, the adversarial
    phase from epoch 1), then AMF, AMF2, ABPR and ANeuMF one epoch each on
    the Video file, then the zoo's runs (``ZOO_CLI``), K1 counted around
    each. Returns (K1's launches by run, the trainers of the APR run and of
    the Video runs by model)."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot

    common = ["--d", str(D), "--bs", str(TRAIN_BATCH)]
    counts = {"ml-1m": expected_counts(ml1m), "video": expected_counts(video)}
    tiles = {k: math.ceil(c[3] / BATCH_USERS) for k, c in counts.items()}
    k1, trainers = {}, {}
    _, k1["apr_ml1m"], trainers["apr"] = run_cli(
        root, ["--model", "apr", "--data", "ml-1m", "--epochs", "2", "--adv_epoch", "1",
               *common], counts["ml-1m"], 2, rank_positions_dot)
    check(k1["apr_ml1m"] == 2 * tiles["ml-1m"],
          f"cli apr: K1 launched {k1['apr_ml1m']} times, not {2 * tiles['ml-1m']}")
    for model in ("amf", "amf2", "abpr", "aneumf"):
        wall, n, tr = run_cli(root, ["--model", model, "--data", "video", "--epochs", "1",
                                     *common], counts["video"], 1, rank_positions_dot)
        tr.cli_s = wall
        trainers[model] = tr
        want = 0 if model == "aneumf" else tiles["video"]  # ANeuMF evaluates densely
        check(n == want, f"cli {model}: K1 launched {n} times, not {want}")
        k1[f"{model}_video"] = n
    for model, epochs, extra in ZOO_CLI:
        _, n, _ = run_cli(root, ["--model", model, "--data", "video", "--epochs", str(epochs),
                                 *extra, *common], counts["video"], epochs, rank_positions_dot)
        want = 0 if model in ("drcf", "dsin") else epochs * tiles["video"]  # dense: DRCF, DSIN
        check(n == want, f"cli {model} {extra}: K1 launched {n} times, not {want}")
        k1[f"{model}{'_fgsm' if '--fgsm' in extra else ''}_video"] = n
    return k1, trainers


# --- the SASRec paper's shapes through the command line: phase 28 -------------

WIDTH_D = 50        # d of the SASRec paper (Kang & McAuley, ICDM 2018) and of Caser's
WIDTH_MAXLEN = 200  # the SASRec paper's ML-1M window
# The kernels of one call, as a profile names them: K2a; K2b (either form)
# and its reduction
K2A_KERNEL = ("sasrec_encoder_fwd_kernel",)
K2B_KERNELS = ("sasrec_encoder_bwd_kernel", "sasrec_encoder_bwd_reduce")


# `apl` through the command line at widths d % 4 != 0 (phase 28): (d, extra
# flags) of each run, one epoch on phase 20's Video file
APL_CLI_WIDTHS = ((50, []), (50, ["--mesh", "1x1"]), (10, []))


def apl_cli_widths(root, video):
    """Phase 28, APL: ``apl --d 50``, the same under ``--mesh 1x1`` (NCCL,
    one rank: the trainer's mesh path) and ``apl --d 10``, one epoch each on
    phase 20's Video file through the command line, each run's counters
    zeroed just before it and read just after: every K3 kernel once a
    generator step, K1 once a tile of the evaluation, the .out file
    (``run_cli``), and the mesh run's params and evaluation bit-equal to the
    run without it. Returns launches by run."""
    import torch.distributed as dist

    from acf_tpu_torch.ops.apl_gen_fused import KERNELS
    from acf_tpu_torch.ops.ranking import rank_positions_dot

    counts = expected_counts(video)
    tiles = math.ceil(counts[3] / BATCH_USERS)
    launched, runs = {}, {}
    for d, extra in APL_CLI_WIDTHS:
        label = " ".join([f"apl --d {d}", *extra])
        for k in KERNELS:
            k.launches = 0
        rank_positions_dot.launches = 0
        _, _, runs[label] = run_cli(root, ["--model", "apl", "--data", "video", "--epochs", "1",
                                           "--d", str(d), "--bs", str(TRAIN_BATCH), *extra],
                                    counts, 1, tag=f"apl_d{d}{'_mesh' if extra else ''}")
        launched[label] = {**{k.__name__: k.launches for k in KERNELS},
                           "k1": rank_positions_dot.launches}
        steps = runs[label].num_batches
        print(f"cli {label}: launches {launched[label]} ({steps} generator steps, "
              f"{tiles} evaluation tiles)")
        check(all(launched[label][k.__name__] == steps for k in KERNELS)
              and launched[label]["k1"] == tiles,
              f"cli {label}: launches {launched[label]}, not {steps} of each K3 kernel and "
              f"{tiles} of K1")
    one, mesh = runs["apl --d 50"], runs["apl --d 50 --mesh 1x1"]
    check(mesh.mesh is not None and not dist.is_initialized(),
          "cli apl --d 50 --mesh 1x1: no mesh, or its group outlived the run")
    keys = [(side, n) for side in sorted(one.params) for n in sorted(one.params[side])]
    same = all(torch.equal(mesh.params[s][n], one.params[s][n]) for s, n in keys)
    res, ref = mesh.best["result"], one.best["result"]
    equal_eval = np.array_equal(res.hr, ref.hr) and np.array_equal(res.ndcg, ref.ndcg)
    print(f"cli apl --d 50 --mesh 1x1: params bit-equal to the run without --mesh {same}; "
          f"per-user HR and NDCG@1..100 equal {equal_eval}")
    check(same and equal_eval, "cli apl --d 50 --mesh 1x1: not bit-equal to one device")
    return launched


def widths_phase(dev, root, ml1m, video):
    """Phase 28, on phase 20's files: ``asasrec --d 50 --maxlen 200`` (the
    SASRec paper's ML-1M shape; one clean and one adversarial epoch) and
    ``bpr --d 50`` (one epoch) through the command line on the ml-1m files,
    each run's counters zeroed just before it and read just after; each
    run's evaluation at the params it trained against the dense path; one
    clean and one asasrec step at that shape through the kernels against the
    plain step; APL at d = 50 and 10 on the Video file (``apl_cli_widths``);
    then the new forms' times. Returns (launches by run, the wide form's
    kernels entry without its max error)."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.ops.sasrec_fused import encoder_bwd, fused_encoder

    counts = expected_counts(ml1m)
    tiles = math.ceil(counts[3] / BATCH_USERS)
    common = ["--data", "ml-1m", "--d", str(WIDTH_D), "--bs", str(TRAIN_BATCH)]
    runs, launched = {}, {}
    for name, argv, epochs in (
            ("asasrec", ["--model", "asasrec", "--maxlen", str(WIDTH_MAXLEN), "--epochs", "2",
                         "--adv_epoch", "1"], 2),
            ("bpr", ["--model", "bpr", "--epochs", "1"], 1)):
        fused_encoder.launches = encoder_bwd.launches = encoder_bwd.wide_launches = 0
        rank_positions_dot.launches = 0
        _, _, runs[name] = run_cli(root, [*argv, *common], counts, epochs)  # the main path
        launched[name] = {"k2a": fused_encoder.launches, "k2b": encoder_bwd.launches,
                          "k2b_wide": encoder_bwd.wide_launches,
                          "k1": rank_positions_dot.launches}
        print(f"cli {name} d={WIDTH_D}: launches {launched[name]}")
    a, b = launched["asasrec"], launched["bpr"]
    check(a["k2a"] > 0 and a["k2b_wide"] > 0 and a["k2b"] == 0 and a["k1"] == 2 * tiles,
          f"cli asasrec d={WIDTH_D} maxlen {WIDTH_MAXLEN}: launches {a}: K2a, the wide K2b "
          f"(and not the tile form) and K1 ({2 * tiles}) must launch")
    check(b["k1"] == tiles and b["k2a"] == b["k2b"] == b["k2b_wide"] == 0,
          f"cli bpr d={WIDTH_D}: launches {b}, K1 must launch {tiles} times")
    for name, tr in runs.items():
        res = tr.evaluator.evaluate_model(tr.model, tr.params)
        check_against_dense(f"cli {name} d={WIDTH_D} (trained params)", tr.evaluator, tr.model,
                            tr.params, res)
    check_training_step(dev, runs["asasrec"].data, maxlen=WIDTH_MAXLEN, d=WIDTH_D)
    launched.update(apl_cli_widths(root, video))
    return launched, widths_timing(dev)


def widths_timing(dev, b=TRAIN_BATCH):
    """Phase 28's timing, beside each kernel's plain version and bound: K1
    off its TMA path (d = 50 at the ml-1m evaluation tile, and d = 64 with
    the users and table one float off 16-byte alignment); K2a at d = 50, T =
    200 in both forms; K2b's wide form at T = 200, d = 50 and 64, and at
    T = 50, d = 50 (which d % 4 != 0 sends to it), full and dx-only, B =
    512, two blocks, with dropout masks; each kernel by its mean time a
    launch (``launches_ms``). Returns the wide form's entry at T = 200, d =
    50 (the command line's shape), the other two shapes' times under
    ``at_d64_t200`` and ``at_d50_t50``."""
    from acf_tpu_torch.ops.sasrec_fused import (
        _bwd_wide_layout, encoder_bwd, encoder_bwd_math, encoder_fwd,
    )

    g = torch.Generator(device=dev).manual_seed(28)
    mark = len(EVENT_TIMED)
    for d, offset in ((WIDTH_D, False), (D, True)):
        u, E, _, _, gt = k1_any_inputs(g, dev, BATCH_USERS, ML1M_ITEMS + 1, d, offset)
        th = (u * E[gt.long()]).sum(dim=1).contiguous()
        k1_line(f"(no TMA: d={d}{', views one float off' if offset else ''})", u, E, th, gt)
    entry = None
    for d, t in ((WIDTH_D, WIDTH_MAXLEN), (D, WIDTH_MAXLEN), (WIDTH_D, 50)):
        model, params = sasrec_model(dev, 100, 1000, t, d=d)
        keep = 1.0 - model.dropout_rate
        x, mask = k2a_inputs(dev, params, b, t, d, g, padded=False)
        masks = model._dropout_masks(g, b, t)
        cot = torch.randn(b, t, d, generator=g, device=dev)
        (ff, fb), (bf, bb) = k2_train_work(b, t, d, model.num_blocks)
        if (d, t) == (WIDTH_D, WIDTH_MAXLEN):
            inf_ms = launches_ms(lambda: encoder_fwd(params, x, mask), K2A_KERNEL, 20)
            fwd_ms = launches_ms(lambda: encoder_fwd(params, x, mask, masks, keep, save=True),
                                 K2A_KERNEL, 20)
            inf_bound, _ = bound(*k2a_work(b, t, d, model.num_blocks))
            fwd_bound, _ = bound(ff, fb)
            print(f"K2a at B={b} T={t} d={d} (4-byte copies): inference {inf_ms:.4f} ms (bound "
                  f"{inf_bound:.4f}), training form {fwd_ms:.4f} ms (bound {fwd_bound:.4f})")
        _, saved = encoder_fwd(params, x, mask, masks, keep, save=True)
        mark_bwd = len(EVENT_TIMED)
        ms = launches_ms(lambda: encoder_bwd(params, x, mask, cot, saved, masks, keep),
                         K2B_KERNELS)
        dx_ms = launches_ms(lambda: encoder_bwd(params, x, mask, cot, saved, masks, keep,
                                                weight_grads=False), K2B_KERNELS[:1])
        plain_ms = device_ms(lambda: encoder_bwd_math(params, x, mask, masks, keep, cot),
                             PLAIN_ITERS, 2)
        bound_ms, bound_by = bound(bf, bb)
        print(f"K2b wide form at B={b} T={t} d={d} (clusters of {_bwd_wide_layout(t, d)[0]}): "
              f"{ms:.4f} ms ({bound_ms / ms:.4f} of the bound), dx-only {dx_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {bf / 1e9:.3f} GFLOP, "
              f"{bb / 1e6:.2f} MB)")
        times = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "dx_only_ms": dx_ms}
        if (d, t) == (WIDTH_D, WIDTH_MAXLEN):
            entry = {**times, "library_ms": None, "timer": timer_since(mark_bwd)}
        else:
            entry[f"at_d{d}_t{t}"] = times
    entry["timer_k1_k2a"] = timer_since(mark)
    return entry


# --- SASRec's bfloat16 training path (--train_dtype bfloat16): phase 29 --------

# K2a's and K2b's bfloat16 forms against their plain bfloat16 versions, by
# tree_err: max |kernel - plain| over a tree divided by its largest |plain|
# entry. Both round the same float32 values to bfloat16 and sum the products
# in float32, in different orders, so a value a float32 ulp apart now and
# then rounds to the neighbouring bfloat16 value (2^-8 of it) on one side;
# and a weight gradient, rounded once at the end on both sides, may land one
# bfloat16 ulp apart. 2^-6 is four bfloat16 ulps of the tree's scale: room
# for a few such flips carried through two blocks, far below a wrong mask,
# residual or transposed weight (O(1) of the scale).
BF16_TOL = 2 ** -6
# The max gate cannot tell the bfloat16 function from the float32 one: the
# float32 form's outputs lie only a few times farther off in max (a sum of
# many small roundings, where a flip is one larger one). The mean tells
# them apart: each tree's mean |kernel - plain bfloat16| must stay below
# this share of its mean |kernel - plain float32| (the kernel in float32
# would sit far above 1, a rounding point missed at its share of the
# whole rounding). Flips, more of them the more operands a window rounds,
# keep it at 3e-4 to 0.11 on an H100 (T = 8 to 200).
BF16_MEAN_RATIO = 0.25
# Phase 29's kernel checks shift conv1's bias by this much, so that no FFN
# unit lies near ReLU's kink: there a flip of one bfloat16 operand moves a
# pre-activation by ~1e-3, enough to gate the unit open on one side and shut
# on the other (both correct subgradients), and at B = 512 some unit of
# nearly every user lies that close to 0, so phase 12's way (leave those
# users out) would leave none in. The gate itself is the float32 form's
# code, checked in phase 12.
BF16_CONV1_BIAS = 6.0
# (d, T) of phase 29's checks at B = 512: K2b's tile form at the windows of
# phases 12 and 14, its wide form at the SASRec paper's shape
BF16_CASES = ((D, 8), (D, 50), (WIDTH_D, WIDTH_MAXLEN))


def k2_counts():
    """(K2a float32, K2a bfloat16, K2b tile float32, wide float32, tile
    bfloat16, wide bfloat16) launch counters."""
    from acf_tpu_torch.ops.sasrec_fused import encoder_bwd, fused_encoder

    return (fused_encoder.launches, fused_encoder.bf16_launches, encoder_bwd.launches,
            encoder_bwd.wide_launches, encoder_bwd.bf16_launches, encoder_bwd.wide_bf16_launches)


def zero_counts():
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.ops.sasrec_fused import encoder_bwd, fused_encoder

    fused_encoder.launches = fused_encoder.bf16_launches = rank_positions_dot.launches = 0
    encoder_bwd.launches = encoder_bwd.wide_launches = 0
    encoder_bwd.bf16_launches = encoder_bwd.wide_bf16_launches = 0


def check_bf16_kernels(dev):
    """Phase 29, first part: at each of BF16_CASES (B = 512, jittered
    weights, dropout masks, padded windows), K2a's bfloat16 form in its
    inference and training forms and its saved block inputs, and K2b's in
    its full and dx-only modes, against their plain bfloat16 versions
    (``fused_encoder_plain``, ``_block``, ``encoder_bwd_math`` with dtype
    bfloat16); two calls bit-identical; only the bfloat16 forms' counters
    move. Returns the max |kernel - plain| of K2a, of K2b's tile form and of
    its wide form."""
    from acf_tpu_torch.ops.sasrec_fused import (
        _block, _bwd_form, _flat_leaves, _input, compute_rounding, encoder_bwd, encoder_bwd_math,
        encoder_fwd, fused_encoder_plain,
    )

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(29)
    max_err = {"fwd": 0.0, "tile": 0.0, "wide": 0.0}
    for d, t in BF16_CASES:
        model, params = sasrec_model(dev, 100, 1000, t, d=d, jitter=True)
        for blk in params["blocks"]:
            blk["conv1"]["b"] += BF16_CONV1_BIAS
        keep, b = 1.0 - model.dropout_rate, TRAIN_BATCH
        x, mask = k2a_inputs(dev, params, b, t, d, g)
        masks = model._dropout_masks(g, b, t)
        cot = torch.randn(b, t, d, generator=g, device=dev)
        form = _bwd_form(t, d)
        label = f"bf16 d={d} T={t} B={b} (K2b {form} form)"
        before = k2_counts()
        inf = encoder_fwd(params, x, mask, dtype=bf16)[0]
        out, saved = encoder_fwd(params, x, mask, masks, keep, save=True, dtype=bf16)
        out2, saved2 = encoder_fwd(params, x, mask, masks, keep, save=True, dtype=bf16)
        dx, grads = encoder_bwd(params, x, mask, cot, saved, masks, keep, dtype=bf16)
        dx2, grads2 = encoder_bwd(params, x, mask, cot, saved, masks, keep, dtype=bf16)
        dx_only, none = encoder_bwd(params, x, mask, cot, saved, masks, keep, weight_grads=False,
                                    dtype=bf16)
        torch.cuda.synchronize()
        moved = tuple(a - c for a, c in zip(k2_counts(), before))
        want = (0, 3, 0, 0, 3, 0) if form == "tile" else (0, 3, 0, 0, 0, 3)
        check(moved == want, f"{label}: the counters moved {moved}, not {want}")
        leaves = [grads["pos_emb"], *_flat_leaves(grads)]
        leaves2 = [grads2["pos_emb"], *_flat_leaves(grads2)]
        check(torch.equal(out, out2) and torch.equal(saved, saved2) and torch.equal(dx, dx2)
              and all(torch.equal(a, c) for a, c in zip(leaves, leaves2)),
              f"{label}: two calls are not bit-identical")
        check(none is None and torch.equal(dx_only, dx), f"{label}: the dx-only mode differs")
        check(all(bool(torch.isfinite(v).all()) for v in (inf, out, dx, *leaves)),
              f"{label}: not finite")
        r = compute_rounding(bf16)
        h, blocks_in = _input(params, x, mask, masks, keep), []
        for i, blk in enumerate(params["blocks"]):
            blocks_in.append(h)
            h, _ = _block(blk, h, mask, 1, masks["blocks"][i], keep, r)
        # each tree's plain bfloat16 and plain float32 versions
        refs = {}
        for dt in (bf16, None):
            m_dx, m_grads = encoder_bwd_math(params, x, mask, masks, keep, cot, dtype=dt)
            refs[dt] = {"K2a inference": [fused_encoder_plain(params, x, mask, dtype=dt)],
                        "K2a training": [fused_encoder_plain(params, x, mask, masks, keep, dt)],
                        "K2b dx": [m_dx],
                        "K2b leaves": [m_grads["pos_emb"], *_flat_leaves(m_grads)]}
        got = {"K2a inference": [inf], "K2a training": [out], "K2b dx": [dx],
               "K2b leaves": leaves}
        errs = {k: tree_err(v, refs[bf16][k]) for k, v in got.items()}
        errs["saved block inputs"] = tree_err([saved], [torch.stack([*blocks_in, h])])
        ratios = {k: mean_abs(v, refs[bf16][k]) / mean_abs(v, refs[None][k])
                  for k, v in got.items()}
        print(f"{label}: " + "; ".join(f"{k} max |d| {e:.3e} ({s:.2e} of scale)"
                                       for k, (e, s) in errs.items())
              + f" (gate {BF16_TOL:.2e} of scale); mean |kernel - plain bfloat16| over mean "
              "|kernel - plain float32|: " + ", ".join(f"{k} {v:.2e}" for k, v in ratios.items())
              + f" (at most {BF16_MEAN_RATIO}); bit-identical over two calls; dx-only equal")
        for k, (_, s) in errs.items():
            check(s <= BF16_TOL, f"{label}: {k} {s:.3e} of scale > {BF16_TOL}")
        for k, v in ratios.items():
            check(v <= BF16_MEAN_RATIO, f"{label}: {k} lies {v:.3e} as far from its plain "
                  f"bfloat16 version as from the float32 one (> {BF16_MEAN_RATIO})")
        max_err["fwd"] = max(max_err["fwd"], *(errs[k][0] for k in ("K2a inference",
                                                                     "K2a training")))
        max_err[form] = max(max_err[form], errs["K2b dx"][0], errs["K2b leaves"][0])
    return max_err


def bf16_bound(dense_flops, attn_flops, t, nbytes):
    """(ms, "operations" or "bytes"): the products at the bf16 tensor-core
    peak, the attention's at it from T = 32 on (float32 below), against the
    bytes."""
    ops_s = dense_flops / BF16_FLOPS + attn_flops / (BF16_FLOPS if t >= 32 else FP32_FLOPS)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def bf16_timing(dev, b=TRAIN_BATCH, rounds=2):
    """Phase 29's timing at B = 512 with dropout masks, at (d, T) = (64, 50)
    (K2b's tile form) and (50, 200) (its wide form): K2a's inference and
    training forms and K2b full and dx-only, each in its float32 and its
    bfloat16 form in turns (float32, bfloat16, ``rounds`` times), by their
    mean time a launch (``launches_ms``), beside the bfloat16 forms' plain
    versions and bounds (``bf16_bound``). Returns the bfloat16 entries of
    the kernels line (without launches and errors)."""
    from acf_tpu_torch.ops.sasrec_fused import (
        encoder_bwd, encoder_bwd_math, encoder_fwd, fused_encoder_plain,
    )

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(290)
    entries = {}
    for d, t in ((D, 50), (WIDTH_D, WIDTH_MAXLEN)):
        model, params = sasrec_model(dev, 100, 1000, t, d=d)
        nb, keep = model.num_blocks, 1.0 - model.dropout_rate
        x, mask = k2a_inputs(dev, params, b, t, d, g, padded=False)
        masks = model._dropout_masks(g, b, t)
        cot = torch.randn(b, t, d, generator=g, device=dev)
        saved = {dt: encoder_fwd(params, x, mask, masks, keep, save=True, dtype=dt)[1]
                 for dt in (None, bf16)}
        calls = {"K2a inference": (lambda dt: encoder_fwd(params, x, mask, dtype=dt), K2A_KERNEL),
                 "K2a training": (lambda dt: encoder_fwd(params, x, mask, masks, keep, save=True,
                                                         dtype=dt), K2A_KERNEL),
                 "K2b": (lambda dt: encoder_bwd(params, x, mask, cot, saved[dt], masks, keep,
                                                dtype=dt), K2B_KERNELS),
                 "K2b dx-only": (lambda dt: encoder_bwd(params, x, mask, cot, saved[dt], masks,
                                                        keep, weight_grads=False, dtype=dt),
                                 K2B_KERNELS[:1])}
        mark = len(EVENT_TIMED)
        times = {(k, dt): [] for k in calls for dt in ("float32", "bfloat16")}
        for _ in range(rounds):
            for k, (fn, names) in calls.items():
                for dt, dtype in (("float32", None), ("bfloat16", bf16)):
                    times[k, dt].append(launches_ms(lambda: fn(dtype), names, 10))
        plain = {"K2a inference": device_ms(lambda: fused_encoder_plain(params, x, mask,
                                                                        dtype=bf16),
                                            PLAIN_ITERS, 2),
                 "K2a training": device_ms(lambda: fused_encoder_plain(params, x, mask, masks,
                                                                       keep, bf16),
                                           PLAIN_ITERS, 2),
                 "K2b": device_ms(lambda: encoder_bwd_math(params, x, mask, masks, keep, cot,
                                                           dtype=bf16), PLAIN_ITERS, 2)}
        timer = timer_since(mark)
        (_, fb), (_, bb) = k2_train_work(b, t, d, nb)
        rows = b * t * nb
        bounds = {"K2a inference": bf16_bound(rows * 10 * d * d, rows * 2 * (t + 1) * d, t,
                                              k2a_work(b, t, d, nb)[1]),
                  "K2a training": bf16_bound(rows * 10 * d * d, rows * 2 * (t + 1) * d, t, fb),
                  "K2b": bf16_bound(rows * 20 * d * d, rows * 4 * (t + 1) * d, t, bb)}
        mean = {key: sum(v) / len(v) for key, v in times.items()}
        for k in calls:
            extra = (f", plain {plain[k]:.4f} ms, bound {bounds[k][0]:.4f} ms ({bounds[k][1]})"
                     if k in plain else "")
            print(f"{k} at B={b} T={t} d={d}, in turns: float32 "
                  + ", ".join(f"{v:.4f}" for v in times[k, "float32"]) + " ms; bfloat16 "
                  + ", ".join(f"{v:.4f}" for v in times[k, "bfloat16"])
                  + f" ms (bfloat16 / float32 {mean[k, 'bfloat16'] / mean[k, 'float32']:.3f})"
                  + extra)
        entries[d, t] = {
            "fwd": {"ms": mean["K2a training", "bfloat16"], "plain_ms": plain["K2a training"],
                    "bound_ms": bounds["K2a training"][0],
                    "bound_by": bounds["K2a training"][1], "library_ms": None,
                    "f32_ms": mean["K2a training", "float32"],
                    "inference_ms": mean["K2a inference", "bfloat16"],
                    "inference_f32_ms": mean["K2a inference", "float32"],
                    "inference_plain_ms": plain["K2a inference"], "timer": timer},
            "bwd": {"ms": mean["K2b", "bfloat16"], "plain_ms": plain["K2b"],
                    "bound_ms": bounds["K2b"][0], "bound_by": bounds["K2b"][1],
                    "library_ms": None, "f32_ms": mean["K2b", "float32"],
                    "dx_only_ms": mean["K2b dx-only", "bfloat16"],
                    "dx_only_f32_ms": mean["K2b dx-only", "float32"], "timer": timer}}
    tile, wide = entries[D, 50], entries[WIDTH_D, WIDTH_MAXLEN]
    tile["fwd"]["t200_d50"] = {k: wide["fwd"][k] for k in ("ms", "f32_ms", "plain_ms",
                                                            "bound_ms", "inference_ms")}
    return tile["fwd"], tile["bwd"], wide["bwd"]


def bf16_cli(root, ml1m):
    """Phase 29's command lines on phase 20's ml-1m files, each with every
    counter zeroed just before it and read just after: ``asasrec
    --train_dtype bfloat16 --maxlen 50`` (d = 64; one clean and one
    adversarial epoch, an evaluation after each), the same at the SASRec
    paper's shape (``--d 50 --maxlen 200``) and the first again under
    ``--mesh 1x1`` (NCCL, a group of one process). Training must run
    through the bfloat16 forms alone (K2a 3 and K2b 3 launches a step over
    the two epochs, K2b in its tile form at maxlen 50 and its wide form at
    200), each evaluation through the float32 K2a and K1 (one launch a
    user tile each); the first run's evaluation at its trained params
    against the dense path; the mesh run's params against the first's.
    Returns the launches by run."""
    import torch.distributed as dist

    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.train.checkpoint import _flatten_with_names

    counts = expected_counts(ml1m)
    tiles = math.ceil(counts[3] / BATCH_USERS)
    common = ["--model", "asasrec", "--train_dtype", "bfloat16", "--data", "ml-1m", "--epochs",
              "2", "--adv_epoch", "1", "--bs", str(TRAIN_BATCH)]
    runs, launched = {}, {}
    for name, extra in (("asasrec", ["--d", str(D), "--maxlen", "50"]),
                        ("asasrec_d50_t200", ["--d", str(WIDTH_D), "--maxlen",
                                              str(WIDTH_MAXLEN)]),
                        ("asasrec_mesh_1x1", ["--d", str(D), "--maxlen", "50", "--mesh", "1x1"])):
        zero_counts()
        _, _, tr = run_cli(root, [*common, *extra], counts, 2, tag=f"bf16_{name}")  # the main path
        runs[name] = tr
        k2a32, k2a16, tile32, wide32, tile16, wide16 = k2_counts()
        launched[name] = {"k2a": k2a32, "k2a_bf16": k2a16, "k2b": tile32, "k2b_wide": wide32,
                          "k2b_bf16": tile16, "k2b_wide_bf16": wide16,
                          "k1": rank_positions_dot.launches}
        steps = 3 * tr.num_batches  # a step of the clean epoch, two of the adversarial one
        wide = name == "asasrec_d50_t200"
        print(f"cli {name} (--train_dtype bfloat16): {tr.num_batches} steps an epoch; "
              f"launches {launched[name]}")
        check(tr.model.train_dtype == "bfloat16", f"cli {name}: the model is not bfloat16")
        check((k2a16, wide16 if wide else tile16, tile16 if wide else wide16) == (steps, steps, 0)
              and (k2a32, tile32, wide32) == (2 * tiles, 0, 0)
              and rank_positions_dot.launches == 2 * tiles,
              f"cli {name}: launches {launched[name]}: training must run the bfloat16 forms "
              f"({steps} each), evaluation the float32 K2a and K1 ({2 * tiles} each)")
    tr = runs["asasrec"]
    res = tr.evaluator.evaluate_model(tr.model, tr.params)
    check_against_dense("cli asasrec bf16 (trained params)", tr.evaluator, tr.model, tr.params,
                        res)
    mesh = runs["asasrec_mesh_1x1"]
    check(mesh.mesh is not None and mesh.mesh.shape == {"data": 1, "model": 1}
          and not dist.is_initialized(), "cli --mesh 1x1: no mesh, or its group outlived the run")
    got, ref = dict(_flatten_with_names(mesh.params)), dict(_flatten_with_names(tr.params))
    names = sorted(ref)
    err, rel = tree_err([got[n] for n in names], [ref[n] for n in names])
    same = all(torch.equal(got[n], ref[n]) for n in names)
    print(f"cli asasrec --train_dtype bfloat16 --mesh 1x1 (NCCL): params against the "
          f"single-device run max |d| {err:.3e} ({rel:.2e} of scale), bit-equal {same}")
    check(rel <= STEP_TOL, f"cli --mesh 1x1 bf16: params differ from one device by {rel:.3e}")
    return launched


def bf16_phase(dev, root, ml1m):
    """Phase 29 on phase 20's files: the bfloat16 forms against their plain
    versions, their times beside the float32 forms', and the command
    line's bfloat16 runs. Returns (the launches by run, the kernels line's
    entries for K2a's, K2b's tile form's and its wide form's bfloat16
    forms)."""
    err = check_bf16_kernels(dev)
    fwd, bwd, wide = bf16_timing(dev)
    launched = bf16_cli(root, ml1m)
    main, paper = launched["asasrec"], launched["asasrec_d50_t200"]
    fwd.update(name="sasrec_encoder_fwd_bf16", launches=main["k2a_bf16"], max_abs_err=err["fwd"],
               launches_d50_t200=paper["k2a_bf16"],
               launches_mesh=launched["asasrec_mesh_1x1"]["k2a_bf16"])
    bwd.update(name="sasrec_encoder_bwd_bf16", launches=main["k2b_bf16"],
               max_abs_err=err["tile"], launches_mesh=launched["asasrec_mesh_1x1"]["k2b_bf16"])
    wide.update(name="sasrec_encoder_bwd_wide_bf16", launches=paper["k2b_wide_bf16"],
                max_abs_err=err["wide"])
    entries = []
    for e, source, line in ((fwd, "sasrec_encoder_fwd_bf16.cu", 225),
                            (bwd, "sasrec_encoder_bwd_bf16.cu", 236),
                            (wide, "sasrec_encoder_bwd_bf16.cu", 236)):
        entries.append({"name": e.pop("name"), "route": "cuda",
                        "source": f"acf_tpu_torch/csrc/{source}",
                        "replaces": f"acf_tpu/ops/sasrec_fused.py:{line}", **e})
    return launched, entries


def pop_draws(tr, seed):
    """One step's draws on the CPU: pair indices [1, B], negative candidates
    [1, R, B] and the index draws into the four pools ([1, B] for the
    discriminators, [1, B // 2] for the recommender)."""
    from acf_tpu_torch.adversarial.popularity import ADV_DRAWS, POOL_DRAWS

    g = torch.Generator().manual_seed(seed)
    idx = torch.randperm(tr.data.num_pairs, generator=g)[:TRAIN_BATCH][None]
    cands = torch.randint(1, tr.data.num_items, (1, 8, TRAIN_BATCH), generator=g,
                          dtype=torch.int32)
    draws = {name: torch.randint(0, tr.dev[pool].shape[0],
                                 (1, TRAIN_BATCH if (name, pool) in POOL_DRAWS else
                                  TRAIN_BATCH // 2), generator=g)
             for name, pool in POOL_DRAWS + ADV_DRAWS}
    return idx, cands, draws


def check_pop_step(label, tr, seed):
    """One step of the trainer's model on the card and on the CPU from the
    trainer's params and Adam states, with the same injected draws: every
    leaf's update (both players) within APR_TOL of the update's scale plus an
    ulp of the largest param, the stats as phase 18 holds them."""
    from acf_tpu_torch.utils.tree import tree_leaves, tree_map

    idx, cands, draws = pop_draws(tr, seed)
    out = {}
    for side, dev in (("card", tr.device), ("cpu", torch.device("cpu"))):
        params = tree_map(lambda x: x.detach().to(dev), tr.params)
        opt_state = tree_map(lambda x: x.to(dev), tr.opt_state)
        data = {k: v.to(dev) for k, v in tr.dev.items()}
        epoch = tr.model.make_epoch_fn(tr.optimizer, TRAIN_BATCH, 1, data)
        new, _, stats = epoch(params, opt_state, data, None, idx.to(dev), cands.to(dev),
                              {k: v.to(dev) for k, v in draws.items()})
        out[side] = ([(a - b).cpu() for a, b in zip(tree_leaves(new), tree_leaves(params))],
                     stats, max(float(x.abs().max()) for x in tree_leaves(params)))
    (upd, stats, top), (upd_cpu, stats_cpu, _) = out["card"], out["cpu"]
    line = check_close(f"{label} step: the card's update vs the CPU's", upd, upd_cpu, top)
    print(f"{label} step, card vs CPU (same params, Adam states and draws): update {line} over "
          f"{len(upd)} leaves; "
          + ", ".join(f"{k} {stats[k]:.6f}/{stats_cpu[k]:.6f}" for k in sorted(stats)))
    check_stats(f"{label} step", stats, stats_cpu)


def time_own_epochs(label, tr, epochs, warm_up):
    """Examples/s of ``epochs`` epochs of a model that brings its own epoch
    (host clock around ``Trainer.run_epoch``, every sample and the median;
    ``warm_up`` says which epoch warmed it up); one step of that epoch (a
    batch of its pairs, the other draws from the trainer's generator): its
    wall time alone, launches, device busy and idle time and largest device
    operations."""
    from acf_tpu_torch.sampling import sample_pair_epoch

    samples = []
    for _ in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.run_epoch()
        samples.append(time.perf_counter() - t0)
    check(all(math.isfinite(v) for v in stats.values()), f"{label} timing: stats {stats}")
    examples = tr.num_batches * TRAIN_BATCH
    median_s = sorted(samples)[len(samples) // 2]
    card = card_line()
    print(f"{label} timing ({card}): {tr.num_batches} steps of {TRAIN_BATCH} an epoch; median "
          f"{examples / median_s:.1f} examples/s; samples "
          + ", ".join(f"{examples / s:.1f}" for s in samples)
          + f" examples/s ({', '.join(f'{s:.4f}' for s in samples)} s; the warm-up was "
          f"{warm_up}); timer: host clock around Trainer.run_epoch, which ends in a host "
          "transfer")
    epoch = tr.model.make_epoch_fn(tr.optimizer, TRAIN_BATCH, 1, tr.dev)
    batches = sample_pair_epoch(tr.generator, tr.data.num_pairs, TRAIN_BATCH, tr.num_batches)
    step_n = [0]

    def step():
        idx = batches[step_n[0] % tr.num_batches][None]
        step_n[0] += 1
        tr.params, tr.opt_state, _ = epoch(tr.params, tr.opt_state, tr.dev, tr.generator, idx)

    step_s = median_s / tr.num_batches
    alone_s = best_wall_s(step, reps=20)
    print(f"{label} step ({card}): {step_s * 1e3:.4f} ms in the median epoch over its steps, "
          f"{alone_s * 1e3:.4f} ms alone (best of 20, each a one-batch epoch ending in a host "
          "transfer of its stats and a synchronize)")
    launches = device_events(step, in_order=True)
    print(f"{label} step: {len(launches)} device launches" if launches
          else f"{label} step: launches not measured (the profiler saw no device time)")
    device_breakdown(f"{label} step ({card})", step, step_s, top=8)


def time_neumf_eval(tr):
    """Phase 21: the Video-scale NeuMF evaluation (dense: every user tile of
    128 scores the whole catalog through the tower in chunks of 4,096 items),
    its seconds (host clock, one run after phase 20's) and the device's busy
    time in it."""
    ev = tr.evaluator
    users, items = len(ev.users), tr.data.num_items
    t0 = time.perf_counter()
    res = tr.evaluate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(np.isfinite(res.hr).all() and res.hr.shape == (users, 100),
          "aneumf evaluation: not finite or the wrong shape")
    d = D
    flop = 2.0 * users * items * (2 * d * 2 * d + 2 * d * d + 2 * d)
    print(f"aneumf evaluation ({card_line()}): {users} users x {items} items in tiles of "
          f"{ev.batch_users}: {wall:.4f} s (host clock); the tower's products {flop:.3e} FLOP, "
          f"{flop / FP32_FLOPS:.4f} s at the card's float32 peak")
    device_breakdown("aneumf evaluation", tr.evaluate, wall, top=8)


def cli_phases(dev):
    """Phases 20-21, and 28 and 29 on phase 20's files before phase 21.
    Returns (K1's launches in the CLI runs, by run; the APR run's trainer;
    phase 28's launches and the wide form's entry; phase 29's launches and
    the bfloat16 forms' entries)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        video, ml1m = write_reference_files(root)
        print(f"reference files written in {time.perf_counter() - t0:.2f} s: Video.txt "
              f"{len(video)} rows, ml-1m.*.rating {len(ml1m)} rows")
        check_parsers(root)
        k1, trainers = cli_runs(root, video, ml1m)
        for n, name in enumerate(POP_MODELS):
            check_pop_step(name, trainers[name], seed=200 + n)
        lap("20")
        widths = widths_phase(dev, root, ml1m, video)
        lap("28")
        bf16 = bf16_phase(dev, root, ml1m)
        lap("29")
    for name in POP_MODELS:
        tr = trainers[name]
        time_own_epochs(name, tr, POP_EPOCHS, f"the CLI run's epoch, {tr.cli_s:.2f} s with its "
                        "loading and evaluation")
    time_neumf_eval(trainers["aneumf"])
    lap("21")
    return k1, trainers["apr"], widths, bf16

# --- the sequence zoo: phase 22 --------------------------------------------------

# The zoo at its full width (scripts/zoo_video.py:35-66,89): d = 64, batch 512,
# Adam(1e-3) (DSIN Adam(1e-4)), maxlen 8 for GRU4Rec and DREAM, 5 for Caser
# and DRCF, DSIN as 2 sessions of 4 items, on the Video-shaped set.
ZOO_EPOCHS = 1  # timed epochs (see APR_EPOCHS)
# One step on the card against the same step on the CPU from the same params
# and draws: the loss to rtol 1e-5 and the accuracies within 1/B
# (``check_stats``), every gradient leaf by the max |d| over the tree over its
# largest entry. Both sides are f32 and sum in their own orders (the
# recurrences' products, the in-batch [T, B, B] logits, the embedding
# gathers' backward scatters); 1e-5 is ~100 ulps of the tree's scale, where a
# missing term or a wrong mask moves 1e-3 and more. Rows holding a ReLU input
# within KINK of 0 (relative to that input's largest entry) in the CPU forward
# are replaced by other rows first, as phases 13 and 18 do: their gating may
# differ between the two sides.
ZOO_TOL = 1e-5
ZOO_SLOTS = 512
ZOO_EVENTS = 8


def zoo_models(data):
    """(label, model, optimizer) of every configuration phase 22 drives."""
    from acf_tpu_torch.adversarial import FGSMAdversarial
    from acf_tpu_torch.models.caser import Caser
    from acf_tpu_torch.models.dream import DREAM
    from acf_tpu_torch.models.drcf import DRCF
    from acf_tpu_torch.models.dsin import DSIN
    from acf_tpu_torch.models.gru4rec import GRU4Rec
    from acf_tpu_torch.train import adam

    U, I = data.num_users, data.num_items
    return [
        ("gru4rec-bpr", GRU4Rec(U, I, D, maxlen=8), adam(1e-3)),
        ("gru4rec-top1", GRU4Rec(U, I, D, maxlen=8, loss_type="top1"), adam(1e-3)),
        ("gru4rec-ce", GRU4Rec(U, I, D, maxlen=8, loss_type="ce"), adam(1e-3)),
        ("dream", DREAM(U, I, D, maxlen=8), adam(1e-3)),
        ("caser", Caser(U, I, D, maxlen=5), adam(1e-3)),
        ("drcf", DRCF(U, I, D, maxlen=5), adam(1e-3)),
        ("dsin", DSIN(U, I, D, sess_count=2, sess_len=4), adam(1e-4)),
        ("dsin-bi", DSIN(U, I, D, sess_count=2, sess_len=4, bi_evolution=True), adam(1e-4)),
        ("fgsm-gru4rec", FGSMAdversarial(U, I, D, base=GRU4Rec(U, I, D, maxlen=8), **APR),
         adam(1e-3)),
        ("fgsm-caser", FGSMAdversarial(U, I, D, base=Caser(U, I, D, maxlen=5), **APR),
         adam(1e-3)),
    ]


def zoo_batch(tr, seed):
    """One training batch of the trainer's model as its epoch draws it,
    drawn on the CPU from ``seed``: Caser's windows with ``target_len``
    uniform negatives, or the sequence sampler's window; and the dropout
    masks of a base that draws them (the perturbed pass's too under the
    wrapper). Returns (batch, masks kwargs)."""
    from acf_tpu_torch.sampling import sample_seq_window_batch, uniform_negatives

    model = tr.model
    g = torch.Generator().manual_seed(seed)
    hist = tr.dev["hist"].cpu()
    if hasattr(model, "make_epoch_fn"):
        idx = torch.randperm(tr.dev["win_seq"].shape[0], generator=g)[:TRAIN_BATCH]
        users, seq, pos = (tr.dev[k].cpu()[idx] for k in ("win_user", "win_seq", "win_pos"))
        neg = torch.stack([uniform_negatives(g, hist[users], model.num_items)
                           for _ in range(model.target_len)], dim=1)
        batch = (users, seq, pos, neg)
    else:
        users, window, neg = sample_seq_window_batch(g, hist, tr.dev["eligible"].cpu(),
                                                     model.maxlen, model.num_items, TRAIN_BATCH)
        batch = (users, window[:, :-1], window[:, 1:], neg)
    base = getattr(model, "base", model)
    kw = {}
    if hasattr(base, "dropout_masks"):
        kw["masks"] = base.dropout_masks(g, batch)
        if base is not model:
            kw["adv_masks"] = base.dropout_masks(g, batch)
    return batch, kw


def relu_kink_rows(fn, b):
    """[b] bool: the rows (leading dim b) of the inputs of ``torch.relu`` in
    one call of ``fn`` on the CPU that hold an entry within KINK of 0,
    relative to that input's largest |entry|."""
    near = torch.zeros(b, dtype=torch.bool)
    real = torch.relu

    def relu(x):
        if x.dim() >= 1 and x.shape[0] == b:
            a = x.detach().abs()
            near.logical_or_((a <= KINK * a.max()).reshape(b, -1).any(dim=1))
        return real(x)

    torch.relu = relu
    try:
        fn()
    finally:
        torch.relu = real
    return near


def zoo_grads(model, params, batch, kw):
    """(aux floats, gradient leaves) of ``model.loss`` at ``params``."""
    from acf_tpu_torch.utils.tree import tree_leaves, tree_map

    prm = tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
    loss, aux = model.loss(prm, batch, None, **kw)
    leaves = tree_leaves(prm)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return ({k: float(v.detach()) for k, v in aux.items()},
            [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)])


def replace_kink_rows(label, fn, batch, kw):
    """Rows of the batch (and of its masks) holding a ReLU input near a kink
    in ``fn(batch, kw)`` on the CPU, replaced in place by clean rows, once;
    none may remain. Returns how many were replaced."""
    from acf_tpu_torch.utils.tree import tree_leaves

    near = relu_kink_rows(lambda: fn(batch, kw), TRAIN_BATCH)
    n = int(near.sum())
    if n:
        ok = torch.nonzero(~near).flatten()
        check(len(ok) >= TRAIN_BATCH // 2, f"{label} step: {n} rows near a ReLU kink")
        rep = ok[torch.arange(n) % len(ok)]
        for rows in (*batch, *tree_leaves(kw)):
            rows[near] = rows[rep]
        check(not bool(relu_kink_rows(lambda: fn(batch, kw), TRAIN_BATCH).any()),
              f"{label} step: rows near a ReLU kink remain after their replacement")
    return n


def check_zoo_step(label, tr, seed):
    """One training step's loss and gradient on the card against the CPU,
    from the trainer's params and one batch and mask draw, rows near a ReLU
    kink replaced. Under the FGSM wrapper the deltas are held against the
    CPU's first (to 1e-4 of eps: a row's direction turns by its rounding over
    its norm, which the H100 runs put below 1e-6 of eps), then the CPU's
    deltas go to both sides, so the step compares at the same perturbed point
    and its rows are replaced once for good."""
    from acf_tpu_torch.utils.tree import tree_map

    model, dev = tr.model, tr.device
    cpu_params = tree_map(lambda x: x.detach().cpu(), tr.params)
    batch, kw = zoo_batch(tr, seed)

    def on_card(b, k):
        return tuple(x.to(dev) for x in b), tree_map(lambda x: x.to(dev), k)

    replaced = 0
    wrapped = hasattr(model, "base")
    if wrapped:
        clean_kw = {"masks": kw["masks"]} if "masks" in kw else {}
        replaced += replace_kink_rows(
            label, lambda b, k: zoo_grads(model.base, cpu_params, b, clean_kw), batch, kw)
        delta = model.deltas(cpu_params, batch, None, kw.get("masks"))
        b_card, k_card = on_card(batch, kw)
        delta_card = model.deltas(tr.params, b_card, None, k_card.get("masks"))
        d_err = max(float((delta_card[n].cpu() - v).abs().max()) for n, v in delta.items())
        print(f"{label} deltas ({', '.join(delta)}), card vs CPU: max |d| {d_err:.3e} "
              f"({d_err / model.eps:.2e} of eps)")
        check(d_err <= 1e-4 * model.eps, f"{label}: the card's deltas differ by {d_err:.3e}")
        model.deltas = lambda params, *a, **k: {n: v.to(params[n].device)
                                                for n, v in delta.items()}
    try:
        replaced += replace_kink_rows(label, lambda b, k: zoo_grads(model, cpu_params, b, k),
                                      batch, kw)
        aux, grads = zoo_grads(model, tr.params, *on_card(batch, kw))
        aux_cpu, grads_cpu = zoo_grads(model, cpu_params, batch, kw)
    finally:
        if wrapped:
            del model.deltas
    err, r = tree_err([g.cpu() for g in grads], grads_cpu)
    print(f"{label} step, card vs CPU (same params, batch and masks"
          + (", the CPU's deltas" if wrapped else "")
          + f"; {replaced} rows near a ReLU kink replaced): gradient max |d| {err:.3e} "
          f"({r:.2e} of the tree's scale, tolerance {ZOO_TOL:.0e}) over {len(grads)} leaves; "
          + ", ".join(f"{k} {aux[k]:.6f}/{aux_cpu[k]:.6f}" for k in sorted(aux)))
    check_stats(f"{label} step", aux, aux_cpu)
    check(r <= ZOO_TOL, f"{label} step: the card's gradient differs from the CPU's by {r:.3e} "
          f"of the tree's scale > {ZOO_TOL}")


def zoo_dense_flop(model, users, items):
    """FLOP of a dense evaluation's products (DRCF's MLP, DSIN's activation
    pools and DNN) over ``users`` x ``items`` pairs."""
    d = model.dim
    if type(model).__name__ == "DRCF":
        h = d // 2
        macs = (1 + 3 * h) * 3 * d + 3 * d * 2 * d + 2 * d * d + 2 * d + 1 + 2 * (d + h)
    else:
        macs = 4 * model.sess_count * d + 4 * d * d + 2 * d * d + d
    return 2.0 * users * items * macs


def zoo_eval(label, tr):
    """``evaluate_model`` on the trainer's params, K1 counted around it: one
    launch a user tile for the factored models (checked against the dense
    path), none for DRCF and DSIN (dense). Returns K1's launches."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot

    ev, model, params = tr.evaluator, tr.model, tr.params
    tiles = math.ceil(len(ev.users) / ev.batch_users)
    factored = model.factored_scorer() is not None
    rank_positions_dot.launches = 0
    t0 = time.perf_counter()
    res = ev.evaluate_model(model, params)  # the main path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rank_positions_dot.launches
    want = tiles if factored else 0
    check(launches == want, f"{label} evaluation: K1 launched {launches} times, not {want}")
    check(np.isfinite(res.hr).all() and res.hr.shape == (len(ev.users), ev.K),
          f"{label} evaluation: not finite or the wrong shape")
    hr, ndcg, auc = res.at_k(10)
    extra = ""
    if not factored:
        flop = zoo_dense_flop(getattr(model, "base", model), len(ev.users), tr.data.num_items)
        extra = (f"; dense products {flop:.3e} FLOP, {flop / FP32_FLOPS:.4f} s at the card's "
                 "float32 peak")
    print(f"{label} evaluation ({card_line()}): {len(ev.users)} users in {tiles} tiles of "
          f"{ev.batch_users}, K1 launches {launches}; {wall:.4f} s (host clock, the first call)"
          f"{extra}; HR@10 {hr:.6f} NDCG@10 {ndcg:.6f} AUC {auc:.6f}")
    if factored:
        check_against_dense(label, ev, model, params, res)
    else:
        check_chunks(label, ev, model, params)
    return launches


def check_chunks(label, ev, model, params):
    """``score_all`` (chunks of ``_item_chunk`` items, the last one short)
    against one ``score_some`` over the whole catalog, for the evaluator's
    first user tile, to ``ZOO_TOL`` of the scores' scale."""
    u, h = ev._users_d[:ev.batch_users], ev._hists_d[:ev.batch_users]
    items = torch.arange(model.num_items, device=u.device)[None, :].expand(u.shape[0], -1)
    with torch.no_grad():
        chunked = model.score_all(params, u, h)
        whole = model.score_some(params, u, h, items)
    err, r = tree_err([chunked], [whole])
    print(f"{label} score_all in chunks of {model._item_chunk} (the last "
          f"{model.num_items % model._item_chunk or model._item_chunk} items) vs one score_some "
          f"over {model.num_items} items, {u.shape[0]} users: max |d| {err:.3e} "
          f"({r:.2e} of the scores' scale, tolerance {ZOO_TOL:.0e})")
    check(chunked.shape == whole.shape and r <= ZOO_TOL,
          f"{label}: score_all's chunks differ from score_some by {r:.3e} of the scale")


def zoo_one_step(tr):
    """One step of the trainer's epoch as a call: the model's own epoch
    (Caser) over one batch of windows, or the sequence epoch at one step;
    each ends in the host transfer of its stats."""
    from acf_tpu_torch.train.trainer import make_seq_epoch_fn

    model, dev = tr.model, tr.dev
    if hasattr(model, "make_epoch_fn"):
        dev = dict(dev, **{k: dev[k][:TRAIN_BATCH] for k in ("win_seq", "win_user", "win_pos")})
        one = model.make_epoch_fn(tr.optimizer, TRAIN_BATCH, 1, dev)
    else:
        one = make_seq_epoch_fn(model, tr.optimizer, TRAIN_BATCH, 1)

    def step():
        tr.params, tr.opt_state, _ = one(tr.params, tr.opt_state, dev, tr.generator)

    return step


def time_zoo(label, tr):
    """Examples/s of ``ZOO_EPOCHS`` epochs after a warm-up epoch (host clock
    around ``Trainer.run_epoch``, every sample and the median); one step's
    wall time, launches and device busy and idle time."""
    tr.run_epoch()
    samples = []
    for _ in range(ZOO_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.run_epoch()
        samples.append(time.perf_counter() - t0)
    check(all(math.isfinite(v) for v in stats.values()), f"{label} timing: stats {stats}")
    steps = getattr(tr.epoch_fn, "num_batches", tr.num_batches)
    examples = steps * TRAIN_BATCH
    median_s = sorted(samples)[len(samples) // 2]
    card = card_line()
    print(f"{label} timing ({card}): {steps} steps of {TRAIN_BATCH} an epoch; median "
          f"{median_s:.4f} s, {examples / median_s:.1f} examples/s; samples "
          + ", ".join(f"{s:.4f}" for s in samples)
          + " s (host clock around Trainer.run_epoch, after a warm-up epoch)")
    step = zoo_one_step(tr)
    step_s = median_s / steps
    alone_s = best_wall_s(step, reps=10)
    launches = device_events(step, in_order=True)
    print(f"{label} step ({card}): {step_s * 1e3:.4f} ms in the median epoch over its steps, "
          f"{alone_s * 1e3:.4f} ms alone (best of 10); "
          + (f"{len(launches)} device launches" if launches
             else "launches not measured (the profiler saw no device time)"))
    device_breakdown(f"{label} step ({card})", step, step_s, top=5)


def check_session_stream(dev, tr, data):
    """``SessionStream`` of the trained GRU4Rec on ``ZOO_SLOTS`` slots over
    ``ZOO_EVENTS`` events (each slot a user's last items, 0 where the
    history is shorter; a third of the slots reset at the fifth event):
    every push's top-10 against ``torch.topk`` of the dense scores of the
    state it leaves, and that state against the same stream's on the CPU
    (to ``ZOO_TOL`` of its scale); then users/s over the events (host clock,
    each push ending in its host transfer)."""
    from acf_tpu_torch.ops.topk import NEG, SessionStream
    from acf_tpu_torch.utils.tree import tree_map

    model, params = tr.model, tr.params
    events = data.hist[1:ZOO_SLOTS + 1, -ZOO_EVENTS:]
    reset = np.arange(ZOO_SLOTS) % 3 == 0
    stream = SessionStream(model, params, batch_size=ZOO_SLOTS, k=10, device=dev)
    cpu_stream = SessionStream(model, tree_map(lambda x: x.detach().cpu(), params),
                               batch_size=ZOO_SLOTS, k=10, device="cpu")
    ties, state_r = 0, 0.0
    for e in range(ZOO_EVENTS):
        s, it = stream.push(events[:, e], reset if e == 4 else None)
        cpu_stream.push(events[:, e], reset if e == 4 else None)
        _, r = tree_err([stream.state.cpu()], [cpu_stream.state])
        check(r <= ZOO_TOL, f"SessionStream event {e}: the card's state differs from the "
              f"CPU's by {r:.3e} of its scale")
        state_r = max(state_r, r)
        with torch.no_grad():
            scores = model._act(stream.state @ params["W"].T + params["b"])
            scores[:, 0] = NEG
            ref_s, ref_i = torch.topk(scores, 11, dim=1)
        ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
        np.testing.assert_allclose(s, ref_s[:, :10], rtol=1e-6, atol=0)
        for r, j in zip(*np.nonzero(it != ref_i[:, :10])):
            gap = min(abs(ref_s[r, j] - ref_s[r, j + 1]),
                      abs(ref_s[r, j] - ref_s[r, j - 1]) if j else np.inf)
            check(gap <= 1e-6 * abs(ref_s[r, j]),
                  f"SessionStream event {e} slot {r} rank {j}: {it[r, j]} vs {ref_i[r, j]}")
            ties += 1
    check(float(stream.state.abs().sum()) > 0, "SessionStream: the state never moved")
    stream.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e in range(ZOO_EVENTS):
        stream.push(events[:, e], reset if e == 4 else None)
    wall = time.perf_counter() - t0
    print(f"SessionStream ({card_line()}): {ZOO_SLOTS} slots x {ZOO_EVENTS} events (one reset "
          f"of {int(reset.sum())} slots), each push's top-10 equal to torch.topk of the dense "
          f"scores of its state ({ties} slots differ only at ties), its state within "
          f"{state_r:.2e} of its scale of the CPU stream's (tolerance {ZOO_TOL:.0e}); "
          f"{ZOO_SLOTS * ZOO_EVENTS / wall:.1f} users/s ({wall / ZOO_EVENTS * 1e3:.4f} ms a push, "
          "host clock)")


def zoo_phase(dev, data):
    """Phase 22, the sequence zoo on the Video-shaped set: per configuration
    a trainer (params from its seed), one step on the card against the CPU,
    its epochs timed, an evaluation with K1 counted; then the session
    stream. Returns K1's launches by configuration."""
    from acf_tpu_torch.train import TrainConfig, Trainer

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on")
    k1, gru = {}, None
    for n, (label, model, opt) in enumerate(zoo_models(data)):
        t0 = time.perf_counter()
        tr = Trainer(model, data, opt, TrainConfig(batch_size=TRAIN_BATCH, verbose=10 ** 9,
                                                   seed=220 + n, device=str(dev)))
        check_zoo_step(label, tr, seed=300 + n)
        time_zoo(label, tr)
        k1[label] = zoo_eval(label, tr)
        print(f"phase 22 {label}: {time.perf_counter() - t0:.1f} s")
        if label == "gru4rec-bpr":
            gru = tr
    check_session_stream(dev, gru, data)
    return k1


# --- the single-device remainder: phase 23 -------------------------------------

# SparseMFBPR as the JAX CLI builds `apr --sparse` (acf_tpu/cli/main.py:198-208)
# at the headline configuration of bench.py:66-85: d = 64, batch 512,
# Adagrad(0.05, 0.1), eps 0.5, reg_adv 1, dedup "auto" (the equality product
# at this batch). Its steps are held to APR_TOL as phase 18's are.
SPARSE_EPOCHS = 2  # timed epochs (see APR_EPOCHS)
# IRGAN as the JAX CLI builds it (acf_tpu/cli/main.py:269-270): d = 64,
# SGD(0.001) for both players, T 0.2, lambda 0.2; batch 512 on the
# Video-shaped set of phase 4.
IRGAN_EPOCHS = 2  # timed epochs (see APR_EPOCHS)
NAIVE = (("pop", "MostPopular"), ("mrv", "MostRecentlyVisit"),
         ("mfv", "MostFrequentlyVisit"), ("av", "AlreadyVisit"))
# the command line's refusals of phase 23, with the JAX CLI's messages
# (acf_tpu/cli/main.py:158-172, 296-311)
REST_REFUSALS = (
    (["--model", "apr", "--sparse", "--adv", "random"],
     "--sparse supports --adv grad only (the sparse step has no random-delta branch); "
     "drop --sparse or use --adv grad"),
    (["--model", "apr", "--sparse", "--dns", "2"],
     "--sparse does not support --dns > 1 (no DNS candidate selection in the sparse step); "
     "drop --sparse or --dns"),
    (["--model", "apr", "--sparse", "--adv_steps", "2"],
     "--sparse does not support --adv_steps > 1 (single-step FGSM only in the sparse step); "
     "drop --sparse or --adv_steps"),
    (["--model", "bpr", "--sparse", "--fgsm"],
     "--fgsm does not combine with --sparse (the row-space step has its own fused FGSM); "
     "use --model apr --sparse for sparse APR"),
    (["--model", "irgan", "--fgsm"],
     "--fgsm does not apply to 'irgan' (already adversarial, or no embedding tables)"),
)


def run_sparse_fit_two_phase(data):
    """Phase 23, sparse APR: ``fit_two_phase`` with a clean and an APR
    SparseMFBPR (one epoch each, the slots reset at the switch, an
    evaluation through K1 after each), row 0 of both tables and of both
    slots checked bit for bit around every epoch, K1 counted. Returns (the
    trainer, K1's launches)."""
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.ops.sparse_step import SparseMFBPR
    from acf_tpu_torch.train import TrainConfig, adagrad, fit_two_phase
    from acf_tpu_torch.train import trainer as trainer_mod

    clean = SparseMFBPR(data.num_users, data.num_items, D)
    adv = SparseMFBPR(data.num_users, data.num_items, D, adversarial=True, **APR)
    stats, seen, pad_kept = [], {}, []
    Trainer = trainer_mod.Trainer
    real_run, real_switch = Trainer.run_epoch, Trainer.switch_model

    def pad_rows(self):
        return torch.stack([self.params["P"][0], self.params["Q"][0],
                            self.opt_state["accP"][0], self.opt_state["accQ"][0]])

    def run_epoch(self):
        before = pad_rows(self).clone()
        stats.append(real_run(self))
        pad_kept.append(torch.equal(pad_rows(self), before))
        return stats[-1]

    def switch_model(self, model, reset_opt=True):
        real_switch(self, model, reset_opt)
        slots = self.opt_state.values()
        seen.update(trainer=self, slots=(min(float(v.min()) for v in slots),
                                         max(float(v.max()) for v in slots)))

    writer = lines_writer()
    tiles = math.ceil(len(data.eval_users()) / BATCH_USERS)
    Trainer.run_epoch, Trainer.switch_model = run_epoch, switch_model
    try:
        rank_positions_dot.launches = 0
        t0 = time.perf_counter()
        best = fit_two_phase(clean, adv, data, adagrad(0.05, initial_accumulator_value=0.1),
                             TrainConfig(batch_size=TRAIN_BATCH, epochs=2, verbose=1),
                             adv_epoch=1, writer=writer)  # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = rank_positions_dot.launches
    finally:
        Trainer.run_epoch, Trainer.switch_model = real_run, real_switch
    tr = seen["trainer"]
    print(f"sparse apr fit_two_phase: dedup {adv.dedup_mode(TRAIN_BATCH)}, {tr.num_batches} steps "
          f"of {TRAIN_BATCH} an epoch, {tiles} eval tiles; {wall:.2f} s; K1 launches {k1}; slots "
          f"after the switch {seen['slots']}; row 0 and its slots kept bit for bit in every epoch "
          f"{all(pad_kept)}; best epoch {best['epoch']} NDCG@10 {best['ndcg']:.6f}")
    print(f"sparse apr fit_two_phase epoch stats: {stats}")
    check(k1 == 2 * tiles, f"sparse apr fit_two_phase: K1 launched {k1} times, not {2 * tiles}")
    check(len(pad_kept) == 2 and all(pad_kept),
          "sparse apr fit_two_phase: row 0 of a table or of its slot moved in an epoch")
    check(all(abs(v - 0.1) < 1e-7 for v in seen["slots"]),
          f"sparse apr fit_two_phase: the slots were not reset at the switch {seen['slots']}")
    epochs = [ln for ln in writer.lines if ln.startswith("Epoch ") and "HR =" in ln]
    check(len(epochs) == 2 and sum(ln.startswith("K = ") for ln in writer.lines) == 100,
          "sparse apr fit_two_phase: not two evaluated epochs and a K sweep")
    check(set(stats[0]) == {"loss", "acc"} and set(stats[1]) == {"loss", "acc", "acc_adv"}
          and all(math.isfinite(v) for s in stats for v in s.values()),
          f"sparse apr fit_two_phase: the phases did not run clean then APR: {stats}")
    check(math.isfinite(best["ndcg"]) and best["epoch"] == 1,
          "sparse apr fit_two_phase: no best epoch")
    return tr, k1


def sparse_step(model, params, tdata, idx, cands):
    """One row-space step of ``model`` from fresh slots with these draws
    (its epoch over one injected batch). Returns ([the update of P, of Q],
    [the slots' increments], stats)."""
    dev = params["P"].device
    opt = model.init_opt_state(None, params)
    epoch = model.make_epoch_fn(None, TRAIN_BATCH, 1)
    new, new_opt, stats = epoch(params, opt, tdata, None, idx.to(dev)[None],
                                cands.to(dev)[None])
    return ([(new[k] - params[k]).cpu() for k in ("P", "Q")],
            [(new_opt[k] - opt[k]).cpu() for k in ("accP", "accQ")], stats)


def slot_top(increments):
    """The largest slot value after a step from fresh slots (0.1 each)."""
    return 0.1 + max(float(a.max()) for a in increments)


def check_sparse_steps(tr):
    """Phase 23, at the params ``fit_two_phase`` left: one clean and one APR
    row-space step on the card against the same step on the CPU, against
    the other dedup program on the card (sort) and against the dense pair
    step on the card (autograd clean, the closed form under APR), all from
    fresh slots with the same draws: the params' updates, the slots'
    increments (the dense step's are not compared) and the stats."""
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.ops.sparse_step import SparseMFBPR

    data = tr.data
    U, I = data.num_users, data.num_items
    params = {k: v.detach() for k, v in tr.params.items()}
    cpu_params = {k: v.cpu() for k, v in params.items()}
    cpu_data = {k: v.cpu() for k, v in tr.dev.items()}
    top = max(float(v.abs().max()) for v in cpu_params.values())
    for n, adversarial in enumerate((False, True)):
        label = "sparse apr" if adversarial else "sparse clean"
        kw = dict(adversarial=True, **APR) if adversarial else {}
        model = SparseMFBPR(U, I, D, **kw)
        idx, cands = apr_draws(data, seed=230 + n)
        upd, acc, stats = sparse_step(model, params, tr.dev, idx, cands)
        upd_c, acc_c, stats_c = sparse_step(model, cpu_params, cpu_data, idx, cands)
        upd_s, acc_s, stats_s = sparse_step(SparseMFBPR(U, I, D, dedup="sort", **kw), params,
                                            tr.dev, idx, cands)
        upd_d, stats_d = apr_step(MFBPR(U, I, D, **kw), params, tr.dev, idx, cands)
        lines = [
            ("the CPU", check_close(f"{label} vs the CPU", upd, upd_c, top),
             check_close(f"{label} slots vs the CPU", acc, acc_c, slot_top(acc_c)),
             stats_c),
            ("dedup sort", check_close(f"{label} vs dedup sort", upd, upd_s, top),
             check_close(f"{label} slots vs dedup sort", acc, acc_s, slot_top(acc_s)),
             stats_s),
            ("the dense step", check_close(f"{label} vs the dense step", upd, upd_d, top), "",
             {k: v for k, v in stats_d.items() if k in stats}),
        ]
        for other, u_line, a_line, ref in lines:
            check_stats(f"{label} vs {other}", stats, ref)
            print(f"{label} step (card, dedup matmul) vs {other} (same draws): update {u_line}"
                  + (f"; slots {a_line}" if a_line else "") + "; "
                  + ", ".join(f"{k} {float(stats[k]):.6f}/{float(ref[k]):.6f}"
                              for k in sorted(ref)))


def irgan_draws(data, seed):
    """One step's draws from ``seed`` on the CPU: pair indices [B], D's
    uniforms [B, I], G's mixture choices [B, 2], uniforms [B, 2, I] and
    history draws [B, 2]."""
    from acf_tpu_torch.models.irgan import G_SAMPLES, uniforms

    g = torch.Generator().manual_seed(seed)
    b, n = TRAIN_BATCH, data.num_items
    idx = torch.randperm(data.num_pairs, generator=g)[:b]
    return (idx, uniforms(g, (b, n)), torch.rand((b, G_SAMPLES), generator=g) < 0.2,
            uniforms(g, (b, G_SAMPLES, n)), torch.randint(0, 2 ** 31 - 1, (b, G_SAMPLES),
                                                          generator=g))


def check_irgan_steps(dev, data):
    """Phase 23: for the pointwise and the pairwise D, one D step and one G
    step on the card against the CPU from the same params and injected
    draws: D's fakes and G's samples equal, G's rewards within APR_TOL of
    their scale plus what an ulp of sigmoid(D) near 0.5 gives them, then
    both players' updates of the one-batch epoch (a D
    step, then a G step against the new D) within APR_TOL of the update's
    scale plus an ulp of the largest param, D's loss to rtol 1e-5 and G's
    within what the rewards' bound gives it: G's loss is a mean of terms
    log p * reward of both signs (the rewards 2(sigmoid(D) - 0.5) lie
    around 0) that cancels to a small share of them, so it is held to
    max |log p| times the rewards' bound plus APR_TOL of the terms' scale,
    both read from the CPU's step at the first D."""
    from acf_tpu_torch.models.irgan import IRGAN, g_row_logits
    from acf_tpu_torch.utils.tree import tree_leaves, tree_map

    cpu = torch.device("cpu")
    tdata = {k: torch.as_tensor(v) for k, v in (("pairs_u", data.pairs_u),
                                                ("pairs_i", data.pairs_i), ("hist", data.hist))}
    for n, pairwise in enumerate((False, True)):
        label = f"irgan ({'pairwise' if pairwise else 'pointwise'} D)"
        model = IRGAN(data.num_users, data.num_items, D, pairwise_d=pairwise)
        params = model.init_params(torch.Generator(device=dev).manual_seed(240 + n), device=dev)
        idx, d_u, mix, g_u, g_idx = irgan_draws(data, 250 + n)
        out = {}
        for side, where in (("card", dev), ("cpu", cpu)):
            prm = tree_map(lambda x: x.to(where), params)
            dd = {k: v.to(where) for k, v in tdata.items()}
            u, pos = dd["pairs_u"][idx.to(where)], dd["pairs_i"][idx.to(where)]
            fake = model.d_fakes(prm["g"], u, d_u.to(where))
            sample, reward = model.g_samples(prm["g"], prm["d"], u, dd["hist"][u], mix.to(where),
                                             g_u.to(where), g_idx.to(where))
            epoch = model.make_epoch_fn(None, TRAIN_BATCH, 1)
            new, _, stats = epoch(prm, model.init_opt_state(None, prm), dd, None,
                                  idx.to(where)[None], d_u.to(where)[None], mix.to(where)[None],
                                  g_u.to(where)[None], g_idx.to(where)[None])
            out[side] = (fake.cpu(), sample.cpu(), reward.cpu(),
                         [(a - b).cpu() for a, b in zip(tree_leaves(new), tree_leaves(prm))],
                         stats)
            lp = torch.gather(torch.log_softmax(g_row_logits(prm["g"], u), dim=-1), 1,
                              sample).cpu()
        (fake, sample, reward, upd, stats), (fake_c, sample_c, reward_c, upd_c, stats_c) = (
            out["card"], out["cpu"])
        check(torch.equal(fake, fake_c), f"{label}: D's fakes differ between the card and the CPU")
        check(torch.equal(sample, sample_c), f"{label}: G's samples differ")
        check(int(fake.min()) >= 1 and int(sample.min()) >= 1, f"{label}: the pad item was drawn")
        # sigmoid(D) - 0.5 cancels: an ulp of sigmoid near 0.5 on either side
        # reaches the reward through the factor 2 p/pn <= 2 / (1 - lambda)
        r_top = 2.0 / (1.0 - model.sample_lambda)
        r_line = check_close(f"{label} rewards", [reward], [reward_c], r_top)
        r_bound = (APR_TOL * float(reward_c.abs().max())
                   + torch.finfo(torch.float32).eps * r_top)
        g_bound = (float(lp.abs().max()) * r_bound
                   + APR_TOL * float((lp * reward_c).abs().max()))
        top = max(float(x.abs().max()) for x in tree_leaves(params))
        u_line = check_close(f"{label} updates", upd, upd_c, top)
        d_rel = abs(stats["d_loss"] - stats_c["d_loss"]) / abs(stats_c["d_loss"])
        g_abs = abs(stats["loss"] - stats_c["loss"])
        print(f"{label} D step + G step, card vs CPU (same params and draws): fakes and samples "
              f"equal ({int(mix.sum())} of {mix.numel()} samples from the history); rewards "
              f"{r_line}; both players' updates {u_line}; d_loss {stats['d_loss']:.6f}/"
              f"{stats_c['d_loss']:.6f} (rel {d_rel:.2e}), loss {stats['loss']:.4e}/"
              f"{stats_c['loss']:.4e} (|d| {g_abs:.2e}, bound {g_bound:.2e})")
        check(d_rel <= 1e-5, f"{label}: d_loss rel {d_rel:.2e}")
        check(g_abs <= g_bound, f"{label}: G's loss differs by {g_abs:.2e} > {g_bound:.2e}")


def time_irgan(dev, data):
    """Phase 23: a pointwise IRGAN trainer on the Video-shaped set: one
    epoch (the warm-up) with both players' pad rows checked bit for bit,
    ``IRGAN_EPOCHS`` timed epochs (every sample and the median, host clock),
    one D step and one G step under the profiler (launches, busy and idle
    time), and an evaluation through K1 (counted, checked against the dense
    path). Returns K1's launches."""
    from acf_tpu_torch.models.irgan import G_SAMPLES, IRGAN, uniforms
    from acf_tpu_torch.ops.ranking import rank_positions_dot
    from acf_tpu_torch.sampling import sample_pair_epoch
    from acf_tpu_torch.train import TrainConfig, Trainer, sgd

    model = IRGAN(data.num_users, data.num_items, D)
    tr = Trainer(model, data, sgd(0.001), TrainConfig(batch_size=TRAIN_BATCH, verbose=10 ** 9,
                                                      seed=260, device=str(dev)))
    pad = {s: tr.params[s]["Q"][0].clone() for s in ("g", "d")}
    t0 = time.perf_counter()
    tr.run_epoch()
    first_s = time.perf_counter() - t0
    kept = all(torch.equal(tr.params[s]["Q"][0], pad[s]) for s in ("g", "d"))
    print(f"irgan epoch 1 (the warm-up): {first_s:.4f} s; the pad rows of both item tables kept "
          f"bit for bit: {kept}")
    check(kept, "irgan: a pad row of an item table moved in an epoch")
    samples = []
    for _ in range(IRGAN_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.run_epoch()
        samples.append(time.perf_counter() - t0)
    check(all(math.isfinite(v) for v in stats.values()), f"irgan timing: stats {stats}")
    examples = tr.num_batches * TRAIN_BATCH
    median_s = sorted(samples)[len(samples) // 2]
    card = card_line()
    print(f"irgan timing ({card}): {tr.num_batches} D steps and {tr.num_batches} G steps of "
          f"{TRAIN_BATCH} an epoch; median {examples / median_s:.1f} examples/s; samples "
          + ", ".join(f"{examples / s:.1f}" for s in samples)
          + " examples/s (" + ", ".join(f"{s:.4f}" for s in samples) + " s); stats "
          f"{stats}; timer: host clock around Trainer.run_epoch, which ends in a host transfer")
    batches = sample_pair_epoch(tr.generator, data.num_pairs, TRAIN_BATCH, tr.num_batches)
    g, b, n = tr.generator, TRAIN_BATCH, data.num_items
    step_n = [0]

    def pair():
        idx = batches[step_n[0] % tr.num_batches]
        step_n[0] += 1
        return tr.dev["pairs_u"][idx], tr.dev["pairs_i"][idx]

    def d_step():
        u, pos = pair()
        p = tr.params
        d, _, loss = model.d_step(p["d"], {}, p["g"], u, pos, uniforms(g, (b, n)))
        tr.params = {"g": p["g"], "d": d}
        return float(loss)

    def g_step():
        u, _ = pair()
        p = tr.params
        mix = torch.rand((b, G_SAMPLES), generator=g, device=g.device) < model.sample_lambda
        idx = torch.randint(0, 2 ** 31 - 1, (b, G_SAMPLES), generator=g, device=g.device)
        gp, _, loss = model.g_step(p["g"], {}, p["d"], u, tr.dev["hist"][u], mix,
                                   uniforms(g, (b, G_SAMPLES, n)), idx)
        tr.params = {"g": gp, "d": p["d"]}
        return float(loss)

    for label, fn in (("irgan D step", d_step), ("irgan G step", g_step)):
        alone_s = best_wall_s(fn, reps=10)
        launches = device_events(fn, in_order=True)
        print(f"{label} ({card}): {alone_s * 1e3:.4f} ms alone (best of 10, each ending in a "
              "host transfer of its loss); "
              + (f"{len(launches)} device launches" if launches
                 else "launches not measured (the profiler saw no device time)"))
        device_breakdown(f"{label} ({card})", fn, alone_s, top=6)
    ev = tr.evaluator
    tiles = math.ceil(len(ev.users) / ev.batch_users)
    rank_positions_dot.launches = 0
    t0 = time.perf_counter()
    res = ev.evaluate_model(model, tr.params)  # the main path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = rank_positions_dot.launches
    hr, ndcg, auc = res.at_k(10)
    print(f"irgan evaluation ({card}): {len(ev.users)} users in {tiles} tiles, K1 launches {k1}; "
          f"{wall:.4f} s (host clock, one call); HR@10 {hr:.6f} NDCG@10 {ndcg:.6f} AUC {auc:.6f}")
    check(k1 == tiles, f"irgan evaluation: K1 launched {k1} times, not {tiles}")
    check_against_dense("irgan", ev, model, tr.params, res)
    return k1


def naive_evals(dev, data, ev):
    """Phase 23: each naive baseline's dense evaluation at Video scale on
    the card (K1 not launched; one call timed, host clock, and its device
    busy time), every user's position equal to the same evaluation's on the
    CPU."""
    from acf_tpu_torch.eval import FullRankEvaluator
    from acf_tpu_torch.models import naive
    from acf_tpu_torch.ops.ranking import rank_positions_dot

    cpu_ev = FullRankEvaluator(data, batch_users=ev.batch_users, device="cpu")
    tiles = math.ceil(len(ev.users) / ev.batch_users)
    for flag, name in NAIVE:
        model = getattr(naive, name)(data.num_users, data.num_items, D, data=data)
        params = model.init_params(None, device=dev)
        rank_positions_dot.launches = 0
        t0 = time.perf_counter()
        res = ev.evaluate_model(model, params)  # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rank_positions_dot.launches == 0, f"{flag}: K1 launched in a dense evaluation")
        t0 = time.perf_counter()
        cpu_pos = cpu_ev.positions(model.score_all, {k: v.cpu() for k, v in params.items()})
        cpu_s = time.perf_counter() - t0
        check(np.array_equal(ev.positions(model.score_all, params), cpu_pos),
              f"{flag}: positions differ between the card and the CPU")
        check(np.isfinite(res.hr).all() and res.hr.shape == (len(ev.users), ev.K),
              f"{flag}: evaluation not finite or the wrong shape")
        hr, ndcg, auc = res.at_k(10)
        print(f"{flag} ({name}) evaluation ({card_line()}): {len(ev.users)} users in {tiles} "
              f"dense tiles, K1 launches 0; {wall:.4f} s (host clock, one call); every "
              f"position equal to the CPU's ({cpu_s:.2f} s there); HR@10 {hr:.6f} NDCG@10 "
              f"{ndcg:.6f} AUC {auc:.6f}")
        device_breakdown(f"{flag} evaluation", lambda: ev.evaluate_model(model, params), wall,
                         top=4)


def rest_cli(dev):
    """Phase 23, the command line on phase 20's files (written again from
    the same seed): ``apr --sparse`` on the ml-1m files (1 clean + 1 APR
    epoch), ``bpr --sparse --dedup sort``, ``irgan`` and ``irgan
    --irgan_pair`` and the naive baselines on the Video file (1 epoch), K1
    counted around each; then the refusals with the JAX CLI's messages.
    Returns K1's launches by run."""
    import contextlib
    import io
    import tempfile

    from acf_tpu_torch.cli.main import main as cli_main
    from acf_tpu_torch.ops.ranking import rank_positions_dot

    common = ["--d", str(D), "--bs", str(TRAIN_BATCH)]
    k1 = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        video, ml1m = write_reference_files(root)
        counts = {"ml-1m": expected_counts(ml1m), "video": expected_counts(video)}
        tiles = {k: math.ceil(c[3] / BATCH_USERS) for k, c in counts.items()}
        runs = [("apr_sparse_ml1m", ["--model", "apr", "--sparse", "--data", "ml-1m",
                                     "--epochs", "2", "--adv_epoch", "1"], "ml-1m", 2),
                ("bpr_sparse_sort_video", ["--model", "bpr", "--sparse", "--dedup", "sort",
                                           "--data", "video", "--epochs", "1"], "video", 1),
                ("irgan_video", ["--model", "irgan", "--data", "video", "--epochs", "1"],
                 "video", 1),
                ("irgan_pair_video", ["--model", "irgan", "--irgan_pair", "--data", "video",
                                      "--epochs", "1"], "video", 1)]
        runs += [(f"{flag}_video", ["--model", flag, "--data", "video", "--epochs", "1"],
                  "video", 1) for flag, _ in NAIVE]
        for key, argv, name, epochs in runs:
            _, n, tr = run_cli(root, [*argv, *common], counts[name], epochs, rank_positions_dot)
            want = 0 if key.split("_")[0] in dict(NAIVE) else epochs * tiles[name]
            check(n == want, f"cli {argv}: K1 launched {n} times, not {want}")
            kind = type(tr.model).__name__
            check("sparse" not in argv or (kind == "SparseMFBPR" and tr.model.dedup_mode(
                TRAIN_BATCH) == ("sort" if "sort" in argv else "matmul")),
                f"cli {argv}: trained {kind}, not the row-space step")
            k1[key] = n
        for argv, message in REST_REFUSALS:
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli_main([*argv, "--data", "video", "--path", str(root),
                              "--opath", f"{root}/out/refused/", *common])
            except SystemExit as e:
                check(str(e) == message, f"cli {argv}: refused with {str(e)!r}, not {message!r}")
                print(f"cli {' '.join(argv)}: refused: {e}")
            else:
                fail(f"cli {argv} ran; the JAX CLI refuses it")
    return k1


def rest_phase(dev, video, ml1m, ev):
    """Phase 23: the sparse row-space APR step at the ml-1m shape, IRGAN
    and the naive baselines at the Video shape, and their command lines.
    Returns K1's launches by path."""
    t0 = time.perf_counter()
    tr, k1_sparse = run_sparse_fit_two_phase(ml1m)
    check_sparse_steps(tr)
    time_own_epochs("sparse apr", tr, SPARSE_EPOCHS, "fit_two_phase's APR epoch")
    print(f"phase 23 sparse apr: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_irgan_steps(dev, video)
    k1_irgan = time_irgan(dev, video)
    print(f"phase 23 irgan: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    naive_evals(dev, video, ev)
    print(f"phase 23 naive: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k1_cli = rest_cli(dev)
    print(f"phase 23 cli: {time.perf_counter() - t0:.1f} s")
    return {"sparse_fit_two_phase": k1_sparse, "irgan_eval": k1_irgan, "cli": k1_cli}


def epoch_twice(label, make):
    """One epoch of two trainers that ``make()`` builds from one seed: every
    param and optimizer slot must be equal bit for bit. Prints the count of
    differing elements of each leaf."""
    from acf_tpu_torch.train.checkpoint import state_arrays

    runs = []
    for _ in range(2):
        tr = make()
        t0 = time.perf_counter()
        stats = tr.run_epoch()
        torch.cuda.synchronize()
        runs.append(state_arrays(tr.params, tr.opt_state))
        print(f"determinism {label}: an epoch of {tr.num_batches} steps in "
              f"{time.perf_counter() - t0:.2f} s: {stats}")
    counts = {n: int(np.sum(a.view(np.uint8) != runs[1][n].view(np.uint8)))
              for n, a in runs[0].items()}
    print(f"determinism {label}: differing elements by leaf: {counts}")
    check(not any(counts.values()), f"determinism {label}: two same-seed epochs differ")


def determinism_phase(video, ml1m):
    """Phase 24: one APR epoch at the ml-1m shape (the dense closed form) and
    one APL epoch at the Video shape, each run twice from one seed."""
    from acf_tpu_torch.models.apl import APL
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.train import TrainConfig, Trainer, adagrad, sgd

    cfg = TrainConfig(batch_size=TRAIN_BATCH, verbose=10 ** 9, seed=24)
    epoch_twice("apr", lambda: Trainer(
        MFBPR(ml1m.num_users, ml1m.num_items, D, adversarial=True, **APR), ml1m,
        adagrad(0.05, initial_accumulator_value=0.1), cfg))
    epoch_twice("apl", lambda: Trainer(APL(video.num_users, video.num_items, D), video,
                                       sgd(0.05), cfg))


# --- distribution: phase 25 ------------------------------------------------------

MESH_SPECS = ("1x2", "2x1")  # two ranks on the one card, over gloo
MESH_STEPS = 150             # steps of each phase of the clean -> APR runs held to one device
MESH_SERVE_USERS = 4096
# the rank functions, tests/torch_rank_cases.py, imported by their own name
# (another package named "tests" may come first on the path)
CASES = "torch_rank_cases"


def rank_cases():
    """The rank functions' module, its directory put on the path (the ranks
    inherit the path)."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    return importlib.import_module(CASES)


def bpr_step_oracle(P, Q, users, pos, neg, eps, lr=0.05):
    """One step of ``make_sharded_bpr_step``'s math on whole tables."""
    from acf_tpu_torch.models.base import bpr_pair_loss, row_normalize

    def grads(dP=None, dQ=None):
        Pv, Qv = P.clone().requires_grad_(True), Q.clone().requires_grad_(True)
        with torch.enable_grad():
            Pa, Qa = (Pv, Qv) if dP is None else (Pv + dP, Qv + dQ)
            pu = Pa[users]
            loss = bpr_pair_loss((pu * Qa[pos]).sum(-1), (pu * Qa[neg]).sum(-1))
            return torch.autograd.grad(loss, (Pv, Qv))

    gP, gQ = grads()
    if eps > 0.0:
        aP, aQ = grads(eps * row_normalize(gP), eps * row_normalize(gQ))
        gP, gQ = gP + aP, gQ + aQ
    return P - lr * gP, Q - lr * gQ


def sasrec_step_oracle(model, params, seq, pos, neg, lr=1e-3):
    """One step of ``make_sharded_sasrec_step``'s math on the whole item
    table, the encoder through K2a and K2b."""
    from acf_tpu_torch.models.base import row_normalize
    from acf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    ist = (pos != 0).to(torch.float32)

    def grads(delta=None):
        prm = tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
        with torch.enable_grad():
            x = prm["item_emb"][seq] * math.sqrt(model.dim)
            reprs = model.encode_core(prm, x, seq != 0)
            tgt = prm["item_emb"] if delta is None else prm["item_emb"] + delta
            zero = torch.zeros_like(reprs[..., 0])
            loss = (torch.sum(torch.logaddexp(zero, -(tgt[pos] * reprs).sum(-1)) * ist)
                    + torch.sum(torch.logaddexp(zero, (tgt[neg] * reprs).sum(-1)) * ist))
            leaves = tree_leaves(prm)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
        return tree_unflatten(prm, [torch.zeros_like(x) if g is None else g
                                    for x, g in zip(leaves, got)])

    g = grads()
    if model.adversarial:
        ag = grads(model.eps * row_normalize(g["item_emb"]))
        g = tree_map(lambda a, b: a + model.reg_adv * b, g, ag)
    return tree_map(lambda p, d: p - lr * d, params, g)


def mesh_cli(apr_ref):
    """Phase 25, first part: ``--mesh 1x1`` through the command line's normal
    path on NCCL (a group of one process), APR on phase 20's ml-1m file
    (written again from its seed), K1 counted; its params and its best
    evaluation against phase 20's single-device run."""
    import tempfile

    import torch.distributed as dist

    from acf_tpu_torch.ops.ranking import rank_positions_dot

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _, ml1m = write_reference_files(root)
        counts = expected_counts(ml1m)
        tiles = math.ceil(counts[3] / BATCH_USERS)
        _, k1, tr = run_cli(root, ["--model", "apr", "--mesh", "1x1", "--data", "ml-1m",
                                   "--epochs", "2", "--adv_epoch", "1", "--d", str(D), "--bs",
                                   str(TRAIN_BATCH)], counts, 2, rank_positions_dot)
    check(tr.mesh is not None and tr.mesh.shape == {"data": 1, "model": 1},
          "cli --mesh 1x1: the trainer had no mesh")
    check(not dist.is_initialized(), "cli --mesh 1x1: the process group outlived the run")
    check(k1 == 2 * tiles, f"cli --mesh 1x1: K1 launched {k1} times, not {2 * tiles}")
    names = sorted(tr.params)
    err, rel = tree_err([tr.params[n].cpu() for n in names], [apr_ref.params[n].cpu() for n in names])
    same = all(torch.equal(tr.params[n], apr_ref.params[n]) for n in names)
    res, ref = tr.best["result"], apr_ref.best["result"]
    hr_same = float((res.hr == ref.hr).all(axis=1).mean())
    print(f"mesh cli apr --mesh 1x1 (NCCL, one rank): K1 {k1}; params against phase 20's "
          f"single-device run max |d| {err:.3e} ({rel:.2e} of scale), bit-equal {same}; "
          f"per-user HR@1..100 equal for {hr_same:.6f} of users")
    check(rel <= APR_TOL, f"cli --mesh 1x1: params differ from one device by {rel:.3e}")
    check(hr_same == 1.0 and np.array_equal(res.ndcg, ref.ndcg),
          "cli --mesh 1x1: its evaluation differs from the single-device run's")
    return k1


def mesh_calls(dev, video, ml1m, mf):
    """The rank cases of the two-rank phase and their single-device
    references on ``dev``. Returns (calls, references)."""
    from acf_tpu_torch.compat.jax_params import params_to_numpy
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.ops.sparse_step import SparseMFBPR
    from acf_tpu_torch.ops.topk import recommend
    from acf_tpu_torch.sampling import sample_seq_window_batch
    from acf_tpu_torch.train import adagrad

    model, params, ev = mf
    # the ranks get copies without the device tensors that serving caches on a dataset
    rank_video, rank_ml1m = dataclasses.replace(video), dataclasses.replace(ml1m)
    rng = np.random.default_rng(25)
    calls, refs = [], {}
    # the lookup: the ml-1m item table, a batch's ids with their duplicates,
    # whole-number cotangents (every order of their sums is exact)
    table = rng.standard_normal((ml1m.num_items, D)).astype(np.float32)
    ids = rng.integers(1, ml1m.num_items, (2, 2 * TRAIN_BATCH))
    ct = rng.integers(-4, 5, (2, 2 * TRAIN_BATCH, D)).astype(np.float32)
    calls.append(("lookup", (table, ids, ct)))
    refs["lookup"] = (table, ids, ct)
    # positions of phase 4's MF-BPR at Video scale, one device through K1
    fs = model.factored_scorer()
    refs["positions"] = ev.positions_factored(fs[0], fs[1], params)
    prm = params_to_numpy(params)
    calls.append(("evaluator", (MFBPR(video.num_users, video.num_items, D), prm, rank_video,
                                BATCH_USERS)))
    # top-10 of MESH_SERVE_USERS users
    users = rng.choice(np.arange(1, video.num_users), MESH_SERVE_USERS,
                       replace=False).astype(np.int32)
    refs["serve"] = (users, recommend(model, params, video, users, k=10, device=dev))
    calls.append(("recommend_bulk", (MFBPR(video.num_users, video.num_items, D), prm,
                                     rank_video, users, 10, BATCH_USERS)))
    # the sharded APR step at the ml-1m shape
    P = (rng.standard_normal((ml1m.num_users, D)) * 0.01).astype(np.float32)
    Q = (rng.standard_normal((ml1m.num_items, D)) * 0.01).astype(np.float32)
    idx = rng.choice(ml1m.num_pairs, TRAIN_BATCH, replace=False)
    batch = [ml1m.pairs_u[idx], ml1m.pairs_i[idx],
             rng.integers(1, ml1m.num_items, TRAIN_BATCH).astype(np.int32)]
    calls.append(("bpr_step", (P, Q, *batch, APR["eps"])))
    refs["bpr_step"] = [x.cpu().numpy() for x in bpr_step_oracle(
        *(torch.as_tensor(x, device=dev) for x in (P, Q)),
        *(torch.as_tensor(b, device=dev).long() for b in batch), APR["eps"])]
    # the adversarial SASRec step at maxlen 50, K2a and K2b
    sas = SASRec(ml1m.num_users, ml1m.num_items, D, maxlen=50, adversarial=True)
    g = torch.Generator(device=dev).manual_seed(25)
    sprm = sas.init_params(g, device=dev)
    eligible = torch.as_tensor(np.nonzero(ml1m.hist_len >= 2)[0].astype(np.int32), device=dev)
    _, window, neg = sample_seq_window_batch(g, torch.as_tensor(ml1m.hist, device=dev),
                                             eligible, 50, ml1m.num_items, TRAIN_BATCH)
    seqb = [x.cpu().numpy() for x in (window[:, :-1], window[:, 1:], neg)]
    calls.append(("sasrec_step", (SASRec(ml1m.num_users, ml1m.num_items, D, maxlen=50,
                                         adversarial=True), params_to_numpy(sprm), *seqb)))
    refs["sasrec_step"] = (params_to_numpy(sprm), params_to_numpy(sasrec_step_oracle(
        sas, sprm, *(torch.as_tensor(b, device=dev).long() for b in seqb))))
    # the data-parallel trainer and the sparse mesh epoch: fit_two_phase's
    # protocol, MESH_STEPS clean steps, then MESH_STEPS APR steps, the slots reset
    opt = adagrad(0.05, initial_accumulator_value=0.1)
    for name, cls in (("apr_train", MFBPR), ("sparse", SparseMFBPR)):
        models = [cls(ml1m.num_users, ml1m.num_items, D, **APR),
                  cls(ml1m.num_users, ml1m.num_items, D, adversarial=True, **APR)]
        args = (models, opt, rank_ml1m, [1, 1], MESH_STEPS, 25, TRAIN_BATCH)
        calls.append(("train", args))
        refs[name] = rank_cases().train(None, dev, *args)
    return calls, refs


def check_mesh_results(spec, res, refs, ml1m):
    """Every rank's results of ``spec`` against the single-device references;
    returns the ranks' launches {kernel: [by rank]}."""
    names = ("lookup", "positions", "serve", "bpr_step", "sasrec_step", "apr_train", "sparse")
    res = [dict(zip(names, r)) for r in res]
    dp, m = (int(v) for v in spec.split("x"))
    label = f"mesh {spec}"
    # the lookup: rows and the gradient exact
    table, ids, ct = refs["lookup"]
    il = -(-table.shape[0] // m)
    want = np.zeros_like(table)
    for d in range(dp):
        np.add.at(want, ids[d], ct[d])
    for r, x in enumerate(res):
        check(np.array_equal(x["lookup"]["rows"], table[ids[r // m]]),
              f"{label} rank {r}: sharded_lookup rows differ from the dense gather")
    grad = np.concatenate([res[mi]["lookup"]["grad"] for mi in range(m)])[:table.shape[0]]
    check(np.array_equal(grad, want), f"{label}: the lookup's gradient differs from the dense "
          f"one by {np.abs(grad - want).max()}")
    # positions: equal to one device's K1 positions for every user
    want_pos = refs["positions"]
    for r, x in enumerate(res):
        got = x["positions"]["pos"]
        bad = np.nonzero(got != want_pos)[0]
        for b in bad[:10]:
            print(f"{label} rank {r}: user {b} position {got[b]} vs one device {want_pos[b]}")
        check(len(bad) == 0, f"{label} rank {r}: {len(bad)} sharded K1 positions differ")
    # top-10 against one device's recommend, ids but at near ties
    users, (ws, wi) = refs["serve"]
    for r, x in enumerate(res):
        gs, gi = x["serve"]["scores"], x["serve"]["items"]
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-9)
        off = np.argwhere(gi != wi)
        for row, j in off:
            tol = 1e-6 * float(np.abs(ws[row]).max())
            near = [ws[row, j - 1]] if j > 0 else []
            near += [ws[row, j + 1]] if j + 1 < ws.shape[1] else []
            check(min(abs(ws[row, j] - v) for v in near) <= tol,
                  f"{label} rank {r}: user {users[row]} slot {j}: {gi[row, j]} vs "
                  f"{wi[row, j]} without a tie")
        if r == 0:
            print(f"{label}: top-10 of {len(users)} users equal to one device's recommend but "
                  f"{len(off)} slots at ties")
    # the sharded APR step and the adversarial SASRec step
    for r, x in enumerate(res):
        err, rel = tree_err([torch.as_tensor(a) for a in (x["bpr_step"]["P"], x["bpr_step"]["Q"])],
                            [torch.as_tensor(a) for a in refs["bpr_step"]])
        check(rel <= APR_TOL, f"{label} rank {r}: the sharded APR step differs by {rel:.3e}")
        before, after = refs["sasrec_step"]
        from acf_tpu_torch.utils.tree import tree_leaves

        got = [torch.as_tensor(a - b) for a, b in zip(tree_leaves(x["sasrec_step"]["params"]),
                                                      tree_leaves(before))]
        ref = [torch.as_tensor(a - b) for a, b in zip(tree_leaves(after), tree_leaves(before))]
        s_err, s_rel = tree_err(got, ref)
        if r == 0:
            print(f"{label}: sharded APR step max |d| {err:.3e} ({rel:.2e} of scale); "
                  f"adversarial SASRec step (maxlen 50) update max |d| {s_err:.3e} "
                  f"({s_rel:.2e} of scale), K2a {x['sasrec_step']['k2a']} K2b "
                  f"{x['sasrec_step']['k2b']} launches")
        check(s_rel <= STEP_TOL, f"{label} rank {r}: the SASRec step's update differs by {s_rel}")
    # the data-parallel trainer and the sparse mesh epoch, clean then APR
    for name in ("apr_train", "sparse"):
        ref = refs[name]["state"]
        keys = sorted(ref)
        for r, x in enumerate(res):
            got = x[name]["state"]
            err, rel = tree_err([torch.as_tensor(got[k]) for k in keys],
                                [torch.as_tensor(ref[k]) for k in keys])
            same = all(np.array_equal(got[k], ref[k]) for k in keys)
            if r == 0:
                print(f"{label}: {name} {MESH_STEPS} clean + {MESH_STEPS} APR steps against "
                      f"one device: max |d| {err:.3e} ({rel:.2e} of scale), bit-equal {same}; "
                      f"stats {x[name]['stats']} vs {refs[name]['stats']}")
            check([sorted(s) for s in x[name]["stats"]] ==
                  [sorted(s) for s in refs[name]["stats"]] and
                  "acc_adv" not in x[name]["stats"][0] and "acc_adv" in x[name]["stats"][1],
                  f"{label} rank {r}: {name}'s second phase is not APR: {x[name]['stats']}")
            check(rel <= APR_TOL, f"{label} rank {r}: {name} differs from one device by {rel}")
            check(all(np.array_equal(got[k], res[0][name]["state"][k]) for k in keys),
                  f"{label}: rank {r}'s {name} params differ from rank 0's")
    return {k: [x["positions"][k] + x["sasrec_step"][k] for x in res]
            for k in ("k1", "k2a", "k2b")}


def mesh_phase(dev, video, ml1m, mf, apr_ref):
    """Phase 25: the mesh on the card. ``--mesh 1x1`` through the CLI on
    NCCL, then two ranks on the one card over gloo with CUDA tensors (1x2 and
    2x1, both launched at once): the sharded lookup, positions through K1
    with ``id_base``, top-10, the sharded APR and SASRec steps, the
    data-parallel trainer and the sparse mesh epoch (clean, then APR), each
    against one device. Returns the kernels' launches in the mesh runs."""
    from acf_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    launches = {"nccl_cli_1x1": {"k1": mesh_cli(apr_ref)}}
    print(f"phase 25 cli: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    calls, refs = mesh_calls(dev, video, ml1m, mf)
    print(f"phase 25 references on one device: {time.perf_counter() - t0:.1f} s")

    def two_ranks(spec):
        t0 = time.perf_counter()
        res = launch.run(f"{CASES}:several", 2, spec, "cuda:0", calls, device="cuda:0",
                         backend="gloo", timeout=300.0)
        return res, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(MESH_SPECS)) as pool:  # both meshes at once: four ranks
        runs = list(pool.map(two_ranks, MESH_SPECS))
    print(f"phase 25 two-rank launches, {len(MESH_SPECS)} at once: "
          f"{time.perf_counter() - t0:.1f} s")
    for spec, (res, wall) in zip(MESH_SPECS, runs):
        got = check_mesh_results(spec, res, refs, ml1m)
        for k, v in got.items():
            check(all(n > 0 for n in v), f"mesh {spec}: a rank never launched {k}: {v}")
        launches[f"gloo_{spec}"] = got
        print(f"mesh {spec}: two ranks on cuda:0 over gloo, launches by rank {got}; "
              f"{wall:.1f} s with the ranks' start, beside the other mesh's launch (gloo "
              "staging through the host: not an NCCL or multi-GPU time)")
    return launches


# --- every model under a mesh: phase 26 ------------------------------------------

MESH_APL_STEPS = 4    # critic and generator steps of APL's mesh runs at the Video shape
MESH_MODEL_STEPS = 3  # steps of each other family's mesh runs (Caser: its epoch on a small set)
# A mesh run's update (params after the steps less the seeded init) against
# one device's, each entry within this share of the largest entry of one
# device's update, plus an ulp of the param a step (an update read back as
# new - old params resolves only to the param's ulp, and each step rounds
# the param once; GRU4Rec's first updates, ~3e-6 on params of ~0.016, sit
# within three ulps of them): the same steps with the sums over the data
# ranks in another order (~1e-7). The runs train by SGD (APL's and
# IRGAN's own, and the trainer's for every other family) or Adagrad (the
# FGSM wrapper), whose updates follow the gradients: a loss share off by
# the data axis moves the update by half of it. (Adam's first steps are
# ±lr whatever the gradient's size, so it shows no such fault, and it turns
# an entry whose gradient is rounding noise into a step of ~lr either way:
# DRCF's under Adam at 2x1 differed from one device's by 9.5e-4, lr 1e-3.)
MESH_UPDATE_TOL = 1e-4
# The popularity discriminators train by their own Adam: their params
# against one device's at the JAX package's bar for its mesh trainer
# (tests/test_parallel.py:500-592), rtol and atol.
MESH_ADAM_TOL = (1e-3, 5e-4)
# a mesh run's sharded HR@10 and NDCG@10 against one device's: its params
# differ by rounding, which can move a near tie's position
MESH_EVAL_TOL = 1e-3
MESH_CLI = ("apl", "irgan")
MESH_SEED = 26


def mesh_model_runs(video, small):
    """name -> (models, optimizer, data, steps, evaluate): the families of
    phase 26 at d=64, batch 512 (APL at the Video shape, the rest at a
    smaller depth), each held against one device."""
    from acf_tpu_torch.adversarial import FGSMAdversarial
    from acf_tpu_torch.adversarial.popularity import PopularityAdversarial
    from acf_tpu_torch.models.apl import APL
    from acf_tpu_torch.models.caser import Caser
    from acf_tpu_torch.models.dream import DREAM
    from acf_tpu_torch.models.drcf import DRCF
    from acf_tpu_torch.models.dsin import DSIN
    from acf_tpu_torch.models.gru4rec import GRU4Rec
    from acf_tpu_torch.models.irgan import IRGAN
    from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
    from acf_tpu_torch.models.naive import MostPopular
    from acf_tpu_torch.models.neumf import NeuMF
    from acf_tpu_torch.train import adagrad, sgd

    U, I = video.num_users, video.num_items
    sU, sI = small.num_users, small.num_items
    n, opt = MESH_MODEL_STEPS, sgd(0.05)

    def pop(base):
        return PopularityAdversarial(U, I, D, base=base)

    return {
        "apl": ([APL(U, I, D)], sgd(0.05), video, MESH_APL_STEPS, True),
        "irgan": ([IRGAN(U, I, D)], sgd(0.001), video, n, True),
        "amf": ([pop(PointwiseMF(U, I, D))], opt, video, n, True),
        "abpr": ([pop(MFBPR(U, I, D))], opt, video, n, False),
        "aneumf": ([pop(NeuMF(U, I, D))], opt, video, n, False),
        "neumf": ([NeuMF(U, I, D)], opt, video, n, False),
        "caser": ([Caser(sU, sI, D, maxlen=5)], opt, small, None, True),
        "gru4rec": ([GRU4Rec(U, I, D, maxlen=8)], opt, video, n, True),
        "dream": ([DREAM(U, I, D, maxlen=8)], opt, video, n, True),
        "drcf": ([DRCF(U, I, D, maxlen=5)], opt, video, n, False),
        "dsin": ([DSIN(U, I, D, sess_count=2, sess_len=4)], opt, video, n, False),
        "pop": ([MostPopular(U, I, D, data=video)], opt, video, n, False),
        "fgsm_mf": ([FGSMAdversarial(U, I, D, base=MFBPR(U, I, D), **APR)],
                    adagrad(0.05, initial_accumulator_value=0.1), video, n, True),
    }


def mesh_model_call(run):
    models, opt, data, steps, evaluate = run
    return ("train", (models, opt, data, [1], steps, MESH_SEED, TRAIN_BATCH, True, None, None,
                      evaluate))


def mesh_model_inits(dev, runs):
    """Each family's seeded init, by snapshot name: what the trainer draws
    first from its generator (the same on every rank of the card)."""
    from acf_tpu_torch.train.checkpoint import _flatten_with_names

    out = {}
    for name, run in runs.items():
        g = torch.Generator(device=dev).manual_seed(MESH_SEED)
        params = run[0][0].init_params(g, device=dev)
        out[name] = {f"params/{k}": v.cpu().numpy() for k, v in _flatten_with_names(params)}
    return out


def check_mesh_models(spec, res, runs, refs, inits):
    """Every rank's results of ``spec`` against one device's: K3a-K3e on the
    rank's rows against their plain versions; each family's stats, update
    (``MESH_UPDATE_TOL``; the discriminators' Adam params at
    ``MESH_ADAM_TOL``) and sharded evaluation against one device's; every
    rank's state equal. Returns the launches {family: {kernel: [by rank]}}."""
    from acf_tpu_torch.ops.apl_gen_fused import KERNELS

    names = ["apl_kernels", *runs]
    res = [dict(zip(names, r)) for r in res]
    dp = int(spec.split("x")[0])
    label = f"mesh {spec}"
    for r, x in enumerate(res):
        k = x["apl_kernels"]
        check(k["rows"] == TRAIN_BATCH // dp, f"{label} rank {r}: K3 ran on {k['rows']} rows, "
              f"not {TRAIN_BATCH // dp}")
        check(all(k[kern.__name__] == 1 for kern in KERNELS),
              f"{label} rank {r}: the K3 check did not launch each kernel once: {k}")
        parts = []
        for name, outs in k["errs"].items():
            for i, (err, scale) in enumerate(outs):
                parts.append(f"{name}[{i}] {err:.2e} ({err / max(scale, 1e-30):.2e} of "
                             f"{scale:.3g})")
                check(math.isfinite(err) and err <= APL_TOL * scale,
                      f"{label} rank {r} {name}[{i}]: max |kernel - plain| {err} > "
                      f"{APL_TOL} x {scale}")
        check(k["pad_grad"] == 0.0, f"{label} rank {r}: the pad item got a gradient")
        print(f"{label} rank {r}: K3 at B={k['rows']} (its rows of {TRAIN_BATCH}), d={D}, "
              f"I={VIDEO_ITEMS + 1}: max |kernel - plain| " + "; ".join(parts))
    launches = {}
    for name, run in runs.items():
        ref, init = refs[name], inits[name]
        models, _, data, steps = run[:4]
        if steps is None:  # Caser's own epoch over its windows
            steps = max(len(models[0].extra_device_data(data)["win_seq"]) // TRAIN_BATCH, 1)
        disc = sorted(k for k in init if k.startswith("params/disc/"))
        trained = sorted(k for k in init if k not in disc)
        scale = max(float(np.abs(ref["state"][k] - init[k]).max()) for k in trained)
        check(name == "pop" or scale > 0, f"{name}: one device's run did not move its params")
        worst, worst_disc = 0.0, 0.0
        for r, x in enumerate(res):
            got = x[name]
            check(set(got["state"]) == set(ref["state"]),
                  f"{label} rank {r} {name}: state {sorted(got['state'])}")
            for key in trained:
                w, g = ref["state"][key], got["state"][key]
                d = np.abs(g - w)
                worst = max(worst, float(d.max()) if d.size else 0.0)
                ulps = steps * np.spacing(np.maximum(np.abs(w), np.abs(g)))
                check(bool(np.all(d <= MESH_UPDATE_TOL * scale + ulps)),
                      f"{label} rank {r} {name} {key}: the update differs from one device's "
                      f"by {float(d.max()):.3e}, its scale {scale:.3e}")
            for key in disc:
                w, g = ref["state"][key], got["state"][key]
                d = np.abs(g - w)
                worst_disc = max(worst_disc, float(d.max()))
                check(bool(np.all(d <= MESH_ADAM_TOL[1] + MESH_ADAM_TOL[0] * np.abs(w))),
                      f"{label} rank {r} {name} {key}: max |mesh - one device| {float(d.max())}")
            check(len(got["stats"]) == len(ref["stats"]),
                  f"{label} rank {r} {name}: stats {got['stats']} vs {ref['stats']}")
            for s, w in zip(got["stats"], ref["stats"]):
                check(set(s) == set(w), f"{label} rank {r} {name}: stats {s} vs {w}")
                for key, v in w.items():
                    tol = (1.0 / TRAIN_BATCH + 1e-7 if key.startswith("acc")
                           else 1e-5 * abs(v) + 1e-8)
                    check(math.isfinite(s[key]) and abs(s[key] - v) <= tol,
                          f"{label} rank {r} {name}: {key} {s[key]} vs one device's {v}")
            check(all(np.array_equal(got["state"][key], res[0][name]["state"][key])
                      for key in got["state"]),
                  f"{label}: rank {r}'s {name} state differs from rank 0's")
            if "at10" in ref:
                check(max(abs(a - b) for a, b in zip(got["at10"][:2], ref["at10"][:2]))
                      <= MESH_EVAL_TOL, f"{label} rank {r} {name}: sharded HR/NDCG@10 "
                      f"{got['at10']} vs one device's {ref['at10']}")
        rel = worst / max(scale, 1e-30)
        counts = {key: [x[name][key] for x in res]
                  for key in ("k1", *(kern.__name__ for kern in KERNELS))}
        launches[name] = {key: v for key, v in counts.items() if any(v)}
        evaluated = (f"; sharded HR/NDCG/AUC@10 {res[0][name]['at10']} vs one device's "
                     f"{ref['at10']}" if "at10" in ref else "")
        adam = f"; discriminators max |d| {worst_disc:.3e}" if disc else ""
        print(f"{label} {name}: {steps} steps; update max |mesh - one "
              f"device| {worst:.3e} ({rel:.2e} of its scale {scale:.3e}){adam}; ranks "
              f"bit-equal; stats {res[0][name]['stats']} vs {ref['stats']}{evaluated}; "
              f"launches by rank {launches[name]}")
    for kern in KERNELS:
        got = launches["apl"].get(kern.__name__, [0] * len(res))
        check(got == [MESH_APL_STEPS] * len(res),
              f"{label} apl: {kern.__name__} launched {got} times by rank, not "
              f"{MESH_APL_STEPS} each")
    for name, run in runs.items():
        check(not run[4] or all(n > 0 for n in launches[name].get("k1", [0])),
              f"{label} {name}: a rank's sharded evaluation never launched K1")
    return launches


def mesh_models_cli(video_counts, root):
    """Phase 26, last part: ``--mesh 1x1`` through the command line on NCCL
    (a group of one process) for ``MESH_CLI``, each beside the same command
    line without it, one epoch on phase 20's Video file: params and the
    evaluation equal. Returns K1's launches by run."""
    import torch.distributed as dist

    from acf_tpu_torch.ops.ranking import rank_positions_dot

    k1 = {}
    for model in MESH_CLI:
        argv = ["--model", model, "--data", "video", "--epochs", "1", "--d", str(D), "--bs",
                str(TRAIN_BATCH)]
        _, k_one, one = run_cli(root, argv, video_counts, 1, rank_positions_dot)
        _, k_mesh, mesh = run_cli(root, [*argv, "--mesh", "1x1"], video_counts, 1,
                                  rank_positions_dot)
        check(mesh.mesh is not None and mesh.mesh.shape == {"data": 1, "model": 1},
              f"cli {model} --mesh 1x1: the trainer had no mesh")
        check(not dist.is_initialized(), f"cli {model} --mesh 1x1: the group outlived the run")
        check(k_mesh == k_one > 0, f"cli {model}: K1 {k_mesh} under --mesh 1x1, {k_one} without")
        keys = [(side, n) for side in sorted(one.params) for n in sorted(one.params[side])]
        err, rel = tree_err([mesh.params[s][n].cpu() for s, n in keys],
                            [one.params[s][n].cpu() for s, n in keys])
        same = all(torch.equal(mesh.params[s][n], one.params[s][n]) for s, n in keys)
        res, ref = mesh.best["result"], one.best["result"]
        equal_eval = np.array_equal(res.hr, ref.hr) and np.array_equal(res.ndcg, ref.ndcg)
        print(f"cli {model} --mesh 1x1 (NCCL, one rank): K1 {k_mesh}; params against the "
              f"run without --mesh max |d| {err:.3e} ({rel:.2e} of scale), bit-equal {same}; "
              f"per-user HR and NDCG@1..100 equal {equal_eval}")
        check(rel <= APR_TOL, f"cli {model} --mesh 1x1: params differ from one device by {rel}")
        check(equal_eval, f"cli {model} --mesh 1x1: its evaluation differs from one device's")
        k1[f"cli_{model}_1x1"] = k_mesh
    return k1


def mesh_models_phase(dev, video):
    """Phase 26: every model under a mesh on the card, two gloo ranks on
    cuda:0 at 1x2 and 2x1 (both launched at once): K3a-K3e on each data
    rank's rows of a Video-shaped generator batch against their plain
    versions, APL's critic and generator steps at the Video shape and a few
    steps of every other family, each against one device (params, sharded
    evaluation), every rank's state bit-equal; then ``--mesh 1x1`` on NCCL
    for ``MESH_CLI`` through the command line. Returns the launches
    {run: {kernel: [by rank]}}."""
    import tempfile

    from acf_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    small = make_synthetic(1_500, VIDEO_ITEMS, 15_000, seed=26)
    rank_video, rank_small = dataclasses.replace(video), dataclasses.replace(small)
    runs = mesh_model_runs(rank_video, rank_small)
    inits = mesh_model_inits(dev, runs)
    refs = {name: rank_cases().train(None, dev, *mesh_model_call(run)[1])
            for name, run in runs.items()}
    print(f"phase 26 references on one device: {time.perf_counter() - t0:.1f} s")
    calls = [("apl_kernels", (rank_video, D, TRAIN_BATCH, MESH_SEED)),
             *(mesh_model_call(run) for run in runs.values())]

    def two_ranks(spec):
        t0 = time.perf_counter()
        res = launch.run(f"{CASES}:several", 2, spec, "cuda:0", calls, device="cuda:0",
                         backend="gloo", timeout=600.0)
        return res, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(MESH_SPECS)) as pool:  # both meshes at once: four ranks
        done = list(pool.map(two_ranks, MESH_SPECS))
    print(f"phase 26 two-rank launches, {len(MESH_SPECS)} at once: "
          f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    for spec, (res, wall) in zip(MESH_SPECS, done):
        for name, counts in check_mesh_models(spec, res, runs, refs, inits).items():
            launches[f"{name}_gloo_{spec}"] = counts
        print(f"mesh {spec}: every family on two ranks on cuda:0 over gloo in {wall:.1f} s "
              "with the ranks' start, beside the other mesh's launch (gloo staging through "
              "the host: not an NCCL or multi-GPU time)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        video_file, _ = write_reference_files(root)
        k1 = mesh_models_cli(expected_counts(video_file), root)
    launches.update({run: {"k1": [n]} for run, n in k1.items()})
    print(f"phase 26 cli: {time.perf_counter() - t0:.1f} s")
    return launches


# --- row-sharded storage and sharded snapshots: phase 27 ------------------------

SHARD_STEPS = 150          # steps of each phase of APR's clean -> APR runs on shards
SHARD_APL_STEPS = 4        # APL's critic and generator steps at the Video shape
SHARD_SEQ_STEPS = 3        # ASASRec's steps at maxlen 50
SNAP_STEPS = 50            # APR steps before and after the 2x2 snapshot
MEM_USERS, MEM_ITEMS = 200_000, 2_000_000
MEM_INTERACTIONS = 300_000  # uniform draws; the run takes 100 batches of 512 of its pairs
MEM_STEPS = 100
MEM_PEAK_RATIO = 0.6       # the 1x2 peak a rank at most this share of the 1x1 peak
SHARD_SEED = 27


def sharded_runs(video, ml1m):
    """name -> (spec, models, optimizer, data, epochs, steps, evaluate,
    positions): the runs of phase 27, each launched sharded
    (``shard_min_rows`` 1024) and with nothing sharded."""
    from acf_tpu_torch.models.apl import APL
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.train import adagrad, adam, sgd

    U, I = ml1m.num_users, ml1m.num_items
    apr = [MFBPR(U, I, D), MFBPR(U, I, D, adversarial=True, **APR)]
    ada = adagrad(0.05, initial_accumulator_value=0.1)
    sas = dict(maxlen=50)
    return {
        "apr_1x2": ("1x2", apr, ada, ml1m, [1, 1], SHARD_STEPS, False, True),
        "apr_2x2": ("2x2", apr, ada, ml1m, [1, 1], SHARD_STEPS, False, True),
        "apl_1x2": ("1x2", [APL(video.num_users, video.num_items, D)], sgd(0.05), video, [1],
                    SHARD_APL_STEPS, False, False),
        "apl_2x1": ("2x1", [APL(video.num_users, video.num_items, D)], sgd(0.05), video, [1],
                    SHARD_APL_STEPS, False, False),
        "asasrec_1x2": ("1x2", [SASRec(U, I, D, adversarial=True, **sas)],
                        adam(1e-3, b2=0.98), ml1m, [1], SHARD_SEQ_STEPS, False, False),
    }


def sharded_calls(runs, spec):
    """The rank cases of ``spec``'s runs: each sharded, then whole."""
    out = []
    for sp, models, opt, data, epochs, steps, ev, pos in runs.values():
        if sp == spec:
            for rows in (1024, 10 ** 9):
                out.append(("train", (models, opt, data, epochs, steps, SHARD_SEED,
                                      TRAIN_BATCH, True, None, None, ev, rows, pos)))
    return out


def memory_call(mem_data):
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.train import adagrad

    model = MFBPR(mem_data.num_users, mem_data.num_items, D, adversarial=True, **APR)
    return ("memory", (model, adagrad(0.05, initial_accumulator_value=0.1), mem_data,
                       MEM_STEPS))


def snapshot_model(ml1m):
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.train import adagrad

    return (MFBPR(ml1m.num_users, ml1m.num_items, D, adversarial=True, **APR),
            adagrad(0.05, initial_accumulator_value=0.1))


def snapshot_call(ml1m, actions):
    model, opt = snapshot_model(ml1m)
    return ("snapshots", (model, opt, ml1m, actions, 1024, TRAIN_BATCH, SHARD_SEED, "dcp",
                          SNAP_STEPS))


def check_sharded_pairs(label, results, names, card):
    """Each run's sharded result against its whole one on every rank, bit
    for bit, and every rank's against rank 0's (with one model rank,
    ``shard_min_rows`` shards nothing); returns {name: [sharded result by
    rank]}."""
    out = {}
    m = int(label.split("x")[-1])
    for i, name in enumerate(names):
        shard = [r[2 * i] for r in results]
        whole = [r[2 * i + 1] for r in results]
        for r, (a, b) in enumerate(zip(shard, whole)):
            check(("storage" in a) == (m > 1) and "storage" not in b,
                  f"{label} {name} rank {r}: stored sharded {'storage' in a} at m={m}")
            check(m == 1 or a["storage"]["pad_zero"],
                  f"{label} {name} rank {r}: a padded row moved")
            keys = sorted(b["state"])
            same = all(np.array_equal(a["state"][k], b["state"][k]) for k in keys)
            if not same:
                err = max(float(np.abs(a["state"][k] - b["state"][k]).max()) for k in keys)
                fail(f"{label} {name} rank {r}: sharded params and slots differ from the "
                     f"unsharded mesh run by {err:.3e} ({card})")
            check(a["stats"] == b["stats"], f"{label} {name} rank {r}: stats differ")
            check(all(np.array_equal(a["state"][k], shard[0]["state"][k]) for k in keys),
                  f"{label} {name}: rank {r}'s state differs from rank 0's")
        leaves = shard[0].get("storage", {"leaves": {}})["leaves"]
        sharded = sorted(n for n, (_, rows) in leaves.items() if rows is not None)
        if m == 1:
            what = ("nothing stored sharded (m=1): shard_min_rows 1024 leaves storage as it "
                    "was, the run bit-equal to the one with shard_min_rows 10^9")
        else:
            what = (f"sharded params and slots gathered bit-equal to the unsharded mesh run "
                    f"({len(sharded)} of {len(leaves)} leaves stored as row shards, e.g. "
                    f"{[(n, leaves[n]) for n in sharded[:2]]})")
        print(f"{label} {name}: {what} on every rank; launches by rank "
              f"{[{k: x[k] for k in ('k1', 'k2a', 'k2b', 'apl_stats1', 'apl_grad')} for x in shard]}")
        out[name] = shard
    return out


def check_memory(mem_data, one, two, card):
    """The 2,000,000-item APR run at 1x1 (NCCL; nothing sharded at m = 1,
    so the whole-table closed form) and on the row path at 1x2 (gloo): the
    stored bytes a rank, the peak a rank, and each rank's rows against
    1x1's tables by hash."""
    (whole,), shards = one, two
    u, i = mem_data.num_users, mem_data.num_items
    want = 2 * 4 * D * (-(-u // 2) + -(-i // 2))  # params and slots, each table's shard
    for r, x in enumerate(shards):
        check(x["sharded"], f"memory 1x2 rank {r}: nothing stored sharded")
        check(x["stored"] == want, f"memory 1x2 rank {r}: {x['stored']} bytes stored, not the "
              f"shards' {want}")
        for (name, k), h in x["hashes"].items():
            check(h == whole["hashes"][name, k],
                  f"memory 1x2 rank {r}: {name}'s rows of rank {k} differ from 1x1's table")
    ratio = max(x["peak"] for x in shards) / whole["peak"]
    print(f"memory ({card}): APR, {u} x {i} at d={D}, {MEM_STEPS} steps of {TRAIN_BATCH}: "
          f"stored {whole['stored']} B at 1x1 (NCCL, the whole-table closed form), "
          f"{[x['stored'] for x in shards]} B a rank at 1x2 (the row path; the shards' sum "
          f"{want}); peak max_memory_allocated {whole['peak']} B at 1x1, "
          f"{[x['peak'] for x in shards]} B a rank at 1x2 ({ratio:.3f} of the whole-table "
          f"path's); params after the steps at 1x2 equal to 1x1's "
          f"rows by SHA-256; {whole['wall_s']:.1f} s at 1x1, "
          f"{[round(x['wall_s'], 1) for x in shards]} s at 1x2 (gloo through the host)")
    check(ratio <= MEM_PEAK_RATIO, f"memory: the 1x2 peak is {ratio:.3f} of 1x1's, not at most "
          f"{MEM_PEAK_RATIO}")


def sharded_storage_phase(dev, video, ml1m):
    """Phase 27: row-sharded storage (``shard_min_rows`` 1024) and
    ``"dcp"`` snapshots on the card. At once: 1x2 and 2x1 over gloo on
    cuda:0 (two ranks each), 2x2 (four ranks), and 1x1 on NCCL. APR's two
    phases at the ml-1m shape at 1x2 and 2x2 (the row path), APL at the
    Video shape at 1x2 (K3a-K3e on gathered tables) and 2x1 (m = 1: nothing
    stored sharded, storage as it was), ASASRec at
    maxlen 50 at 1x2 (K2a, K2b), each bit-equal to the same mesh with
    nothing sharded; APR's sharded evaluation from the stored item shard
    (K1) against one device's positions; the 2,000,000-item APR run's
    stored bytes and peak a rank at 1x1 and 1x2; a 2x2 ``"dcp"`` snapshot
    (the 2x2 launch's first case), resumed on 2x2 bit for bit, and restored
    onto 1x1 (NCCL) and 1x2 by those launches' last cases once it is
    written. Returns the launches {run: {kernel: [by rank]}}."""
    import tempfile

    from acf_tpu_torch.eval.full_rank import FullRankEvaluator
    from acf_tpu_torch.models.mf import MFBPR
    from acf_tpu_torch.parallel import launch

    card = card_line()
    rank_cases()  # the ranks import it from the path
    t0 = time.perf_counter()
    rank_video, rank_ml1m = dataclasses.replace(video), dataclasses.replace(ml1m)
    runs = sharded_runs(rank_video, rank_ml1m)
    mem_data = make_synthetic(MEM_USERS, MEM_ITEMS, MEM_INTERACTIONS, seed=SHARD_SEED)
    print(f"phase 27 data: {mem_data.num_users} users x {mem_data.num_items} items, "
          f"{mem_data.num_pairs} train pairs, {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "apr_2x2")
        save = snapshot_call(rank_ml1m, [("epoch",), ("save", ck), ("state",), ("positions",),
                                         ("epoch",), ("state",)])
        resume = snapshot_call(rank_ml1m, [("restore", ck), ("state",), ("epoch",), ("state",)])
        restore = snapshot_call(rank_ml1m, [("await", ck, 500.0), ("restore", ck), ("state",),
                                            ("positions",)])
        plans = {  # spec: (ranks, device, backend, calls)
            "2x2": (4, "cuda:0", "gloo", [save, resume] + sharded_calls(runs, "2x2")),
            "1x2": (2, "cuda:0", "gloo",
                    [memory_call(mem_data)] + sharded_calls(runs, "1x2") + [restore]),
            "2x1": (2, "cuda:0", "gloo", sharded_calls(runs, "2x1")),
            "1x1": (1, "cuda", None, [memory_call(mem_data), restore]),
        }

        def ranks(spec):
            n, device, backend, calls = plans[spec]
            t1 = time.perf_counter()
            res = launch.run(f"{CASES}:several", n, spec, device, calls, device=device,
                             backend=backend, timeout=600.0)
            return res, time.perf_counter() - t1

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(plans)) as pool:
            done = dict(zip(plans, pool.map(ranks, plans)))
    print(f"phase 27 launches 2x2, 1x2, 2x1 (gloo on cuda:0) and 1x1 (NCCL) at once: "
          f"{time.perf_counter() - t0:.1f} s ({card}); "
          f"{ {k: round(v[1], 1) for k, v in done.items()} } s each with the ranks' start")
    check_memory(mem_data, [r[0] for r in done["1x1"][0]], [r[0] for r in done["1x2"][0]],
                 card)
    launches, by_spec = {}, {}
    for spec, cut in (("2x2", slice(2, None)), ("1x2", slice(1, -1)), ("2x1", slice(None))):
        res = [r[cut] for r in done[spec][0]]  # less the memory and snapshot cases
        names = [n for n, run in runs.items() if run[0] == spec]
        by_spec[spec] = (res, names)
        for name, shard in check_sharded_pairs(f"sharded {spec}", res, names, card).items():
            launches[name] = {k: [x[k] for x in shard] for k in
                              ("k1", "k2a", "k2b", *(f"apl_{p}" for p in (
                                  "stats1", "z", "fake", "bigr", "grad")))}
    # K3a-K3e SHARD_APL_STEPS times a rank, K2a and K2b in every ASASRec step
    for name in ("apl_1x2", "apl_2x1"):
        for k in ("apl_stats1", "apl_z", "apl_fake", "apl_bigr", "apl_grad"):
            check(launches[name][k] == [SHARD_APL_STEPS] * len(launches[name][k]),
                  f"{name}: {k} launched {launches[name][k]} times, not "
                  f"{SHARD_APL_STEPS} a rank")
    check(all(n > 0 for k in ("k2a", "k2b") for n in launches["asasrec_1x2"][k]),
          f"asasrec_1x2: K2a/K2b not launched on every rank: {launches['asasrec_1x2']}")
    # the sharded evaluation from the stored item shard against one device's K1
    ev = FullRankEvaluator(ml1m, batch_users=BATCH_USERS, device=dev)
    fs = MFBPR(ml1m.num_users, ml1m.num_items, D).factored_scorer()
    for name in ("apr_1x2", "apr_2x2"):
        res, names = by_spec[name[-3:]]
        shard = [r[2 * names.index(name)] for r in res]
        prm = {k: torch.as_tensor(shard[0]["state"][f"params/{k}"], device=dev)
               for k in ("P", "Q")}
        want = ev.positions_factored(fs[0], fs[1], prm)
        for r, x in enumerate(shard):
            check(np.array_equal(x["pos"], want),
                  f"{name} rank {r}: sharded positions from the stored item shard differ "
                  f"from one device's in {int((x['pos'] != want).sum())} users")
        check(all(n > 0 for n in launches[name]["k1"]), f"{name}: K1 not launched")
        print(f"{name}: positions of {len(want)} users from the stored item shard equal to "
              f"one device's K1 positions; K1 launches by rank {launches[name]['k1']}")
    # the 2x2 snapshot: resumed on 2x2 bit for bit, restored onto 1x1 (NCCL) and 1x2
    snap = [r[:2] for r in done["2x2"][0]]
    for r, (run, resumed) in enumerate(snap):
        saved, _, after = run
        check(saved["sharded"] and resumed[0]["sharded"], "snapshot 2x2: not sharded")
        for k, w in saved["state"].items():
            check(np.array_equal(resumed[0]["state"][k], w),
                  f"snapshot 2x2 rank {r}: restored {k} differs from the saved state")
        for k, w in after["state"].items():
            check(np.array_equal(resumed[1]["state"][k], w),
                  f"snapshot 2x2 rank {r}: {k} after {SNAP_STEPS} resumed steps differs")
    saved, ref_pos = snap[0][0][0], snap[0][0][1]["pos"]
    for spec in ("1x1", "1x2"):
        launches[f"snapshot_onto_{spec}"] = {"k1": []}
        for r, x in enumerate(done[spec][0]):
            state, pos = x[-1]
            check(state["sharded"] == (spec != "1x1"), f"restore onto {spec}: storage")
            for k, w in saved["state"].items():
                check(np.array_equal(state["state"][k], w),
                      f"restore onto {spec} rank {r}: {k} differs from the 2x2 save")
            check(np.array_equal(pos["pos"], ref_pos),
                  f"restore onto {spec} rank {r}: positions differ from the 2x2 trainer's")
            launches[f"snapshot_onto_{spec}"]["k1"].append(pos["k1"])
    print(f"snapshot ({card}): APR at 2x2 after {SNAP_STEPS} steps saved as a dcp directory "
          f"(each rank its rows, host-staged over gloo), resumed on 2x2 bit for bit over "
          f"{SNAP_STEPS} more steps, restored onto 1x1 (NCCL) and 1x2 with params, slots and "
          f"generator state bit-equal and positions of {len(ref_pos)} users equal (K1 "
          f"{launches['snapshot_onto_1x1']['k1']} at 1x1, "
          f"{launches['snapshot_onto_1x2']['k1']} a rank at 1x2)")
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    if not (ROOT / "acf_tpu_torch" / "csrc").is_dir():
        fail(f"the acf_tpu_torch package is not beside {Path(__file__).name}")
    import acf_tpu_torch
    from acf_tpu_torch.ops import _build

    check(Path(acf_tpu_torch.__file__).resolve().parent == ROOT / "acf_tpu_torch",
          f"acf_tpu_torch imported from {acf_tpu_torch.__file__}, not this checkout")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

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
        check_no_spill(log.read_text())
    from acf_tpu_torch.data import native_io

    t0 = time.perf_counter()
    native_io.library()
    print(f"build: {native_io.lib_path().name} (g++, the native parser) ready in "
          f"{time.perf_counter() - t0:.2f} s")
    lap("1-2")

    # 3. K1 against its plain version
    max_err = check_k1(dev)
    lap("3")

    # 4. MF-BPR full-catalog evaluation at Video scale
    t0 = time.perf_counter()
    data = make_synthetic(VIDEO_USERS, VIDEO_ITEMS, VIDEO_INTERACTIONS)
    print(f"data: {data.num_users} users x {data.num_items} items, "
          f"{data.num_pairs} train pairs, built in {time.perf_counter() - t0:.2f} s")
    model, params, ev, launches = run_eval(dev, data)
    time_eval("eval", ev, model, params)
    entry = k1_timing(dev, model, params, ev)

    # 5. MF-BPR serving
    users = check_serving(dev, model, params, data)
    time_serving("serve", dev, model, params, data, users)
    lap("4-5")

    # 6-10. SASRec: K2a, evaluation at maxlen 50 and 8, serving, K2a timing
    k2a_inference_err, k2a_inference, ml1m = sasrec_phases(dev, data)

    # 11-14. SASRec training: K2a's dropout form, K2b, fit_two_phase, timing
    k2a_entry, k2b_entry, wide_err = training_phases(dev, ml1m, data)
    k2a_entry["max_abs_err"] = max(k2a_entry["max_abs_err"], k2a_inference_err)
    k2a_entry["inference_ms"] = k2a_inference["ms"]
    if k2a_inference["timer"] != "profiler":
        k2a_entry["timer"] = k2a_inference["timer"]

    # 15-17. APL: K3a-K3e, the pretrained protocol at Video scale, timing
    k3_entries = apl_phases(dev, data)

    # 18-19. APR on the ml-1m-shaped set: fit_two_phase, the steps against
    # autograd and the CPU, the FGSM wrapper, timing
    k1_apr = apr_phases(dev, ml1m)

    # 20-21. The command line on the reference's file formats, the popularity
    # adversaries' steps against the CPU, their timing; between them, 28: the
    # SASRec paper's shape (asasrec --d 50 --maxlen 200) and bpr --d 50 on
    # phase 20's files, and the new forms' times; and 29: the bfloat16 forms
    # of K2a and K2b against their plain versions, their times, asasrec
    # --train_dtype bfloat16 through the command line (and under --mesh 1x1)
    k1_cli, apr_cli, (widths, wide_entry), (bf16, bf16_entries) = cli_phases(dev)

    # 22. The sequence zoo: steps against the CPU, timing, evaluations, the
    # session stream
    k1_zoo = zoo_phase(dev, data)
    lap("22")

    # 23. The single-device remainder: the sparse row-space APR step, IRGAN,
    # the naive baselines, their command lines
    k1_rest = rest_phase(dev, data, ml1m, ev)
    lap("23")

    # 24. Two same-seed epochs of APR and of APL, bit for bit
    determinism_phase(data, ml1m)
    lap("24")

    # 25. The mesh: --mesh 1x1 on NCCL, two ranks on the card over gloo
    mesh = mesh_phase(dev, data, ml1m, (model, params, ev), apr_cli)
    lap("25")

    # 26. Every model under a mesh: K3a-K3e on each rank's rows, APL at the
    # Video shape and every other family against one device, --mesh 1x1 on NCCL
    mesh_models = mesh_models_phase(dev, data)
    lap("26")

    # 27. Row-sharded storage: APR, APL and ASASRec on shards bit-equal to
    # the unsharded mesh runs, the sharded evaluation from the stored item
    # shard, the 2,000,000-item memory run, a 2x2 dcp snapshot restored
    # onto 2x2, 1x1 and 1x2
    sharded = sharded_storage_phase(dev, data, ml1m)
    lap("27")

    kernels = [{
        "name": "rank_count", "route": "cuda",
        "source": "acf_tpu_torch/csrc/rank_count.cu",
        "replaces": "acf_tpu/ops/ranking.py:39",
        "launches": launches, "max_abs_err": max_err, **entry, "launches_apr": k1_apr,
        "launches_cli": k1_cli, "launches_zoo": k1_zoo, "launches_rest": k1_rest,
        "launches_mesh": {run: v["k1"] for run, v in mesh.items()},
        "launches_mesh_models": {run: v["k1"] for run, v in mesh_models.items() if "k1" in v},
        "launches_widths": {run: v["k1"] for run, v in widths.items()},
    }, k2a_entry, k2b_entry, {
        "name": "sasrec_encoder_bwd_wide", "route": "cuda",
        "source": "acf_tpu_torch/csrc/sasrec_encoder_bwd.cu",
        "replaces": "acf_tpu/ops/sasrec_fused.py:236",
        "launches": widths["asasrec"]["k2b_wide"], "max_abs_err": wide_err, **wide_entry,
    }, *bf16_entries, *k3_entries]
    k2a_entry["launches_widths"] = widths["asasrec"]["k2a"]
    for entry in k3_entries:
        entry["launches_mesh_models"] = {run: v[entry["name"]] for run, v in mesh_models.items()
                                         if entry["name"] in v}
        entry["launches_widths"] = {run: v[entry["name"]] for run, v in widths.items()
                                    if entry["name"] in v}
    for entry, key in ((k2a_entry, "k2a"), (k2b_entry, "k2b")):
        entry["launches_mesh"] = {run: v[key] for run, v in mesh.items() if key in v}
    for entry, key in ((kernels[0], "k1"), (k2a_entry, "k2a"), (k2b_entry, "k2b"),
                       *((e, e["name"]) for e in k3_entries)):
        entry["launches_sharded"] = {run: v[key] for run, v in sharded.items()
                                     if key in v and any(v[key])}
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
