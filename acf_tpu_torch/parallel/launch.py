"""Run a function on N ranks of a fresh process group (the counterpart of the
launcher in ``scripts/multiprocess_smoke.py``).

:func:`run` spawns ``world_size`` processes (``spawn`` start method: each
imports afresh, nothing of the caller's state is shared), which meet through
a ``file://`` rendezvous in a temporary directory, never a fixed TCP port,
so several launches can run side by side. Each rank initialises the default
group (:func:`acf_tpu_torch.parallel.mesh.init_distributed`), calls the
function named ``"module:function"`` with the given arguments, and writes its
result (pickled) into the directory. The call returns the ranks' results in
rank order, or raises if a rank raised, died or is still running at the
timeout (the ranks still running are then killed)::

    from acf_tpu_torch.parallel import launch
    # each of two CPU ranks calls function("2x1", "cpu") of module
    results = launch.run("module:function", 2, "2x1", "cpu", device="cpu")

The ranks import the function's module and what it imports, nothing else of
the caller: a module whose rank functions import no ``jax`` keeps the ranks
free of it.
"""

from __future__ import annotations

import importlib
import os
import pickle
import tempfile
import time
import traceback

import torch


def _rank_main(case, rank, world_size, root, backend, device, args, kwargs):
    """A rank's body: the group, the case, its result or its traceback."""
    try:
        torch.set_num_threads(1)  # ranks share the host's cores
        if device == "cuda":  # one card a rank
            device = f"cuda:{rank}"
        from acf_tpu_torch.parallel.mesh import init_distributed

        init_distributed(device, backend, init_method="file://" + os.path.join(root, "rdv"),
                         rank=rank, world_size=world_size)
        module, name = case.split(":")
        result = getattr(importlib.import_module(module), name)(*args, **kwargs)
        with open(os.path.join(root, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(root, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run(case: str, world_size: int, *args, device="cuda", backend=None,
        timeout: float = 120.0, **kwargs):
    """Run ``case`` ("module:function") on ``world_size`` new ranks and
    return their results in rank order. ``device``: ``"cuda"`` (the
    default) puts rank r on card r, over NCCL; ``"cpu"`` puts every rank on
    the CPU, over gloo; a device with an index (``"cuda:0"``, with
    ``backend="gloo"``) puts every rank on that one card. Raises
    ``RuntimeError`` naming the rank and its traceback if a rank fails,
    ``TimeoutError`` if one is still running after ``timeout`` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="acf_launch_") as root:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(case, r, world_size, root, backend, str(device), args,
                                   kwargs))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            running = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(root, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0 and r not in running:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError(f"{case} on {world_size} ranks failed:\n" + "\n".join(errors))
        if running:
            raise TimeoutError(f"{case} on {world_size} ranks: ranks {running} still running "
                               f"after {timeout} s")
        results = []
        for r in range(world_size):
            with open(os.path.join(root, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
