"""Device and precision policy.

Precision: the JAX package forces ``Precision.HIGHEST`` on every scoring
matmul (ops/ranking.py, eval/full_rank.py, ops/topk.py) because bf16
truncation shifted rank positions by up to ~50 of ~24k. TF32 would do the
same on the GPU, so it is switched off for matmuls and cuDNN at import.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`, defaulting to the current
    CUDA device.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is available: entry points never fall back to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:  # "cuda" -> "cuda:<current>", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
