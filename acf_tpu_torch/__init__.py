"""acf_tpu_torch — the PyTorch/CUDA port of ``acf_tpu`` for NVIDIA Hopper.

A second package beside ``acf_tpu`` (the JAX reference, which it never
imports). It follows the reference's layout — ``data/``, ``models/``,
``eval/``, ``ops/``, ``train/`` — so every module has a counterpart there.
Params are plain ``dict[str, Tensor]`` trees shaped like the JAX pytrees
(``{"P": [U, d], "Q": [I, d]}`` for MF), and hand-written CUDA kernels live
in ``csrc/``, built at first use by :mod:`acf_tpu_torch.ops._build`.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.
"""

__version__ = "0.1.0"

from acf_tpu_torch.device import resolve_device  # noqa: F401  (sets precision policy)
