"""Negative samplers (counterpart of ``acf_tpu.sampling``)."""

from acf_tpu_torch.sampling.negatives import (  # noqa: F401
    sample_seq_batch, sample_seq_window_batch, seq_window_from_draws,
)
