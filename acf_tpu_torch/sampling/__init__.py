"""Negative samplers (counterpart of ``acf_tpu.sampling``)."""

from acf_tpu_torch.sampling.negatives import (  # noqa: F401
    negatives_from_draws, pair_batches_from_perm, sample_pair_epoch, sample_seq_batch,
    sample_seq_window_batch, seq_window_from_draws, uniform_negatives,
)
