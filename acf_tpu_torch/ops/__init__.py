"""Kernels with their plain versions, and serving ops (counterpart of
``acf_tpu.ops``)."""
