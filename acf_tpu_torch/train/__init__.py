"""Training-side utilities (counterpart of ``acf_tpu.train``)."""
