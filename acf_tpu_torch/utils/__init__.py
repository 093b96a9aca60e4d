"""Host utilities (counterpart of ``acf_tpu.utils``)."""
