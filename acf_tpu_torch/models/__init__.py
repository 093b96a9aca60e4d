"""Models (counterpart of ``acf_tpu.models``)."""
