"""The command line (counterpart of ``acf_tpu.cli``): ``python -m acf_tpu_torch.cli.main``."""
