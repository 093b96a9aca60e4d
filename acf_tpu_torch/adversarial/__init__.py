"""Adversarial training wrappers (counterpart of ``acf_tpu.adversarial``)."""

from acf_tpu_torch.adversarial.fgsm import FGSMAdversarial  # noqa: F401
