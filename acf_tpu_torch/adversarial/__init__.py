"""Adversarial training wrappers (counterpart of ``acf_tpu.adversarial``)."""

from acf_tpu_torch.adversarial.fgsm import FGSMAdversarial  # noqa: F401
from acf_tpu_torch.adversarial.popularity import PopularityAdversarial  # noqa: F401
