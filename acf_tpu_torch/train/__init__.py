"""Training (counterpart of ``acf_tpu.train``)."""

from acf_tpu_torch.train.optim import SGD, Adagrad, Adam, adagrad, adam, sgd  # noqa: F401
from acf_tpu_torch.train.trainer import TrainConfig, Trainer, fit_two_phase  # noqa: F401
