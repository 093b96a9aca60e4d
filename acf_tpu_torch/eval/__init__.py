"""Leave-one-out evaluation (counterpart of ``acf_tpu.eval``)."""

from acf_tpu_torch.eval.full_rank import EvalResult, FullRankEvaluator  # noqa: F401
from acf_tpu_torch.eval.metrics import mean_metrics, metrics_from_position  # noqa: F401
