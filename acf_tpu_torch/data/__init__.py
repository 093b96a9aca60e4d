"""Dataset ingestion (counterpart of ``acf_tpu.data``)."""

from acf_tpu_torch.data.datasets import Interactions, interactions_from_frame, load_dataset  # noqa: F401
