"""Data pipelines of the trainer: port of ``src/repro/data/``."""
from repro_torch.data.pipeline import (
    SyntheticLM, make_lm_batch, make_batch_for, node_task_loader,
)
