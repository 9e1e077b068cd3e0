"""Checkpoint store: path-keyed .npz shards + a JSON manifest, with
crash-safe (stage-then-rename) saves.  ``latest_step`` only reports
complete checkpoints, so a hot-swapping reader (the serving side's
:class:`repro_torch.serving.publisher.HotSwapSource`) can never load a
partially written step.  Port of ``src/repro/checkpoint/``."""
from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,
                                          save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
