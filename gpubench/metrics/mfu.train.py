"""Model FLOPs of the window's train steps over its length and the bf16 peak
(gpubench.roofline.train_step_flops)."""
from gpubench import readers


def read(run):
    return readers.mfu_pct(run)
