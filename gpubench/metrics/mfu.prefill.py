"""Model FLOPs of the window's prefill calls over its length and the bf16 peak
(gpubench.roofline.prefill_flops)."""
from gpubench import readers


def read(run):
    return readers.mfu_pct(run)
