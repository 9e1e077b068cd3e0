"""flash_attention's share of its roofline in the traced prefill calls:
the least time of its calls (gpubench.roofline.flash_cost) over its
kernel's device time (device trace)."""
from gpubench import readers


def read(run):
    return readers.roofline_pct(run, "flash_attention",
                                readers.FLASH, readers.flash_call_cost)
