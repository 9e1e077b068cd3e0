"""ssd_scan's share of its roofline in the traced train steps: the least
time of its calls (gpubench.roofline.ssd_cost, a node's batch a call)
over its three bf16 passes' device time (device trace)."""
from gpubench import readers


def read(run):
    return readers.roofline_pct(run, "ssd_scan", readers.SSD,
                                readers.ssd_call_cost)
