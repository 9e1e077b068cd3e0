"""Share of the traced prefill window in which no device operation ran (device
trace, union of intervals)."""
from gpubench import readers


def read(run):
    return readers.idle_pct(run)
