"""95th percentile of every prompt's time to its last-position logits, dispatch
to synchronize (host clock)."""
from gpubench import readers


def read(run):
    return readers.latency_quantile_ms(run, 95)
