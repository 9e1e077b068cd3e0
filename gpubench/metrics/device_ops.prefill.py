"""Device operations a traced prefill call (device trace)."""
from gpubench import readers


def read(run):
    return readers.device_ops(run)
