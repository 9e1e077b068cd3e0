"""Device operations a traced train step (device trace)."""
from gpubench import readers


def read(run):
    return readers.device_ops(run)
