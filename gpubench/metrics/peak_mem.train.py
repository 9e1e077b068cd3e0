"""Peak device memory allocated over the train window, GiB (the allocator's
counter after a reset)."""
from gpubench import readers


def read(run):
    return readers.peak_gib(run)
