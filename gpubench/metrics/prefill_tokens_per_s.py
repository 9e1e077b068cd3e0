"""Every prompt token prefilled in the window over its length (host clock)."""
from gpubench import readers


def read(run):
    return readers.tokens_per_s(run)
