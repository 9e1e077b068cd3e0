"""gossip_combine launches a traced train step (the port's _build.LAUNCHES)."""
from gpubench import readers


def read(run):
    return readers.launches(run, "gossip_combine")
