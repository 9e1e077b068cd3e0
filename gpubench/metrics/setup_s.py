"""Set-up seconds: start to the window, kernels built or loaded, weights made,
every shape warmed (host clock)."""


def read(run):
    return run.setup_s
