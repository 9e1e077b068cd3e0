"""Shared test config.

x64 is enabled globally: the paper's linear-MTRL path needs double
precision to exhibit the theoretical contraction cleanly.  Model/NN code
always passes explicit float32/bfloat16 dtypes, so it is unaffected.

NOTE: XLA_FLAGS device-count faking is deliberately NOT set here — smoke
tests run on the 1 real CPU device; only launch/dryrun.py (a separate
process) fakes 512 devices.
"""
import jax

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
