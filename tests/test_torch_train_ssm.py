"""The port's trainer against the JAX package's on the smoke
mamba2-130m, on the CPU: three train steps of every aggregation strategy
at float64 and float32, and the JAX package's own jitted
``make_train_step_fused``.  The tolerances, and why, are in the
docstring of ``tests/torch_train_parity.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import aggregation as ragg  # noqa: E402
from torch_train_parity import (  # noqa: E402,F401
    check_reference_step, check_train_step, one_torch_thread,
)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("strategy", ragg.STRATEGIES)
def test_train_step_matches_jax(strategy, dtype):
    """Three steps of the port's fused step (and, at float32, of the
    unfused one) against the JAX package's; float32 also the first
    step's per-node gradients."""
    check_train_step("mamba2-130m", strategy, dtype)


def test_reference_step_is_jax_make_train_step():
    check_reference_step("mamba2-130m")
