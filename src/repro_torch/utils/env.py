"""The port's environment-variable registry.

Every environment variable ``repro_torch`` reads is declared HERE and
read through the typed accessors below, so a misspelled name fails at
the registry instead of silently reading nothing.  The names carry a
``REPRO_TORCH_`` prefix of their own: the JAX package's ``REPRO_*``
variables (its ``pallas`` / ``pallas-interpret`` / ``xla-ref`` backend
names) are never read here, so a value left over for that package
cannot leak into the port.
"""
from __future__ import annotations

import os

ENV_VARS: dict[str, str] = {
    "REPRO_TORCH_KERNEL_BACKEND":
        "default kernel backend for repro_torch.kernels.ops when an op "
        "gets backend=None: 'cuda' | 'torch-ref'",
    "REPRO_TORCH_ENGINE_BACKEND":
        "default AltgdminEngine backend (falls back to "
        "REPRO_TORCH_KERNEL_BACKEND, then to the tensors' device); same "
        "choices",
}


def _lookup(name: str) -> str | None:
    if name not in ENV_VARS:
        raise KeyError(
            f"unknown env var {name!r}: every variable the port reads must "
            f"be declared in repro_torch.utils.env.ENV_VARS (declared: "
            f"{sorted(ENV_VARS)})")
    val = os.environ.get(name)
    return val if val else None          # unset and empty are both "off"


def read_choice(name: str, choices) -> str | None:
    """A validated enum read: unset → None, a value outside ``choices``
    → ValueError naming the offending variable."""
    val = _lookup(name)
    if val is not None and val not in choices:
        raise ValueError(
            f"invalid value {val!r} in environment variable {name}; "
            f"valid choices: {tuple(choices)}")
    return val
