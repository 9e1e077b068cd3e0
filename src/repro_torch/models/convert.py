"""The weight carrier: the JAX package's parameter pytree as the port's
model.

:func:`params_from_jax` takes the tree that ``repro.models.init_params``
returns (nested dicts whose leaves are arrays: numpy, or anything
``numpy.asarray`` reads, such as a JAX array) and returns the
:class:`~repro_torch.models.transformer.LanguageModel` that computes the
same function.  No layout changes: the port keeps the JAX package's —
each segment's leaves carry its leading layer axes ((n,), or a zamba
segment's (n_groups, period)), the MoE experts are stacked (E, d, dff) /
(E, dff, d), and linear weights are ``(d_in, d_out)`` — so every leaf is
checked, path and shape, against
the tree :func:`~repro_torch.models.transformer.init_params` builds for
``cfg`` (on the meta device), and copied as it is.  This module imports
nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as tfm


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":              # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree, cfg, device=None):
    """The JAX package's parameters for ``cfg`` → the port's model on
    ``device`` (the card unless asked otherwise).  Raises ValueError if a
    leaf is missing, extra, or of another shape than ``cfg`` implies."""
    device = tfm.resolve_device(device)
    want = dict(tfm.leaves(tfm.init_params(cfg, device="meta")))

    def convert(node, prefix=""):
        if not isinstance(node, dict):
            t = _tensor(node, device)
            if prefix not in want:
                raise ValueError(f"unexpected leaf {prefix!r} for {cfg.name}")
            if tuple(t.shape) != tuple(want[prefix].shape):
                raise ValueError(f"leaf {prefix!r}: shape {tuple(t.shape)}, "
                                 f"want {tuple(want[prefix].shape)}")
            return t
        return {k: convert(v, f"{prefix}/{k}" if prefix else k)
                for k, v in node.items()}

    params = convert(tree)
    missing = set(want) - {path for path, _ in tfm.leaves(params)}
    if missing:
        raise ValueError(f"missing leaves for {cfg.name}: {sorted(missing)}")
    return tfm.LanguageModel(cfg, params)
