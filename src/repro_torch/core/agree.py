"""AGREE — the agreement (gossip) protocol, Algorithm 1.

Port of ``src/repro/core/agree.py``.  Simulator form: all node variables
are stacked on a leading axis ``Z: (L, ...)`` and one gossip round is
the exact mixing product ``Z ← W @ Z``.

Proposition 1: after T_con rounds on a connected graph,
max_g |z_g − z̄| ≤ γ(W)^{T_con} · max_g |z_g^{(in)} − z̄|.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.consensus import (stacked_dense_mix,
                                               stacked_product)


def agree(Z, W, T_con: int):
    """Run T_con gossip rounds. Z: (L, ...), W: (L, L)."""
    return stacked_product(Z, W, T_con)


def agree_power(Z, W, T_con: int):
    """Equivalent single-product form using W^{T_con}."""
    Wp = torch.linalg.matrix_power(W, T_con)
    return stacked_dense_mix(Z, Wp, backend="torch-ref")
