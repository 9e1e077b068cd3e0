"""Shared pieces of the AltGDmin solver family.

Partial port of ``src/repro/core/altgdmin.py``: the result type, the
sample-split fold selection, the per-iteration metrics and the step-size
rule.  The solver loop itself is the ``dif_altgdmin`` program of
:mod:`repro_torch.core.program`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.metrics import consensus_spread, subspace_distance


class RunResult(NamedTuple):
    U_nodes: torch.Tensor    # (L, d, r) final bases
    B_nodes: torch.Tensor    # (L, tpn, r) final coefficients
    sd_max: torch.Tensor     # (T_GD,) max_g SD₂(U_g, U*) per iteration
    sd_mean: torch.Tensor    # (T_GD,)
    spread: torch.Tensor     # (T_GD,) max_{g,g'} ||U_g − U_g'||_F
    eta: float
    # (T_GD,) measured per-iteration send rate (event-triggered rule
    # only); None for every other solver
    send_frac: Optional[torch.Tensor] = None


def _select(Xg, yg, fold):
    """Fold ``fold mod F`` of sample-split data (F, L, tpn, n, d); the
    data itself when there is no fold axis."""
    if Xg.ndim == 5:
        i = fold % Xg.shape[0]
        return Xg[i], yg[i]
    return Xg, yg


def _metrics(U_nodes, U_star):
    """(max_g SD₂, mean_g SD₂, consensus spread) as 0-d tensors on the
    device — no host sync."""
    sd = subspace_distance(U_nodes, U_star)
    return torch.max(sd), torch.mean(sd), consensus_spread(U_nodes)


def resolve_eta(eta, n, sigma_max=None, R_diag=None, L=None,
                c_eta: float = 0.4):
    """η = c_η / (n σ*max²) (Theorem 1).  When σ*max is unknown, estimate
    σ̂max² = L · max diag(R^(T_pm)) from the spectral init (the power
    method converges to the top eigenvalue of (1/L) Θ*Θ*ᵀ = σ*max²/L)."""
    if eta is not None:
        return float(eta)
    if sigma_max is not None:
        return c_eta / (n * sigma_max**2)
    sig2 = float(L * torch.max(R_diag))
    return c_eta / (n * sig2)
