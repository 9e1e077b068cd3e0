"""Decentralized truncated spectral initialization — Algorithm 2.

Port of ``src/repro/core/spectral.py``.  Steps (per node g, node axis
leading):
  1. local truncation level  α_g^(in) = 9κ²μ² (L/nT) Σ_{t∈S_g} Σ_i y_ti²,
     AGREE'd to an approximate global average α_g;
  2. truncated covariance columns Θ_g^(0) = [ (1/n) X_tᵀ y_t,trnc ]_{t∈S_g};
  3. decentralized orthogonal (power) iteration on (1/L) Σ_g Θ_g Θ_gᵀ:
     local matmul → AGREE → local QR, repeated T_pm times (all nodes start
     from the SAME Gaussian draw, paper line 8);
  4. broadcast of node 0's basis via AGREE followed by a local QR.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.agree import agree
from repro_torch.distributed.consensus import maybe_sparsify


class SpectralInit(NamedTuple):
    U0: torch.Tensor        # (L, d, r) initial bases per node
    R_diag: torch.Tensor    # (L, r) diagonal of the final power-method R
    alpha: torch.Tensor     # (L,) truncation levels after AGREE


def _qr_pos(M):
    """QR with positive-diagonal R for determinism across nodes (a zero
    diagonal entry counts as positive)."""
    Q, R = torch.linalg.qr(M)
    s = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return Q * s[..., None, :], R * s[..., :, None]


def decentralized_spectral_init(generator: torch.Generator | None, Xg, yg,
                                W, *, kappa: float, mu: float, r: int,
                                T_pm: int, T_con: int,
                                broadcast: bool = True,
                                U_init=None) -> SpectralInit:
    """Xg: (L, tpn, n, d) node-major designs, yg: (L, tpn, n), W: (L, L).

    ``U_init`` is the common (d, r) Gaussian start; when None it is drawn
    from ``generator`` (a CPU generator).  Passing it lets a test start
    from exactly the JAX package's draw."""
    W = maybe_sparsify(W)
    L, tpn, n, d = Xg.shape
    T = L * tpn
    dtype = Xg.dtype

    # --- lines 3-4: truncation threshold, gossiped ---------------------
    alpha_in = 9.0 * kappa**2 * mu**2 * (L / (n * T)) * torch.sum(
        yg**2, dim=(1, 2))                                   # (L,)
    alpha = agree(alpha_in, W, T_con)

    # --- lines 5-7: truncated covariance columns ------------------------
    mask = (yg**2 <= alpha[:, None, None]).to(dtype)
    y_trnc = yg * mask
    # Θ_g^(0): (L, d, tpn); column t = (1/n) X_tᵀ y_t,trnc
    Theta0 = torch.einsum("gtnd,gtn->gdt", Xg, y_trnc) / n

    # --- lines 8-9: common Gaussian start, QR ---------------------------
    if U_init is None:
        U_init = torch.randn((d, r), generator=generator, dtype=dtype)
    U, _ = _qr_pos(U_init.to(device=Xg.device, dtype=dtype))
    U = U.expand(L, d, r)

    # --- lines 10-13: decentralized orthogonal iteration ----------------
    R_diag = None
    for _ in range(T_pm):
        V = Theta0 @ (Theta0.mT @ U)                      # Θ_gΘ_gᵀU_g
        V = agree(V, W, T_con)
        U, R = _qr_pos(V)
        R_diag = torch.diagonal(R, dim1=-2, dim2=-1)

    # --- lines 14-15: broadcast node 0's basis --------------------------
    if broadcast:
        U_bc = torch.zeros_like(U)
        U_bc[0] = U[0]
        U_bc = agree(U_bc, W, T_con)    # ≈ U_0 / L at every node
        U, _ = _qr_pos(U_bc)

    return SpectralInit(U0=U, R_diag=R_diag, alpha=alpha)
