"""Synthetic multi-task linear-regression problem generator (paper Sec. II).

Port of ``src/repro/core/problem.py``.  Model: for task t ∈ [T],
y_t = X_t θ*_t with θ*_t = U* b*_t, Θ* = U* Σ* V*ᵀ rank-r, X_t ∈ R^{n×d}
i.i.d. standard Gaussian (Assumption 2), incoherent B* (Assumption 1).
Tasks are partitioned evenly over L nodes.

Draws come from an explicit ``torch.Generator`` on the CPU and the
tensors are then moved to ``device``, so a seed gives the same problem
on the CPU and on the card.  (They are not the JAX package's draws:
cross-package tests hand the reference's arrays over instead.)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class MTRLProblem:
    """A generated Dec-MTRL instance.

    X: (T, n, d) design matrices (or (F, T, n, d) when sample-split into
       F folds — see :func:`split_samples`).
    y: (T, n) responses (or (F, T, n)).
    U_star: (d, r) orthonormal ground-truth basis.
    B_star: (r, T) coefficients; Theta_star = U_star @ B_star.
    tasks_per_node: (L, T/L) int array — node g owns row g (the sets S_g).
    """
    X: torch.Tensor
    y: torch.Tensor
    U_star: torch.Tensor
    B_star: torch.Tensor
    sigma_max: float
    sigma_min: float
    mu: float
    tasks_per_node: np.ndarray

    @property
    def d(self) -> int:
        return self.U_star.shape[0]

    @property
    def r(self) -> int:
        return self.U_star.shape[1]

    @property
    def T(self) -> int:
        return self.B_star.shape[1]

    @property
    def n(self) -> int:
        return self.y.shape[-1]

    @property
    def L(self) -> int:
        return self.tasks_per_node.shape[0]

    @property
    def kappa(self) -> float:
        return self.sigma_max / self.sigma_min

    @property
    def Theta_star(self) -> torch.Tensor:
        return self.U_star @ self.B_star


def generate_problem(generator: torch.Generator, *, d: int, T: int, r: int,
                     n: int, L: int, kappa: float = 1.0,
                     noise_std: float = 0.0, dtype=torch.float64,
                     device="cpu") -> MTRLProblem:
    """Generate the paper's synthetic setting.

    U* = QR(Gaussian d×r); V* = QR(Gaussian T×r); Σ* = diag geomspace so
    the condition number is exactly ``kappa``; scaling keeps σ*_min = 1.
    ``generator`` is a CPU generator."""
    if T % L != 0:
        raise ValueError(f"simulator requires L | T, got T={T}, L={L}")

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype)

    U_star, _ = torch.linalg.qr(normal(d, r))
    V_star, _ = torch.linalg.qr(normal(T, r))
    sig = torch.as_tensor(np.geomspace(kappa, 1.0, r), dtype=dtype)
    B_star = sig[:, None] * V_star.T                     # (r, T)

    X = normal(T, n, d)
    Theta = U_star @ B_star                               # (d, T)
    y = torch.einsum("tnd,dt->tn", X, Theta)
    if noise_std > 0:
        y = y + noise_std * normal(*y.shape)

    # incoherence parameter mu of Assumption 1 (measured, not imposed)
    bt_norms2 = torch.sum(B_star ** 2, dim=0)
    mu = float(torch.sqrt(torch.max(bt_norms2) * T / (r * sig[0] ** 2)))

    tasks = np.arange(T).reshape(L, T // L)
    return MTRLProblem(X=X.to(device), y=y.to(device),
                       U_star=U_star.to(device), B_star=B_star.to(device),
                       sigma_max=float(sig[0]), sigma_min=float(sig[-1]),
                       mu=mu, tasks_per_node=tasks)


def split_samples(problem: MTRLProblem, n_folds: int) -> MTRLProblem:
    """Sample-splitting (Algorithm 3 line 4): partition each task's n
    samples into ``n_folds`` disjoint folds (requires n_folds | n).
    Returns a problem whose X/y carry a leading fold axis."""
    n = problem.n
    if n % n_folds != 0:
        raise ValueError(f"n_folds={n_folds} must divide n={n}")
    m = n // n_folds
    X = problem.X.reshape(problem.T, n_folds, m, problem.d).permute(1, 0, 2, 3)
    y = problem.y.reshape(problem.T, n_folds, m).permute(1, 0, 2)
    return dataclasses.replace(problem, X=X.contiguous(), y=y.contiguous())


def node_view(problem: MTRLProblem):
    """Reshape task-major data into node-major (L, T/L, ...) blocks."""
    L, tpn = problem.tasks_per_node.shape
    idx = torch.as_tensor(problem.tasks_per_node.reshape(-1),
                          device=problem.X.device)
    if problem.X.ndim == 4:   # folded
        Xg = problem.X[:, idx].reshape(problem.X.shape[0], L, tpn,
                                       problem.n, problem.d)
        yg = problem.y[:, idx].reshape(problem.y.shape[0], L, tpn,
                                       problem.n)
    else:
        Xg = problem.X[idx].reshape(L, tpn, problem.n, problem.d)
        yg = problem.y[idx].reshape(L, tpn, problem.n)
    return Xg, yg
