"""The paper's own experimental configurations (Sec. V) as named presets.

Port of ``src/repro/configs/paper.py``, plus :func:`to_spec`, which turns
a preset into the :class:`~repro_torch.api.ExperimentSpec` the runner
takes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.api.spec import (EngineSpec, ExperimentSpec, InitSpec,
                                  ProblemSpec, SolverSpec, TopologySpec)


@dataclasses.dataclass(frozen=True)
class MTRLConfig:
    """One Dec-MTRL experiment setting."""
    name: str
    L: int            # nodes
    d: int            # feature dimension
    T: int            # tasks
    r: int            # subspace rank
    n: int            # samples per task
    p: float          # Erdős–Rényi edge probability
    kappa: float = 1.0
    T_GD: int = 500
    T_con: int = 10
    T_pm: int = 30
    seed: int = 0
    n_trials: int = 100


# Experiment 1 (Fig. 1): L=20, d=T=600, r=4, n=30, p=0.5, T_GD=500,
# T_con ∈ {10, 20, 30}
EXPERIMENT1 = tuple(
    MTRLConfig(name=f"exp1_Tcon{tc}", L=20, d=600, T=600, r=4, n=30, p=0.5,
               T_GD=500, T_con=tc)
    for tc in (10, 20, 30))

# Experiment 2 (Fig. 2): L=d=T=100, r=10, n=50, T_con=10, T_GD=1500,
# p ∈ {varied}
EXPERIMENT2 = tuple(
    MTRLConfig(name=f"exp2_p{p}", L=100, d=100, T=100, r=10, n=50, p=p,
               T_GD=1500, T_con=10)
    for p in (0.2, 0.5, 0.8))

# Scaled-down variants (same regimes, ~20× less compute).
EXPERIMENT1_SMALL = tuple(
    MTRLConfig(name=f"exp1s_Tcon{tc}", L=10, d=150, T=150, r=4, n=30, p=0.5,
               T_GD=250, T_con=tc, n_trials=5)
    for tc in (2, 5, 10))

EXPERIMENT2_SMALL = tuple(
    MTRLConfig(name=f"exp2s_p{p}", L=20, d=80, T=80, r=4, n=40, p=p,
               T_GD=300, T_con=5, n_trials=5)
    for p in (0.2, 0.5, 0.8))


def to_spec(cfg: MTRLConfig, *, dtype: str = "float64",
            backend: str | None = None) -> ExperimentSpec:
    """The ``dif_altgdmin`` experiment of one preset: an Erdős–Rényi
    graph G(L, p) with Metropolis weights, T_pm power-method rounds and
    T_con AGREE rounds in the init and in every iteration."""
    return ExperimentSpec(
        name=cfg.name,
        problem=ProblemSpec(d=cfg.d, T=cfg.T, r=cfg.r, n=cfg.n, L=cfg.L,
                            kappa=cfg.kappa, dtype=dtype),
        topology=TopologySpec(family="erdos_renyi", p=cfg.p, seed=cfg.seed,
                              weights="metropolis"),
        init=InitSpec(T_pm=cfg.T_pm, T_con=cfg.T_con),
        solver=SolverSpec(name="dif_altgdmin", T_GD=cfg.T_GD,
                          T_con=cfg.T_con),
        engine=EngineSpec(backend=backend))
