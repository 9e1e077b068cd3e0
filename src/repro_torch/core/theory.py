"""Theorem 1 / complexity formulas of the paper, as executable functions.

The port's own copy of ``src/repro/core/theory.py`` (pure ``math``, so
its values equal the reference's bit for bit).

These encode the *scaling* of the paper's guarantees (universal constants C
are arguments, default 1):

  * iteration counts  T_GD, T_pm, T_con,GD, T_con,init  (Theorem 1 a–b);
  * sample complexity  nT ≳ κ⁶ μ² (d+T) r (κ²r + log 1/ε)  (Theorem 1 c);
  * time  τ_time  and communication  τ_comm  complexities (Sec. III), for
    both Dif-AltGDmin (this paper) and Dec-AltGDmin [9] so the benchmark
    tables can show the claimed improvements (κ² vs κ⁴, ε-independent
    T_con,GD, no log d in τ_gd).

Also Proposition 1's consensus-round bound and the connectivity requirement
Eq. (2).
"""
from __future__ import annotations

import dataclasses
import math


def prop1_consensus_rounds(L: int, eps_con: float, gamma_W: float,
                           C: float = 1.0) -> int:
    """Proposition 1: T_con ≥ C · log(L/ε_con) / log(1/γ(W))."""
    if not 0.0 < gamma_W < 1.0:
        raise ValueError(f"need 0 < gamma(W) < 1, got {gamma_W}")
    return max(1, math.ceil(C * math.log(L / eps_con) / math.log(1.0 / gamma_W)))


def eq2_connectivity_requirement(L: int, eps_con: float, T_con: int,
                                 C: float = 1.0) -> float:
    """Eq. (2): γ(W) ≤ exp(−C log(L/ε_con)/T_con) — the largest admissible
    consensus contraction factor for a fixed round budget."""
    return math.exp(-C * math.log(L / eps_con) / T_con)


# ----------------------------------------------------------------------
# Theorem 1 parts a)–c)
# ----------------------------------------------------------------------

def T_pm(d: int, kappa: float, C: float = 1.0) -> int:
    """a) T_pm = Cκ²(log d + log κ)."""
    return max(1, math.ceil(C * kappa**2 * (math.log(d) + math.log(kappa))))


def T_con_init(L: int, d: int, r: int, kappa: float, gamma_W: float,
               C: float = 1.0) -> int:
    """a) T_con,init = C (log L + log d + log r + log κ)/log(1/γ(W))."""
    num = math.log(L) + math.log(d) + math.log(r) + math.log(max(kappa, 1.0 + 1e-12))
    return max(1, math.ceil(C * num / math.log(1.0 / gamma_W)))


def T_GD(kappa: float, eps: float, C: float = 1.0) -> int:
    """b) T_GD = Cκ² log(1/ε)."""
    return max(1, math.ceil(C * kappa**2 * math.log(1.0 / eps)))


def T_con_GD(L: int, r: int, kappa: float, gamma_W: float,
             C: float = 1.0) -> int:
    """b) T_con,GD = C (log L + log r + log κ)/log(1/γ(W)).

    The headline property: INDEPENDENT of the target accuracy ε, unlike
    Dec-AltGDmin's log(1/ε_con) ≳ log(Ldκ(1/ε)^{κ²})."""
    num = math.log(L) + math.log(r) + math.log(max(kappa, 1.0 + 1e-12))
    return max(1, math.ceil(C * num / math.log(1.0 / gamma_W)))


def T_con_GD_dec(L: int, d: int, kappa: float, eps: float, gamma_W: float,
                 C: float = 1.0) -> int:
    """Dec-AltGDmin's [9] consensus rounds per GD iteration:
    log(1/ε_con) ≳ log(L d κ (1/ε)^{κ²})  ⇒  grows with κ² log(1/ε)."""
    num = (math.log(L) + math.log(d) + math.log(max(kappa, 1.0 + 1e-12))
           + kappa**2 * math.log(1.0 / eps))
    return max(1, math.ceil(C * num / math.log(1.0 / gamma_W)))


def sample_complexity(d: int, T: int, r: int, kappa: float, mu: float,
                      eps: float, C: float = 1.0) -> float:
    """c) nT ≳ C κ⁶ μ² (d+T) r (κ²r + log(1/ε)) — lower bound on nT."""
    return C * kappa**6 * mu**2 * (d + T) * r * (kappa**2 * r + math.log(1.0 / eps))


def eta_star(n: int, sigma_max: float, c_eta: float = 0.4) -> float:
    """Theorem 1 step size η = c_η/(n σ*max²)."""
    return c_eta / (n * sigma_max**2)


def contraction_factor(kappa: float, c_eta: float = 0.4) -> float:
    """Per-iteration subspace-distance contraction of Lemma 1 Eq. (12):
    δ^(τ) ≤ (1 − 0.3 c_η/κ²) δ^(τ−1)."""
    return 1.0 - 0.3 * c_eta / kappa**2


# ----------------------------------------------------------------------
# Sec. III — time & communication complexity (Dif vs Dec), per paper
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ComplexityReport:
    algorithm: str
    tau_init: float      # initialization time complexity (flop-count scale)
    tau_gd: float        # GD-phase time complexity
    tau_comm: float      # total communication complexity (scalar-sends scale)
    T_pm: int
    T_GD: int
    T_con_init: int
    T_con_GD: int

    @property
    def tau_time(self) -> float:
        return self.tau_init + self.tau_gd


def _w_per_round(n: int, d: int, r: int, T: int) -> float:
    """ϖ = O(ndrT): aggregate per-round compute of one LS+grad (or PM) pass."""
    return float(n) * d * r * T


def dif_complexity(*, n: int, d: int, T: int, r: int, L: int, kappa: float,
                   eps: float, gamma_W: float, max_deg: int,
                   C: float = 1.0) -> ComplexityReport:
    """Eq. (4)-(5): τ_time = (T_con,init·T_pm)ϖ_init + (T_con,GD·T_GD)ϖ_gd,
    τ_comm = (T_con,init·T_pm + T_con,GD·T_GD)·(d r L max_deg)."""
    tpm = T_pm(d, kappa, C)
    tci = T_con_init(L, d, r, kappa, gamma_W, C)
    tgd = T_GD(kappa, eps, C)
    tcg = T_con_GD(L, r, kappa, gamma_W, C)
    w = _w_per_round(n, d, r, T)
    comm_unit = d * r * L * max_deg
    return ComplexityReport(
        algorithm="dif_altgdmin",
        tau_init=tci * tpm * w, tau_gd=tcg * tgd * w,
        tau_comm=(tci * tpm + tcg * tgd) * comm_unit,
        T_pm=tpm, T_GD=tgd, T_con_init=tci, T_con_GD=tcg)


def dec_complexity(*, n: int, d: int, T: int, r: int, L: int, kappa: float,
                   eps: float, gamma_W: float, max_deg: int,
                   C: float = 1.0) -> ComplexityReport:
    """Dec-AltGDmin [9] for comparison: κ⁴ scaling, ε-dependent consensus.

    τ_init ≈ κ⁴ max(log²d, log²κ, log²L, log²(1/ε))/log(1/γ) · ndrT
    τ_gd   ≈ κ⁴ log(1/ε) max(log(1/ε), log L, log d, log κ)/log(1/γ) · ndrT
    """
    # iteration structure: same T_pm/T_GD shape but with κ⁴-grade consensus
    tpm = max(1, math.ceil(C * kappa**2 * (math.log(d) + math.log(kappa))))
    # [9]'s T_con depends on ε (both phases)
    tci = T_con_GD_dec(L, d, kappa, eps, gamma_W, C)
    tgd = max(1, math.ceil(C * kappa**2 * math.log(1.0 / eps)))
    tcg = T_con_GD_dec(L, d, kappa, eps, gamma_W, C)
    w = _w_per_round(n, d, r, T)
    comm_unit = d * r * L * max_deg
    return ComplexityReport(
        algorithm="dec_altgdmin",
        tau_init=tci * tpm * w, tau_gd=tcg * tgd * w,
        tau_comm=(tci * tpm + tcg * tgd) * comm_unit,
        T_pm=tpm, T_GD=tgd, T_con_init=tci, T_con_GD=tcg)
