"""Solver programs — the AltGDmin loop as data, and its simulator lowering.

Partial port of ``src/repro/core/program.py``.  A :class:`SolverProgram`
holds a solver's per-iteration ``update`` body, written against a
substrate-independent :class:`ProgramCtx` (``min_grad`` / ``mix`` /
``qr`` plus the step sizes), and the combine rule that carries its
communication.  :func:`lower_simulator` runs any program on the stacked
single-host simulator, here as a plain Python loop over T_GD with the
per-iteration metrics kept on the device (one host sync, at the end).

Registered: ``dif_altgdmin`` (Algorithm 3).  The JAX package's eleven
other programs and its mesh lowerings come with later slices of the
port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.altgdmin import RunResult, _metrics, _select
from repro_torch.core.engine import resolve_engine
from repro_torch.core.spectral import _qr_pos


class ProgramCtx(NamedTuple):
    """What a solver's per-iteration ``update`` may touch.

    ``min_grad(U, fold)`` — fused min-B + gradient on iteration
    ``fold``'s sample-split folds; ``mix`` — the combine closure;
    ``qr`` — the positive-diagonal QR retraction; ``eta_L`` — the
    step size η·L of the local adapt step."""
    min_grad: Callable
    mix: Callable
    qr: Callable
    eta_L: float


def _refit_last_min(T_GD: int) -> int:
    """The last min fold, 2·(T_GD−1): B is fit on the same data that
    produced the final U."""
    return 2 * (T_GD - 1)


@dataclasses.dataclass(frozen=True)
class SolverProgram:
    """One AltGDmin-family solver as data.

    ``update(ctx, U, tau) -> U_new`` is the per-iteration body, over the
    mixing matrix W; ``combine`` names the combine rule; ``spec_kwargs``
    the extra SolverSpec fields the solver takes; ``refit(T_GD)`` the
    ``_select`` index of the final B refit."""
    name: str
    combine: str
    update: Callable
    spec_kwargs: tuple = ()
    refit: Callable = _refit_last_min


def _upd_dif(ctx, U, tau):
    """Algorithm 3: adapt-then-combine."""
    _, G = ctx.min_grad(U, tau)
    U_breve = U - ctx.eta_L * G           # local adapt (line 12)
    U_tilde = ctx.mix(U_breve)            # diffusion   (line 13)
    return ctx.qr(U_tilde)                # projection  (line 14)


def lower_simulator(program: SolverProgram) -> Callable:
    """Stacked single-host simulator: ``run(U0, Xg, yg, W, *, eta, T_GD,
    T_con, U_star, engine, backend) -> RunResult``.  Xg (L, tpn, n, d),
    or (F, L, tpn, n, d) sample-split into F folds."""

    def run(U0, Xg, yg, W, *, eta, T_GD, T_con=1, U_star=None,
            engine=None, backend=None):
        eng = resolve_engine(engine, backend, device=U0.device)
        same_data = Xg.ndim == 4              # no sample-split fold axis
        U_star_ = U_star if U_star is not None else U0[0]
        eta_L = eta * U0.shape[0]
        mix = eng.make_mixer(W, T_con, rule=program.combine)

        def min_grad(U, fold):
            Xb, yb = _select(Xg, yg, 2 * fold)
            Xc, yc = _select(Xg, yg, 2 * fold + 1)
            return eng.min_grad(U, Xb, yb, Xc, yc, same_data=same_data)

        ctx = ProgramCtx(min_grad=min_grad, mix=mix,
                         qr=lambda M: _qr_pos(M)[0], eta_L=eta_L)
        U = U0
        trace = []
        for tau in range(T_GD):
            U = program.update(ctx, U, tau)
            trace.append(torch.stack(_metrics(U, U_star_)))
        sd_max, sd_mean, spread = (torch.stack(trace).T if trace
                                   else torch.zeros((3, 0), dtype=U0.dtype,
                                                    device=U0.device))
        B_fin = eng.minimize_B(U, *_select(Xg, yg, program.refit(T_GD)))
        return RunResult(U, B_fin, sd_max, sd_mean, spread, eta)

    run.__name__ = run.__qualname__ = f"{program.name}__simulator"
    run.__doc__ = (f"Simulator lowering of the {program.name!r} solver "
                   f"program (combine rule {program.combine!r}).")
    return run


# ----------------------------------------------------------------------
# program registry
# ----------------------------------------------------------------------

PROGRAMS: dict[str, SolverProgram] = {}


def register_program(program: SolverProgram) -> SolverProgram:
    if program.name in PROGRAMS:
        raise ValueError(f"solver program {program.name!r} already "
                         f"registered")
    PROGRAMS[program.name] = program
    return program


def get_program(name: str) -> SolverProgram:
    try:
        return PROGRAMS[name]
    except KeyError:
        raise ValueError(f"unknown solver program {name!r}; registered: "
                         f"{sorted(PROGRAMS)}") from None


def program_names() -> tuple[str, ...]:
    return tuple(sorted(PROGRAMS))


register_program(SolverProgram(
    name="dif_altgdmin", combine="gossip", update=_upd_dif))
