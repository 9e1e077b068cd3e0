"""Solver programs — the AltGDmin loop as data, and its simulator lowering.

Partial port of ``src/repro/core/program.py``.  A :class:`SolverProgram`
holds a solver's per-iteration ``update`` body, written against a
substrate-independent :class:`ProgramCtx` (``min_grad`` / ``mix`` /
``qr`` plus the step sizes), the combine rule that carries its
communication, the lowering family of that combine (``mixer``) and what
rides the loop next to U (``aux``).  :func:`lower_simulator` runs any
program on the stacked single-host simulator, here as a plain Python
loop over T_GD with the per-iteration metrics kept on the device (one
host sync, at the end).

Registered: ``dif_altgdmin`` (Algorithm 3) and the compressed trio
``dif_topk`` / ``dif_quantized`` / ``dif_event``, whose combine rules
are stateful (the public copies of the error-feedback scheme ride the
``aux`` slot).  The JAX package's eight other programs, the other mixer
families and its mesh lowerings come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.altgdmin import RunResult, _metrics, _select
from repro_torch.core.engine import resolve_engine
from repro_torch.core.spectral import _qr_pos
from repro_torch.distributed.consensus import get_rule


class ProgramCtx(NamedTuple):
    """What a solver's per-iteration ``update`` may touch.

    ``min_grad(U, fold)`` — min-B + gradient on iteration ``fold``'s
    sample-split folds; ``mix`` — the combine closure of the program's
    mixer family (``Z ↦ Z'``, or ``(Z, state) ↦ (Z', state')`` for the
    stateful rules); ``qr`` — the positive-diagonal QR retraction;
    ``eta`` / ``eta_L`` — the step size and η·L of the local adapt step;
    ``send_fraction(Z, state)`` — the event rule's measured trigger
    rate (None for every other program)."""
    min_grad: Callable
    mix: Callable
    qr: Callable
    eta: float
    eta_L: float
    send_fraction: Optional[Callable]


def _refit_last_min(T_GD: int) -> int:
    """The last min fold, 2·(T_GD−1): B is fit on the same data that
    produced the final U."""
    return 2 * (T_GD - 1)


# The mixer families ported so far (the JAX package also has neighbor /
# central / masked / masked_state, brought with their programs).
MIXERS = ("plain", "state")


@dataclasses.dataclass(frozen=True)
class SolverProgram:
    """One AltGDmin-family solver as data.

    ``update(ctx, U, aux, tau) -> (U_new, aux_new, extra)`` is the
    per-iteration body; ``aux`` names what rides the loop next to U
    (None, or ``"state"`` — the combine rule's ``init_state``);
    ``extra`` is an optional per-iteration scalar recorded next to the
    metrics (the event rule's send fraction; None elsewhere).
    ``combine`` names the combine rule and ``mixer`` its lowering family
    (``"plain"`` — a stateless ``Z ↦ Z'``; ``"state"`` — the stateful
    ``(Z, state) ↦ (Z', state')``).  ``spec_kwargs`` are the extra
    SolverSpec fields the solver takes, ``rule_kwargs`` those forwarded
    to the stateful mixer and its ``init_state``, ``defaults`` their
    default values as ``((name, value), ...)``.  ``refit(T_GD)`` is the
    ``_select`` index of the final B refit."""
    name: str
    combine: str
    update: Callable
    mixer: str = "plain"
    records_send_frac: bool = False
    aux: Optional[str] = None        # None | "state"
    spec_kwargs: tuple = ()
    rule_kwargs: tuple = ()
    defaults: tuple = ()             # ((name, value), ...)
    refit: Callable = _refit_last_min

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"bad mixer kind {self.mixer!r}; expected "
                             f"one of {MIXERS}")
        if self.aux not in (None, "state"):
            raise ValueError(f"bad aux kind {self.aux!r}")


def _resolve_spec(program: SolverProgram, spec_kw: dict) -> dict:
    unknown = set(spec_kw) - set(program.spec_kwargs)
    if unknown:
        raise TypeError(f"solver {program.name!r} got unexpected spec "
                        f"kwargs {sorted(unknown)}; takes "
                        f"{sorted(program.spec_kwargs)}")
    kw = dict(program.defaults)
    kw.update(spec_kw)
    return kw


# ----------------------------------------------------------------------
# per-iteration update bodies
# ----------------------------------------------------------------------

def _upd_dif(ctx, U, aux, tau):
    """Algorithm 3: adapt-then-combine."""
    _, G = ctx.min_grad(U, tau)
    U_breve = U - ctx.eta_L * G           # local adapt (line 12)
    U_tilde = ctx.mix(U_breve)            # diffusion   (line 13)
    return ctx.qr(U_tilde), aux, None     # projection  (line 14)


def _upd_compressed(ctx, U, cstate, tau):
    """Adapt-then-combine over a STATEFUL compressed rule; the error-
    feedback state rides the aux slot.  The measured send fraction
    (event rule) is recorded BEFORE the mix — the same first-round
    trigger decision the encode uses."""
    _, G = ctx.min_grad(U, tau)
    U_breve = U - ctx.eta_L * G                    # local adapt
    sf = (ctx.send_fraction(U_breve, cstate)
          if ctx.send_fraction is not None else None)
    U_tilde, cstate = ctx.mix(U_breve, cstate)     # compressed diffusion
    return ctx.qr(U_tilde), cstate, sf             # projection


# ----------------------------------------------------------------------
# the simulator lowering
# ----------------------------------------------------------------------

def lower_simulator(program: SolverProgram) -> Callable:
    """Stacked single-host simulator: ``run(U0, Xg, yg, W, *, eta, T_GD,
    T_con, U_star, engine, backend, **spec_kw) -> RunResult``.
    Xg (L, tpn, n, d), or (F, L, tpn, n, d) sample-split into F folds;
    ``spec_kw`` the program's ``spec_kwargs``."""

    def run(U0, Xg, yg, W, *, eta, T_GD, T_con=1, U_star=None,
            engine=None, backend=None, **spec_kw):
        kw = _resolve_spec(program, spec_kw)
        rule_kw = {k: kw[k] for k in program.rule_kwargs}
        eng = resolve_engine(engine, backend, device=U0.device)
        same_data = Xg.ndim == 4              # no sample-split fold axis
        U_star_ = U_star if U_star is not None else U0[0]
        eta_L = eta * U0.shape[0]
        rule = get_rule(program.combine)
        if program.mixer == "state":
            mix = eng.make_state_mixer(W, T_con, rule=program.combine,
                                       **rule_kw)
        else:
            mix = eng.make_mixer(W, T_con, rule=program.combine)
        aux = (rule.init_state(U0, **rule_kw) if program.aux == "state"
               else None)

        send_fraction = None
        if program.records_send_frac:
            threshold = float(kw.get("event_threshold", 0.0))

            def send_fraction(Z, st):
                return rule.send_fraction(Z, st, threshold)

        def min_grad(U, fold):
            Xb, yb = _select(Xg, yg, 2 * fold)
            Xc, yc = _select(Xg, yg, 2 * fold + 1)
            return eng.min_grad(U, Xb, yb, Xc, yc, same_data=same_data)

        ctx = ProgramCtx(min_grad=min_grad, mix=mix,
                         qr=lambda M: _qr_pos(M)[0], eta=eta, eta_L=eta_L,
                         send_fraction=send_fraction)
        U = U0
        trace, extras = [], []
        for tau in range(T_GD):
            U, aux, extra = program.update(ctx, U, aux, tau)
            trace.append(torch.stack(_metrics(U, U_star_)))
            if extra is not None:
                extras.append(extra)
        sd_max, sd_mean, spread = (torch.stack(trace).T if trace
                                   else torch.zeros((3, 0), dtype=U0.dtype,
                                                    device=U0.device))
        send_frac = None
        if program.records_send_frac:
            send_frac = (torch.stack(extras) if extras
                         else torch.zeros(0, device=U0.device))
        B_fin = eng.minimize_B(U, *_select(Xg, yg, program.refit(T_GD)))
        return RunResult(U, B_fin, sd_max, sd_mean, spread, eta,
                         send_frac=send_frac)

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

register_program(SolverProgram(
    name="dif_topk", combine="topk_gossip", update=_upd_compressed,
    mixer="state", aux="state",
    spec_kwargs=("compression_k", "consensus_gamma"),
    rule_kwargs=("compression_k", "consensus_gamma"),
    defaults=(("compression_k", 0), ("consensus_gamma", 1.0))))

register_program(SolverProgram(
    name="dif_quantized", combine="quantized_gossip",
    update=_upd_compressed, mixer="state", aux="state",
    spec_kwargs=("compression", "consensus_gamma"),
    rule_kwargs=("compression", "consensus_gamma"),
    defaults=(("compression", None), ("consensus_gamma", 1.0))))

register_program(SolverProgram(
    name="dif_event", combine="event_gossip", update=_upd_compressed,
    mixer="state", aux="state", records_send_frac=True,
    spec_kwargs=("event_threshold", "consensus_gamma"),
    rule_kwargs=("event_threshold", "consensus_gamma"),
    defaults=(("event_threshold", 0.0), ("consensus_gamma", 1.0))))
