"""Solver programs — the AltGDmin loop as data, and its lowerings.

Partial port of ``src/repro/core/program.py``.  A :class:`SolverProgram`
holds a solver's per-iteration ``update`` body, written against a
substrate-independent :class:`ProgramCtx` (``min_grad`` / ``mix`` /
``qr`` / ``all_sum`` plus the step sizes), the combine rule that carries
its communication, the lowering family of that combine (``mixer``) and
what rides the loop next to U (``aux``).  Two lowerings run a program:

  * :func:`lower_simulator` — the stacked single-host simulator, a plain
    Python loop over T_GD with the per-iteration metrics kept on the
    device (one host sync, at the end);
  * :func:`lower_mesh` — one node per rank of a
    :class:`~repro_torch.distributed.mesh.NodeMesh`, on the
    :func:`~repro_torch.core.runtime._altgdmin_mesh` skeleton, the
    combine crossing the wire by ``ppermute`` (or ``psum``).

Registered: the paper's four programs ``dif_altgdmin`` (Algorithm 3),
``dec_altgdmin``, ``centralized_altgdmin`` and ``dgd_altgdmin``, the
related-work combines ``exact_diffusion`` and ``beyond_central``, and
the compressed trio ``dif_topk`` / ``dif_quantized`` / ``dif_event``,
whose combine rules are stateful (the public copies of the
error-feedback scheme ride the ``aux`` slot; their mesh lowering comes
with a later slice).  The masked trio and the virtual-node mesh
lowering come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.altgdmin import RunResult, _metrics, _select
from repro_torch.core.engine import resolve_engine
from repro_torch.core.metrics import subspace_distance
from repro_torch.core.runtime import _altgdmin_mesh
from repro_torch.core.spectral import _qr_pos
from repro_torch.distributed.consensus import (ExactDiffusionCombine,
                                               get_rule,
                                               neighbor_average_matrix)


class ProgramCtx(NamedTuple):
    """What a solver's per-iteration ``update`` may touch.

    ``min_grad(U, fold)`` — min-B + gradient on iteration ``fold``'s
    sample-split folds; ``mix`` — the combine closure of the program's
    mixer family (``Z ↦ Z'``, or ``(Z, state) ↦ (Z', state')`` for the
    stateful rules); ``qr`` — the positive-diagonal QR retraction;
    ``eta`` / ``eta_L`` — the step size and η·L of the local adapt step;
    ``local_steps`` — beyond-central's local adapt epoch;
    ``all_sum`` — the fusion-center exact gradient sum (``central``
    programs only); ``send_fraction(Z, state)`` — the event rule's
    measured trigger rate (simulator only; None elsewhere)."""
    min_grad: Callable
    mix: Optional[Callable]
    qr: Callable
    eta: float
    eta_L: float
    local_steps: int
    all_sum: Optional[Callable]
    send_fraction: Optional[Callable]


# ----------------------------------------------------------------------
# refit-fold schedules (the _select index of the final B refit)
# ----------------------------------------------------------------------

def _refit_last_min(T_GD: int, local_steps: int) -> int:
    """The last min fold, 2·(T_GD−1): B is fit on the same data that
    produced the final U."""
    return 2 * (T_GD - 1)


def _refit_last_local(T_GD: int, local_steps: int) -> int:
    """Beyond-central: iteration T_GD−1's final LOCAL adapt step."""
    return 2 * (T_GD * local_steps - 1)


def _refit_first(T_GD: int, local_steps: int) -> int:
    """Centralized: the fold-0 refit."""
    return 0


# The mixer families ported so far (the JAX package also has masked /
# masked_state, brought with the masked trio).
MIXERS = ("plain", "neighbor", "central", "state")


class DispatchBudget(NamedTuple):
    """A program's kernel launches per outer iteration on the cuda
    backend, per substrate: coefficients ``(a, b, c, d)`` of

        count = a + R·(b + c·K) + d·local_steps

    where R is the combine rule's ``CommSignature.rounds_per_iter`` and
    K the number of cyclic shift classes of the decomposed mixing
    matrix (0 on the simulator — its AGREE chain is the hoisted
    W^{T_con} combine).  ``a`` counts the round-independent launches
    (the fused min-B + gradient; the hoisted combine), ``b``/``c`` the
    per-round and per-round-per-shift ones, ``d`` the local adapt
    epoch.  The final B refit, one launch outside the loop, is not
    counted."""
    simulator: tuple
    mesh: tuple

    def per_iter(self, substrate: str, rounds: int, n_shifts: int,
                 local_steps: int) -> int:
        a, b, c, d = getattr(self, substrate)
        return a + rounds * (b + c * n_shifts) + d * local_steps


@dataclasses.dataclass(frozen=True)
class SolverProgram:
    """One AltGDmin-family solver as data.

    ``update(ctx, U, aux, tau) -> (U_new, aux_new, extra)`` is the
    per-iteration body; ``aux`` names what rides the loop next to U
    (None | ``"iterate"`` — the previous adapt state, seeded with U0 |
    ``"state"`` — the combine rule's ``init_state``); ``extra`` is an
    optional per-iteration scalar recorded next to the metrics (the
    event rule's send fraction; None elsewhere).  ``combine`` names the
    combine rule and ``mixer`` its lowering family (``"plain"`` — a
    stateless ``Z ↦ Z'``; ``"neighbor"`` — one self-excluding neighbour
    average; ``"central"`` — no mix, an exact gradient sum; ``"state"``
    — the stateful ``(Z, state) ↦ (Z', state')``).  ``stacked=False``
    marks the fusion-center program, whose simulator carries a single
    (d, r) iterate; ``topology`` names what the solver consumes
    (``"W"`` the mixing matrix, ``"adj"`` the adjacency, ``"none"``).
    ``spec_kwargs`` are the extra SolverSpec fields the solver takes,
    ``rule_kwargs`` those forwarded to the stateful mixer and its
    ``init_state``, ``defaults`` their default values as ``((name,
    value), ...)``.  ``refit(T_GD, local_steps)`` is the ``_select``
    index of the final B refit."""
    name: str
    combine: str
    update: Callable
    mixer: str = "plain"
    stacked: bool = True
    topology: str = "W"              # "W" | "adj" | "none"
    decentralized: bool = True
    records_send_frac: bool = False
    aux: Optional[str] = None        # None | "iterate" | "state"
    spec_kwargs: tuple = ()
    rule_kwargs: tuple = ()
    defaults: tuple = ()             # ((name, value), ...)
    refit: Callable = _refit_last_min
    dispatch_budget: Optional[DispatchBudget] = None

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"bad mixer kind {self.mixer!r}; expected "
                             f"one of {MIXERS}")
        if self.aux not in (None, "iterate", "state"):
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


def _upd_dec(ctx, U, aux, tau):
    """Dec-AltGDmin [9]: combine-then-adjust (consensus on gradients)."""
    _, G = ctx.min_grad(U, tau)
    G_hat = ctx.mix(G)
    return ctx.qr(U - ctx.eta_L * G_hat), aux, None


def _upd_central(ctx, U, aux, tau):
    """AltGDmin [10] with a fusion center: exact gradient sum."""
    _, G = ctx.min_grad(U, tau)
    grad = ctx.all_sum(G)
    return ctx.qr(U - ctx.eta * grad), aux, None


def _upd_dgd(ctx, U, aux, tau):
    """DGD-variation (Experiment 1 iii): self-excluding neighbour
    average of the PREVIOUS iterate minus the plain-η local gradient."""
    _, G = ctx.min_grad(U, tau)
    nbr = ctx.mix(U)
    return ctx.qr(nbr - ctx.eta * G), aux, None


def _upd_exact_diffusion(ctx, U, psi_prev, tau):
    """Exact Subspace Diffusion (arXiv:2304.07358):
    adapt-correct-combine; aux carries the previous adapt state ψ."""
    _, G = ctx.min_grad(U, tau)
    psi = U - ctx.eta_L * G                        # adapt
    phi = ExactDiffusionCombine.correct(psi, psi_prev, U)
    return ctx.qr(ctx.mix(phi)), psi, None         # combine + project


def _upd_beyond_central(ctx, U, aux, tau):
    """Beyond Centralization (arXiv:2512.22675): ``local_steps`` full
    local adapt steps, then ONE combine round."""
    for j in range(ctx.local_steps):               # local adapt epoch
        fold = tau * ctx.local_steps + j
        _, G = ctx.min_grad(U, fold)
        U = ctx.qr(U - ctx.eta_L * G)
    return ctx.qr(ctx.mix(U)), aux, None           # one combine round


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
    """Stacked single-host simulator: ``run(U0, Xg, yg, topo, *, eta,
    T_GD, T_con, U_star, engine, backend, **spec_kw) -> RunResult``.
    ``topo`` is the mixing matrix (``"W"`` programs), the adjacency
    (``"adj"``), or absent (``"none"``); U0 is (L, d, r), or (d, r) for
    the fusion center.  Xg (L, tpn, n, d), or (F, L, tpn, n, d)
    sample-split into F folds; ``spec_kw`` the program's
    ``spec_kwargs``."""

    def run(U0, Xg, yg, topo=None, *, eta, T_GD, T_con=1, U_star=None,
            engine=None, backend=None, **spec_kw):
        kw = _resolve_spec(program, spec_kw)
        rule_kw = {k: kw[k] for k in program.rule_kwargs}
        local_steps = int(kw.get("local_steps", 1))
        eng = resolve_engine(engine, backend, device=U0.device)
        same_data = Xg.ndim == 4              # no sample-split fold axis
        if program.stacked:
            L = U0.shape[0]
            U_star_ = U_star if U_star is not None else U0[0]
        else:
            L = Xg.shape[0] if Xg.ndim == 4 else Xg.shape[1]
            U_star_ = U_star if U_star is not None else U0
        eta_L = eta * L
        rule = get_rule(program.combine)

        mix = all_sum = None
        if program.mixer == "plain":
            mix = eng.make_mixer(topo, T_con, rule=program.combine)
        elif program.mixer == "neighbor":
            mix = eng.make_neighbor_mixer(neighbor_average_matrix(topo))
        elif program.mixer == "central":
            def all_sum(G):
                return torch.sum(G, dim=0)    # fusion-center aggregation
        else:
            mix = eng.make_state_mixer(topo, T_con, rule=program.combine,
                                       **rule_kw)
        if program.aux == "iterate":
            aux = U0
        elif program.aux == "state":
            aux = rule.init_state(U0, **rule_kw)
        else:
            aux = None

        send_fraction = None
        if program.records_send_frac:
            threshold = float(kw.get("event_threshold", 0.0))

            def send_fraction(Z, st):
                return rule.send_fraction(Z, st, threshold)

        def nodes(U):
            """The fusion center's iterate, broadcast to every node."""
            return U if program.stacked else torch.broadcast_to(
                U[None], (L,) + tuple(U.shape))

        def min_grad(U, fold):
            Xb, yb = _select(Xg, yg, 2 * fold)
            Xc, yc = _select(Xg, yg, 2 * fold + 1)
            return eng.min_grad(nodes(U), Xb, yb, Xc, yc,
                                same_data=same_data)

        if program.stacked:
            def metrics(U_new):
                return _metrics(U_new, U_star_)
        else:
            def metrics(U_new):
                sd = subspace_distance(U_new, U_star_)
                return sd, sd, torch.zeros((), dtype=U_new.dtype,
                                           device=U_new.device)

        ctx = ProgramCtx(min_grad=min_grad, mix=mix,
                         qr=lambda M: _qr_pos(M)[0], eta=eta, eta_L=eta_L,
                         local_steps=local_steps, all_sum=all_sum,
                         send_fraction=send_fraction)
        U = U0
        trace, extras = [], []
        for tau in range(T_GD):
            U, aux, extra = program.update(ctx, U, aux, tau)
            trace.append(torch.stack(metrics(U)))
            if extra is not None:
                extras.append(extra)
        sd_max, sd_mean, spread = (torch.stack(trace).T if trace
                                   else torch.zeros((3, 0), dtype=U0.dtype,
                                                    device=U0.device))
        send_frac = None
        if program.records_send_frac:
            send_frac = (torch.stack(extras) if extras
                         else torch.zeros(0, device=U0.device))
        Xb, yb = _select(Xg, yg, program.refit(T_GD, local_steps))
        B_fin = eng.minimize_B(nodes(U), Xb, yb)
        U_out = U if program.stacked else U[None]
        return RunResult(U_out, B_fin, sd_max, sd_mean, spread, eta,
                         send_frac=send_frac)

    run.__name__ = run.__qualname__ = f"{program.name}__simulator"
    run.__doc__ = (f"Simulator lowering of the {program.name!r} solver "
                   f"program (combine rule {program.combine!r}).")
    return run


def lower_mesh(program: SolverProgram) -> Callable:
    """One-node-per-rank lowering on the shared
    :func:`~repro_torch.core.runtime._altgdmin_mesh` skeleton, called on
    every rank of the mesh: ``run(U0, Xg, yg, mesh, *, eta, T_GD, T_con,
    shifts, self_weight, W, engine, backend, U_star, **spec_kw)``.  U0,
    Xg and yg are the stacked (L, ...) arrays, of which rank g keeps node
    g's rows; ``W`` (a concrete mixing matrix, for ``"adj"`` programs
    the neighbour average) or ``shifts`` / ``self_weight`` (the uniform
    circulant) give the topology.  The stateful (``state``) mixers
    raise NotImplementedError: their mesh lowering comes with a later
    slice of the port."""

    def run(U0, Xg, yg, mesh, *, eta, T_GD, T_con=1, shifts=(-1, 1),
            self_weight=None, W=None, engine=None, backend=None,
            U_star=None, **spec_kw):
        kw = _resolve_spec(program, spec_kw)
        if program.mixer == "state":
            raise NotImplementedError(
                f"solver {program.name!r} mixes with the stateful "
                f"{program.combine!r} rule, whose mesh lowering comes with "
                f"a later slice of the port; use substrate='simulator'")
        local_steps = int(kw.get("local_steps", 1))
        eta_L = eta * mesh.size
        rule = get_rule(program.combine)
        if not program.stacked:
            # fusion center: every node starts (and stays) on node 0's
            # iterate — the psum keeps the rows identical
            U0 = torch.broadcast_to(U0[:1], U0.shape)

        def make_update(eng):
            mix = all_sum = None
            if program.mixer == "plain":
                mix = rule.make_mesh_mixer(mesh, T_con, shifts, self_weight,
                                           W=W, backend=eng.backend)
            elif program.mixer == "neighbor":
                # one self-excluding round; T_con and self_weight are
                # structurally ignored by the rule
                mix = rule.make_mesh_mixer(mesh, 1, shifts, W=W,
                                           backend=eng.backend)
            else:
                all_sum = mesh.psum

            def update(U, aux, mg):
                ctx = ProgramCtx(min_grad=lambda U_, fold: mg(U_), mix=mix,
                                 qr=lambda M: _qr_pos(M)[0], eta=eta,
                                 eta_L=eta_L, local_steps=local_steps,
                                 all_sum=all_sum, send_fraction=None)
                U_new, aux_new, _ = program.update(ctx, U, aux, 0)
                return U_new, aux_new
            return update

        init_aux = (lambda U: U) if program.aux == "iterate" else None
        return _altgdmin_mesh(U0, Xg, yg, mesh, eta=eta, T_GD=T_GD,
                              make_update=make_update, engine=engine,
                              backend=backend, U_star=U_star,
                              init_aux=init_aux)

    run.__name__ = run.__qualname__ = f"{program.name}__mesh"
    run.__doc__ = (f"Mesh lowering of the {program.name!r} solver "
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


# Budget shorthand: the adapt-then-combine family shares one shape — the
# simulator fuses min-grad + the hoisted W^{T_con} combine (2 launches,
# round-independent); the mesh keeps the combine per round (1 + R).
_BUDGET_DIFFUSION = DispatchBudget(
    simulator=(2, 0, 0, 0), mesh=(1, 1, 0, 0))

# The event rule: one combine launch per round on both stacked tiers.
_BUDGET_MASKED = DispatchBudget(
    simulator=(1, 1, 0, 0), mesh=(1, 1, 0, 0))

register_program(SolverProgram(
    name="dif_altgdmin", combine="gossip", update=_upd_dif,
    dispatch_budget=_BUDGET_DIFFUSION))

register_program(SolverProgram(
    name="dec_altgdmin", combine="gossip", update=_upd_dec,
    dispatch_budget=_BUDGET_DIFFUSION))

register_program(SolverProgram(
    name="centralized_altgdmin", combine="central", update=_upd_central,
    mixer="central", stacked=False, topology="none", decentralized=False,
    refit=_refit_first,
    dispatch_budget=DispatchBudget(
        simulator=(1, 0, 0, 0), mesh=(1, 0, 0, 0))))  # fusion center: psum

register_program(SolverProgram(
    name="dgd_altgdmin", combine="neighbor", update=_upd_dgd,
    mixer="neighbor", topology="adj",
    dispatch_budget=DispatchBudget(      # single self-excluding round
        simulator=(1, 1, 0, 0), mesh=(1, 1, 0, 0))))

register_program(SolverProgram(
    name="exact_diffusion", combine="exact_diffusion",
    update=_upd_exact_diffusion, aux="iterate",
    dispatch_budget=_BUDGET_DIFFUSION))

register_program(SolverProgram(
    name="beyond_central", combine="beyond_central",
    update=_upd_beyond_central, spec_kwargs=("local_steps",),
    defaults=(("local_steps", 1),), refit=_refit_last_local,
    dispatch_budget=DispatchBudget(      # one min-grad per LOCAL step,
        simulator=(0, 1, 0, 1),          # one combine round per iter
        mesh=(0, 1, 0, 1))))

register_program(SolverProgram(
    name="dif_topk", combine="topk_gossip", update=_upd_compressed,
    mixer="state", aux="state",
    spec_kwargs=("compression_k", "consensus_gamma"),
    rule_kwargs=("compression_k", "consensus_gamma"),
    defaults=(("compression_k", 0), ("consensus_gamma", 1.0)),
    dispatch_budget=DispatchBudget(      # encode + combine per round
        simulator=(1, 2, 0, 0), mesh=(1, 2, 0, 0))))

register_program(SolverProgram(
    name="dif_quantized", combine="quantized_gossip",
    update=_upd_compressed, mixer="state", aux="state",
    spec_kwargs=("compression", "consensus_gamma"),
    rule_kwargs=("compression", "consensus_gamma"),
    defaults=(("compression", None), ("consensus_gamma", 1.0)),
    dispatch_budget=DispatchBudget(      # per-shift dequant on mesh
        simulator=(1, 2, 0, 0), mesh=(1, 2, 1, 0))))

register_program(SolverProgram(
    name="dif_event", combine="event_gossip", update=_upd_compressed,
    mixer="state", aux="state", records_send_frac=True,
    spec_kwargs=("event_threshold", "consensus_gamma"),
    rule_kwargs=("event_threshold", "consensus_gamma"),
    defaults=(("event_threshold", 0.0), ("consensus_gamma", 1.0)),
    dispatch_budget=_BUDGET_MASKED))
