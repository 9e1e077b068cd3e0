"""Solver registry — the AltGDmin-family algorithms behind ONE call
convention.

Port of ``src/repro/api/registry.py``.  Every registered solver is
derived from a :class:`~repro_torch.core.program.SolverProgram`: its
simulator entry point is the program's simulator lowering, and the
combine rule that prices its communication comes off the program.
Registered: ``dif_altgdmin`` and the compressed trio ``dif_topk`` /
``dif_quantized`` / ``dif_event``.  The JAX package's other eight
solvers raise NotImplementedError until a later slice of the port
registers them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.altgdmin import RunResult
from repro_torch.core.program import (get_program, lower_simulator,
                                      program_names)
from repro_torch.distributed.consensus import CommSignature, get_rule

# The JAX package's solvers that later slices of the port bring.
LATER_SLICE_SOLVERS = ("dec_altgdmin", "centralized_altgdmin",
                       "dgd_altgdmin", "exact_diffusion", "beyond_central",
                       "dif_partial", "dif_stale", "dif_pushsum")


@dataclasses.dataclass(frozen=True)
class SolverDef:
    """One registered algorithm.

    ``fn`` is the simulator entry point; ``call`` adapts the uniform
    convention onto it.  ``combine`` names the combine rule whose
    signature prices the wall-clock axis; ``spec_kwargs`` the extra
    SolverSpec fields the solver takes."""
    name: str
    fn: Callable
    combine: str = "gossip"
    spec_kwargs: tuple = ()

    def signature(self, T_con: int, **params) -> CommSignature:
        """The solver's per-iteration communication signature.
        ``params`` optionally carries the payload context (problem dims
        ``d``/``r`` + the SolverSpec compression knobs) so compressed
        rules can report their actual wire format; the others ignore
        it."""
        return get_rule(self.combine).signature(T_con, **params)

    def call(self, U0_nodes, Xg, yg, W, adj, *, eta: float, T_GD: int,
             T_con: int, U_star=None, engine=None, **extra) -> RunResult:
        """Uniform convention: stacked node-major inputs, the mixing
        matrix ``W`` and the adjacency ``adj`` (which the solvers that
        average neighbours will take).  ``extra`` forwards the fields
        named in ``spec_kwargs``."""
        return self.fn(U0_nodes, Xg, yg, W, T_con=T_con, eta=eta,
                       T_GD=T_GD, U_star=U_star, engine=engine, **extra)


SOLVERS: dict[str, SolverDef] = {}


def register_solver(solver: SolverDef) -> SolverDef:
    if solver.name in SOLVERS:
        raise ValueError(f"solver {solver.name!r} already registered")
    SOLVERS[solver.name] = solver
    return solver


def register_program_solver(name: str) -> SolverDef:
    """Derive and register a SolverDef from a registered program."""
    p = get_program(name)
    return register_solver(SolverDef(
        name=p.name, fn=lower_simulator(p), combine=p.combine,
        spec_kwargs=p.spec_kwargs))


def get_solver(name: str) -> SolverDef:
    try:
        return SOLVERS[name]
    except KeyError:
        if name in LATER_SLICE_SOLVERS:
            raise NotImplementedError(
                f"solver {name!r} is not ported yet; a later slice of the "
                f"port brings it (ported: {sorted(SOLVERS)})") from None
        raise ValueError(f"unknown solver {name!r}; registered: "
                         f"{sorted(SOLVERS)}") from None


def solver_names() -> tuple[str, ...]:
    return tuple(sorted(SOLVERS))


for _name in program_names():
    register_program_solver(_name)
del _name
