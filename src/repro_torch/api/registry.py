"""Solver registry — the AltGDmin-family algorithms behind ONE call
convention.

Port of ``src/repro/api/registry.py``.  Every registered solver is
derived from a :class:`~repro_torch.core.program.SolverProgram`: its
simulator and mesh entry points are the program's two lowerings, and
the call-convention metadata (which topology it consumes, the combine
rule that prices its communication, its extra SolverSpec knobs) comes
off the program.  Registered: ``dif_altgdmin``, ``dec_altgdmin``,
``centralized_altgdmin``, ``dgd_altgdmin``, ``exact_diffusion``,
``beyond_central`` and the compressed trio ``dif_topk`` /
``dif_quantized`` / ``dif_event``.  The JAX package's masked trio
raises NotImplementedError until a later slice of the port registers
it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.altgdmin import RunResult
from repro_torch.core.program import (SolverProgram, get_program,
                                      lower_mesh, lower_simulator,
                                      program_names)
from repro_torch.distributed.consensus import CommSignature, get_rule

# The JAX package's solvers that later slices of the port bring.
LATER_SLICE_SOLVERS = ("dif_partial", "dif_stale", "dif_pushsum")


@dataclasses.dataclass(frozen=True)
class SolverDef:
    """One registered algorithm.

    ``fn`` is the simulator entry point; ``call`` adapts the uniform
    convention onto it.  ``topology`` names what the solver consumes:
    ``"W"`` (mixing matrix), ``"adj"`` (adjacency), ``"none"`` (fusion
    center).  ``combine`` names the combine rule whose signature prices
    the wall-clock axis; ``mesh_fn`` is the one-node-per-rank mesh entry
    point; ``spec_kwargs`` the extra SolverSpec fields the solver takes;
    ``program`` the source program."""
    name: str
    fn: Callable
    topology: str = "W"             # "W" | "adj" | "none"
    combine: str = "gossip"
    decentralized: bool = True
    mesh_fn: Callable | None = None
    spec_kwargs: tuple = ()
    program: SolverProgram | None = None

    @property
    def mesh_capable(self) -> bool:
        return self.mesh_fn is not None

    def signature(self, T_con: int, **params) -> CommSignature:
        """The solver's per-iteration communication signature.
        ``params`` optionally carries the payload context (problem dims
        ``d``/``r`` + the SolverSpec compression knobs) so compressed
        rules can report their actual wire format; the others ignore
        it."""
        return get_rule(self.combine).signature(T_con, **params)

    def call(self, U0_nodes, Xg, yg, W, adj, *, eta: float, T_GD: int,
             T_con: int, U_star=None, engine=None, **extra) -> RunResult:
        """Uniform convention: stacked node-major inputs; the def routes
        the topology the solver needs (``W`` the mixing matrix, ``adj``
        the adjacency) and drops what it ignores.  ``extra`` forwards the
        fields named in ``spec_kwargs``."""
        kw = dict(eta=eta, T_GD=T_GD, U_star=U_star, engine=engine, **extra)
        if self.topology == "none":
            U0 = U0_nodes if self.decentralized else U0_nodes[0]
            return self.fn(U0, Xg, yg, **kw)
        if self.topology == "adj":
            return self.fn(U0_nodes, Xg, yg, adj, **kw)
        return self.fn(U0_nodes, Xg, yg, W, T_con=T_con, **kw)


SOLVERS: dict[str, SolverDef] = {}


def register_solver(solver: SolverDef) -> SolverDef:
    if solver.name in SOLVERS:
        raise ValueError(f"solver {solver.name!r} already registered")
    SOLVERS[solver.name] = solver
    return solver


def register_program_solver(name: str) -> SolverDef:
    """Derive and register a SolverDef from a registered program: its
    simulator and mesh entry points from the program's lowerings, the
    call convention from its fields."""
    p = get_program(name)
    return register_solver(SolverDef(
        name=p.name, fn=lower_simulator(p), topology=p.topology,
        combine=p.combine, decentralized=p.decentralized,
        mesh_fn=lower_mesh(p), spec_kwargs=p.spec_kwargs, program=p))


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
