"""Run-level analyzers: invariants of the lowerings, read off real runs.

Port of ``src/repro/analysis/jaxlint.py``, with its rule ids.  Each rule
is a checked property of a :class:`~repro_torch.analysis.harness.Case`
(a lowering run at a tiny shape by the harness, on the CPU inside
``_build.recording()`` or on the card):

  * **JX001 dispatch budget** — kernel launches per outer iteration
    (``_build.LAUNCHES``) equal the program's registered
    :class:`~repro_torch.core.program.DispatchBudget`, and exactly one
    launch (the final B refit) lies outside the loop.  A program with
    no budget is a finding too.
  * **JX002 no dense node axis** — no op may CREATE a buffer carrying
    two dims equal to the node count L (the 40 GB
    ``consensus_spread`` bug class).  Pass-throughs of an existing
    (L, L) operand — the small-L dense mixing tier — are fine; the rule
    fires where the quadratic buffer is born, and those sites must be
    on the allowlist below, each entry applying only where its size
    guard admits L.  Run on the three substrates and on the sparse tier
    (L = 520), where only ``consensus_spread``'s entry can apply.  A
    buffer born in numpy is RL002's business.
  * **JX003 precision flow** — on a float64 run, no op with a float64
    input may produce a float32 / bfloat16 / float16 output outside
    ``src/repro_torch/kernels/`` (the f32-accumulator kernels and their
    wrappers' operand casts).  This makes the ``_fused_wanted``
    f64-stays-exact gate checkable.
  * **JX004 comm pricing** — on the mesh and virtual substrates, rank
    0's point-to-point sends per outer iteration equal R × K × the
    rule's wire factor (``wire_mesh`` / ``wire_virtual``), and none lies
    outside the loop.  The simulator is exempt: its AGREE is a matrix
    product, nothing is sent.

A JX002 / JX003 site may also carry an inline marker on its line (or the
line above), ``# reprolint: allow=JX003 — <the guard>``, as the AST
rules' sites do.
"""
from __future__ import annotations

import functools
import pathlib
from typing import Callable, NamedTuple

from repro_torch.analysis import astlint
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.harness import (ALL_SUBSTRATES, SUBSTRATES,
                                          Case, run_cases)
from repro_torch.core.metrics import SPREAD_EXACT_MAX
from repro_torch.distributed.consensus import SPARSE_MIN_NODES

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]


class Allowed(NamedTuple):
    """A JX002 allowlist entry: why the (L, L) buffer is acceptable, and
    the size guard that caps it (``admits(L)``)."""
    why: str
    admits: Callable[[int], bool]


# JX002 allowlist: (repo-relative path, function) -> Allowed.  An entry
# applies only where its guard admits the run's L.
DENSE_NODE_AXIS_ALLOWLIST = {
    ("src/repro_torch/core/metrics.py", "consensus_spread"): Allowed(
        "exact pairwise diameter; consensus_spread switches to the "
        "O(L·d·r) radius above SPREAD_EXACT_MAX=4096 nodes",
        lambda L: L <= SPREAD_EXACT_MAX),
    ("src/repro_torch/distributed/consensus.py", "masked_mixing_matrix"):
        Allowed("per-iteration masked dense W; dense tier only — sparse "
                "topologies take the _sparse_masked_fold edge path from "
                "SPARSE_MIN_NODES=512 nodes",
                lambda L: L < SPARSE_MIN_NODES),
    ("src/repro_torch/distributed/consensus.py", "push_sum_matrix"): Allowed(
        "per-iteration column-stochastic dense W; dense tier only, the "
        "same SPARSE_MIN_NODES=512 gate as masked_mixing_matrix",
        lambda L: L < SPARSE_MIN_NODES),
}

# JX003: directories whose f64 → f32 narrowings are sanctioned (the
# f32-accumulator kernels and their wrappers).
SANCTIONED_NARROWING_DIRS = ("src/repro_torch/kernels/",)

LOWERING_PATH = "src/repro_torch/core/program.py"


def _sym(case: Case) -> str:
    return f"{case.program}/{case.substrate}"


@functools.lru_cache(maxsize=None)
def _markers(path: str):
    p = REPO_ROOT / path
    if not path or not p.is_file():
        return None
    return astlint._Markers(p.read_text(), path)


def _marked(rule: str, op) -> bool:
    """Whether the op's line (or the one above) carries a justified
    ``# reprolint: allow=<rule>`` marker."""
    m = _markers(op.path)
    return m is not None and m.allows(rule, op.line)


# ----------------------------------------------------------------------
# JX001 — dispatch budget
# ----------------------------------------------------------------------

def check_dispatch_budget(case: Case, budget) -> list[Finding]:
    if budget is None:
        return [Finding(
            rule="JX001", path=LOWERING_PATH, line=0, symbol=_sym(case),
            detail="missing-budget",
            message=f"program {case.program!r} registered without a "
                    f"DispatchBudget — every program must declare its "
                    f"per-iteration kernel launch count")]
    expected = budget.per_iter(case.substrate, case.rounds, case.n_shifts,
                               case.local_steps)
    got, outside = case.launches
    out = []
    if got != expected:
        by_kernel = {k: v for k, v in sorted(case.launches_by_kernel.items())
                     if v}
        out.append(Finding(
            rule="JX001", path=LOWERING_PATH, line=0, symbol=_sym(case),
            detail="per-iter",
            message=f"{got} kernel launches per outer iteration "
                    f"{by_kernel}, budget says {expected} "
                    f"(R={case.rounds}, K={case.n_shifts}, "
                    f"local_steps={case.local_steps})"))
    if outside != 1:
        out.append(Finding(
            rule="JX001", path=LOWERING_PATH, line=0, symbol=_sym(case),
            detail="outside-loop",
            message=f"{outside} kernel launches outside the outer loop; "
                    f"exactly 1 (the final B refit) is budgeted"))
    return out


# ----------------------------------------------------------------------
# JX002 — no dense node axis
# ----------------------------------------------------------------------

def check_dense_node_axis(case: Case) -> list[Finding]:
    out = []
    seen = set()
    for op in case.births:
        key = (op.path, op.func)
        allowed = DENSE_NODE_AXIS_ALLOWLIST.get(key)
        if (allowed is not None and allowed.admits(case.L)) or key in seen \
                or _marked("JX002", op):
            continue
        seen.add(key)
        out.append(Finding(
            rule="JX002", path=op.path or LOWERING_PATH, line=op.line,
            symbol=_sym(case), detail=f"{op.func}:{op.op}",
            message=f"op {op.op} in {op.func}() creates a dense node-axis "
                    f"buffer {op.shape} (two dims == L={case.L}) — O(L²) "
                    f"memory; use the sparse path or allowlist it with "
                    f"its size guard"))
    return out


# ----------------------------------------------------------------------
# JX003 — precision flow (the float64 runs)
# ----------------------------------------------------------------------

def check_precision_flow(case: Case) -> list[Finding]:
    if case.dtype != "float64":
        return []
    out = []
    seen = set()
    for op in case.narrowings:
        if op.path.startswith(SANCTIONED_NARROWING_DIRS) \
                or _marked("JX003", op):
            continue
        to = op.dtypes.split("->")[1]
        key = (op.path, op.func, to)
        if key in seen:
            continue
        seen.add(key)
        out.append(Finding(
            rule="JX003", path=op.path or LOWERING_PATH, line=op.line,
            symbol=_sym(case), detail=f"{op.func}:{to}",
            message=f"float64 value narrowed to {to} by {op.op} in "
                    f"{op.func}() — outside the sanctioned kernels/ "
                    f"accumulators, f64 runs must stay exact (the "
                    f"_fused_wanted gate)"))
    return out


# ----------------------------------------------------------------------
# JX004 — comm pricing
# ----------------------------------------------------------------------

def check_comm_pricing(case: Case, budget) -> list[Finding]:
    if case.substrate not in ("mesh", "virtual") or budget is None:
        return []            # JX001 already reports a missing budget
    wire = (budget.wire_mesh if case.substrate == "mesh"
            else budget.wire_virtual)
    expected = case.rounds * case.n_shifts * wire
    got, outside = case.sends
    out = []
    if got != expected:
        out.append(Finding(
            rule="JX004", path=LOWERING_PATH, line=0, symbol=_sym(case),
            detail="rounds",
            message=f"{got} point-to-point sends per outer iteration, but "
                    f"the CommSignature prices {expected} "
                    f"(rounds={case.rounds} × shifts={case.n_shifts} × "
                    f"wire={wire}) — the lowering's gossip structure and "
                    f"its wire pricing disagree"))
    if outside != 0:
        out.append(Finding(
            rule="JX004", path=LOWERING_PATH, line=0, symbol=_sym(case),
            detail="outside-loop",
            message=f"{outside} point-to-point sends outside the outer "
                    f"loop — unpriced communication"))
    return out


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

def check_case(case: Case, budget) -> list[Finding]:
    """Every run rule that applies to ``case``: the counted rules on the
    f32 runs of the three substrates, JX002 on every f32 run (the
    sparse tier's included), JX003 on the f64 runs."""
    if case.dtype == "float64":
        return check_precision_flow(case)
    findings = check_dense_node_axis(case)
    if case.substrate in SUBSTRATES:
        findings = (check_dispatch_budget(case, budget) + findings
                    + check_comm_pricing(case, budget))
    return findings


def analyze_programs(programs, substrates=ALL_SUBSTRATES) -> list[Finding]:
    """All four run rules for ``programs`` (names): f32 runs price the
    launch, dense-axis and send structure, an f64 run a substrate checks
    precision flow, and an f32 run on the sparse tier (``"sparse"``)
    checks JX002 at L = 520.  One spawn serves every mesh and virtual
    case."""
    from repro_torch.core.program import get_program

    cases = run_cases(programs, substrates)
    return [f for case in cases
            for f in check_case(case, get_program(case.program)
                                .dispatch_budget)]


def analyze_program(name: str, substrates=ALL_SUBSTRATES) -> list[Finding]:
    """:func:`analyze_programs` for one program."""
    return analyze_programs([name], substrates)
