"""reprolint for the port — its static-analysis suite
(``repro_torch.analysis``), the counterpart of ``repro.analysis``.

Two levels, one driver:

  * run analyzers (:mod:`repro_torch.analysis.torchlint`) run every
    registered :class:`~repro_torch.core.program.SolverProgram` through
    its three lowerings at a tiny shape (:mod:`~repro_torch.analysis.
    harness`; on the CPU the kernels' plain versions stand in for their
    launches and count as they do) and enforce the dispatch budget
    (JX001), the no-dense-node-axis invariant on the three substrates
    and the sparse tier (JX002), f64 precision flow (JX003) and
    CommSignature wire pricing (JX004);
  * AST rules (:mod:`repro_torch.analysis.astlint`) enforce the source
    rules RL001–RL006 on ``src/repro_torch/``.

Run everything: ``python -m tools.reprolint_torch --all``.
Programmatic use::

    from repro_torch.analysis import run_all
    findings = run_all(repo_root=".")
"""
from repro_torch.analysis.astlint import check_source, run_ast_rules
from repro_torch.analysis.driver import main, run_all
from repro_torch.analysis.findings import (Finding, load_baseline,
                                           split_by_baseline, write_baseline)
from repro_torch.analysis.torchlint import analyze_program, analyze_programs

__all__ = ["Finding", "analyze_program", "analyze_programs", "check_source",
           "load_baseline", "main", "run_all", "run_ast_rules",
           "split_by_baseline", "write_baseline"]
