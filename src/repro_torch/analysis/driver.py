"""The reprolint driver for the port — both analyzer levels, the
baseline, the CLI.

Port of ``src/repro/analysis/driver.py``.  Exit codes: 0 clean (or
every finding baselined), 1 findings or stale baseline entries, 2
usage.  The CLI front-end is ``tools/reprolint_torch``
(``python -m tools.reprolint_torch``).  Nothing here imports jax or the
JAX package.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis.findings import (Finding, load_baseline,
                                           split_by_baseline, write_baseline)

DEFAULT_BASELINE = "tools/reprolint_torch/baseline.json"


def run_all(repo_root=".", *, ast_level=True, run_level=True,
            programs=None, substrates=None) -> list[Finding]:
    """Every finding on the tree (pre-baseline)."""
    from repro_torch.analysis import astlint, torchlint
    from repro_torch.analysis.harness import ALL_SUBSTRATES

    findings: list[Finding] = []
    if ast_level:
        findings += astlint.run_ast_rules(repo_root)
    if run_level:
        from repro_torch.core.program import program_names
        findings += torchlint.analyze_programs(
            programs or program_names(), substrates or ALL_SUBSTRATES)
    return findings


def main(argv=None) -> int:
    from repro_torch.analysis.harness import ALL_SUBSTRATES

    ap = argparse.ArgumentParser(
        prog="reprolint_torch",
        description="run-level + AST static analysis for the PyTorch port "
                    "(see README 'Static analysis' for the rule table)")
    level = ap.add_mutually_exclusive_group()
    level.add_argument("--all", action="store_true",
                       help="both analyzer levels (the CI entry point)")
    level.add_argument("--ast", action="store_true",
                       help="AST rules RL001–RL006 only (fast, runs "
                            "nothing)")
    level.add_argument("--run", action="store_true",
                       help="run rules JX001–JX004 only")
    ap.add_argument("--program", action="append", default=None,
                    metavar="NAME",
                    help="restrict the run level to this program "
                         "(repeatable; default: all registered)")
    ap.add_argument("--substrate", action="append", default=None,
                    choices=ALL_SUBSTRATES,
                    help="restrict the run level to this substrate "
                         "(repeatable; default: all four, the sparse "
                         "tier's JX002 run included)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"suppression file (default {DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline as "
                         "TODO-justified suppressions and exit")
    args = ap.parse_args(argv)
    if not (args.all or args.ast or args.run):
        ap.error("pick a level: --all, --ast, or --run")

    root = pathlib.Path.cwd()
    if not (root / "src" / "repro_torch").is_dir():
        print("reprolint_torch: run from the repo root (src/repro_torch not "
              "found)", file=sys.stderr)
        return 2

    findings = run_all(
        root, ast_level=args.all or args.ast,
        run_level=args.all or args.run,
        programs=args.program, substrates=args.substrate)

    if args.write_baseline:
        write_baseline(root / args.baseline, findings)
        print(f"wrote {len(findings)} suppression skeleton(s) to "
              f"{args.baseline}; fill in every justification")
        return 0

    baseline = load_baseline(root / args.baseline)
    new, suppressed, stale = split_by_baseline(findings, baseline)

    for f in sorted(new, key=lambda f: (f.path, f.line, f.rule)):
        print(f.render())
    if suppressed:
        print(f"({len(suppressed)} finding(s) suppressed by "
              f"{args.baseline})")
    for fp in stale:
        print(f"stale baseline entry (fix landed — remove it): {fp}")

    if new or stale:
        print(f"reprolint_torch: {len(new)} finding(s), {len(stale)} stale "
              f"baseline entr(ies)")
        return 1
    print("reprolint_torch: clean")
    return 0
