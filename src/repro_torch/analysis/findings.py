"""Findings, fingerprints, and the baseline/suppression file.

Port of ``src/repro/analysis/findings.py``, kept as a copy of its own so
the analyzer imports nothing of the JAX package.  Every analyzer (run
level or AST level) reports :class:`Finding`s.  A
finding's *fingerprint* is deliberately line-insensitive —
``rule:path:symbol:detail`` — so a baseline entry survives unrelated
edits to the file and dies exactly when the flagged construct moves or
changes.  The baseline file (``tools/reprolint_torch/baseline.json``) is the
escape hatch for findings that are accepted-for-now: each entry must
carry a one-line justification, and ``python -m tools.reprolint_torch
--write-baseline`` emits a skeleton to fill in.  A clean tree ships an
EMPTY baseline.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit.

    ``rule`` is the rule id (``RL001``…``RL006`` for the AST level,
    ``JX001``…``JX004`` for the run level); ``path`` is repo-relative;
    ``line`` is 0 for whole-run findings (the run rules attach the
    recorded source location in ``detail`` instead); ``symbol`` names the
    enclosing function/solver/substrate so the fingerprint survives
    line drift."""
    rule: str
    path: str
    line: int
    symbol: str
    message: str
    detail: str = ""

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}:{self.detail}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.rule} {loc}{sym}: {self.message}"


def load_baseline(path) -> dict[str, str]:
    """fingerprint -> justification.  A missing file is an empty
    baseline; a present file must parse and every entry must carry a
    non-empty justification (an empty one defeats the point of a
    suppression file)."""
    p = pathlib.Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    out = {}
    for entry in data.get("suppressions", []):
        fp = entry.get("fingerprint", "")
        why = entry.get("justification", "")
        if not fp:
            raise ValueError(f"baseline entry without fingerprint: {entry}")
        if not why.strip() or why.strip().upper().startswith("TODO"):
            raise ValueError(
                f"baseline entry for {fp!r} has no justification — every "
                f"suppression must say why it is acceptable (the "
                f"--write-baseline skeleton's TODO placeholders do not "
                f"count)")
        out[fp] = why
    return out


def write_baseline(path, findings) -> None:
    """Emit a baseline skeleton for the given findings.  Justifications
    are left as TODO placeholders on purpose: the file will not LOAD
    until each is filled in, so a baseline can never silently accrete."""
    entries = [{"fingerprint": f.fingerprint,
                "justification": "TODO: justify or fix",
                "message": f.message}
               for f in sorted(findings, key=lambda f: f.fingerprint)]
    pathlib.Path(path).write_text(
        json.dumps({"suppressions": entries}, indent=2) + "\n")


def split_by_baseline(findings, baseline: dict[str, str]):
    """(new, suppressed, stale_fingerprints).  Stale entries — baseline
    fingerprints no finding matched — are reported so a fixed bug also
    removes its suppression."""
    new, suppressed = [], []
    seen = set()
    for f in findings:
        if f.fingerprint in baseline:
            suppressed.append(f)
            seen.add(f.fingerprint)
        else:
            new.append(f)
    stale = sorted(set(baseline) - seen)
    return new, suppressed, stale
