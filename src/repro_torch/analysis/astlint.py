"""AST rules over the port's sources (``src/repro_torch/``).

Port of ``src/repro/analysis/astlint.py``: the same rule ids, the same
inline markers, the paths retargeted to the port.

  * **RL001** — bare ``assert`` in ``src/repro_torch/kernels/``: kernel
    shape contracts die silently under ``python -O``; raise instead.
  * **RL002** — ``.to_dense()`` / ``.adj`` access outside
    ``distributed/graphs.py`` (which defines them): every dense (L, L)
    materialization site must carry an inline justification naming the
    guard that keeps L small there.
  * **RL003** — ``REPRO_*`` environment variables: reads must go through
    the :mod:`repro_torch.utils.env` registry, and every ``REPRO_*``
    string literal in the port must be a declared key of
    ``ENV_VARS`` (its ``REPRO_TORCH_*`` names; the JAX package's
    ``REPRO_*`` variables are never read by the port, so a literal of
    one is undeclared here).
  * **RL004** — unseeded randomness: numpy's legacy global RNG
    (``np.random.rand`` etc., or an argless ``default_rng()``), and
    torch's global generator — a ``torch.rand`` / ``randn`` /
    ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
    ``multinomial`` call, or an in-place ``normal_`` / ``uniform_`` /
    ``bernoulli_`` / ``random_`` / ``exponential_``, without
    ``generator=``.  The port threads explicit generators; JAX has no
    global generator, so the torch half is the same rule's purpose.
  * **RL005** — ``SolverProgram.update`` bodies (the ``_upd_*``
    functions) must be pure: no attribute mutation, no free variables
    beyond ``ctx`` / arguments / builtins / the declared-pure
    allowlist, and no Python ``if`` on a tensor argument (in torch an
    implicit device → host sync, and a branch the lowerings do not
    share).
  * **RL006** — ``repro_torch.core.runtime`` holds ONLY the two substrate
    skeletons and the iteration loop they share (``_rank_loop``).

Suppression is inline, never invisible::

    x = g.to_dense()   # reprolint: allow=RL002 — spectral-init tier, L <= DENSE_MATERIALIZE_MAX

The marker must name the rule AND carry a justification after the dash;
a bare marker is itself a finding (RL000).  Markers are honored on the
flagged line or the line immediately above it.
"""

from __future__ import annotations

import ast
import builtins
import pathlib
import re

from repro_torch.analysis.findings import Finding

KERNELS_DIR = "src/repro_torch/kernels/"
ENV_REGISTRY_PATH = "src/repro_torch/utils/env.py"
RUNTIME_PATH = "src/repro_torch/core/runtime.py"
# the two skeletons, and the T_GD loop both of them run (one body, so
# the two tiers cannot drift apart in what an iteration records)
RUNTIME_ALLOWED = {"_altgdmin_mesh", "_altgdmin_virtual_mesh", "_rank_loop"}

# RL002: files whose job IS the dense/sparse boundary — graphs.py
# defines Graph.adj and the SparseGraph.adj property that itself raises
# above DENSE_MATERIALIZE_MAX, so flagging it would be circular.
RL002_EXEMPT_FILES = ("src/repro_torch/distributed/graphs.py",)

# RL005: module-level names an update body may capture besides builtins
# — each must be a pure, stateless callable.
RL005_PURE_CAPTURES = {"ExactDiffusionCombine"}

_ENV_LITERAL = re.compile(r"^REPRO_[A-Z0-9_]+$")
_MARKER = re.compile(
    r"#\s*reprolint:\s*allow=(?P<rules>[A-Z0-9,]+)"
    r"(?:\s*[—–-]+\s*(?P<why>\S.*))?")

ALL_RULES = ("RL001", "RL002", "RL003", "RL004", "RL005", "RL006")


def _declared_env_vars() -> set:
    from repro_torch.utils.env import ENV_VARS
    return set(ENV_VARS)


class _Markers:
    """Inline ``# reprolint: allow=`` markers of one source file."""

    def __init__(self, src: str, path: str):
        self.by_line: dict[int, set] = {}
        self.findings: list[Finding] = []
        for i, text in enumerate(src.splitlines(), start=1):
            m = _MARKER.search(text)
            if not m:
                continue
            rules = set(m.group("rules").split(","))
            if not m.group("why"):
                self.findings.append(Finding(
                    rule="RL000", path=path, line=i, symbol="",
                    detail=f"marker:{i}",
                    message="suppression marker without a justification "
                            "— write `# reprolint: allow=<rule> — <why>`"))
                continue
            self.by_line[i] = rules

    def allows(self, rule: str, line: int) -> bool:
        return (rule in self.by_line.get(line, ())
                or rule in self.by_line.get(line - 1, ()))


def _finding(markers, rule, path, line, symbol, message, detail):
    if markers.allows(rule, line):
        return []
    return [Finding(rule=rule, path=path, line=line, symbol=symbol,
                    message=message, detail=detail)]


def _enclosing_names(tree):
    """node -> name of the nearest enclosing function/class, for
    symbols in fingerprints."""
    names = {}

    def walk(node, current):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            current = node.name
        for child in ast.iter_child_nodes(node):
            names[child] = current
            walk(child, current)

    walk(tree, "")
    return names


# ----------------------------------------------------------------------
# per-rule visitors
# ----------------------------------------------------------------------

def _rl001(tree, names, markers, path):
    if KERNELS_DIR not in path:
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert):
            out += _finding(
                markers, "RL001", path, node.lineno,
                names.get(node, ""), detail=f"assert:{names.get(node, '')}",
                message="bare `assert` in a kernel module — stripped "
                        "under python -O; raise ValueError instead")
    return out


def _rl002(tree, names, markers, path):
    if any(path.endswith(p) or p in path for p in RL002_EXEMPT_FILES):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        if node.attr == "to_dense" and isinstance(node.ctx, ast.Load):
            what = ".to_dense()"
        elif node.attr == "adj" and isinstance(node.ctx, ast.Load):
            what = ".adj"
        else:
            continue
        out += _finding(
            markers, "RL002", path, node.lineno, names.get(node, ""),
            detail=f"{node.attr}:{names.get(node, '')}",
            message=f"{what} materializes a dense (L, L) topology — "
                    f"justify the size guard with an inline "
                    f"`# reprolint: allow=RL002 — ...` or take the "
                    f"sparse path")
    return out


def _env_read_arg(node):
    """The REPRO_* literal of an env read call/subscript, if any."""
    target = None
    if isinstance(node, ast.Call):
        f = node.func
        # os.environ.get(...) / os.getenv(...)
        if (isinstance(f, ast.Attribute) and f.attr in ("get", "getenv")
                and node.args):
            target = node.args[0]
    elif isinstance(node, ast.Subscript):     # os.environ[...]
        target = node.slice
    if (isinstance(target, ast.Constant) and isinstance(target.value, str)
            and _ENV_LITERAL.match(target.value)):
        return target.value
    return None


def _rl003(tree, names, markers, path):
    out = []
    declared = _declared_env_vars()
    in_registry = path.endswith("utils/env.py")
    for node in ast.walk(tree):
        var = _env_read_arg(node)
        if var is not None and not in_registry:
            out += _finding(
                markers, "RL003", path, node.lineno, names.get(node, ""),
                detail=f"read:{var}",
                message=f"direct environ read of {var} — go through the "
                        f"repro_torch.utils.env registry accessors")
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _ENV_LITERAL.match(node.value) \
                and node.value not in declared:
            out += _finding(
                markers, "RL003", path, node.lineno, names.get(node, ""),
                detail=f"undeclared:{node.value}",
                message=f"{node.value} is not declared in "
                        f"repro_torch.utils.env.ENV_VARS — declare it (or "
                        f"fix the typo; undeclared names read nothing)")
    return out


_NP_RANDOM_SEEDED = {"default_rng", "Generator", "SeedSequence",
                     "PCG64", "Philox"}
# torch functions that draw from the global generator unless given one
_TORCH_RANDOM = {"rand", "randn", "randint", "randperm", "normal",
                 "bernoulli", "multinomial"}
# in-place samplers on any tensor (or torch.nn.init), likewise
_TORCH_RANDOM_INPLACE = {"normal_", "uniform_", "bernoulli_", "random_",
                         "exponential_"}


def _np_random(f):
    return (isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Attribute)
            and f.value.attr == "random"
            and isinstance(f.value.value, ast.Name)
            and f.value.value.id in ("np", "numpy"))


def _torch_global_draw(node):
    """The sampler's name if the call draws from torch's global
    generator: a ``torch.<fn>`` of :data:`_TORCH_RANDOM` or an in-place
    sampler of :data:`_TORCH_RANDOM_INPLACE`, with no ``generator=``."""
    f = node.func
    if not isinstance(f, ast.Attribute) or any(
            kw.arg == "generator" for kw in node.keywords):
        return None
    if f.attr in _TORCH_RANDOM and isinstance(f.value, ast.Name) \
            and f.value.id == "torch":
        return f"torch.{f.attr}"
    if f.attr in _TORCH_RANDOM_INPLACE:
        return f".{f.attr}"
    return None


def _rl004(tree, names, markers, path):
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if _np_random(f):
            if f.attr in _NP_RANDOM_SEEDED:
                if node.args or node.keywords:
                    continue          # seeded constructor
                msg = (f"np.random.{f.attr}() without a seed — thread an "
                       f"explicit seed for reproducibility")
            else:
                msg = (f"np.random.{f.attr} uses the global unseeded RNG — "
                       f"use np.random.default_rng(seed)")
            what = f.attr
        else:
            what = _torch_global_draw(node)
            if what is None:
                continue
            msg = (f"{what} draws from torch's global generator — pass "
                   f"generator= (an explicit, seeded torch.Generator)")
        out += _finding(markers, "RL004", path, node.lineno,
                        names.get(node, ""),
                        detail=f"{what}:{names.get(node, '')}",
                        message=msg)
    return out


def _rl005(tree, names, markers, path):
    out = []
    builtin_names = set(dir(builtins))
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or \
                not fn.name.startswith("_upd_"):
            continue
        params = {a.arg for a in (fn.args.args + fn.args.kwonlyargs
                                  + fn.args.posonlyargs)}
        tensor_params = params - {"ctx"}
        local = set(params)
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Attribute):
                            out += _finding(
                                markers, "RL005", path, node.lineno,
                                fn.name, detail=f"mutation:{fn.name}",
                                message=f"attribute mutation in update "
                                        f"body {fn.name}() — update "
                                        f"bodies must be pure (every "
                                        f"lowering calls the same body)")
                        elif isinstance(leaf, ast.Name):
                            local.add(leaf.id)
            if isinstance(node, (ast.For,)) and \
                    isinstance(node.target, ast.Name):
                local.add(node.target.id)
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                name = node.id
                if name in local or name in builtin_names \
                        or name in RL005_PURE_CAPTURES:
                    continue
                out += _finding(
                    markers, "RL005", path, node.lineno, fn.name,
                    detail=f"capture:{fn.name}:{name}",
                    message=f"update body {fn.name}() captures free "
                            f"variable {name!r} — updates may only touch "
                            f"ctx, their arguments, and declared-pure "
                            f"helpers (RL005_PURE_CAPTURES)")
            if isinstance(node, ast.If):
                used = {leaf.id for leaf in ast.walk(node.test)
                        if isinstance(leaf, ast.Name)}
                if used & tensor_params:
                    out += _finding(
                        markers, "RL005", path, node.lineno, fn.name,
                        detail=f"tensor-if:{fn.name}",
                        message=f"Python `if` on a tensor argument in "
                                f"{fn.name}() — use torch.where; in "
                                f"torch the branch is an implicit "
                                f"device → host sync, and one the "
                                f"lowerings do not share")
    return out


def _rl006(tree, names, markers, path):
    if not path.endswith("runtime.py") or "core" not in path:
        return []
    top_level = [n.name for n in tree.body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    out = []
    for name in top_level:
        if name not in RUNTIME_ALLOWED:
            out.append(Finding(
                rule="RL006", path=path, line=0, symbol=name,
                detail=f"rogue:{name}",
                message=f"solver-specific function {name}() in the "
                        f"runtime module — register a SolverProgram in "
                        f"repro_torch.core.program instead; the "
                        f"lowerings derive every substrate"))
    for name in sorted(RUNTIME_ALLOWED - set(top_level)):
        out.append(Finding(
            rule="RL006", path=path, line=0, symbol=name,
            detail=f"missing:{name}",
            message=f"expected substrate skeleton {name}() missing from "
                    f"the runtime module"))
    return out


_RULES = {"RL001": _rl001, "RL002": _rl002, "RL003": _rl003,
          "RL004": _rl004, "RL005": _rl005, "RL006": _rl006}


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

def check_source(src: str, path: str, rules=ALL_RULES) -> list[Finding]:
    """Run the AST rules over one source string — the testable core
    (tests feed known-bad fixture snippets through this)."""
    tree = ast.parse(src, filename=path)
    names = _enclosing_names(tree)
    markers = _Markers(src, path)
    findings = list(markers.findings)
    for rule in rules:
        findings += _RULES[rule](tree, names, markers, path)
    return findings


def run_ast_rules(repo_root, rules=ALL_RULES) -> list[Finding]:
    """All rules over every ``src/repro_torch/**.py`` file."""
    root = pathlib.Path(repo_root)
    findings = []
    for p in sorted((root / "src" / "repro_torch").rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        findings += check_source(p.read_text(), rel, rules)
    return findings
