"""The port's static-analysis suite (``repro_torch.analysis``) against
the JAX package's (``repro.analysis``), and on planted violations.

Every AST fixture of ``tests/test_reprolint.py`` runs through both
packages' ``check_source`` — the port's on the same snippet under
``src/repro_torch/`` (the RL003 / RL004 ones in the port's vocabulary)
— and both must give the same rule set; the torch-generator half of
RL004 and the port's RL006 skeletons have cases of their own.  The
findings, the baseline round trip, stale detection and the TODO refusal
run on both packages with the same data.  The run rules JX002 / JX003
see planted functions in a named file and must report that file,
function and line.  The kernel wrappers' recording context runs each
plain version where the launch would be and counts it there; outside
it the ``cuda`` route refuses CPU tensors as before.
"""
import dataclasses
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import astlint as ref_astlint
from repro.analysis import findings as ref_findings
from repro_torch.analysis import astlint, torchlint
from repro_torch.analysis import findings as fnd
from repro_torch.analysis.harness import Case, OpRecorder, op_location
from repro_torch.kernels import _build

import torch_lint_planted as planted

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules(found):
    return sorted({f.rule for f in found})


# ------------------------------------------------------------ AST rules
#
# (id, reference snippet, the port's snippet or None for the same, path
# under the package, expected rule set)

_ASSERT_KERNEL = """
    def _kernel(x_ref, o_ref):
        assert x_ref.shape[0] % 8 == 0
        o_ref[...] = x_ref[...]
"""
_RAISE_KERNEL = """
    def _kernel(x):
        if x.shape[0] % 8:
            raise ValueError("bad block")
        return x
"""
_UPD_OK = """
    def _upd_ok(ctx, U, cstate, tau):
        for j in range(ctx.local_steps):
            U = ctx.qr(U)
        sf = (ctx.send_fraction(U, cstate)
              if ctx.send_fraction is not None else None)
        phi = ExactDiffusionCombine.correct(U, U, U)
        return ctx.qr(phi), cstate, sf
"""

AST_CASES = [
    ("rl001_bare_assert", _ASSERT_KERNEL, None, "kernels/planted.py",
     ["RL001"]),
    ("rl001_raise_passes", _RAISE_KERNEL, None, "kernels/ok.py", []),
    ("rl001_assert_outside_kernels", "def f(x):\n    assert x\n", None,
     "core/x.py", []),
    ("rl001_inline_marker", """
        def _kernel(x):
            assert x  # reprolint: allow=RL001 — trace-time shape contract, unreachable at runtime
     """, None, "kernels/planted.py", []),
    ("rl002_to_dense", """
        def hot_path(graph):
            W = graph.to_dense()
            return W @ W
     """, None, "distributed/planted.py", ["RL002"]),
    ("rl002_adj", "def f(g):\n    return g.adj.sum()\n", None,
     "core/planted.py", ["RL002"]),
    ("rl002_graphs_exempt", "def f(g):\n    return g.adj\n", None,
     "distributed/graphs.py", []),
    ("rl002_justified_marker", """
        def f(g):
            return g.to_dense()  # reprolint: allow=RL002 — init tier, L <= DENSE_MATERIALIZE_MAX
     """, None, "core/ok.py", []),
    ("rl000_bare_marker", """
        def f(g):
            return g.to_dense()  # reprolint: allow=RL002
     """, None, "core/bad.py", ["RL000", "RL002"]),
    ("rl003_stray_read", """
        import os
        def f():
            return os.environ.get("REPRO_KERNEL_BACKEND")
     """, """
        import os
        def f():
            return os.environ.get("REPRO_TORCH_KERNEL_BACKEND")
     """, "core/planted.py", ["RL003"]),
    ("rl003_undeclared_typo", """
        def f(read_str):
            return read_str("REPRO_KERNEL_BACKEMD")
     """, """
        def f(read_choice):
            return read_choice("REPRO_TORCH_KERNEL_BACKEMD", ())
     """, "core/planted.py", ["RL003"]),
    ("rl003_registry_read_passes", """
        from repro.utils import env
        def f():
            return env.read_str("REPRO_KERNEL_BACKEND")
     """, """
        from repro_torch.utils import env
        def f():
            return env.read_choice("REPRO_TORCH_KERNEL_BACKEND", ())
     """, "core/ok.py", []),
    ("rl003_registry_module_passes", """
        import os
        def _lookup(name):
            return os.environ.get(name)
     """, None, "utils/env.py", []),
    ("rl004_global_rng", """
        import numpy as np
        def f():
            return np.random.rand(3)
     """, None, "core/planted.py", ["RL004"]),
    ("rl004_unseeded_default_rng",
     "import numpy as np\nrng = np.random.default_rng()\n", None,
     "core/planted.py", ["RL004"]),
    ("rl004_seeded_rng_passes",
     "import numpy as np\nrng = np.random.default_rng(0)\n", None,
     "core/ok.py", []),
    ("rl005_attribute_mutation", """
        def _upd_planted(ctx, U, aux, tau):
            ctx.cache = U
            return U, aux, None
     """, None, "core/planted.py", ["RL005"]),
    ("rl005_foreign_capture", """
        GLOBAL_STATE = []
        def _upd_planted(ctx, U, aux, tau):
            GLOBAL_STATE.append(tau)
            return U, aux, None
     """, None, "core/planted.py", ["RL005"]),
    ("rl005_python_if", """
        def _upd_planted(ctx, U, aux, tau):
            if tau > 0:
                U = ctx.mix(U)
            return U, aux, None
     """, None, "core/planted.py", ["RL005"]),
    ("rl005_real_idioms_pass", _UPD_OK, None, "core/ok.py", []),
    ("rl006_rogue_function", """
        def _altgdmin_mesh(): pass
        def _altgdmin_virtual_mesh(): pass
        def dif_altgdmin_mesh(): pass
     """, """
        def _altgdmin_mesh(): pass
        def _altgdmin_virtual_mesh(): pass
        def _rank_loop(): pass
        def dif_altgdmin_mesh(): pass
     """, "core/runtime.py", ["RL006"]),
    ("rl006_missing_skeleton", "def _altgdmin_mesh(): pass\n", None,
     "core/runtime.py", ["RL006"]),
]


@pytest.mark.parametrize("ref_src, port_src, rel, want",
                         [c[1:] for c in AST_CASES],
                         ids=[c[0] for c in AST_CASES])
def test_ast_rule_sets_match_reference(ref_src, port_src, rel, want):
    ref = ref_astlint.check_source(textwrap.dedent(ref_src),
                                   "src/repro/" + rel)
    port = astlint.check_source(textwrap.dedent(port_src or ref_src),
                                "src/repro_torch/" + rel)
    assert _rules(port) == _rules(ref) == want, (
        [f.render() for f in ref], [f.render() for f in port])


def check(src, rel):
    return astlint.check_source(textwrap.dedent(src),
                                "src/repro_torch/" + rel)


def test_rl003_messages_name_the_port_registry():
    found = check(AST_CASES[9][2], "core/planted.py")
    assert any("repro_torch.utils.env registry" in f.message for f in found)
    found = check(AST_CASES[10][2], "core/planted.py")
    assert any("not declared in repro_torch.utils.env.ENV_VARS"
               in f.message for f in found)


def test_rl003_jax_package_variable_is_undeclared_in_the_port():
    """The port never reads the JAX package's REPRO_* variables."""
    found = check('NAME = "REPRO_KERNEL_BACKEND"\n', "core/planted.py")
    assert [f.detail for f in found] == ["undeclared:REPRO_KERNEL_BACKEND"]


@pytest.mark.parametrize("src, flagged", [
    ("torch.randn(3)", True),
    ("torch.rand((2, 2), dtype=torch.float64)", True),
    ("torch.randint(0, 5, (4,))", True),
    ("torch.randperm(5)", True),
    ("torch.normal(0.0, 1.0, (3,))", True),
    ("torch.bernoulli(p)", True),
    ("torch.multinomial(p, 1)", True),
    ("x.normal_()", True),
    ("x.uniform_(-1, 1)", True),
    ("x.bernoulli_(0.5)", True),
    ("x.random_(0, 7)", True),
    ("x.exponential_()", True),
    ("torch.nn.init.normal_(x)", True),
    ("torch.randn(3, generator=g)", False),
    ("torch.randint(0, 5, (4,), generator=g, device='cuda')", False),
    ("torch.randperm(5, generator=g)", False),
    ("torch.multinomial(p, 1, generator=g)", False),
    ("x.normal_(generator=g)", False),
    ("x.uniform_(-1, 1, generator=g)", False),
    ("torch.zeros(3)", False),
    ("torch.Generator().manual_seed(0)", False),
])
def test_rl004_torch_global_generator(src, flagged):
    found = check(f"import torch\ndef f(x, p, g):\n    return {src}\n",
                  "core/planted.py")
    assert _rules(found) == (["RL004"] if flagged else []), src
    if flagged:
        assert "generator=" in found[0].message


def test_rl004_torch_draw_marker_suppresses():
    found = check("""
        import torch
        def f():
            return torch.randn(3)  # reprolint: allow=RL004 — planted, seeded by the caller's torch.manual_seed
    """, "core/ok.py")
    assert found == []


def test_rl005_details_and_sync_message():
    found = check(AST_CASES[16][1], "core/planted.py")
    assert any(f.detail.startswith("mutation") for f in found)
    found = check(AST_CASES[17][1], "core/planted.py")
    assert any("capture" in f.detail and "GLOBAL_STATE" in f.detail
               for f in found)
    found = check(AST_CASES[18][1], "core/planted.py")
    assert [f.detail for f in found] == ["tensor-if:_upd_planted"]
    assert "device → host sync" in found[0].message


def test_rl006_port_runtime_names_its_shared_loop():
    ok = check("""
        def _altgdmin_mesh(): pass
        def _altgdmin_virtual_mesh(): pass
        def _rank_loop(): pass
    """, "core/runtime.py")
    assert ok == []
    found = check("""
        def _altgdmin_mesh(): pass
        def _altgdmin_virtual_mesh(): pass
    """, "core/runtime.py")
    assert [f.detail for f in found] == ["missing:_rank_loop"]


def test_ast_rules_clean_on_the_port():
    found = astlint.run_ast_rules(REPO_ROOT)
    assert found == [], [f.render() for f in found]


def test_ast_rules_cover_the_port_only():
    """run_ast_rules reads src/repro_torch and nothing of src/repro."""
    seen = []
    real = astlint.check_source

    def spy(src, path, rules=astlint.ALL_RULES):
        seen.append(path)
        return real(src, path, rules)

    astlint.check_source = spy
    try:
        astlint.run_ast_rules(REPO_ROOT)
    finally:
        astlint.check_source = real
    assert seen and all(p.startswith("src/repro_torch/") for p in seen)
    assert "src/repro_torch/analysis/astlint.py" in seen


# ------------------------------------------------ findings and baseline

def _finding(mod, **kw):
    base = dict(rule="RL001", path="a.py", line=3, symbol="f",
                message="m", detail="assert:f")
    return mod.Finding(**{**base, **kw})


@pytest.mark.parametrize("kw", [{}, {"line": 0}, {"symbol": ""},
                                {"rule": "JX002", "detail": "f:aten.eye"}])
def test_finding_fingerprint_and_render_match_reference(kw):
    ref, port = _finding(ref_findings, **kw), _finding(fnd, **kw)
    assert port.fingerprint == ref.fingerprint
    assert port.render() == ref.render()


def test_baseline_roundtrip_and_stale_detection_match_reference(tmp_path):
    outcomes = []
    for name, mod in (("ref", ref_findings), ("port", fnd)):
        f1 = _finding(mod)
        p = tmp_path / f"{name}.json"
        mod.write_baseline(p, [f1])
        skeleton = p.read_text()
        # the skeleton's TODO justification refuses to load
        with pytest.raises(ValueError, match="TODO|justification"):
            mod.load_baseline(p)
        data = json.loads(skeleton)
        data["suppressions"][0]["justification"] = "known, tracked"
        p.write_text(json.dumps(data))
        base = mod.load_baseline(p)
        new, sup, stale = mod.split_by_baseline([f1], base)
        assert (new, len(sup), stale) == ([], 1, [])
        # once the finding is fixed, the entry goes stale
        new, sup, stale_after = mod.split_by_baseline([], base)
        assert stale_after == [f1.fingerprint]
        outcomes.append((skeleton, base, stale_after))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("why", ["", "   ", "TODO: justify or fix",
                                 "todo later"])
def test_baseline_refuses_empty_and_todo_justifications(tmp_path, why):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"suppressions": [
        {"fingerprint": "RL001:a.py:f:assert:f", "justification": why}]}))
    for mod in (ref_findings, fnd):
        with pytest.raises(ValueError):
            mod.load_baseline(p)


def test_missing_baseline_is_empty(tmp_path):
    assert fnd.load_baseline(tmp_path / "none.json") == {}


def test_shipped_baseline_is_empty():
    with open(os.path.join(REPO_ROOT,
                           "tools/reprolint_torch/baseline.json")) as f:
        assert json.load(f) == {"suppressions": []}


# ---------------------------------------------------- run rules: planted

def _case(recorder, *, L, dtype="float32"):
    return Case(program="planted", substrate="simulator", dtype=dtype,
                device="cpu", L=L, rounds=1, n_shifts=0, local_steps=1,
                launches=None, sends=None, launches_by_kernel={},
                births=tuple(recorder.births.values()),
                narrowings=tuple(recorder.narrowings.values()))


def _recorded(fn, *args, L):
    rec = OpRecorder(L)
    with rec:
        fn(*args)
    return rec


def test_jx002_reports_the_planted_birth_site():
    L = 8
    rec = _recorded(planted.planted_dense, torch.ones((L, 5)), L=L)
    found = torchlint.check_dense_node_axis(_case(rec, L=L))
    assert [f.rule for f in found] == ["JX002"]
    f = found[0]
    assert (f.path, f.line) == (planted.PLANTED_PATH, planted.LINE_DENSE)
    assert f.detail.startswith("planted_dense:") and "L=8" in f.message


def test_jx002_passthrough_of_existing_dense_operand_ok():
    L = 8
    rec = _recorded(planted.planted_passthrough, torch.ones((L, L)), L=L)
    assert rec.n_ops > 0
    assert torchlint.check_dense_node_axis(_case(rec, L=L)) == []


def test_jx003_reports_the_planted_narrowing_site():
    rec = _recorded(planted.planted_narrow,
                    torch.ones(4, dtype=torch.float64), L=8)
    found = torchlint.check_precision_flow(_case(rec, L=8, dtype="float64"))
    assert [f.rule for f in found] == ["JX003"]
    f = found[0]
    assert (f.path, f.line) == (planted.PLANTED_PATH, planted.LINE_NARROW)
    assert f.detail == "planted_narrow:float32"


@pytest.mark.parametrize("fn, dtype", [
    (planted.planted_widen, torch.float32),       # f32 → f64
    (planted.planted_widen, torch.float64),       # f64 only
])
def test_jx003_widening_and_f64_only_pass(fn, dtype):
    rec = _recorded(fn, torch.ones(4, dtype=dtype), L=8)
    assert rec.n_ops > 0
    assert torchlint.check_precision_flow(
        _case(rec, L=8, dtype="float64")) == []


def test_jx003_kernels_dir_is_sanctioned_and_f32_runs_exempt():
    rec = _recorded(planted.planted_narrow,
                    torch.ones(4, dtype=torch.float64), L=8)
    ops = tuple(dataclasses.replace(o, path="src/repro_torch/kernels/x.py")
                for o in rec.narrowings.values())
    case = _case(rec, L=8, dtype="float64")
    assert torchlint.check_precision_flow(
        dataclasses.replace(case, narrowings=ops)) == []
    assert torchlint.check_precision_flow(
        dataclasses.replace(case, dtype="float32")) == []


def test_jx003_inline_marker_on_the_port_site(monkeypatch):
    """consensus.place_weights' f32 copy of an f64 table is the one
    narrowing on the port's f64 runs: its marker names the guard, and
    without the marker the rule reports that line."""
    from repro_torch.distributed.consensus import place_weights
    table = np.full((8, 3), 0.25)
    rec = _recorded(place_weights, table, "cpu", L=8)
    case = _case(rec, L=8, dtype="float64")
    assert torchlint.check_precision_flow(case) == []
    monkeypatch.setattr(torchlint, "_markers", lambda path: None)
    found = torchlint.check_precision_flow(case)
    assert [(f.rule, f.path, f.detail) for f in found] == [
        ("JX003", "src/repro_torch/distributed/consensus.py",
         "place_weights:float32")]


def test_op_location_skips_torch_and_analysis_frames():
    """The innermost port frame outside analysis/: a helper compiled
    under analysis/ that does the op is skipped for its caller."""
    helper_path = os.path.join(REPO_ROOT,
                               "src/repro_torch/analysis/planted_helper.py")
    ns = {"torch": torch, "op_location": op_location}
    exec(compile("def helper(x):\n    return torch.eye(x)\n", helper_path,
                 "exec"), ns)
    caller_path = os.path.join(REPO_ROOT, planted.PLANTED_PATH)
    exec(compile("\n\ndef caller(x):\n    return helper(x)\n", caller_path,
                 "exec"), ns)
    rec = _recorded(ns["caller"], 8, L=8)
    (op,) = rec.births.values()
    assert (op.path, op.func, op.line) == (planted.PLANTED_PATH, "caller", 4)
    assert op.op == "aten.eye.default" and op.shape == (8, 8)
    assert op_location() == ("", "", 0)           # a test frame: no port


# ----------------------------------------------- the recording context

def _X(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype)


def _wrapper_calls():
    from repro_torch.kernels import (altgdmin_ls, compress, flash_attention,
                                     gossip_axpy, ref, ssd_scan)
    L, tpn, n, d, r = 3, 2, 6, 5, 2
    X, y = _X(L, tpn, n, d), _X(L, tpn, n, seed=1)
    U = torch.linalg.qr(_X(L, d, r, seed=2))[0]
    B = _X(L, tpn, r, seed=3)
    M = _X(4, 6, 2, seed=4)
    q = torch.randint(-127, 128, (4, 6, 2), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(5))
    scale = _X(4, 1, 1, seed=6).abs()
    qk = _X(1, 5, 2, 4, seed=7)
    kv = _X(1, 5, 1, 4, seed=8)
    xs, dt = _X(1, 6, 2, 3, seed=9), _X(1, 6, 2, seed=10).abs()
    A, Bm, Cm, Dh = -_X(2, seed=11).abs(), _X(1, 6, 4, seed=12), \
        _X(1, 6, 4, seed=13), _X(2, seed=14)
    W = _X(L, L, seed=15)
    z, nbrs = _X(7, seed=16), _X(2, 7, seed=17)
    w = torch.tensor([0.5, 0.25, 0.25])
    return [
        ("node_fused_iter", lambda: altgdmin_ls.node_fused_iter(X, U, y),
         lambda: ref.ref_fused_iter(X, U, y)),
        ("node_task_gram", lambda: altgdmin_ls.node_task_gram(X, U, y),
         lambda: ref.ref_task_gram(X, U, y)),
        ("node_task_grad_tiles",
         lambda: altgdmin_ls.node_task_grad_tiles(X, U, B, y),
         lambda: ref.ref_node_grad_tiles(X, U, B, y)),
        ("task_gram", lambda: altgdmin_ls.task_gram(X[0], U[0], y[0]),
         lambda: ref.ref_single_task_gram(X[0], U[0], y[0])),
        ("task_grad_tiles",
         lambda: altgdmin_ls.task_grad_tiles(X[0], U[0], B[0], y[0]),
         lambda: ref.ref_single_grad_tiles(X[0], U[0], B[0], y[0])),
        ("mix_rows", lambda: gossip_axpy.mix_rows(W, X.reshape(L, -1)),
         lambda: ref.ref_mix_rows(W, X.reshape(L, -1))),
        ("gossip_combine", lambda: gossip_axpy.gossip_combine(z, nbrs, w),
         lambda: ref.ref_gossip_combine(z, nbrs, w)),
        ("compress_topk", lambda: compress.compress_topk(M, 3),
         lambda: ref.ref_compress_topk(M, 3)),
        ("dequant", lambda: compress.dequant(q, scale),
         lambda: ref.ref_dequant(q, scale)),
        ("dequant", lambda: compress.int8_round(M, M * 0.5),
         lambda: ref.ref_int8_round(M, M * 0.5)),
        ("flash_attention",
         lambda: flash_attention.flash_attention(qk, kv, kv),
         lambda: ref.ref_attention(qk.transpose(1, 2), kv.transpose(1, 2),
                                   kv.transpose(1, 2)).transpose(1, 2)),
        ("ssd_scan", lambda: ssd_scan.ssd_scan(xs, dt, A, Bm, Cm, Dh),
         lambda: ref.ref_ssd(xs, dt, A, Bm, Cm, Dh)),
    ]


@pytest.mark.parametrize("i", range(12))
def test_recording_runs_the_plain_version_and_counts_one_launch(i):
    name, call, plain = _wrapper_calls()[i]
    with pytest.raises(ValueError, match="CUDA"):
        call()                              # outside: refuses CPU tensors
    _build.LAUNCHES.clear()
    with _build.recording():
        got = call()
    assert dict(_build.LAUNCHES) == {name: 1}
    got = got if isinstance(got, tuple) else (got,)
    want = plain()
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w.to(g.dtype), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        call()                              # and refuses again after
    _build.LAUNCHES.clear()


def test_cuda_route_on_cpu_raises_on_the_main_path_outside_recording():
    """No fallback: the simulator's main path with backend='cuda' on CPU
    tensors raises as before, and runs inside the recording context."""
    from repro_torch.core.program import get_program, lower_simulator
    L, d, r, tpn, n = 4, 6, 2, 2, 8
    U0 = torch.linalg.qr(_X(L, d, r, dtype=torch.float64))[0]
    Xg = _X(L, tpn, n, d, dtype=torch.float64, seed=1)
    yg = _X(L, tpn, n, dtype=torch.float64, seed=2)
    W = torch.full((L, L), 1.0 / L, dtype=torch.float64)
    run = lower_simulator(get_program("dif_altgdmin"))
    with pytest.raises(ValueError, match="CUDA"):
        run(U0, Xg, yg, W, eta=0.01, T_GD=2, T_con=2, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        run(U0.float(), Xg.float(), yg.float(), W.float(), eta=0.01,
            T_GD=2, T_con=2, backend="cuda")
    _build.LAUNCHES.clear()
    with _build.recording():
        run(U0.float(), Xg.float(), yg.float(), W.float(), eta=0.01,
            T_GD=2, T_con=2, backend="cuda")
    assert dict(_build.LAUNCHES) == {"node_fused_iter": 2, "mix_rows": 2,
                                     "node_task_gram": 1}
    _build.LAUNCHES.clear()


def test_recording_leaves_torch_ref_untouched():
    """torch-ref is the same computation inside the context: nothing is
    counted and the result is the same bits."""
    from repro_torch.kernels import ops
    X, y = _X(3, 2, 6, 5), _X(3, 2, 6, seed=1)
    U = torch.linalg.qr(_X(3, 5, 2, seed=2))[0]
    want = ops.altgdmin_fused_step(X, U, y)
    _build.LAUNCHES.clear()
    with _build.recording():
        got = ops.altgdmin_fused_step(X, U, y)
    assert not _build.LAUNCHES
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cli_sources_never_import_jax_or_repro():
    import ast
    import glob
    files = glob.glob(os.path.join(REPO_ROOT, "tools/reprolint_torch/*.py"))
    assert len(files) == 2
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        roots = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)
