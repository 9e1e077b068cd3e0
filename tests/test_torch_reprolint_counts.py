"""The port's run-level counts against the JAX package's traced counts.

For each of the 33 (program, substrate) pairs the reference traces
(12 programs × simulator / mesh / virtual, less ``dif_topk``), the
port's kernel launches per outer iteration and outside the loop, its
shift-class count K and, on the mesh and virtual tiers, its
point-to-point sends are held against the reference's
``count_primitive(trace, "pallas_call")``, ``n_shifts`` and
``count_primitive(trace, "ppermute")``.  The reference's traces run in
one subprocess (8 fake host devices, x64 on); the port's simulator runs
in this process inside the recording context and its mesh and virtual
runs in one spawn of 8 gloo ranks.

``dif_topk`` is held against its ``DispatchBudget`` alone: the
reference's ``compress_topk`` does not trace on jax 0.9.0
(``jax.experimental.pallas`` has no ``store``, ``kernels/compress.py:46``
there), so there is no traced count to compare with.

Planted regressions must each be caught: an update that launches a
kernel twice (JX001), a lowering with one extra send a round (JX004)
and an (L, L) ``torch.eye`` born in an update on the sparse tier
(JX002).  Last, ``python -m tools.reprolint_torch --all`` runs in a
subprocess with ``jax`` and ``repro`` made unimportable and exits 0.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.analysis import harness, torchlint
from repro_torch.core.program import get_program, program_names

import torch_lint_planted as planted

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBSTRATES = harness.SUBSTRATES
TRACED = [(name, s) for name in program_names() if name != "dif_topk"
          for s in SUBSTRATES]
PLANTED_SEND = "torch_lint_planted:EXTRA_SEND"

_REFERENCE_COUNTS = r"""
import json
import jax
jax.config.update("jax_enable_x64", True)
from repro.analysis.harness import SUBSTRATES, count_primitive, trace_program
from repro.core.program import program_names
out = {}
for name in program_names():
    if name == "dif_topk":
        continue
    for s in SUBSTRATES:
        t = trace_program(name, s)
        out[name + "/" + s] = dict(
            pallas=count_primitive(t, "pallas_call"),
            ppermute=count_primitive(t, "ppermute"), K=t.n_shifts,
            R=t.rounds, L=t.L)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _REFERENCE_COUNTS],
                       capture_output=True, text=True, cwd=REPO_ROOT,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    """Every f32 case of the 12 programs on the three substrates, and the
    planted extra-send lowering on the mesh, in one spawn."""
    cases = [harness.run_case(name, "simulator") for name in program_names()]
    specs = [(name, s, "float32", "cpu") for name in program_names()
             for s in ("mesh", "virtual")]
    specs.append((PLANTED_SEND, "mesh", "float32", "cpu"))
    cases += harness.spawn_cases(specs)
    return {(c.program, c.substrate): c for c in cases}


@pytest.mark.parametrize("name, substrate", TRACED,
                         ids=[f"{n}-{s}" for n, s in TRACED])
def test_counts_equal_the_reference_trace(reference, port, name, substrate):
    ref = reference[f"{name}/{substrate}"]
    case = port[(name, substrate)]
    assert (case.L, case.rounds, case.n_shifts) == (ref["L"], ref["R"],
                                                    ref["K"])
    assert list(case.launches) == ref["pallas"], case.launches_by_kernel
    if substrate != "simulator":
        assert list(case.sends) == ref["ppermute"]
    found = torchlint.check_case(case, get_program(name).dispatch_budget)
    assert found == [], [f.render() for f in found]


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_dif_topk_equals_its_budget(port, substrate):
    """No traced count exists (the reference's compress_topk fails to
    trace on jax 0.9.0), so the budget alone: one compress_topk launch a
    round beside the combine's."""
    case = port[("dif_topk", substrate)]
    budget = get_program("dif_topk").dispatch_budget
    want = budget.per_iter(substrate, case.rounds, case.n_shifts,
                           case.local_steps)
    assert case.launches == (want, 1)
    assert case.launches_by_kernel["compress_topk"] == case.rounds
    if substrate != "simulator":
        wire = (budget.wire_mesh if substrate == "mesh"
                else budget.wire_virtual)
        assert case.sends == (case.rounds * case.n_shifts * wire, 0)
    assert torchlint.check_case(case, budget) == []


def test_counts_only_spawn_equals_the_recorded_run(port):
    """The card's lint phase runs the virtual tier's CPU recording without
    the op recorder, at T_GD 1 and 2: the counts are the recorded run's
    at 3 and 4, and no ops are kept."""
    names = ("dif_quantized", "dif_pushsum", "beyond_central")
    cases = harness.spawn_cases([(n, "virtual", "float32", "cpu")
                                 for n in names], lengths=(1, 2),
                                record_ops=False)
    for name, case in zip(names, cases):
        full = port[(name, "virtual")]
        assert (case.launches, case.sends, case.launches_by_kernel) == (
            full.launches, full.sends, full.launches_by_kernel)
        assert case.births == case.narrowings == ()
        assert case.started > 0 and case.seconds > 0


def test_planted_double_launch_is_jx001():
    case = harness.run_case(planted.TWICE, "simulator")
    found = torchlint.check_case(case, planted.TWICE.dispatch_budget)
    assert [(f.rule, f.detail) for f in found] == [("JX001", "per-iter")]
    assert "3 kernel launches per outer iteration" in found[0].message
    assert "budget says 2" in found[0].message


def test_planted_extra_send_is_jx004(port):
    case = port[("planted_extra_send", "mesh")]
    assert case.sends == (case.rounds * (case.n_shifts + 1), 0)
    found = torchlint.check_case(case, planted.EXTRA_SEND.dispatch_budget)
    assert [(f.rule, f.detail) for f in found] == [("JX004", "rounds")]
    assert "14 point-to-point sends" in found[0].message


def test_planted_eye_on_the_sparse_tier_is_jx002():
    case = harness.run_case(planted.EYE, "sparse", lengths=(2,))
    assert case.L == harness.L_SPARSE
    found = torchlint.check_dense_node_axis(case)
    assert [(f.rule, f.path, f.line) for f in found] == [
        ("JX002", planted.PLANTED_PATH, planted.LINE_EYE)]
    assert found[0].detail == "_upd_eye:aten.eye.default"
    # consensus_spread's (L, L, d, r) difference is born here too, and
    # its guard (SPREAD_EXACT_MAX) admits L = 520
    assert any(o.func == "consensus_spread" for o in case.births)


def test_sparse_tier_guards_admit_only_consensus_spread():
    allow = torchlint.DENSE_NODE_AXIS_ALLOWLIST
    admitted = sorted(key[1] for key, a in allow.items()
                      if a.admits(harness.L_SPARSE))
    assert admitted == ["consensus_spread"]
    assert all(a.admits(harness.L_VIRT) for a in allow.values())


def test_reprolint_torch_cli_clean_without_jax(tmp_path):
    blocked = tmp_path / "blocked"
    for pkg in ("jax", "repro"):
        (blocked / pkg).mkdir(parents=True)
        (blocked / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is blocked: the port must not "
            f"import it')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(blocked), os.path.join(REPO_ROOT, "src")]))
    r = subprocess.run([sys.executable, "-m", "tools.reprolint_torch",
                        "--all"], capture_output=True, text=True,
                       cwd=REPO_ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "reprolint_torch: clean" in r.stdout
    r = subprocess.run([sys.executable, "-c", "import jax"], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode != 0 and "blocked" in r.stderr
