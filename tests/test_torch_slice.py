"""The whole slice: ``repro_torch.api.run_experiment`` for
``dif_altgdmin`` on the reference's own materialized arrays, against
``repro.api.run_experiment`` — at f64 (torch-ref vs xla-ref, ≤ 1e-8) and
at f32 (torch-ref vs the Pallas kernels in interpret mode, rtol 1e-4,
atol 1e-5, the reference's trajectory tolerance) — plus the port's own
materialize end to end on the CPU, the gaps that must raise, and the
package hygiene (no jax, no repro, no silent CPU)."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.distributed.consensus import maybe_sparsify  # noqa: E402
from repro_torch.distributed.mixing import SparseWeights  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

SPEC = rapi.ExperimentSpec(
    problem=rapi.ProblemSpec(d=60, T=24, r=3, n=25, L=6, kappa=1.5),
    topology=rapi.TopologySpec(family="erdos_renyi", p=0.5, seed=3,
                               weights="metropolis"),
    init=rapi.InitSpec(T_pm=20, T_con=8),
    solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=50, T_con=3))


def _ref_spec(dtype, backend):
    return dataclasses.replace(
        SPEC, problem=dataclasses.replace(SPEC.problem, dtype=dtype),
        engine=rapi.EngineSpec(backend=backend))


def _port_spec(ref_spec, backend):
    d = ref_spec.to_dict()
    d["engine"]["backend"] = backend
    return tapi.ExperimentSpec.from_dict(d)


def _arrays(mat):
    """The reference's materialized state as host arrays."""
    return {"Xg": mat.Xg, "yg": mat.yg, "W": mat.W, "adj": mat.adj,
            "U0": mat.init.U0, "R_diag": mat.init.R_diag,
            "alpha": mat.init.alpha, "U_star": mat.problem.U_star,
            "B_star": mat.problem.B_star, "eta": mat.eta,
            "mu": mat.problem.mu, "sigma_max": mat.problem.sigma_max,
            "sigma_min": mat.problem.sigma_min}


def _run_both(dtype, ref_backend):
    ref_spec = _ref_spec(dtype, ref_backend)
    mat = rapi.materialize(ref_spec, key=0)
    ref = rapi.run_experiment(ref_spec, key=0, materialized=mat)
    port_mat = tapi.materialized_from_arrays(
        {k: np.asarray(v) for k, v in _arrays(mat).items()},
        device="cpu", dtype=dtype)
    got = tapi.run_experiment(_port_spec(ref_spec, "torch-ref"),
                              materialized=port_mat)
    return ref, got


def _compare(ref, got, tol):
    for name in ("sd_max", "sd_mean", "spread"):
        assert getattr(got, name).shape == getattr(ref, name).shape
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   err_msg=name, **tol)
    for name in ("U_nodes", "B_nodes"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **tol)
    np.testing.assert_array_equal(got.time_axis, ref.time_axis)
    assert got.eta == ref.eta


def test_slice_f64_torch_ref_matches_xla_ref():
    ref, got = _run_both("float64", "xla-ref")
    assert got.U_nodes.dtype == torch.float64
    _compare(ref, got, dict(rtol=0, atol=1e-8))


def test_slice_f32_torch_ref_matches_pallas_interpret():
    ref, got = _run_both("float32", "pallas-interpret")
    assert got.U_nodes.dtype == torch.float32
    _compare(ref, got, dict(rtol=1e-4, atol=1e-5))


def test_port_materialize_runs_and_converges_on_cpu():
    spec = _port_spec(SPEC, None)            # 10 tasks per node
    spec = dataclasses.replace(
        spec, problem=dataclasses.replace(spec.problem, T=60),
        solver=dataclasses.replace(spec.solver, T_GD=150))
    tr = tapi.run_experiment(spec, key=1, device="cpu")
    assert tr.sd_max.shape == (150,) and np.isfinite(tr.sd_max).all()
    assert tr.U_nodes.shape == (6, 60, 3) and tr.B_nodes.shape == (6, 10, 3)
    assert tr.final_sd_max < 1e-2 * tr.sd_max[0]
    assert tr.spread[-1] < 1e-2
    again = tapi.run_experiment(spec, key=1, device="cpu")
    np.testing.assert_array_equal(again.sd_max, tr.sd_max)


def test_specs_round_trip_between_packages():
    d = SPEC.to_dict()
    assert tapi.ExperimentSpec.from_dict(d).to_dict() == d
    assert tapi.ExperimentSpec.from_json(SPEC.to_json()).to_dict() == d


# ---------------------------------------------------------------- gaps

def test_later_slice_features_raise_not_implemented():
    spec = _port_spec(SPEC, None)
    for name in ("dif_partial", "dif_stale", "dif_pushsum"):
        # the masked trio lowers to the mesh too: outside a process group
        # its mesh run stops where every program's does
        assert tapi.get_solver(name).takes_avail
        assert tapi.get_solver(name).mesh_capable
        bad = dataclasses.replace(spec, substrate="mesh",
                                  solver=dataclasses.replace(spec.solver,
                                                             name=name))
        with pytest.raises(RuntimeError, match="process group"):
            tapi.run_experiment(bad, device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        tapi.get_solver("no_such_solver")
    with pytest.raises(RuntimeError, match="process group"):
        tapi.run_experiment(dataclasses.replace(spec, substrate="mesh"),
                            device="cpu")
    d = SPEC.to_dict()
    d["system"] = {"availability": "bernoulli", "p_on": 0.9}
    assert tapi.ExperimentSpec.from_dict(d).system == tapi.SystemSpec(
        availability="bernoulli", p_on=0.9)
    # the sparse representation, refused before the sparse tier was
    # ported, now materializes W in sparse form
    sparse = dataclasses.replace(spec, topology=dataclasses.replace(
        spec.topology, representation="sparse"))
    mat = tapi.materialize(sparse, device="cpu")
    assert isinstance(mat.W, SparseWeights)
    np.testing.assert_allclose(mat.W.to_dense(), tapi.materialize(
        spec, device="cpu").W.numpy(), rtol=0, atol=1e-15)


def test_sparse_tier_matrix_raises():
    """A sparse matrix above the node cutoff, refused before the sparse
    tier was ported, now lowers to its SparseWeights."""
    L = 512
    W = torch.eye(L, dtype=torch.float64)
    W[0, 1] = W[1, 0] = 0.5
    sw = maybe_sparsify(W)
    assert isinstance(sw, SparseWeights)
    np.testing.assert_array_equal(sw.to_dense(), W.numpy())
    small = torch.eye(8)
    assert maybe_sparsify(small) is small


# ---------------------------------------------------------------- hygiene

def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.run_experiment(_port_spec(SPEC, None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.materialize(_port_spec(SPEC, None))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.api, repro_torch.configs.paper\n"
        "import repro_torch.kernels.ops, repro_torch.core.program\n"
        "import repro_torch.serving, repro_torch.checkpoint\n"
        "from repro_torch.api import run_experiment, materialize\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'msgpack'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]


def test_port_sources_never_import_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro", "msgpack"}, path
