"""This slice's solver paths end to end, the port against the JAX package
on the reference's own arrays, on the CPU:

* sample-split ``dif_altgdmin`` (Algorithm 3's fold schedule: min-B on
  fold 2τ mod F, the gradient on fold 2τ+1 mod F, the final B refitted
  on the last min fold) at f64 on ``torch-ref`` against ``xla-ref``
  (≤ 1e-8), plus the schedule and refit pins;
* ``dif_topk`` / ``dif_quantized`` (``bf16``, ``int8``) / ``dif_event``
  through ``run_experiment`` at f64 (≤ 1e-8 on ``sd_max``, ``U_nodes``,
  ``B_nodes``; the priced time axis and the event rule's send fraction
  equal);
* the lossless anchors through ``run_experiment`` (k = d, θ = 0 give
  dense Dif-AltGDmin bit for bit), the stochastic int8 wire's
  convergence under the reference's bound, and the knob checks;
* hygiene: every module of the port imports without jax or ``repro``.
"""
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.api.registry import get_solver as ref_get_solver  # noqa: E402
from repro_torch.core.agree import agree  # noqa: E402
from repro_torch.core.engine import (AltgdminEngine,  # noqa: E402
                                     ref_grad_U, ref_minimize_B)
from repro_torch.core.spectral import _qr_pos  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=0, atol=1e-8)

SPEC = rapi.ExperimentSpec(
    problem=rapi.ProblemSpec(d=60, T=24, r=3, n=24, L=6, kappa=1.5),
    topology=rapi.TopologySpec(family="erdos_renyi", p=0.5, seed=3,
                               weights="metropolis"),
    init=rapi.InitSpec(T_pm=20, T_con=8),
    solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=40, T_con=3))


def _arrays(mat):
    return {"Xg": mat.Xg, "yg": mat.yg, "W": mat.W, "adj": mat.adj,
            "U0": mat.init.U0, "R_diag": mat.init.R_diag,
            "alpha": mat.init.alpha, "U_star": mat.problem.U_star,
            "B_star": mat.problem.B_star, "eta": mat.eta,
            "mu": mat.problem.mu, "sigma_max": mat.problem.sigma_max,
            "sigma_min": mat.problem.sigma_min}


@pytest.fixture(scope="module")
def mats():
    """The reference's f64 materialization of SPEC, unsplit and split
    into two folds, each beside the port's copy of it."""
    out = {}
    for n_folds in (0, 2):
        spec = dataclasses.replace(SPEC, problem=dataclasses.replace(
            SPEC.problem, n_folds=n_folds))
        mat = rapi.materialize(spec, key=0)
        port = tapi.materialized_from_arrays(
            {k: np.asarray(v) for k, v in _arrays(mat).items()},
            device="cpu", dtype="float64")
        out[n_folds] = (spec, mat, port)
    return out


def _port_spec(spec):
    d = spec.to_dict()
    d["engine"]["backend"] = "torch-ref"
    return tapi.ExperimentSpec.from_dict(d)


def _compare(ref, got):
    for name in ("sd_max", "sd_mean", "spread"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   err_msg=name, **TOL)
    for name in ("U_nodes", "B_nodes"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_array_equal(got.time_axis, ref.time_axis)


# --------------------------------------------------------- sample split

def _folded_setup():
    """The reference's own sample-split instance
    (tests/test_compression.py::_folded_setup): F = 4 folds, a ring of
    8 nodes, d = 24, r = 3."""
    from repro.core import generate_problem, node_view, split_samples
    from repro.distributed.graphs import ring
    from repro.distributed.mixing import metropolis_weights
    prob = generate_problem(jax.random.PRNGKey(9), d=24, T=16, r=3, n=40,
                            L=8, kappa=1.5)
    Xg, yg = node_view(split_samples(prob, 4))
    W = jnp.asarray(metropolis_weights(ring(8)))
    U0 = jnp.stack([jnp.linalg.qr(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(10), g), (24, 3)))[0]
        for g in range(8)])
    return [np.asarray(a) for a in (Xg, yg, W, U0, prob.U_star)]


@pytest.fixture(scope="module")
def folded():
    return _folded_setup()


def test_sample_split_program_matches_reference(folded):
    """n_folds = 4, T_GD = 7 (the schedule wraps round the folds)."""
    Xg, yg, W, U0, U_star = (np.array(a) for a in folded)
    kw = dict(eta=1e-3, T_GD=7, T_con=2)
    ref = ref_get_solver("dif_altgdmin").fn(
        *(jnp.asarray(a) for a in (U0, Xg, yg, W)), U_star=jnp.asarray(U_star),
        engine=None, backend="xla-ref", **kw)
    got = tapi.get_solver("dif_altgdmin").fn(
        *(torch.as_tensor(a) for a in (U0, Xg, yg, W)),
        U_star=torch.as_tensor(U_star), backend="torch-ref", **kw)
    for name in ("U_nodes", "B_nodes", "sd_max", "sd_mean", "spread"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)


def test_fold_schedule_is_2tau_2tau_plus_1(folded):
    """Iteration τ runs min-B on fold 2τ mod F and the gradient on fold
    2τ+1 mod F: a hand-rolled loop with that selection reproduces the
    program's run."""
    Xg, yg, W, U0, _ = (torch.tensor(a) for a in folded)
    T_GD, T_con, F = 5, 2, 4
    got = tapi.get_solver("dif_altgdmin").fn(
        U0, Xg, yg, W, eta=1e-3, T_GD=T_GD, T_con=T_con,
        backend="torch-ref")
    U = U0
    for tau in range(T_GD):
        Xb, yb = Xg[(2 * tau) % F], yg[(2 * tau) % F]
        Xc, yc = Xg[(2 * tau + 1) % F], yg[(2 * tau + 1) % F]
        B = ref_minimize_B(U, Xb, yb)
        G = ref_grad_U(U, B, Xc, yc)
        U = _qr_pos(agree(U - (1e-3 * 8) * G, W, T_con))[0]
    np.testing.assert_allclose(got.U_nodes.numpy(), U.numpy(), rtol=0,
                               atol=1e-12)


def test_final_B_refits_on_last_min_fold(folded):
    Xg, yg, W, U0, _ = (torch.tensor(a) for a in folded)
    T_GD, F = 5, 4
    res = tapi.get_solver("dif_altgdmin").fn(
        U0, Xg, yg, W, eta=1e-3, T_GD=T_GD, T_con=2, backend="torch-ref")
    last_min = (2 * (T_GD - 1)) % F
    want = AltgdminEngine("torch-ref").minimize_B(res.U_nodes, Xg[last_min],
                                                  yg[last_min])
    assert torch.equal(res.B_nodes, want)


def test_sample_split_run_experiment_matches_reference(mats):
    spec, mat, port = mats[2]
    assert port.Xg.shape == (2, 6, 4, 12, 60)
    ref = rapi.run_experiment(spec, key=0, materialized=mat)
    got = tapi.run_experiment(_port_spec(spec), materialized=port)
    _compare(ref, got)
    assert got.final_sd_max < got.sd_max[0]


# ------------------------------------------------------- compressed trio

TRIO = [("dif_topk", {"compression_k": 12}),
        ("dif_topk", {}),
        ("dif_quantized", {}),
        ("dif_quantized", {"compression": "int8"}),
        ("dif_event", {"event_threshold": 0.02})]


@pytest.mark.parametrize("name,kw", TRIO)
def test_compressed_solvers_match_reference(mats, name, kw):
    spec0, mat, port = mats[0]
    spec = dataclasses.replace(spec0, solver=rapi.SolverSpec(
        name=name, T_GD=40, T_con=3, **kw))
    ref = rapi.run_experiment(spec, key=0, materialized=mat)
    got = tapi.run_experiment(_port_spec(spec), materialized=port)
    assert got.U_nodes.dtype == torch.float64
    _compare(ref, got)
    assert np.all(np.isfinite(got.sd_max))
    assert got.final_sd_max < got.sd_max[0]
    assert (got.send_frac is not None) == (name == "dif_event")


def test_event_send_fraction_matches_reference(mats):
    _, mat, port = mats[0]
    kw = dict(eta=mat.eta, T_GD=30, T_con=3, event_threshold=0.05)
    ref = ref_get_solver("dif_event").fn(
        mat.init.U0, mat.Xg, mat.yg, mat.W, U_star=mat.problem.U_star,
        backend="xla-ref", **kw)
    got = tapi.get_solver("dif_event").fn(
        port.init.U0, port.Xg, port.yg, port.W, U_star=port.problem.U_star,
        backend="torch-ref", **kw)
    assert got.send_frac.dtype == torch.float32
    # the same trigger decisions; a float32 mean of L = 6 of them may
    # differ in its last bit between the two reductions
    np.testing.assert_allclose(got.send_frac.numpy(),
                               np.asarray(ref.send_frac), rtol=0, atol=1e-6)
    assert float(got.send_frac[0]) == 1.0 and float(got.send_frac.min()) < 1


@pytest.mark.parametrize("name,kw", [("dif_topk", {"compression_k": 60}),
                                     ("dif_event", {})])
def test_lossless_solvers_are_dif_altgdmin_bit_for_bit(mats, name, kw):
    spec0, _, port = mats[0]
    spec = _port_spec(spec0)
    dense = tapi.run_experiment(spec, materialized=port)
    lossless = tapi.run_experiment(dataclasses.replace(
        spec, solver=tapi.SolverSpec(name=name, T_GD=40, T_con=3, **kw)),
        materialized=port)
    assert torch.equal(lossless.U_nodes, dense.U_nodes)
    assert torch.equal(lossless.B_nodes, dense.B_nodes)
    np.testing.assert_array_equal(lossless.sd_max, dense.sd_max)


def test_stochastic_int8_converges():
    """The reference's bound (tests/test_compression.py::
    test_compressed_solvers_converge) on its TINY shape, on the port's
    own materialization."""
    spec = tapi.ExperimentSpec(
        problem=tapi.ProblemSpec(d=36, T=24, r=3, n=22, L=8, kappa=1.5),
        topology=tapi.TopologySpec(family="ring", weights="metropolis"),
        init=tapi.InitSpec(T_pm=12, T_con=5),
        solver=tapi.SolverSpec(name="dif_quantized", T_GD=60, T_con=3,
                               compression="int8_stochastic"))
    tr = tapi.run_experiment(spec, key=0, device="cpu")
    assert np.all(np.isfinite(tr.sd_max))
    assert tr.final_sd_max < 0.5 * tr.sd_max[0]
    again = tapi.run_experiment(spec, key=0, device="cpu")
    np.testing.assert_array_equal(again.sd_max, tr.sd_max)


@pytest.mark.parametrize("name,kw", TRIO + [
    ("dif_quantized", {"compression": "int8_stochastic"})])
def test_time_axis_matches_reference(mats, name, kw):
    spec0, mat, _ = mats[0]
    spec = dataclasses.replace(spec0, solver=rapi.SolverSpec(
        name=name, T_GD=25, T_con=3, **kw))
    ref = rapi.comm_time_axis(spec, ref_get_solver(name), mat.graph)
    got = tapi.comm_time_axis(_port_spec(spec), tapi.get_solver(name),
                              mat.graph)
    np.testing.assert_array_equal(got, ref)


def test_unconsumed_and_bad_knobs_rejected(mats):
    spec = _port_spec(mats[0][0])
    port = mats[0][2]
    for name, field, kw in (
            ("dif_altgdmin", "compression", {"compression": "bf16"}),
            ("dif_altgdmin", "compression_k", {"compression_k": 5}),
            ("dif_altgdmin", "event_threshold", {"event_threshold": 0.1}),
            ("dif_quantized", "compression_k", {"compression_k": 3}),
            ("dif_topk", "event_threshold", {"event_threshold": 0.1}),
            ("dif_event", "compression", {"compression": "int8"})):
        bad = dataclasses.replace(spec, solver=tapi.SolverSpec(
            name=name, T_GD=5, **kw))
        with pytest.raises(ValueError, match=f"does not consume {field}"):
            tapi.run_experiment(bad, materialized=port)
    bad = dataclasses.replace(spec, solver=tapi.SolverSpec(
        name="dif_quantized", T_GD=5, compression="fp4"))
    with pytest.raises(ValueError, match="wire format"):
        tapi.run_experiment(bad, materialized=port)
    with pytest.raises(TypeError, match="unexpected spec kwargs"):
        tapi.get_solver("dif_topk").fn(
            port.init.U0, port.Xg, port.yg, port.W, eta=0.1, T_GD=2,
            compression="int8")


# -------------------------------------------------------------- hygiene

def test_every_port_module_imports_without_jax_or_repro():
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert {"repro_torch.kernels.compress",
            "repro_torch.core.program"} <= set(names)
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
