"""The sparse tier on the port's mesh substrates, held against the JAX
package's simulator on the CPU at f64 within 1e-8, from the reference's
own sparse materialization carried across as numpy (W by its
``SparseWeights`` fields, no (L, L) array):

* (a) the virtual-node tier at the reference's shape
  (``tests/test_sparse.py``'s virtual-mesh script: L = 48 on 8 ranks, a
  block of 6, ER(48, 0.15, seed 3) Metropolis, ``representation=
  "sparse"``), all 12 programs in one 8-rank gloo group, the masked trio
  under the reference's 30 % bernoulli dropout; each rank's sends
  R·K·``wire_virtual`` an iteration;
* (b) the one-node-a-rank mesh on a forced-sparse W at L = 8 (its
  ``mesh_weights_from_matrix`` densifies it, as the reference's does).
"""
import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.distributed import graphs as rgraphs  # noqa: E402
from repro.distributed import mixing as rmixing  # noqa: E402
from repro_torch.api.runner import run_on_mesh  # noqa: E402
from repro_torch.distributed import consensus as tcons  # noqa: E402
from repro_torch.distributed.mesh import spawn  # noqa: E402

TOL = dict(rtol=0, atol=1e-8)
SPAWN_TIMEOUT = 300
N_RANKS = 8
# the reference's 30 % bernoulli dropout (tests/test_system.py's DROP30)
DROP = rapi.SystemSpec(availability="bernoulli", p_on=0.7, seed=7)
SPEC_KW = {
    "beyond_central": dict(local_steps=2),
    "dif_topk": dict(compression_k=3),
    "dif_quantized": dict(compression="int8"),
    "dif_event": dict(event_threshold=0.05),
}
VIRTUAL = rapi.ExperimentSpec(
    problem=rapi.ProblemSpec(d=16, T=96, r=2, n=12, L=48, kappa=1.2),
    topology=rapi.TopologySpec(family="erdos_renyi", p=0.15, seed=3,
                               weights="metropolis",
                               representation="sparse"),
    init=rapi.InitSpec(T_pm=4, T_con=2),
    solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=4, T_con=3))
ONE_NODE = rapi.ExperimentSpec(
    problem=rapi.ProblemSpec(d=16, T=16, r=2, n=12, L=8, kappa=1.2),
    topology=rapi.TopologySpec(family="erdos_renyi", p=0.5, seed=1,
                               weights="metropolis",
                               representation="sparse"),
    init=rapi.InitSpec(T_pm=4, T_con=2),
    solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=4, T_con=3))
NAMES = tapi.solver_names()
ONE_NODE_NAMES = ("dif_altgdmin", "dgd_altgdmin", "dif_topk", "dif_pushsum")


def _sparse_arrays(mat):
    """The reference's sparse materialized state as host arrays."""
    W = mat.W
    assert isinstance(W, rmixing.SparseWeights)
    assert isinstance(mat.adj, rgraphs.SparseGraph)
    return {"Xg": np.asarray(mat.Xg), "yg": np.asarray(mat.yg),
            "W_rows": W.rows, "W_cols": W.cols, "W_vals": W.vals,
            "W_diag": W.diag, "n": W.n, "U0": np.asarray(mat.init.U0),
            "R_diag": np.asarray(mat.init.R_diag),
            "alpha": np.asarray(mat.init.alpha),
            "U_star": np.asarray(mat.problem.U_star),
            "B_star": np.asarray(mat.problem.B_star), "eta": mat.eta,
            "mu": mat.problem.mu, "sigma_max": mat.problem.sigma_max,
            "sigma_min": mat.problem.sigma_min}


def _specs(base, name):
    """(the reference's simulator spec, the port's mesh spec on
    torch-ref) of one program."""
    takes_avail = tapi.get_solver(name).takes_avail
    ref = dataclasses.replace(
        base, system=DROP if takes_avail else None,
        solver=dataclasses.replace(base.solver, name=name,
                                   **SPEC_KW.get(name, {})))
    d = dataclasses.replace(ref, substrate="mesh").to_dict()
    d["engine"]["backend"] = "torch-ref"
    return ref, tapi.ExperimentSpec.from_dict(d)


def _spawn(base, names):
    """Every program of ``names`` in one 8-rank gloo group on the
    reference's f64 sparse arrays; → (reference materialization,
    per-rank results)."""
    mat = rapi.materialize(base, key=0)
    specs = [_specs(base, name)[1].to_dict() for name in names]
    t0 = time.monotonic()
    per_rank = spawn(run_on_mesh, N_RANKS,
                     args=("cpu", specs, 0, _sparse_arrays(mat), "float64"),
                     backend="gloo", timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT
    return mat, per_rank


@pytest.fixture(scope="module")
def virtual_runs():
    return _spawn(VIRTUAL, NAMES)


@pytest.fixture(scope="module")
def one_node_runs():
    return _spawn(ONE_NODE, ONE_NODE_NAMES)


def _hold(mat, per_rank, base, names, i):
    """Rank 0's result of program ``i`` against the reference's simulator
    on its own materialization; every rank equal to rank 0."""
    name = names[i]
    ref = rapi.run_experiment(_specs(base, name)[0], materialized=mat)
    hw = per_rank[0][i]
    L, d, r = base.problem.L, base.problem.d, base.problem.r
    assert hw["U_nodes"].shape == (L, d, r)
    U_ref = np.broadcast_to(np.asarray(ref.U_nodes), hw["U_nodes"].shape)
    np.testing.assert_allclose(hw["U_nodes"], U_ref, err_msg=name, **TOL)
    np.testing.assert_allclose(hw["B_nodes"], np.asarray(ref.B_nodes),
                               err_msg=name, **TOL)
    for field in ("sd_max", "sd_mean", "spread"):
        np.testing.assert_allclose(hw[field], getattr(ref, field),
                                   err_msg=f"{name} {field}", **TOL)
    assert hw["transport"] == "gloo" and hw["launches"] == {}
    for g in range(1, N_RANKS):
        for field in ("U_nodes", "B_nodes", "sd_max"):
            np.testing.assert_array_equal(per_rank[g][i][field], hw[field])
    return hw


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_virtual_tier_sparse_matches_reference(virtual_runs, i):
    mat, per_rank = virtual_runs
    hw = _hold(mat, per_rank, VIRTUAL, NAMES, i)
    # sends: T_GD·R·K·wire_virtual, K the cross-rank classes of the
    # sparse W (the sparse neighbour average for "adj" programs)
    solver = tapi.get_solver(NAMES[i])
    port = tapi.materialized_from_arrays(_sparse_arrays(mat), device="cpu",
                                         dtype="float64")
    topo = (tcons.neighbor_average_matrix(port.adj)
            if solver.topology == "adj" else port.W)
    K = len(tcons.VirtualTopology.from_weights(topo, N_RANKS).dev_shifts)
    T_con = VIRTUAL.solver.T_con
    R = tcons.get_rule(solver.combine).signature(T_con).rounds_per_iter
    want = (VIRTUAL.solver.T_GD * R * K
            * solver.program.dispatch_budget.wire_virtual)
    assert K > 1
    assert [per_rank[g][i]["sends"] for g in range(N_RANKS)] == \
        [want] * N_RANKS
    assert hw["sd_max"].shape == (VIRTUAL.solver.T_GD,)


@pytest.mark.parametrize("i", range(len(ONE_NODE_NAMES)),
                         ids=ONE_NODE_NAMES)
def test_one_node_mesh_on_a_sparse_w_matches_reference(one_node_runs, i):
    mat, per_rank = one_node_runs
    _hold(mat, per_rank, ONE_NODE, ONE_NODE_NAMES, i)


def test_masked_runs_part_from_dense_gossip(virtual_runs):
    """The dropout schedule reaches the sparse virtual tier."""
    _, per_rank = virtual_runs
    dense = per_rank[0][NAMES.index("dif_altgdmin")]["U_nodes"]
    for name in ("dif_partial", "dif_stale", "dif_pushsum"):
        got = per_rank[0][NAMES.index(name)]["U_nodes"]
        assert np.abs(got - dense).max() > 1e-6, name
