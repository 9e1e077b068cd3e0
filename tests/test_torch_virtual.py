"""The virtual-node mesh tier — a block of L / D nodes on each of D ranks
— held against the JAX package on the CPU, inputs built by ``repro`` and
carried across as numpy:

* (a) ``SparseWeights.from_dense`` / ``to_dense`` and
  ``VirtualTopology.from_weights`` field for field against the
  reference's (ER(48, 0.15, seed 3) Metropolis at D = 8, Experiment 1's
  ER(20, 0.5, seed 0) at D ∈ {1, 2, 4, 5, 10}), the decomposition
  rebuilding W, ``mesh_weights_relabeled`` and ``_vt_is_symmetric``;
* (b) one 8-rank gloo group, spawned once for the module, running all 12
  programs through ``run_on_mesh`` at the reference's own virtual-mesh
  shape (L = 16, block 2, ``tests/test_programs.py``'s knobs with
  ``dif_quantized`` on ``"int8"``, the masked trio under the reference's
  30 % bernoulli dropout), each held at f64 within 1e-8 of the
  reference's simulator and of the port's, ``int8_stochastic`` (whose
  dither is the port's own) of the port's only; each rank's sends
  R·K·``wire_virtual`` an iteration, every rank equal to rank 0.  The
  reference's own virtual-mesh run is not used: its push-sum does not
  trace on this jax;
* (c) the refusals: a rank count that does not divide L, the stateful
  and masked rules' plain entry, an asymmetric W for push-sum.
"""
import dataclasses
import datetime
import time

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.api.registry import get_solver as ref_get_solver  # noqa: E402
from repro.distributed import consensus as rcons  # noqa: E402
from repro.distributed import graphs as rgraphs  # noqa: E402
from repro.distributed import mixing as rmixing  # noqa: E402
from repro_torch.api.runner import run_on_mesh  # noqa: E402
from repro_torch.distributed import consensus as tcons  # noqa: E402
from repro_torch.distributed import mixing as tmixing  # noqa: E402
from repro_torch.distributed.mesh import NodeMesh, spawn  # noqa: E402

TOL = dict(rtol=0, atol=1e-8)
SPAWN_TIMEOUT = 300


# ------------------------------------------------ (a) the decomposition

def _metropolis(L, p, seed):
    return rmixing.metropolis_weights(rgraphs.erdos_renyi(L, p, seed=seed))


# (W's graph, D): the reference's decomposition test, and Experiment 1's
# graph over every rank count the issue's table lists
TOPO_CASES = [((48, 0.15, 3), 8)] + [((20, 0.5, 0), D)
                                     for D in (1, 2, 4, 5, 10)]
VT_FIELDS = ("local_rows", "local_cols", "local_vals", "cross_rows",
             "cross_cols", "cross_vals", "diag")


def test_sparse_weights_match_reference():
    for graph in ((48, 0.15, 3), (20, 0.5, 0)):
        W = _metropolis(*graph)
        want = rmixing.SparseWeights.from_dense(W)
        got = tmixing.SparseWeights.from_dense(W)
        assert got.n == want.n and got.shape == want.shape
        for field in ("rows", "cols", "vals", "diag"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert (got.nnz, got.n_edges, got.density) == (
            want.nnz, want.n_edges, want.density)
        np.testing.assert_array_equal(got.row_sums(), want.row_sums())
        np.testing.assert_array_equal(got.col_sums(), want.col_sums())
        np.testing.assert_array_equal(got.to_dense(), want.to_dense())
        np.testing.assert_array_equal(got.to_dense(), W)
    # COO input is sorted by (row, col), as the reference sorts it
    sw = tmixing.SparseWeights(n=3, rows=[2, 0, 1], cols=[0, 2, 0],
                               vals=[0.1, 0.2, 0.3], diag=[1, 1, 1])
    np.testing.assert_array_equal(sw.rows, [0, 1, 2])
    np.testing.assert_array_equal(sw.vals, [0.2, 0.3, 0.1])
    with pytest.raises(ValueError, match="belong in .diag"):
        tmixing.SparseWeights(n=2, rows=[1], cols=[1], vals=[1.0],
                              diag=[1, 1])
    with pytest.raises(ValueError, match="out of range"):
        tmixing.SparseWeights(n=2, rows=[2], cols=[0], vals=[1.0],
                              diag=[1, 1])


@pytest.mark.parametrize("graph,D", TOPO_CASES,
                         ids=[f"L{g[0]}-D{D}" for g, D in TOPO_CASES])
def test_virtual_topology_matches_reference(graph, D):
    W = _metropolis(*graph)
    want = rcons.VirtualTopology.from_weights(
        rmixing.SparseWeights.from_dense(W), D)
    for arg in (tmixing.SparseWeights.from_dense(W), W):
        got = tcons.VirtualTopology.from_weights(arg, D)
        assert (got.n_dev, got.block, got.dev_shifts) == (
            want.n_dev, want.block, want.dev_shifts)
        for field in VT_FIELDS:
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert (got.n_nodes, got.n_local_entries, got.n_cross_entries,
                got.block_sends_per_round) == (
            want.n_nodes, want.n_local_entries, want.n_cross_entries,
            want.block_sends_per_round)
    if graph == (20, 0.5, 0):
        # Experiment 1's graph: 160 off-diagonal entries; D = 4 sends
        # three blocks a round (one-node-per-rank: 19 shifts)
        assert got.n_local_entries + got.n_cross_entries == 160
        if D == 4:
            assert got.dev_shifts == (-1, 1, 2)
            assert (got.n_local_entries, got.n_cross_entries) == (46, 114)
        if D == 1:
            assert got.dev_shifts == ()
            assert got.cross_rows.shape == (0, 1, 1)


@pytest.mark.parametrize("graph,D", TOPO_CASES[:2],
                         ids=[f"L{g[0]}-D{D}" for g, D in TOPO_CASES[:2]])
def test_virtual_topology_rebuilds_w(graph, D):
    """The class decomposition rebuilds W (the port of the reference's
    ``test_virtual_topology_decomposition_reconstructs_W``)."""
    W = _metropolis(*graph)
    sw = tmixing.SparseWeights.from_dense(W)
    vt = tcons.VirtualTopology.from_weights(sw, D)
    L, V = sw.n, vt.block
    assert vt.n_nodes == L and vt.n_local_entries + vt.n_cross_entries \
        == sw.nnz
    R = np.zeros((L, L))
    for dev in range(D):
        keep = vt.local_rows[dev] < V
        R[dev * V + vt.local_rows[dev][keep],
          dev * V + vt.local_cols[dev][keep]] += vt.local_vals[dev][keep]
        for k, s in enumerate(vt.dev_shifts):
            src = (dev + s) % D
            keep = vt.cross_rows[k, dev] < V
            R[dev * V + vt.cross_rows[k, dev][keep],
              src * V + vt.cross_cols[k, dev][keep]] += \
                vt.cross_vals[k, dev][keep]
    R[np.arange(L), np.arange(L)] = vt.diag.ravel()
    np.testing.assert_allclose(R, sw.to_dense(), rtol=0, atol=1e-15)
    # the global edge list the push-sum check reads is W's
    r, c, v = tcons._vt_edges(vt)
    Wr = np.zeros((L, L))
    Wr[r, c] = v
    np.testing.assert_array_equal(Wr + np.diag(np.diag(W)), W)


def _relabel_cases():
    er = rgraphs.erdos_renyi(20, 0.5, seed=0)
    ba = rgraphs.barabasi_albert(30, 2, seed=1)
    return {"er20": rmixing.metropolis_weights(er),
            "ba30": rmixing.metropolis_weights(ba.to_dense()),
            "ring": rmixing.circulant_weights(12, (-1, 1)),
            "neighbor_average": np.asarray(rcons.neighbor_average_matrix(
                jnp.asarray(er.adj, float)))}


@pytest.mark.parametrize("name", ["er20", "ba30", "ring",
                                  "neighbor_average"])
def test_mesh_weights_relabeled_and_symmetry_match_reference(name):
    W = _relabel_cases()[name]
    want = rcons.mesh_weights_relabeled(W)
    for arg in (W, tmixing.SparseWeights.from_dense(W)):
        got = tcons.mesh_weights_relabeled(arg)
        np.testing.assert_array_equal(got.perm, want.perm)
        assert got.shifts == want.shifts
        assert (got.shifts_before, got.shifts_after) == (
            want.shifts_before, want.shifts_after)
        np.testing.assert_array_equal(got.table, want.table)
    for D in (1, 2, 4):
        if W.shape[0] % D:
            continue
        want_vt = rcons.VirtualTopology.from_weights(W, D)
        got_vt = tcons.VirtualTopology.from_weights(W, D)
        assert tcons._vt_is_symmetric(got_vt) == \
            rcons._vt_is_symmetric(want_vt) == (name != "neighbor_average")


# -------------------------------------- (b) all 12 programs on the tier

L_V, N_RANKS, T_GD, T_CON = 16, 8, 3, 2
SPEC = rapi.ExperimentSpec(
    problem=rapi.ProblemSpec(d=16, T=48, r=2, n=20, L=L_V, kappa=1.2),
    topology=rapi.TopologySpec(family="erdos_renyi", p=0.4, seed=3,
                               weights="metropolis"),
    init=rapi.InitSpec(T_pm=8, T_con=4),
    solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=T_GD, T_con=T_CON))
# tests/test_programs.py's knobs, with dif_quantized on the int8 wire
SPEC_KW = {
    "beyond_central": dict(local_steps=2),
    "dif_topk": dict(compression_k=3),
    "dif_quantized": dict(compression="int8"),
    "dif_event": dict(event_threshold=0.05),
}
# the reference's 30 % bernoulli dropout (tests/test_system.py's DROP30)
DROP = rapi.SystemSpec(availability="bernoulli", p_on=0.7, seed=7)
# (id, solver, knobs, held against the reference's simulator too)
CASES = [(name, name, SPEC_KW.get(name, {}), True)
         for name in tapi.solver_names()] + [
    ("dif_quantized-int8_stochastic", "dif_quantized",
     {"compression": "int8_stochastic"}, False)]
IDS = [c[0] for c in CASES]


def _arrays(mat):
    """The reference's materialized state as host arrays."""
    return {k: np.asarray(v) for k, v in {
        "Xg": mat.Xg, "yg": mat.yg, "W": mat.W, "adj": mat.adj,
        "U0": mat.init.U0, "R_diag": mat.init.R_diag,
        "alpha": mat.init.alpha, "U_star": mat.problem.U_star,
        "B_star": mat.problem.B_star, "eta": mat.eta, "mu": mat.problem.mu,
        "sigma_max": mat.problem.sigma_max,
        "sigma_min": mat.problem.sigma_min}.items()}


def _case_spec(case, substrate="mesh"):
    """The port's spec of a case, on torch-ref."""
    _, name, knobs, _ = case
    takes_avail = tapi.get_solver(name).takes_avail
    spec = dataclasses.replace(
        SPEC, substrate=substrate, system=DROP if takes_avail else None,
        solver=dataclasses.replace(SPEC.solver, name=name, **knobs))
    d = spec.to_dict()
    d["engine"]["backend"] = "torch-ref"
    return tapi.ExperimentSpec.from_dict(d)


@pytest.fixture(scope="module")
def virtual_runs():
    """Every case in one 8-rank gloo group (block 2), spawned once, on
    the reference's f64 arrays; → (arrays, per-rank results)."""
    mat = rapi.materialize(SPEC, key=0)
    arrays = _arrays(mat)
    specs = [_case_spec(c).to_dict() for c in CASES]
    t0 = time.monotonic()
    per_rank = spawn(run_on_mesh, N_RANKS,
                     args=("cpu", specs, 0, arrays, "float64"),
                     backend="gloo", timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT
    return arrays, per_rank


def _ref_simulator(case, arrays):
    """The reference's simulator on the same arrays and schedule."""
    _, name, knobs, _ = case
    s = ref_get_solver(name)
    kw = dict(eta=float(arrays["eta"]), T_GD=T_GD,
              U_star=jnp.asarray(arrays["U_star"]), backend="xla-ref",
              **knobs)
    if s.takes_avail:
        kw["avail"] = jnp.asarray(DROP.availability_mask(T_GD, L_V))
    U0, Xg, yg = (jnp.asarray(arrays[k]) for k in ("U0", "Xg", "yg"))
    if s.topology == "none":
        return s.fn(U0[0], Xg, yg, **kw)
    if s.topology == "adj":
        return s.fn(U0, Xg, yg, jnp.asarray(arrays["adj"]), **kw)
    return s.fn(U0, Xg, yg, jnp.asarray(arrays["W"]), T_con=T_CON, **kw)


def test_dropout_schedule_has_down_and_live_nodes():
    m = DROP.availability_mask(T_GD, L_V)
    assert m.shape == (T_GD, L_V) and (~m).any() and m.any()


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_virtual_mesh_matches_both_simulators(virtual_runs, i):
    arrays, per_rank = virtual_runs
    case = CASES[i]
    hw = per_rank[0][i]
    port = tapi.materialized_from_arrays(arrays, device="cpu",
                                         dtype="float64")
    sim = tapi.run_experiment(_case_spec(case, "simulator"),
                              materialized=port)
    U_hw = hw["U_nodes"]
    assert U_hw.shape == (L_V, 16, 2) and hw["sd_max"].shape == (T_GD,)
    assert np.all(np.isfinite(U_hw)) and np.all(np.isfinite(hw["sd_max"]))
    U_sim = np.broadcast_to(sim.U_nodes.numpy(), U_hw.shape)  # the center
    np.testing.assert_allclose(U_hw, U_sim, **TOL)
    np.testing.assert_allclose(hw["B_nodes"], sim.B_nodes.numpy(), **TOL)
    for field in ("sd_max", "sd_mean", "spread"):
        np.testing.assert_allclose(hw[field], getattr(sim, field),
                                   err_msg=field, **TOL)
    if case[3]:
        ref = _ref_simulator(case, arrays)
        U_ref = np.broadcast_to(np.asarray(ref.U_nodes), U_hw.shape)
        np.testing.assert_allclose(U_hw, U_ref, err_msg="reference", **TOL)
        np.testing.assert_allclose(hw["sd_max"], np.asarray(ref.sd_max),
                                   err_msg="reference", **TOL)
    assert hw["transport"] == "gloo" and hw["launches"] == {}
    for g in range(1, N_RANKS):                   # the same on every rank
        for field in ("U_nodes", "B_nodes", "sd_max", "spread"):
            np.testing.assert_array_equal(per_rank[g][i][field], hw[field])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_virtual_mesh_sends_equal_the_wire_budget(virtual_runs, i):
    """Each rank's point-to-point sends: T_GD·R·K·wire_virtual, with R
    the rule's rounds an iteration and K the cross-rank edge classes of
    its W (the neighbour average for ``"adj"`` programs)."""
    arrays, per_rank = virtual_runs
    solver = tapi.get_solver(CASES[i][1])
    W = arrays["W"]
    if solver.topology == "adj":
        W = tcons.neighbor_average_matrix(
            torch.tensor(arrays["adj"])).numpy()
    K = len(tcons.VirtualTopology.from_weights(W, N_RANKS).dev_shifts)
    R = tcons.get_rule(solver.combine).signature(T_CON).rounds_per_iter
    budget = solver.program.dispatch_budget
    want = T_GD * R * K * budget.wire_virtual
    assert K > 1
    assert [per_rank[g][i]["sends"] for g in range(N_RANKS)] == \
        [want] * N_RANKS


def test_dropout_moves_the_masked_runs(virtual_runs):
    """The schedule reaches the tier: each masked run parts from dense
    dif_altgdmin."""
    _, per_rank = virtual_runs
    dense = per_rank[0][IDS.index("dif_altgdmin")]["U_nodes"]
    for name in ("dif_partial", "dif_stale", "dif_pushsum"):
        got = per_rank[0][IDS.index(name)]["U_nodes"]
        assert np.abs(got - dense).max() > 1e-6, name


@pytest.mark.parametrize("name", tapi.solver_names())
def test_virtual_budgets_equal_reference(name):
    solver = tapi.get_solver(name)
    got, ref = solver.program.dispatch_budget, ref_get_solver(name)
    assert (got.virtual, got.wire_virtual) == (
        ref.dispatch_budget.virtual, ref.dispatch_budget.wire_virtual)
    assert solver.virtual_mesh_fn is not None
    assert ref.virtual_mesh_fn is not None


# ---------------------------------------------------------- (c) refusals

def test_ranks_that_do_not_divide_l_raise():
    with pytest.raises(ValueError, match="n_dev to divide L"):
        tcons.VirtualTopology.from_weights(_metropolis(16, 0.4, 3), 3)
    spec = _case_spec(CASES[IDS.index("dif_altgdmin")])
    with pytest.raises(RuntimeError, match="ValueError.*rank count that "
                                           "divides L"):
        spawn(run_on_mesh, 3, args=("cpu", [spec.to_dict()], 0),
              backend="gloo", timeout=SPAWN_TIMEOUT)


@pytest.fixture
def one_rank_group(tmp_path):
    """A 1-rank gloo group in this process, destroyed after the test."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_virtual_rule_refusals(one_rank_group):
    mesh = NodeMesh("cpu")
    vt = tcons.VirtualTopology.from_weights(_metropolis(8, 0.5, 1), 1)
    for name in ("dif_topk", "dif_quantized", "dif_event"):
        rule = tcons.get_rule(tapi.get_solver(name).combine)
        with pytest.raises(TypeError, match="make_virtual_mesh_state_mixer"):
            rule.make_virtual_mesh_mixer(mesh, vt, 2)
    for name in ("dif_partial", "dif_stale", "dif_pushsum"):
        rule = tcons.get_rule(tapi.get_solver(name).combine)
        with pytest.raises(TypeError, match="availability-masked"):
            rule.make_virtual_mesh_mixer(mesh, vt, 2)
    with pytest.raises(NotImplementedError, match="no virtual-mesh"):
        tcons.get_rule("central").make_virtual_mesh_mixer(mesh, vt, 2)
    push = tcons.get_rule("push_sum_gossip")
    asym = np.array([[0.5, 0.5], [0.2, 0.8]])
    with pytest.raises(ValueError, match="symmetric mixing matrix"):
        push.make_virtual_mesh_masked_mixer(
            mesh, tcons.VirtualTopology.from_weights(asym, 1), 2)
    # a symmetric W is taken; on one rank no message is sent
    z = torch.as_tensor(np.random.default_rng(0).standard_normal((8, 3, 2)))
    W = _metropolis(8, 0.5, 1)
    mix = push.make_virtual_mesh_masked_mixer(mesh, vt, 2)
    np.testing.assert_allclose(
        mix(z, torch.ones(8, dtype=torch.bool)).numpy(),
        np.einsum("gh,h...->g...", np.linalg.matrix_power(W, 2), z.numpy()),
        rtol=0, atol=1e-14)
