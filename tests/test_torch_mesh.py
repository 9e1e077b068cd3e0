"""This slice — the mesh substrate and the stateless solvers — held
against the JAX package on the CPU, inputs from a seed (numpy) or from
``repro.api.materialize``:

* ``ops.gossip_combine`` and ``combine_blocks`` on ``torch-ref`` against
  the reference's ``ops.gossip_combine`` on ``pallas-interpret`` and
  ``xla-ref`` (rtol = atol = 1e-6), uniform and per-shift weights, odd
  sizes, K from 1 to 5; float64 stays exact (``assert_array_equal``);
* ``mesh_weights_from_matrix`` bit for bit, and ``roll_gossip`` within
  1e-12 at f64, shared scalar weights and a per-node table;
* ``dec_altgdmin``, ``centralized_altgdmin``, ``dgd_altgdmin``,
  ``exact_diffusion`` and ``beyond_central`` on the simulator at f64
  against the reference's simulator (≤ 1e-8);
* the mesh substrate: 8 ranks over gloo, spawned once for the module,
  every stateless program and a circulant ring held against the port's
  own simulator and the reference's simulator on the same arrays (≤ 1e-8
  on ``U_nodes`` and ``sd_max``), and the same result on every rank.
  The reference's own mesh runs are not used: they fail on this jax;
* L = 8 on a one-rank group, which runs the virtual-node tier (one
  block of 8, no message): every program equal to the port's simulator;
* the refusals, and a failing or hung rank failing the spawn.
"""
import dataclasses
import datetime
import operator
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
from repro.distributed import gossip as rgossip  # noqa: E402
from repro.distributed import graphs as rgraphs  # noqa: E402
from repro.distributed import mixing as rmixing  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.api.runner import run_on_mesh  # noqa: E402
from repro_torch.distributed import consensus as tcons  # noqa: E402
from repro_torch.distributed import gossip as tgossip  # noqa: E402
from repro_torch.distributed import mesh as tmesh  # noqa: E402
from repro_torch.distributed.mesh import NodeMesh, spawn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = dict(rtol=0, atol=1e-8)
STATELESS = ("dif_altgdmin", "dec_altgdmin", "centralized_altgdmin",
             "dgd_altgdmin", "exact_diffusion", "beyond_central")
# a hung rank fails the spawn within this, never the suite
SPAWN_TIMEOUT = 300


# ------------------------------------------------------ gossip_combine

# (n, K): odd sizes, a 16-byte-aligned size, K from 1 to 5
COMBINE_CASES = [(3, 1), (257, 2), (2400, 3), (999, 4), (4096, 5), (17, 5)]


def _combine_inputs(n, k, seed, weights):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n).astype(np.float32)
    nbrs = rng.standard_normal((k, n)).astype(np.float32)
    if weights == "uniform":
        w_self = 1.0 / (k + 1)
        w = (w_self,) + ((1.0 - w_self) / k,) * k
    else:
        e = np.exp(rng.standard_normal(k + 1))
        w = tuple(float(x) for x in e / e.sum())
    return z, nbrs, w


@pytest.mark.parametrize("weights", ["uniform", "per_shift"])
@pytest.mark.parametrize("n,k", COMBINE_CASES)
def test_gossip_combine_matches_reference(n, k, weights):
    z, nbrs, w = _combine_inputs(n, k, n + k, weights)
    tz, tn = torch.as_tensor(z), torch.as_tensor(nbrs)
    got_floats = tops.gossip_combine(tz, tn, w).numpy()
    got_tensor = tops.gossip_combine(
        tz, tn, torch.tensor(w, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got_floats, got_tensor)
    for backend in ("pallas-interpret", "xla-ref"):
        want = np.asarray(rops.gossip_combine(
            jnp.asarray(z), jnp.asarray(nbrs), w, backend=backend))
        np.testing.assert_allclose(got_floats, want, rtol=1e-6, atol=1e-6,
                                   err_msg=backend)


@pytest.mark.parametrize("weights", ["uniform", "per_shift"])
@pytest.mark.parametrize("n,k", COMBINE_CASES[:4])
def test_combine_blocks_matches_reference(n, k, weights):
    """The unfused chain (torch-ref) against the reference's fused and
    unfused combine, on a (rows, 3) block, with the weights as Python
    floats and as a tensor (a device's W row)."""
    z, nbrs, w = _combine_inputs(3 * n, k, 7 * n + k, weights)
    z, nbrs = z.reshape(n, 3), nbrs.reshape(k, n, 3)
    blocks = [torch.as_tensor(b) for b in nbrs]
    for tw in (w, torch.tensor(w, dtype=torch.float32)):
        got = tcons.combine_blocks(torch.as_tensor(z), blocks, tw).numpy()
        for backend in ("pallas-interpret", "xla-ref"):
            want = np.asarray(rcons.combine_blocks(
                jnp.asarray(z), [jnp.asarray(b) for b in nbrs],
                jnp.asarray(w, jnp.float32), backend=backend))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=backend)


def test_combine_blocks_f64_stays_exact():
    """float64 never takes the f32 kernel, even on the cuda backend name:
    the exact chain, equal to the reference's bit for bit."""
    z = np.random.default_rng(1).standard_normal((8, 4))
    nbrs = [np.roll(z, s, axis=0) for s in (-1, 1)]
    sw = wn = 1 / 3
    exact = sw * z + wn * nbrs[0] + wn * nbrs[1]
    tz = torch.as_tensor(z)
    for backend in ("torch-ref", "cuda"):
        out = tcons.combine_blocks(tz, [torch.as_tensor(b) for b in nbrs],
                                   (sw, wn, wn), backend=backend)
        assert out.dtype == torch.float64
        np.testing.assert_array_equal(out.numpy(), exact)
    ref = rcons.combine_blocks(jnp.asarray(z), [jnp.asarray(b) for b in nbrs],
                               (sw, wn, wn), backend="pallas-interpret")
    np.testing.assert_array_equal(np.asarray(ref), exact)


def test_gossip_combine_checks_its_operands():
    z = torch.zeros(5)
    with pytest.raises(ValueError, match="want 3 weights"):
        tops.gossip_combine(z, torch.zeros(2, 5), (0.5, 0.5))
    with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
        tops.gossip_combine(z, torch.zeros(1, 5), (0.5, 0.5),
                            backend="cuda")
    out = tops.gossip_combine(z.to(torch.bfloat16),
                              torch.ones(1, 5, dtype=torch.bfloat16),
                              (0.5, 0.5))
    assert out.dtype == torch.bfloat16


# ------------------------------------------ weights and the roll form

def _weight_matrices():
    er = rgraphs.erdos_renyi(9, 0.45, seed=4)
    return {"ring": rmixing.circulant_weights(9, (-1, 1)),
            "er_metropolis": rmixing.metropolis_weights(er),
            "neighbor_average": np.asarray(
                rcons.neighbor_average_matrix(jnp.asarray(er.adj, float)))}


@pytest.mark.parametrize("name", ["ring", "er_metropolis",
                                  "neighbor_average"])
def test_mesh_weights_from_matrix_bitwise(name):
    W = _weight_matrices()[name]
    want_shifts, want_table = rcons.mesh_weights_from_matrix(W)
    for arg in (W, torch.tensor(W)):
        shifts, table = tcons.mesh_weights_from_matrix(arg)
        assert shifts == want_shifts
        assert table.dtype == want_table.dtype
        np.testing.assert_array_equal(table, want_table)


def test_neighbor_average_matrix_matches_reference():
    er = rgraphs.erdos_renyi(9, 0.45, seed=4)
    er.adj[3] = er.adj[:, 3] = 0            # an isolated node: degree 1
    want = np.asarray(rcons.neighbor_average_matrix(
        jnp.asarray(er.adj, float)))
    got = tcons.neighbor_average_matrix(torch.as_tensor(er.adj, dtype=float))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["shared", "circulant_W", "table_W"])
def test_roll_gossip_matches_reference(case):
    rng = np.random.default_rng(5)
    Z = rng.standard_normal((9, 6, 2))
    kw = {}
    if case == "circulant_W":
        kw["W"] = rmixing.circulant_weights(9, (-2, 1))
    elif case == "table_W":
        kw["W"] = _weight_matrices()["er_metropolis"]
    shifts = {"shifts": (-1, 1, 3)} if case == "shared" else {}
    want = np.asarray(rgossip.roll_gossip(jnp.asarray(Z), 4, **shifts, **kw))
    got = tgossip.roll_gossip(torch.as_tensor(Z), 4, **shifts, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # a tree of tensors mixes every leaf the same way
    tree = tgossip.roll_gossip({"a": torch.as_tensor(Z)}, 4, **shifts, **kw)
    np.testing.assert_array_equal(tree["a"].numpy(), got.numpy())
    # and the product with the equivalent W
    if "W" in kw:
        W = kw["W"]
        np.testing.assert_allclose(
            got.numpy(),
            np.einsum("gh,h...->g...", np.linalg.matrix_power(W, 4), Z),
            rtol=0, atol=1e-12)


def test_roll_gossip_rejects_wrong_node_axis():
    W = _weight_matrices()["er_metropolis"]
    with pytest.raises(ValueError, match="one row per node"):
        tgossip.roll_gossip(torch.zeros(8, 2, dtype=torch.float64), 1, W=W)


# --------------------------------------------- the stateless solvers

SPEC = rapi.ExperimentSpec(
    problem=rapi.ProblemSpec(d=40, T=24, r=3, n=24, L=6, kappa=1.5),
    topology=rapi.TopologySpec(family="erdos_renyi", p=0.5, seed=3,
                               weights="metropolis"),
    init=rapi.InitSpec(T_pm=20, T_con=8),
    solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=30, T_con=3))


def _arrays(mat):
    """The reference's materialized state as host arrays."""
    return {k: np.asarray(v) for k, v in {
        "Xg": mat.Xg, "yg": mat.yg, "W": mat.W, "adj": mat.adj,
        "U0": mat.init.U0, "R_diag": mat.init.R_diag,
        "alpha": mat.init.alpha, "U_star": mat.problem.U_star,
        "B_star": mat.problem.B_star, "eta": mat.eta, "mu": mat.problem.mu,
        "sigma_max": mat.problem.sigma_max,
        "sigma_min": mat.problem.sigma_min}.items()}


def _port_spec(spec, **changes):
    d = dataclasses.replace(spec, **changes).to_dict()
    d["engine"]["backend"] = "torch-ref"
    return tapi.ExperimentSpec.from_dict(d)


@pytest.fixture(scope="module")
def sim_mats():
    mat = rapi.materialize(SPEC, key=0)
    port = tapi.materialized_from_arrays(_arrays(mat), device="cpu",
                                         dtype="float64")
    return mat, port


@pytest.mark.parametrize("name,kw", [
    ("dec_altgdmin", {}), ("centralized_altgdmin", {}),
    ("dgd_altgdmin", {}), ("exact_diffusion", {}),
    ("beyond_central", {"local_steps": 1}),
    ("beyond_central", {"local_steps": 2})])
def test_stateless_solvers_match_reference(sim_mats, name, kw):
    mat, port = sim_mats
    spec = dataclasses.replace(SPEC, solver=rapi.SolverSpec(
        name=name, T_GD=30, T_con=3, **kw))
    ref = rapi.run_experiment(spec, key=0, materialized=mat)
    got = tapi.run_experiment(_port_spec(spec), materialized=port)
    for field in ("sd_max", "sd_mean", "spread"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field),
                                   err_msg=field, **TOL)
    for field in ("U_nodes", "B_nodes"):
        want = np.asarray(getattr(ref, field))
        assert tuple(getattr(got, field).shape) == want.shape
        np.testing.assert_allclose(getattr(got, field).numpy(), want,
                                   err_msg=field, **TOL)
    np.testing.assert_array_equal(got.time_axis, ref.time_axis)
    assert got.U_nodes.dtype == torch.float64
    assert np.all(np.isfinite(got.sd_max))


def test_solver_call_convention_matches_reference():
    for name in STATELESS:
        ref, got = ref_get_solver(name), tapi.get_solver(name)
        assert (got.topology, got.combine, got.decentralized,
                got.spec_kwargs) == (ref.topology, ref.combine,
                                     ref.decentralized, ref.spec_kwargs)
        assert got.mesh_capable
        # the substrates the port lowers to price their launches alike
        got_b, ref_b = got.program.dispatch_budget, ref.dispatch_budget
        assert ((got_b.simulator, got_b.mesh)
                == (ref_b.simulator, ref_b.mesh))
        assert (tcons.get_rule(got.combine).signature(3).__dict__
                == rcons.get_rule(ref.combine).signature(3).__dict__)


# ------------------------------------------------ the mesh substrate

L_MESH = 8
MESH_SPEC = rapi.ExperimentSpec(
    problem=rapi.ProblemSpec(d=30, T=16, r=2, n=20, L=L_MESH, kappa=1.5),
    topology=rapi.TopologySpec(family="erdos_renyi", p=0.6, seed=2,
                               weights="metropolis"),
    init=rapi.InitSpec(T_pm=8, T_con=4),
    solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=3, T_con=2))
RING = rapi.TopologySpec(family="ring", weights="circulant")
# (solver, topology): every stateless program on the ER graph's
# Metropolis W, and two on a circulant ring (shared scalar weights)
MESH_CASES = [(name, "er") for name in STATELESS] + [
    ("dif_altgdmin", "ring"), ("dgd_altgdmin", "ring")]


def _mesh_spec(name, topo):
    spec = dataclasses.replace(
        MESH_SPEC, substrate="mesh",
        solver=dataclasses.replace(MESH_SPEC.solver, name=name))
    if topo == "ring":
        spec = dataclasses.replace(spec, topology=RING)
    return _port_spec(spec)


@pytest.fixture(scope="module")
def mesh_runs():
    """Every mesh case in one 8-rank gloo group, spawned once, on the
    reference's f64 arrays; → (arrays, per-rank results)."""
    mat = rapi.materialize(MESH_SPEC, key=0)
    arrays = _arrays(mat)
    specs = [_mesh_spec(name, topo).to_dict() for name, topo in MESH_CASES]
    t0 = time.monotonic()
    per_rank = spawn(run_on_mesh, L_MESH, args=("cpu", specs, 0, arrays,
                                                "float64"),
                     backend="gloo", timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT
    return arrays, per_rank


def _ref_simulator(name, topo, arrays):
    """The reference's simulator on the same arrays (and, for the ring,
    the ring's own circulant W and adjacency)."""
    s = ref_get_solver(name)
    W, adj = arrays["W"], arrays["adj"]
    if topo == "ring":
        W = rmixing.circulant_weights(L_MESH, (-1, 1))
        adj = rgraphs.ring(L_MESH).adj.astype(np.float64)
    kw = dict(eta=float(arrays["eta"]), T_GD=3,
              U_star=jnp.asarray(arrays["U_star"]), backend="xla-ref")
    U0, Xg, yg = (jnp.asarray(arrays[k]) for k in ("U0", "Xg", "yg"))
    if s.topology == "none":
        return s.fn(U0[0], Xg, yg, **kw), W, adj
    if s.topology == "adj":
        return s.fn(U0, Xg, yg, jnp.asarray(adj), **kw), W, adj
    return s.fn(U0, Xg, yg, jnp.asarray(W), T_con=2, **kw), W, adj


@pytest.mark.parametrize("case", range(len(MESH_CASES)),
                         ids=[f"{n}-{t}" for n, t in MESH_CASES])
def test_mesh_matches_both_simulators(mesh_runs, case):
    arrays, per_rank = mesh_runs
    name, topo = MESH_CASES[case]
    hw = per_rank[0][case]
    ref, W, adj = _ref_simulator(name, topo, arrays)
    port_arrays = dict(arrays, W=W, adj=adj)
    port = tapi.materialized_from_arrays(port_arrays, device="cpu",
                                         dtype="float64")
    spec = dataclasses.replace(_mesh_spec(name, topo), substrate="simulator")
    sim = tapi.run_experiment(spec, materialized=port)
    U_hw = hw["U_nodes"]
    assert U_hw.shape == (L_MESH, 30, 2) and hw["sd_max"].shape == (3,)
    for label, U_sim, sd_sim in (
            ("port simulator", sim.U_nodes.numpy(), sim.sd_max),
            ("reference simulator", np.asarray(ref.U_nodes),
             np.asarray(ref.sd_max))):
        U_sim = np.broadcast_to(U_sim, U_hw.shape)    # the fusion center
        np.testing.assert_allclose(U_hw, U_sim, err_msg=label, **TOL)
        np.testing.assert_allclose(hw["sd_max"], sd_sim, err_msg=label,
                                   **TOL)
    np.testing.assert_allclose(hw["sd_mean"], sim.sd_mean, **TOL)
    np.testing.assert_allclose(hw["spread"], sim.spread, **TOL)
    np.testing.assert_allclose(hw["B_nodes"], sim.B_nodes.numpy(), **TOL)
    assert hw["transport"] == "gloo" and hw["launches"] == {}
    for g in range(1, L_MESH):                    # the same on every rank
        for field in ("U_nodes", "B_nodes", "sd_max", "spread"):
            np.testing.assert_array_equal(per_rank[g][case][field],
                                          hw[field])


# --------------------------------------------------------- refusals

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


def _small_mesh_spec(**changes):
    spec = _port_spec(dataclasses.replace(MESH_SPEC, substrate="mesh"))
    return dataclasses.replace(spec, **changes)


def test_mesh_outside_a_process_group_raises():
    with pytest.raises(RuntimeError, match="process group"):
        tapi.run_experiment(_small_mesh_spec(), device="cpu")


def test_mesh_refusals(one_rank_group):
    spec = _small_mesh_spec()
    # L=8 on one rank runs the virtual-node tier (D = 1, block 8): no
    # cross-rank class, so no message, and every program equals the
    # port's simulator
    mat = tapi.materialize(spec, key=0, device="cpu")
    for name in tapi.solver_names():
        s = dataclasses.replace(spec, solver=dataclasses.replace(
            spec.solver, name=name))
        tmesh.SENDS.clear()
        got = tapi.run_experiment(s, materialized=mat)
        assert tmesh.SENDS["p2p"] == 0, name
        sim = tapi.run_experiment(
            dataclasses.replace(s, substrate="simulator"), materialized=mat)
        np.testing.assert_allclose(
            got.U_nodes.numpy(),
            np.broadcast_to(sim.U_nodes.numpy(), got.U_nodes.shape),
            err_msg=name, **TOL)
        np.testing.assert_allclose(got.B_nodes.numpy(), sim.B_nodes.numpy(),
                                   err_msg=name, **TOL)
        for field in ("sd_max", "sd_mean", "spread"):
            np.testing.assert_allclose(getattr(got, field),
                                       getattr(sim, field),
                                       err_msg=f"{name} {field}", **TOL)
    folded = dataclasses.replace(spec, problem=dataclasses.replace(
        spec.problem, n_folds=2))
    with pytest.raises(ValueError, match="sample splitting"):
        tapi.run_experiment(folded, device="cpu")
    # the stateful and masked rules refuse the stateless mesh entry point
    # (it would drop their state or their mask)
    mesh = NodeMesh("cpu")
    for name in ("dif_topk", "dif_quantized", "dif_event"):
        rule = tcons.get_rule(tapi.get_solver(name).combine)
        with pytest.raises(TypeError, match="make_mesh_state_mixer"):
            rule.make_mesh_mixer(mesh, 2)
    for name in ("dif_partial", "dif_stale", "dif_pushsum"):
        rule = tcons.get_rule(tapi.get_solver(name).combine)
        with pytest.raises(TypeError, match="availability-masked"):
            rule.make_mesh_mixer(mesh, 2)


def test_one_rank_mesh_gossip_and_mean(one_rank_group):
    """A 1-node mesh: its ppermutes come back to itself, so the ring
    combine, the mean and a one-node run return the node's own block."""
    mesh = NodeMesh("cpu")
    assert (mesh.axis_index(), mesh.size, mesh.transport) == (0, 1, "gloo")
    z = torch.as_tensor(np.random.default_rng(0).standard_normal((5, 2)))
    got = mesh.ppermute_many(z, (-1, 0, 1))
    assert got.shape == (3, 5, 2) and all(torch.equal(b, z) for b in got)
    ring = tcons.get_rule("gossip").make_mesh_mixer(mesh, 3, (-1, 1))
    np.testing.assert_allclose(ring(z).numpy(), z.numpy(), rtol=0,
                               atol=1e-15)
    assert torch.equal(tcons.get_rule("central").make_mesh_mixer(mesh, 0)(z),
                       z)
    assert torch.equal(mesh.psum(z), z)
    assert torch.equal(mesh.all_gather(z)[0], z)
    rng = np.random.default_rng(1)
    Xg = torch.as_tensor(rng.standard_normal((1, 2, 10, 6)))
    yg = torch.as_tensor(rng.standard_normal((1, 2, 10)))
    U0 = torch.linalg.qr(torch.as_tensor(rng.standard_normal((1, 6, 2))))[0]
    kw = dict(eta=0.01, T_GD=3, T_con=2, U_star=U0[0], backend="torch-ref")
    s = tapi.get_solver("dif_altgdmin")
    hw = s.mesh_fn(U0, Xg, yg, mesh, W=torch.ones(1, 1, dtype=float), **kw)
    sim = s.fn(U0, Xg, yg, torch.ones(1, 1, dtype=float), **kw)
    np.testing.assert_allclose(hw.U_nodes.numpy(), sim.U_nodes.numpy(),
                               **TOL)
    np.testing.assert_allclose(hw.sd_max.numpy(), sim.sd_max.numpy(), **TOL)


# ------------------------------------------------- failing ranks fail

def test_spawn_fails_with_the_rank_traceback():
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        spawn(operator.truediv, 2, args=(1, 0), timeout=SPAWN_TIMEOUT)


def test_spawn_times_out_on_a_hung_rank():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not report") as err:
        spawn(time.sleep, 2, args=(3600,), timeout=30)
    assert time.monotonic() - t0 < 90
    assert "_rank_main" in str(err.value)       # the hung rank's stacks
