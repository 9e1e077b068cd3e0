"""The stateful and masked mixers on the mesh — the compressed trio
``dif_topk`` / ``dif_quantized`` / ``dif_event`` and the dropout-tolerant
trio ``dif_partial`` / ``dif_stale`` / ``dif_pushsum`` — held against the
JAX package on the CPU.

One 8-rank gloo group, spawned once for the module, runs every case of
``CASES`` through ``run_on_mesh`` on the reference's f64 arrays of
``MESH_SPEC`` (T_GD = 3, T_con = 2): the six programs on the ER graph's
Metropolis W (the masked trio always-on and under the reference's 30 %
bernoulli schedule), the lossless wires (``dif_topk`` at k = d,
``dif_event`` at θ = 0), ``dif_topk`` with ``consensus_gamma`` 0.5, every
``dif_quantized`` wire, two programs on a circulant ring, and mesh
``dif_altgdmin`` as the anchor.  Each run is held (≤ 1e-8) against the
port's simulator and, where the wire is deterministic (not
``int8_stochastic``, whose dither is the port's own hash), against the
reference's simulator, on the same schedule.  The always-on and lossless
runs equal mesh ``dif_altgdmin`` bit for bit; every rank returns rank
0's result; each rank's sends equal R·K·``wire_mesh``.  The reference's
own mesh runs are not used: its compressed and push-sum mesh tests fail
on this jax.
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
from repro.distributed import graphs as rgraphs  # noqa: E402
from repro.distributed import mixing as rmixing  # noqa: E402
from repro_torch.api.runner import run_on_mesh  # noqa: E402
from repro_torch.distributed import consensus as tcons  # noqa: E402
from repro_torch.distributed.mesh import NodeMesh, spawn  # noqa: E402

TOL = dict(rtol=0, atol=1e-8)
SPAWN_TIMEOUT = 300
L_MESH, T_GD, T_CON = 8, 3, 2
MESH_SPEC = rapi.ExperimentSpec(
    problem=rapi.ProblemSpec(d=30, T=16, r=2, n=20, L=L_MESH, kappa=1.5),
    topology=rapi.TopologySpec(family="erdos_renyi", p=0.6, seed=2,
                               weights="metropolis"),
    init=rapi.InitSpec(T_pm=8, T_con=4),
    solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=T_GD, T_con=T_CON))
RING = rapi.TopologySpec(family="ring", weights="circulant")
# the reference's 30 % bernoulli dropout (tests/test_system.py's DROP30)
DROP = rapi.SystemSpec(availability="bernoulli", p_on=0.7, seed=7)
ALWAYS = rapi.SystemSpec()

# (id, solver, knobs, system, topology)
CASES = [
    ("dif_topk", "dif_topk", {}, None, "er"),
    ("dif_topk-gamma0.5", "dif_topk", {"consensus_gamma": 0.5}, None, "er"),
    ("dif_topk-k=d", "dif_topk", {"compression_k": 30}, None, "er"),
    ("dif_quantized-bf16", "dif_quantized", {}, None, "er"),
    ("dif_quantized-int8", "dif_quantized", {"compression": "int8"}, None,
     "er"),
    ("dif_quantized-int8_stochastic", "dif_quantized",
     {"compression": "int8_stochastic"}, None, "er"),
    ("dif_event", "dif_event", {"event_threshold": 0.05}, None, "er"),
    ("dif_event-theta=0", "dif_event", {}, None, "er"),
    ("dif_partial-always", "dif_partial", {}, ALWAYS, "er"),
    ("dif_partial-drop", "dif_partial", {}, DROP, "er"),
    ("dif_stale-always", "dif_stale", {}, ALWAYS, "er"),
    ("dif_stale-drop", "dif_stale", {}, DROP, "er"),
    ("dif_pushsum-always", "dif_pushsum", {}, ALWAYS, "er"),
    ("dif_pushsum-drop", "dif_pushsum", {}, DROP, "er"),
    ("dif_quantized-int8-ring", "dif_quantized", {"compression": "int8"},
     None, "ring"),
    ("dif_pushsum-drop-ring", "dif_pushsum", {}, DROP, "ring"),
    ("dif_altgdmin", "dif_altgdmin", {}, None, "er"),
]
IDS = [c[0] for c in CASES]
# runs equal to mesh dif_altgdmin bit for bit on torch-ref: a full mask
# keeps the dense weights, a lossless wire delivers the iterate itself
ANCHORED = ("dif_partial-always", "dif_stale-always", "dif_topk-k=d",
            "dif_event-theta=0")


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
    _, name, knobs, system, topo = case
    spec = dataclasses.replace(
        MESH_SPEC, substrate=substrate, system=system,
        solver=dataclasses.replace(MESH_SPEC.solver, name=name, **knobs))
    if topo == "ring":
        spec = dataclasses.replace(spec, topology=RING)
    d = spec.to_dict()
    d["engine"]["backend"] = "torch-ref"
    return tapi.ExperimentSpec.from_dict(d)


def _topology(topo, arrays):
    if topo == "ring":
        return (rmixing.circulant_weights(L_MESH, (-1, 1)),
                rgraphs.ring(L_MESH).adj.astype(np.float64))
    return arrays["W"], arrays["adj"]


def _avail(case):
    system = case[3]
    return (system.availability_mask(T_GD, L_MESH)
            if tapi.get_solver(case[1]).program.takes_avail
            and system is not None else None)


@pytest.fixture(scope="module")
def state_runs():
    """Every case in one 8-rank gloo group, spawned once, on the
    reference's f64 arrays; → (arrays, per-rank results)."""
    mat = rapi.materialize(MESH_SPEC, key=0)
    arrays = _arrays(mat)
    specs = [_case_spec(c).to_dict() for c in CASES]
    t0 = time.monotonic()
    per_rank = spawn(run_on_mesh, L_MESH, args=("cpu", specs, 0, arrays,
                                                "float64"),
                     backend="gloo", timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT
    return arrays, per_rank


def _port_simulator(case, arrays):
    W, adj = _topology(case[4], arrays)
    port = tapi.materialized_from_arrays(dict(arrays, W=W, adj=adj),
                                         device="cpu", dtype="float64")
    return tapi.run_experiment(_case_spec(case, "simulator"),
                               materialized=port)


def _ref_simulator(case, arrays):
    """The reference's simulator on the same arrays, topology and
    schedule."""
    _, name, knobs, _, topo = case
    W, _ = _topology(topo, arrays)
    kw = dict(eta=float(arrays["eta"]), T_GD=T_GD, T_con=T_CON,
              U_star=jnp.asarray(arrays["U_star"]), backend="xla-ref",
              **knobs)
    avail = _avail(case)
    if avail is not None:
        kw["avail"] = jnp.asarray(avail)
    U0, Xg, yg = (jnp.asarray(arrays[k]) for k in ("U0", "Xg", "yg"))
    return ref_get_solver(name).fn(U0, Xg, yg, jnp.asarray(W), **kw)


def test_dropout_schedule_has_down_and_live_nodes():
    m = DROP.availability_mask(T_GD, L_MESH)
    assert m.shape == (T_GD, L_MESH)
    assert (~m).any() and m.any()
    np.testing.assert_array_equal(
        m, tapi.SystemSpec(**dataclasses.asdict(DROP)).availability_mask(
            T_GD, L_MESH))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_mesh_matches_both_simulators(state_runs, i):
    arrays, per_rank = state_runs
    case = CASES[i]
    hw = per_rank[0][i]
    sim = _port_simulator(case, arrays)
    U_hw = hw["U_nodes"]
    assert U_hw.shape == (L_MESH, 30, 2) and hw["sd_max"].shape == (T_GD,)
    assert np.all(np.isfinite(U_hw)) and np.all(np.isfinite(hw["sd_max"]))
    np.testing.assert_allclose(U_hw, sim.U_nodes.numpy(), **TOL)
    np.testing.assert_allclose(hw["B_nodes"], sim.B_nodes.numpy(), **TOL)
    for field in ("sd_max", "sd_mean", "spread"):
        np.testing.assert_allclose(hw[field], getattr(sim, field),
                                   err_msg=field, **TOL)
    if case[2].get("compression") != "int8_stochastic":
        ref = _ref_simulator(case, arrays)
        np.testing.assert_allclose(U_hw, np.asarray(ref.U_nodes),
                                   err_msg="reference", **TOL)
        np.testing.assert_allclose(hw["sd_max"], np.asarray(ref.sd_max),
                                   err_msg="reference", **TOL)
    assert hw["transport"] == "gloo" and hw["launches"] == {}
    for g in range(1, L_MESH):                    # the same on every rank
        for field in ("U_nodes", "B_nodes", "sd_max", "spread"):
            np.testing.assert_array_equal(per_rank[g][i][field], hw[field])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_mesh_sends_equal_the_wire_budget(state_runs, i):
    """Each rank's point-to-point sends: T_GD·R·K·wire_mesh, with R the
    rule's rounds an iteration and K the distinct shifts of its W.
    ``dif_quantized``'s wire_mesh of 2 prices the int8 wires (q and its
    scale); its bf16 wire's payload is the one cast block."""
    arrays, per_rank = state_runs
    case = CASES[i]
    program = tapi.get_solver(case[1]).program
    W, _ = _topology(case[4], arrays)
    K = len(tcons.mesh_weights_from_matrix(W)[0])
    R = tcons.get_rule(program.combine).signature(T_CON).rounds_per_iter
    wire = program.dispatch_budget.wire_mesh
    if case[0] == "dif_quantized-bf16":
        wire -= 1
    want = T_GD * R * K * wire
    assert want > 0
    assert [per_rank[g][i]["sends"] for g in range(L_MESH)] == [want] * L_MESH


@pytest.mark.parametrize("case_id", ANCHORED)
def test_always_on_and_lossless_equal_dense_mesh(state_runs, case_id):
    _, per_rank = state_runs
    got, dense = per_rank[0][IDS.index(case_id)], per_rank[0][-1]
    for field in ("U_nodes", "B_nodes", "sd_max", "sd_mean", "spread"):
        np.testing.assert_array_equal(got[field], dense[field],
                                      err_msg=field)


def test_dropout_moves_the_masked_runs(state_runs):
    """The schedule reaches the mesh: under dropout each masked run
    parts from its always-on run."""
    _, per_rank = state_runs
    for name in ("dif_partial", "dif_stale", "dif_pushsum"):
        on = per_rank[0][IDS.index(f"{name}-always")]["U_nodes"]
        off = per_rank[0][IDS.index(f"{name}-drop")]["U_nodes"]
        assert np.abs(on - off).max() > 1e-6, name


@pytest.mark.parametrize("name", tapi.solver_names())
def test_dispatch_budgets_equal_reference(name):
    got = tapi.get_solver(name).program.dispatch_budget
    ref = ref_get_solver(name).dispatch_budget
    assert (got.simulator, got.mesh, got.wire_mesh) == (
        ref.simulator, ref.mesh, ref.wire_mesh)
    assert tapi.get_solver(name).mesh_capable


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


def test_push_sum_mesh_needs_a_symmetric_w(one_rank_group):
    mesh = NodeMesh("cpu")
    rule = tcons.get_rule("push_sum_gossip")
    W = np.array([[0.5, 0.5], [0.2, 0.8]])
    with pytest.raises(ValueError, match="symmetric mixing matrix"):
        rule.make_mesh_masked_mixer(mesh, 2, W=W)
    with pytest.raises(ValueError, match="closed under negation"):
        rule.make_mesh_masked_mixer(mesh, 2, shifts=(1, 2))
    # a symmetric W and symmetric shifts are accepted; on one node the
    # mixer returns the node's block
    z = torch.as_tensor(np.random.default_rng(0).standard_normal((5, 2)))
    m = torch.ones(1, dtype=torch.bool)
    for kw in ({"W": np.ones((1, 1))}, {"shifts": (-1, 1)}):
        mix = rule.make_mesh_masked_mixer(mesh, 2, **kw)
        np.testing.assert_allclose(mix(z, m).numpy(), z.numpy(), rtol=0,
                                   atol=1e-15)
