"""The system layer and the dropout-tolerant trio of the port, held
against the JAX package on the CPU at the reference's ``TINY`` shape
(``tests/test_system.py``), inputs carried across with
``materialized_from_arrays``:

* ``SystemSpec``: its field checks, the reference's ``to_dict()``
  loading in the port unchanged, and ``availability_mask`` /
  ``node_speeds`` equal to the reference's arrays (host numpy from the
  same seeds);
* ``masked_mixing_matrix`` / ``push_sum_matrix`` bit for bit at f64
  under random masks;
* ``dif_partial`` / ``dif_stale`` / ``dif_pushsum`` on the simulator:
  torch-ref against ``xla-ref`` at f64 (≤ 1e-8 on ``sd_max``,
  ``U_nodes``, ``B_nodes``) and against ``pallas-interpret`` at f32
  (rtol 1e-4, atol 1e-5), always-on and under 30 % bernoulli dropout;
  always-on ``dif_partial`` / ``dif_stale`` equal the port's dense
  ``dif_altgdmin`` bit for bit, ``dif_pushsum`` within 1e-8;
* the simulated clock (``system_time_axis``) equal to the reference's
  exactly, the segmented run under dropout, and the refusals;
* ``core.theory`` equal to the reference's on the cases of
  ``tests/test_agree.py`` and ``tests/test_core_paper.py``.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.core import theory as rtheory  # noqa: E402
from repro.distributed import consensus as rcons  # noqa: E402
from repro.distributed.graphs import erdos_renyi  # noqa: E402
from repro.distributed.mixing import metropolis_weights  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402
from repro_torch.distributed import consensus as tcons  # noqa: E402

jax.config.update("jax_enable_x64", True)

TINY = rapi.ExperimentSpec(
    problem=rapi.ProblemSpec(d=36, T=24, r=3, n=22, L=8, kappa=1.5),
    topology=rapi.TopologySpec(family="erdos_renyi", p=0.5, seed=3,
                               weights="metropolis"),
    init=rapi.InitSpec(T_pm=12, T_con=5),
    solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=30, T_con=3))
DROP30 = rapi.SystemSpec(availability="bernoulli", p_on=0.7, seed=7)
MASKED = ("dif_partial", "dif_stale", "dif_pushsum")
SYSTEMS = {"always": rapi.SystemSpec(), "drop30": DROP30}
F64 = dict(rtol=0, atol=1e-8)
F32 = dict(rtol=1e-4, atol=1e-5)


def _ref_spec(name="dif_altgdmin", system=None, dtype="float64",
              backend="xla-ref", **solver_kw):
    return dataclasses.replace(
        TINY, problem=dataclasses.replace(TINY.problem, dtype=dtype),
        solver=dataclasses.replace(TINY.solver, name=name, **solver_kw),
        engine=rapi.EngineSpec(backend=backend), system=system)


def _port_spec(ref_spec, backend="torch-ref"):
    d = ref_spec.to_dict()
    d["engine"]["backend"] = backend
    return tapi.ExperimentSpec.from_dict(d)


def _arrays(mat):
    return {k: np.asarray(v) for k, v in {
        "Xg": mat.Xg, "yg": mat.yg, "W": mat.W, "adj": mat.adj,
        "U0": mat.init.U0, "R_diag": mat.init.R_diag,
        "alpha": mat.init.alpha, "U_star": mat.problem.U_star,
        "B_star": mat.problem.B_star, "eta": mat.eta,
        "mu": mat.problem.mu, "sigma_max": mat.problem.sigma_max,
        "sigma_min": mat.problem.sigma_min}.items()}


@pytest.fixture(scope="module")
def mats():
    """The reference's materialized TINY problem at each dtype, and the
    port's copy of it on the CPU."""
    out = {}
    for dtype in ("float64", "float32"):
        ref = rapi.materialize(_ref_spec(dtype=dtype), key=0)
        out[dtype] = (ref, tapi.materialized_from_arrays(
            _arrays(ref), device="cpu", dtype=dtype))
    return out


def _compare(got, ref, tol):
    for name in ("sd_max", "sd_mean", "spread"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   err_msg=name, **tol)
    for name in ("U_nodes", "B_nodes"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **tol)


# ------------------------------------------------------------ SystemSpec

@pytest.mark.parametrize("bad", [
    dict(availability="sometimes"),
    dict(availability="bernoulli", p_on=1.3),
    dict(availability="bernoulli", p_on=-0.1),
    dict(availability="markov", p_drop=2.0),
    dict(availability="markov", p_return=-0.5),
    dict(straggler_prob=1.5),
    dict(straggler_factor=0.5),
    dict(speed_spread=-1.0),
    dict(latency_s=-1e-3),
    dict(jitter_std_s=-1e-6),
])
def test_systemspec_rejects_bad_fields(bad):
    with pytest.raises(ValueError):
        tapi.SystemSpec(**bad)


def test_reference_spec_with_system_round_trips():
    spec = dataclasses.replace(
        _ref_spec("dif_stale"), system=rapi.SystemSpec(
            availability="markov", p_drop=0.2, p_return=0.6,
            speed_spread=0.3, straggler_prob=0.1, straggler_factor=3.0,
            latency_s=1e-3, seed=4))
    d = spec.to_dict()
    port = tapi.ExperimentSpec.from_dict(d)
    assert isinstance(port.system, tapi.SystemSpec)
    assert port.to_dict() == d
    assert tapi.ExperimentSpec.from_json(spec.to_json()).to_dict() == d
    # a spec without a system layer round-trips to None
    assert tapi.ExperimentSpec.from_dict(TINY.to_dict()).system is None
    assert tapi.AVAILABILITY_KINDS == rapi.spec.AVAILABILITY_KINDS


@pytest.mark.parametrize("kw", [
    dict(),
    dict(availability="bernoulli", p_on=0.7, seed=7),
    dict(availability="bernoulli", p_on=1.0),
    dict(availability="markov", p_drop=0.3, p_return=0.4, seed=5),
    dict(availability="markov", p_drop=0.0, speed_spread=0.5, seed=3),
])
def test_masks_and_speeds_equal_reference(kw):
    ref, port = rapi.SystemSpec(**kw), tapi.SystemSpec(**kw)
    assert port.is_always_on == ref.is_always_on
    for T_GD, L in ((30, 8), (400, 20)):
        got = port.availability_mask(T_GD, L)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, ref.availability_mask(T_GD, L))
        np.testing.assert_array_equal(port.node_speeds(L),
                                      ref.node_speeds(L))


# ------------------------------------------------ masked mixing matrices

@pytest.mark.parametrize("L", [8, 20])
def test_masked_matrices_equal_reference(L):
    W = np.asarray(metropolis_weights(erdos_renyi(L, 0.5, seed=3)))
    rng = np.random.default_rng(L)
    for _ in range(30):
        m = rng.random(L) < 0.6
        for name in ("masked_mixing_matrix", "push_sum_matrix"):
            want = np.asarray(getattr(rcons, name)(jnp.asarray(W),
                                                   jnp.asarray(m)))
            got = getattr(tcons, name)(torch.as_tensor(W),
                                       torch.as_tensor(m)).numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
    full = torch.ones(L, dtype=torch.bool)
    assert torch.equal(tcons.masked_mixing_matrix(torch.as_tensor(W), full),
                       torch.as_tensor(W))
    C = tcons.push_sum_matrix(torch.as_tensor(W), torch.as_tensor(
        rng.random(L) < 0.5))
    np.testing.assert_allclose(C.sum(0).numpy(), 1.0, atol=1e-12)


def test_masked_rules_refuse_the_stateless_entry_points():
    W = torch.eye(4, dtype=torch.float64)
    for name in ("partial_gossip", "stale_gossip", "push_sum_gossip"):
        rule = tcons.get_rule(name)
        with pytest.raises(TypeError, match="masked"):
            rule.make_sim_mixer(W, 2)
        with pytest.raises(TypeError, match="masked"):
            rule.make_mesh_mixer(None, 2)
        with pytest.raises(NotImplementedError, match="later slice"):
            rule.make_mesh_masked_mixer(None, 2)
        assert rule.signature(3) == tcons.CommSignature("gossip", 3)


def test_push_sum_weights_stay_a_distribution():
    """Σ_g w_g = L through any masked-round product, and at full mask the
    bias-corrected readout agrees with dense gossip."""
    L = 8
    W = torch.as_tensor(metropolis_weights(erdos_renyi(L, 0.5, seed=3)))
    rng = np.random.default_rng(0)
    w = torch.ones((L, 1), dtype=torch.float64)
    for _ in range(6):
        m = torch.as_tensor(rng.random(L) < 0.7)
        m[int(rng.integers(L))] = True
        w = tcons.push_sum_matrix(W, m) @ w
        assert abs(float(w.sum()) - L) <= 1e-12 * L
        assert bool((w >= 0).all())
    Z = torch.as_tensor(rng.standard_normal((L, 6, 2)))
    dense = tcons.get_rule("gossip").make_sim_mixer(W, 4)(Z)
    push = tcons.get_rule("push_sum_gossip").make_sim_masked_mixer(W, 4)(
        Z, torch.ones(L, dtype=torch.bool))
    np.testing.assert_allclose(push.numpy(), dense.numpy(), rtol=1e-10,
                               atol=1e-12)


# ------------------------------------------------------ the three programs

@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("name", MASKED)
def test_masked_trio_f64_matches_xla_ref(mats, name, system):
    ref_mat, port_mat = mats["float64"]
    spec = _ref_spec(name, SYSTEMS[system])
    ref = rapi.run_experiment(spec, key=0, materialized=ref_mat)
    got = tapi.run_experiment(_port_spec(spec), materialized=port_mat)
    assert got.U_nodes.dtype == torch.float64
    _compare(got, ref, F64)
    assert got.time_axis_source == ref.time_axis_source == "simulated"
    np.testing.assert_array_equal(got.time_axis, ref.time_axis)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("name", MASKED)
def test_masked_trio_f32_matches_pallas_interpret(mats, name, system):
    ref_mat, port_mat = mats["float32"]
    spec = _ref_spec(name, SYSTEMS[system], dtype="float32",
                     backend="pallas-interpret")
    ref = rapi.run_experiment(spec, key=0, materialized=ref_mat)
    got = tapi.run_experiment(_port_spec(spec), materialized=port_mat)
    assert got.U_nodes.dtype == torch.float32
    _compare(got, ref, F32)


@pytest.mark.parametrize("name", MASKED)
def test_always_on_matches_dense_dif_altgdmin(mats, name):
    """An always-on SystemSpec perturbs no trajectory: partial and stale
    reduce to dense dif_altgdmin bit for bit on the exact lowering,
    push-sum to round-off (its ratio correction is other arithmetic)."""
    port_mat = mats["float64"][1]
    dense = tapi.run_experiment(_port_spec(_ref_spec()),
                                materialized=port_mat)
    got = tapi.run_experiment(_port_spec(_ref_spec(name, rapi.SystemSpec())),
                              materialized=port_mat)
    if name == "dif_pushsum":
        np.testing.assert_allclose(got.sd_max, dense.sd_max, **F64)
        np.testing.assert_allclose(got.U_nodes.numpy(),
                                   dense.U_nodes.numpy(), **F64)
    else:
        assert torch.equal(got.U_nodes, dense.U_nodes)
        assert torch.equal(got.B_nodes, dense.B_nodes)
        np.testing.assert_array_equal(got.sd_max, dense.sd_max)
    # no SystemSpec at all: the same trajectory on the closed-form clock
    plain = tapi.run_experiment(_port_spec(_ref_spec(name)),
                                materialized=port_mat)
    np.testing.assert_array_equal(plain.sd_max, got.sd_max)
    assert plain.time_axis_source == "closed_form"


def test_dropout_solvers_converge_and_freeze_down_nodes(mats):
    """30 % dropout on the port's own run: the trio keeps contracting,
    the simulated clock is strictly increasing, and a node down at the
    only iteration keeps its starting iterate."""
    port_mat = mats["float64"][1]
    for name in MASKED:
        spec = _port_spec(_ref_spec(name, DROP30, T_GD=70))
        t = tapi.run_experiment(spec, materialized=port_mat)
        assert np.all(np.isfinite(t.sd_max)), name
        assert t.sd_max[-1] < 0.2 * t.sd_max[0], name
        assert np.all(np.diff(t.time_axis) > 0), name
    one = _port_spec(_ref_spec("dif_partial", DROP30, T_GD=1))
    down = ~DROP30.availability_mask(1, 8)[0]
    assert down.any()
    t = tapi.run_experiment(one, materialized=port_mat)
    assert torch.equal(t.U_nodes[torch.as_tensor(down)],
                       port_mat.init.U0[torch.as_tensor(down)])


def test_dropout_on_unaware_solver_raises(mats):
    port_mat = mats["float64"][1]
    with pytest.raises(ValueError, match="dropout"):
        tapi.run_experiment(_port_spec(_ref_spec(system=DROP30)),
                            materialized=port_mat)
    # an always-on system layer is fine on any solver: it changes the
    # clock only
    t = tapi.run_experiment(_port_spec(_ref_spec(system=rapi.SystemSpec())),
                            materialized=port_mat)
    assert t.time_axis_source == "simulated"
    solver = tapi.get_solver("dif_partial")
    with pytest.raises(TypeError, match="availability"):
        tapi.get_solver("dif_altgdmin").fn(
            port_mat.init.U0, port_mat.Xg, port_mat.yg, port_mat.W,
            eta=port_mat.eta, T_GD=2, avail=np.ones((2, 8), bool))
    with pytest.raises(ValueError, match="does not match"):
        solver.fn(port_mat.init.U0, port_mat.Xg, port_mat.yg, port_mat.W,
                  eta=port_mat.eta, T_GD=2, avail=np.ones((3, 8), bool))


def test_all_twelve_programs_resolve():
    ref_names = set(rapi.solver_names())
    assert set(tapi.solver_names()) == ref_names and len(ref_names) == 12
    for name in ref_names:
        port, ref = tapi.get_solver(name), rapi.get_solver(name)
        assert port.takes_avail == ref.takes_avail, name
        assert port.program.mixer == ref.program.mixer, name
        assert (port.program.dispatch_budget.simulator
                == ref.program.dispatch_budget.simulator), name


# ----------------------------------------------------- the simulated clock

CLOCKS = {
    "zero_jitter": ("dif_altgdmin", rapi.SystemSpec(jitter_std_s=0.0), {}),
    "jitter": ("dif_altgdmin", rapi.SystemSpec(), {}),
    "stragglers": ("dif_altgdmin", rapi.SystemSpec(
        speed_spread=1.0, straggler_prob=0.2, straggler_factor=5.0,
        latency_s=2e-3, seed=2), {}),
    "dropout": ("dif_partial", DROP30, {}),
    "markov_beyond": ("beyond_central", rapi.SystemSpec(
        availability="markov", p_drop=0.0, speed_spread=0.4, seed=1),
        {"local_steps": 2}),
    "central": ("centralized_altgdmin", rapi.SystemSpec(latency_s=1e-3), {}),
}


@pytest.mark.parametrize("case", sorted(CLOCKS))
def test_system_time_axis_equals_reference(case):
    name, system, kw = CLOCKS[case]
    spec = _ref_spec(name, system, **kw)
    port_spec = _port_spec(spec)
    L = spec.problem.L
    ref_axis = rapi.system_time_axis(spec, rapi.get_solver(name),
                                     spec.topology.build_graph(L))
    got = tapi.system_time_axis(port_spec, tapi.get_solver(name),
                                port_spec.topology.build_graph(L))
    np.testing.assert_array_equal(got, ref_axis)
    assert np.all(np.diff(got) > 0)


def test_event_send_fraction_prices_the_clock_as_the_reference(mats):
    """dif_event's measured send fraction feeds the simulated clock: the
    port's f64 run sends in the same rounds, so its axis is the
    reference's exactly."""
    ref_mat, port_mat = mats["float64"]
    spec = _ref_spec("dif_event", rapi.SystemSpec(), event_threshold=0.05)
    ref = rapi.run_experiment(spec, key=0, materialized=ref_mat)
    got = tapi.run_experiment(_port_spec(spec), materialized=port_mat)
    assert got.send_frac is not None and 0 < got.send_frac.mean() < 1
    np.testing.assert_array_equal(got.time_axis, ref.time_axis)
    _compare(got, ref, F64)


@pytest.mark.parametrize("name", MASKED)
def test_segmented_run_under_dropout_matches_reference(mats, name,
                                                       tmp_path):
    """checkpoint_every slices the availability schedule per segment, as
    the reference does: the same trajectory and clock, within 1e-8."""
    ref_mat, port_mat = mats["float64"]
    spec = _ref_spec(name, DROP30)
    ref = rapi.run_experiment(spec, key=0, materialized=ref_mat,
                              checkpoint_every=7,
                              checkpoint_dir=str(tmp_path / "ref"))
    got = tapi.run_experiment(_port_spec(spec), materialized=port_mat,
                              checkpoint_every=7,
                              checkpoint_dir=str(tmp_path / "port"))
    _compare(got, ref, F64)
    np.testing.assert_array_equal(got.time_axis, ref.time_axis)
    if name != "dif_stale":
        # a loop carrying just U: segmenting changes nothing
        whole = tapi.run_experiment(_port_spec(spec), materialized=port_mat)
        np.testing.assert_array_equal(got.sd_max, whole.sd_max)


# ---------------------------------------------------------------- theory

@pytest.mark.parametrize("L,eps_con,gamma_W", [
    (9, 1e-3, 0.61), (20, 1e-6, 0.9), (8, 0.5, 0.2), (100, 1e-12, 0.999)])
def test_theory_consensus_rounds_equal_reference(L, eps_con, gamma_W):
    assert (ttheory.prop1_consensus_rounds(L, eps_con, gamma_W)
            == rtheory.prop1_consensus_rounds(L, eps_con, gamma_W))
    for T_con in (1, 5, 30):
        assert (ttheory.eq2_connectivity_requirement(L, eps_con, T_con)
                == rtheory.eq2_connectivity_requirement(L, eps_con, T_con))
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError):
            ttheory.prop1_consensus_rounds(L, eps_con, bad)


def test_theory_prop1_with_the_graph_of_test_agree():
    """tests/test_agree.py's case: ER(9, 0.6, seed 7) Metropolis, the
    second-largest eigenvalue modulus as γ(W)."""
    W = metropolis_weights(erdos_renyi(9, 0.6, seed=7))
    ev = np.sort(np.abs(np.linalg.eigvalsh(W - np.full((9, 9), 1 / 9))))
    gamma = float(ev[-1])
    assert (ttheory.prop1_consensus_rounds(9, 1e-3, gamma)
            == rtheory.prop1_consensus_rounds(9, 1e-3, gamma))


@pytest.mark.parametrize("eps", [1e-2, 1e-6, 1e-8, 1e-12])
def test_theory_round_counts_equal_reference(eps):
    args = dict(L=20, r=4, kappa=2.0, gamma_W=0.8)
    assert ttheory.T_con_GD(**args) == rtheory.T_con_GD(**args)
    dec = dict(L=20, d=600, kappa=2.0, eps=eps, gamma_W=0.8)
    assert ttheory.T_con_GD_dec(**dec) == rtheory.T_con_GD_dec(**dec)
    assert ttheory.T_con_GD_dec(**dec) > ttheory.T_con_GD(**args)
    assert ttheory.T_GD(2.0, eps) == rtheory.T_GD(2.0, eps)
    for fn, a in ((ttheory.T_pm, (600, 2.0)),
                  (ttheory.T_con_init, (20, 600, 4, 2.0, 0.8))):
        assert fn(*a) == getattr(rtheory, fn.__name__)(*a)
    assert (ttheory.sample_complexity(600, 600, 4, 2.0, 1.3, eps)
            == rtheory.sample_complexity(600, 600, 4, 2.0, 1.3, eps))


@pytest.mark.parametrize("eps,kappa", [(1e-4, 2.0), (1e-8, 4.0)])
def test_theory_complexity_reports_equal_reference(eps, kappa):
    kw = dict(n=30, d=600, T=600, r=4, L=20, gamma_W=0.8, max_deg=10)
    for fn in ("dif_complexity", "dec_complexity"):
        got = getattr(ttheory, fn)(eps=eps, kappa=kappa, **kw)
        want = getattr(rtheory, fn)(eps=eps, kappa=kappa, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.tau_time == want.tau_time
    dif = ttheory.dif_complexity(eps=eps, kappa=kappa, **kw)
    dec = ttheory.dec_complexity(eps=eps, kappa=kappa, **kw)
    assert dif.tau_time < dec.tau_time and dif.tau_comm < dec.tau_comm
    assert (ttheory.eta_star(30, 1.7) == rtheory.eta_star(30, 1.7)
            and ttheory.contraction_factor(kappa)
            == rtheory.contraction_factor(kappa))
    assert math.isfinite(dif.tau_comm)
