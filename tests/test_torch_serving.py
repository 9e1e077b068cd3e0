"""The port's serving slice against the JAX package's, on the CPU.

* The single-basis least-squares ops (``ops.altgdmin_minimize_B``,
  ``ops.altgdmin_gradient``) on ``torch-ref`` against ``repro``'s on
  ``pallas-interpret``, at tests/test_kernels.py's shapes and tolerances.
* ``ServingEngine`` (``torch-ref``, f64) against ``repro.serving``
  (``xla-ref``, f64) on the same U and the same ``RequestGenerator``
  requests, within 1e-10: ``solve``, ``solve_packed``, ragged batches,
  slot padding and bucket padding — the padding cases also bit for bit
  within the port; the f32 port against ``pallas-interpret`` at
  tests/test_serving.py's tolerance (atol 1e-6).
* The deadline batcher under a ``service_time`` model: identical
  ``ServeRecord`` timings, batch sizes, versions and shed counts.
* The publisher and the hot-swap reader.
* ``run_experiment(checkpoint_every=...)``: segmented ≡ unsegmented bit
  for bit within the port, within 1e-8 of the reference's segmented run
  on the reference's arrays, the publish schedule, the drifting-U error
  falling, and the reference's guards.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro.serving as rsrv  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.altgdmin_ls import task_gram as ref_task_gram  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.core.engine import AltgdminEngine  # noqa: E402
from repro_torch.kernels import altgdmin_ls, ops, ref  # noqa: E402
from repro_torch.serving import (HotSwapSource,  # noqa: E402
                                 RepresentationPublisher, RequestGenerator,
                                 ServeRequest, ServingEngine,
                                 deployable_basis, load_representation,
                                 pack_requests, publish_representation,
                                 run_closed_loop)

D, R_RANK = 40, 3
F64 = dict(rtol=0, atol=1e-10)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _basis(seed, d=D, r=R_RANK):
    return np.linalg.qr(np.random.default_rng(seed).standard_normal((d, r)))[0]


def _requests(seed, d=D, t_news=(16, 16, 16)):
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal((t, d)) for t in t_news],
            [rng.standard_normal(t) for t in t_news])


def _engines(U, **kw):
    """The port's engine on the CPU (torch-ref) and the reference's
    (xla-ref), on the same f64 basis."""
    return (ServingEngine(torch.as_tensor(U), backend="torch-ref", **kw),
            rsrv.ServingEngine(jnp.asarray(U), backend="xla-ref", **kw))


# =========================================================== the LS ops

@pytest.mark.parametrize("T,n,d,r,blk_d", [
    (6, 30, 64, 4, 16),
    (3, 20, 100, 8, 32),         # d not a multiple of blk_d: the reference pads
    (1, 50, 256, 2, 256),
])
def test_minimize_B_matches_reference(T, n, d, r, blk_d):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((T, n, d)).astype(np.float32)
    U = np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
    y = rng.standard_normal((T, n)).astype(np.float32)
    tX, tU, ty = (torch.as_tensor(a) for a in (X, U, y))
    B_ref = rops.altgdmin_minimize_B(X, U, y, blk_d=blk_d,
                                     backend="pallas-interpret")
    B = ops.altgdmin_minimize_B(tX, tU, ty)
    assert B.dtype == torch.float32 and B.shape == (T, r)
    np.testing.assert_allclose(_np(B), np.asarray(B_ref), rtol=1e-3,
                               atol=1e-4)
    # the Gram pieces against the Pallas kernel itself, d padded as the
    # reference's ops pad it
    dpad = (-d) % blk_d
    G_ref, c_ref = ref_task_gram(np.pad(X, ((0, 0), (0, 0), (0, dpad))),
                                 np.pad(U, ((0, dpad), (0, 0))), y,
                                 blk_d=min(blk_d, d + dpad))
    G, c = ref.ref_single_task_gram(tX, tU, ty)
    np.testing.assert_allclose(_np(G), np.asarray(G_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(c), np.asarray(c_ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("T,n,d,r", [(5, 25, 64, 4), (2, 30, 80, 6)])
def test_gradient_matches_reference(T, n, d, r):
    rng = np.random.default_rng(6)
    X = rng.standard_normal((T, n, d)).astype(np.float32)
    U = np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
    B = rng.standard_normal((T, r)).astype(np.float32)
    y = rng.standard_normal((T, n)).astype(np.float32)
    g_ref = rops.altgdmin_gradient(X, U, B, y, blk_d=32,
                                   backend="pallas-interpret")
    g = ops.altgdmin_gradient(*(torch.as_tensor(a) for a in (X, U, B, y)))
    assert g.dtype == torch.float32 and g.shape == (d, r)
    np.testing.assert_allclose(_np(g), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(g), np.asarray(rref.ref_altgdmin_grad(
        X, U, B, y)), rtol=1e-4, atol=1e-4)


def test_single_basis_ops_compute_in_f32_like_the_reference():
    rng = np.random.default_rng(7)
    X, U = rng.standard_normal((4, 20, 50)), _basis(7, d=50, r=3)
    B, y = rng.standard_normal((4, 3)), rng.standard_normal((4, 20))
    targs = [torch.as_tensor(a) for a in (X, U, y)]
    B_port = ops.altgdmin_minimize_B(*targs)
    assert B_port.dtype == torch.float32
    np.testing.assert_allclose(
        _np(B_port), np.asarray(rops.altgdmin_minimize_B(
            X, U, y, backend="xla-ref"), np.float64), rtol=1e-4, atol=1e-4)
    g = ops.altgdmin_gradient(targs[0], targs[1], torch.as_tensor(B),
                              targs[2])
    assert g.dtype == torch.float32
    np.testing.assert_allclose(
        _np(g), np.asarray(rops.altgdmin_gradient(X, U, B, y,
                                                  backend="xla-ref")),
        rtol=1e-4, atol=1e-4)


def test_single_basis_minimize_B_matches_the_simulator_min_step():
    """Per node, the single-basis op on the shared U* agrees with the
    reference simulator's min step on a real MTRL instance (the same
    Cholesky route; tests/test_kernels.py's check)."""
    import jax
    from repro.core import generate_problem, node_view
    from repro.core.altgdmin import minimize_B
    prob = generate_problem(jax.random.PRNGKey(7), d=60, T=24, r=3, n=20,
                            L=4, kappa=1.5, dtype=jnp.float32)
    Xg, yg = node_view(prob)
    B_sim = minimize_B(jnp.broadcast_to(prob.U_star,
                                        (4,) + prob.U_star.shape), Xg, yg)
    U = torch.tensor(np.asarray(prob.U_star))
    B = torch.stack([ops.altgdmin_minimize_B(
        torch.tensor(np.asarray(Xg[g])), U,
        torch.tensor(np.asarray(yg[g]))) for g in range(4)])
    np.testing.assert_allclose(_np(B), np.asarray(B_sim), rtol=1e-3,
                               atol=1e-4)


def test_single_basis_kernels_launch_or_raise():
    X, U = torch.zeros(2, 5, 8), torch.zeros(8, 2)
    B, y = torch.zeros(2, 2), torch.zeros(2, 5)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.altgdmin_minimize_B(X, U, y, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.altgdmin_gradient(X, U, B, y, backend="cuda")
    # the wrappers themselves: never a CPU fallback
    with pytest.raises(ValueError, match="CUDA device"):
        altgdmin_ls.task_gram(X, U, y)
    with pytest.raises(ValueError, match="CUDA device"):
        altgdmin_ls.task_grad_tiles(X, U, B, y)
    with pytest.raises(ValueError, match="want X"):
        altgdmin_ls.task_gram(X[None], U, y)
    with pytest.raises(ValueError, match="shape mismatch"):
        altgdmin_ls.task_gram(X, U[:4], y)


# ========================================================= serving parity

def test_request_generator_draws_the_reference_requests():
    U = _basis(0)
    mine = RequestGenerator(torch.as_tensor(U), t_new=(8, 16), seed=3)
    theirs = rsrv.RequestGenerator(U, t_new=(8, 16), seed=3)
    for a, b in zip(mine.generate(10), theirs.generate(10)):
        assert a.rid == b.rid and a.t_arrival == b.t_arrival
        for f in ("X", "y", "theta_star"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_packed_solve_is_the_training_minb_path():
    """solve_packed ≡ AltgdminEngine.minimize_B on the same packed
    layout, bit for bit — serving IS the training fold solve — and the
    reference's packed solve within 1e-10."""
    U = _basis(1)
    X_list, y_list = _requests(2)
    X, y, R = pack_requests(X_list, y_list, max_batch=4, device="cpu")
    mine, theirs = _engines(U, max_batch=4)
    B_serve, version = mine.solve_packed(X, y)
    tU = torch.as_tensor(U)
    B_train = AltgdminEngine("torch-ref").minimize_B(tU[None], X[None],
                                                     y[None])[0]
    assert torch.equal(B_serve, B_train)
    assert R == 3 and B_serve.shape == (4, R_RANK) and version == 0
    assert mine.n_dispatches == 1 and mine.n_requests == 4
    jX, jy, _ = rsrv.pack_requests(X_list, y_list, max_batch=4)
    np.testing.assert_array_equal(_np(X), np.asarray(jX))
    np.testing.assert_array_equal(_np(y), np.asarray(jy))
    np.testing.assert_allclose(_np(B_serve),
                               np.asarray(theirs.solve_packed(jX, jy)[0]),
                               **F64)


def test_ragged_batch_matches_reference_and_per_request_solve():
    """Heterogeneous T_new, one packed call against the reference's and
    against one training-engine solve per request at its TRUE sample
    count (so the zero-row padding too)."""
    U = _basis(3)
    X_list, y_list = _requests(4, t_news=(5, 9, 16, 12))
    mine, theirs = _engines(U, max_batch=4)
    B, theta, version = mine.solve(X_list, y_list)
    B_ref, theta_ref, _ = theirs.solve(X_list, y_list)
    assert B.dtype == torch.float64 and version == 0
    assert mine.n_dispatches == 1 and mine.n_requests == 4
    np.testing.assert_allclose(_np(B), np.asarray(B_ref), **F64)
    np.testing.assert_allclose(_np(theta), np.asarray(theta_ref), **F64)
    tU = torch.as_tensor(U)
    train = AltgdminEngine("torch-ref")
    for i, (Xi, yi) in enumerate(zip(X_list, y_list)):
        b_ref = train.minimize_B(tU[None], torch.as_tensor(Xi)[None, None],
                                 torch.as_tensor(yi)[None, None])[0, 0]
        np.testing.assert_allclose(_np(B[i]), _np(b_ref), **F64)
    assert torch.equal(theta, B @ tU.T)


def test_batch_slot_padding_is_bitwise_exact():
    """R=3 real requests from a max_batch=3 engine and from a max_batch=8
    engine (5 dummy slots): the real solutions equal bit for bit."""
    U = _basis(5)
    X_list, y_list = _requests(6)
    tight, tight_ref = _engines(U, max_batch=3)
    slack, _ = _engines(U, max_batch=8)
    B_tight = tight.solve(X_list, y_list)[0]
    assert torch.equal(B_tight, slack.solve(X_list, y_list)[0])
    np.testing.assert_allclose(_np(B_tight),
                               np.asarray(tight_ref.solve(X_list, y_list)[0]),
                               **F64)


def test_sample_bucket_padding_is_bitwise_exact():
    """The same requests in a pad_n_to=8 bucket and a pad_n_to=32 bucket
    (3x the zero rows): bit-identical b."""
    U = _basis(7)
    X_list, y_list = _requests(8, t_news=(7, 11, 13))
    e8, e8_ref = _engines(U, max_batch=4, pad_n_to=8)
    e32, _ = _engines(U, max_batch=4, pad_n_to=32)
    B8 = e8.solve(X_list, y_list)[0]
    assert torch.equal(B8, e32.solve(X_list, y_list)[0])
    np.testing.assert_allclose(_np(B8),
                               np.asarray(e8_ref.solve(X_list, y_list)[0]),
                               **F64)


def test_f32_port_matches_pallas_interpret():
    U = _basis(9)
    X_list, y_list = _requests(10, t_news=(8, 16, 12))
    f32 = [[a.astype(np.float32) for a in lst] for lst in (X_list, y_list)]
    B_pl, _, _ = rsrv.ServingEngine(
        jnp.asarray(U, jnp.float32), max_batch=4,
        backend="pallas-interpret").solve(*f32)
    B, _, _ = ServingEngine(torch.as_tensor(U, dtype=torch.float32),
                            max_batch=4, backend="torch-ref").solve(*f32)
    assert B.dtype == torch.float32
    np.testing.assert_allclose(_np(B), np.asarray(B_pl), rtol=0, atol=1e-6)
    # and the f64 reference at the same tolerance
    B_ref = _engines(U, max_batch=4)[1].solve(X_list, y_list)[0]
    np.testing.assert_allclose(_np(B), np.asarray(B_ref), rtol=0, atol=1e-6)


def test_noiseless_request_recovers_truth():
    """With U = U* and noiseless y, the served θ̂ is the user's true
    regressor to solver precision."""
    U_star = _basis(11)
    reqs = RequestGenerator(U_star, t_new=16, seed=0).generate(6)
    eng = ServingEngine(torch.as_tensor(U_star), max_batch=8,
                        backend="torch-ref")
    _, theta, _ = eng.solve([q.X for q in reqs], [q.y for q in reqs])
    for i, q in enumerate(reqs):
        err = np.linalg.norm(_np(theta[i]) - q.theta_star) \
            / np.linalg.norm(q.theta_star)
        assert err < 1e-9


# ============================================================ validation

def test_underdetermined_request_raises():
    eng = ServingEngine(torch.as_tensor(_basis(12)), max_batch=4)
    with pytest.raises(ValueError, match="underdetermined"):
        eng.solve([np.zeros((R_RANK - 1, D))], [np.zeros(R_RANK - 1)])


def test_pack_requests_validation():
    X = np.zeros((4, D))
    with pytest.raises(ValueError, match="at least one"):
        pack_requests([], [], max_batch=4, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        pack_requests([X] * 5, [np.zeros(4)] * 5, max_batch=4, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        pack_requests([X], [np.zeros(3)], max_batch=4, device="cpu")


def test_update_representation_rejects_stacks():
    eng = ServingEngine(torch.as_tensor(_basis(13)))
    with pytest.raises(ValueError, match="single"):
        eng.update_representation(torch.zeros((4, D, R_RANK)))
    eng.update_representation(_basis(14), version=9)
    assert eng.version == 9 and eng.U.dtype == torch.float64


def test_serving_entry_points_need_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    U = _basis(15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(U)                        # a host array: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_requests([np.zeros((4, D))], [np.zeros(4)], max_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HotSwapSource(str(tmp_path), d=D, r=R_RANK)
    publish_representation(str(tmp_path), 0, U)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_representation(str(tmp_path), 0, d=D, r=R_RANK)
    eng = ServingEngine(U, device="cpu")
    assert eng.U.device.type == "cpu" and eng.engine.backend == "torch-ref"


# ======================================================= deadline batcher

def _tiny_engines(max_batch=4):
    return _engines(_basis(16, d=8, r=2), max_batch=max_batch)


def _burst(n, dt, t0=0.0, d=8, t_new=4, seed=0):
    rng = np.random.default_rng(seed)
    return [ServeRequest(rid=i, X=rng.standard_normal((t_new, d)),
                         y=rng.standard_normal(t_new),
                         t_arrival=t0 + i * dt) for i in range(n)]


def _const_service(_batch_size):
    return 5e-3


def test_batcher_full_batch_launches_at_fill_time():
    reqs = _burst(8, dt=1e-4)
    report = run_closed_loop(_tiny_engines()[0], reqs, max_wait_s=1.0,
                             service_time=_const_service)
    assert report.batch_sizes == [4, 4]
    assert report.n_shed == 0
    assert all(r.t_launch == pytest.approx(reqs[3].t_arrival)
               for r in report.records if r.rid < 4)
    assert sorted(r.rid for r in report.records) == list(range(8))


def test_batcher_deadline_launches_short_batch():
    report = run_closed_loop(_tiny_engines()[0], _burst(3, dt=1.0),
                             max_wait_s=2e-3, service_time=_const_service)
    assert report.batch_sizes == [1, 1, 1]
    for rec in report.records:
        assert rec.queue_wait == pytest.approx(2e-3)
        assert rec.latency == pytest.approx(2e-3 + 5e-3)


def test_batcher_sheds_on_full_queue_and_serves_rest_exactly_once():
    report = run_closed_loop(_tiny_engines()[0], _burst(20, dt=1e-4),
                             max_wait_s=1e-3, queue_capacity=4,
                             service_time=lambda _b: 1.0)
    assert report.n_shed > 0
    rids = [r.rid for r in report.records]
    assert len(rids) == len(set(rids))
    assert len(rids) + report.n_shed == 20
    assert all(s <= 4 for s in report.batch_sizes)


def test_batcher_rejects_inconsistent_limits():
    eng = _tiny_engines()[0]
    with pytest.raises(ValueError, match="packed capacity"):
        run_closed_loop(eng, _burst(2, dt=1e-3), max_batch=8)
    with pytest.raises(ValueError, match="cannot hold"):
        run_closed_loop(eng, _burst(2, dt=1e-3), queue_capacity=2)


class _ListSource:
    """A swap source that offers ``(step, U)`` on the given polls."""

    def __init__(self, offers, convert):
        self.offers, self.convert, self.n = dict(offers), convert, 0

    def poll(self):
        self.n += 1
        hit = self.offers.get(self.n)
        return None if hit is None else (hit[0], self.convert(hit[1]))


@pytest.mark.parametrize("case", ["burst", "sparse", "shed", "swap",
                                  "generator"])
def test_closed_loop_matches_reference_record_for_record(case):
    """Under a service-time model both packages make the same batches at
    the same virtual times: identical records, batch sizes, depth trace,
    versions and shed counts; errors within 1e-10."""
    kw = dict(max_wait_s=3e-3, service_time=_const_service)
    sources = (None, None)
    if case == "burst":
        reqs = _burst(12, dt=2e-4)
    elif case == "sparse":
        reqs = _burst(6, dt=1e-2)
    elif case == "shed":
        reqs = _burst(30, dt=1e-4)
        kw.update(queue_capacity=5, service_time=lambda b: 1e-2 * b)
    elif case == "swap":
        reqs = _burst(16, dt=2e-3)
        offers = {2: (7, _basis(17, d=8, r=2)), 4: (9, _basis(18, d=8, r=2))}
        sources = (_ListSource(offers, torch.as_tensor),
                   _ListSource(offers, jnp.asarray))
    else:
        U_star = _basis(19, d=8, r=2)
        reqs = RequestGenerator(U_star, t_new=(4, 6, 8), rate_hz=400.0,
                                seed=5).generate(40)
    mine, theirs = _tiny_engines()
    a = run_closed_loop(mine, reqs, swap_source=sources[0], **kw)
    b = rsrv.run_closed_loop(theirs, reqs, swap_source=sources[1], **kw)
    assert a.batch_sizes == b.batch_sizes
    assert a.depth_trace == b.depth_trace
    assert a.n_shed == b.n_shed
    assert len(a.records) == len(b.records) > 0
    for x, y in zip(a.records, b.records):
        assert (x.rid, x.t_arrival, x.t_launch, x.t_done, x.batch_size,
                x.version) == (y.rid, y.t_arrival, y.t_launch, y.t_done,
                               y.batch_size, y.version)
        if y.err is None:
            assert x.err is None
        else:
            assert x.err == pytest.approx(y.err, rel=0, abs=1e-10)
    if case == "swap":
        assert {r.version for r in a.records} == {0, 7, 9}


# ==================================================== publisher / hot swap

def test_deployable_basis_is_orthonormal_and_the_reference():
    stack = np.random.default_rng(20).standard_normal((5, D, R_RANK))
    U = deployable_basis(torch.as_tensor(stack))
    assert U.shape == (D, R_RANK)
    np.testing.assert_allclose(_np(U.T @ U), np.eye(R_RANK), atol=1e-10)
    np.testing.assert_allclose(_np(U), np.asarray(rsrv.deployable_basis(
        jnp.asarray(stack))), **F64)
    np.testing.assert_allclose(_np(deployable_basis(stack[0])),
                               np.asarray(rsrv.deployable_basis(stack[0])),
                               **F64)


def test_publisher_cadence(tmp_path):
    pub = RepresentationPublisher(str(tmp_path), every=3)
    stack = torch.randn(2, 6, 2, generator=torch.Generator().manual_seed(0))
    hits = [s for s in range(7) if pub.maybe(s, stack)]
    assert hits == [0, 3, 6]
    assert pub.published == [0, 3, 6]
    assert latest_step(str(tmp_path)) == 6
    with pytest.raises(ValueError):
        RepresentationPublisher(str(tmp_path), every=0)


def test_hot_swap_source_only_reports_newer(tmp_path):
    d, r = 6, 2
    U0 = torch.as_tensor(_basis(21, d=d, r=r))
    publish_representation(str(tmp_path), 0, U0)
    src = HotSwapSource(str(tmp_path), d=d, r=r, dtype=torch.float64,
                        device="cpu")
    step, U = src.poll()
    assert step == 0 and U.dtype == torch.float64
    np.testing.assert_allclose(_np(U), _np(deployable_basis(U0)),
                               atol=1e-12)
    assert src.poll() is None                  # nothing newer
    publish_representation(str(tmp_path), 5,
                           torch.as_tensor(_basis(22, d=d, r=r)))
    assert src.poll()[0] == 5
    # an incomplete (manifest-less) newer dir stays invisible
    os.mkdir(tmp_path / "step_000000009")
    assert src.poll() is None


# ==================================================== checkpointed training

def _spec(T_GD=16):
    return rapi.ExperimentSpec(
        name="serving_test",
        problem=rapi.ProblemSpec(d=30, T=24, r=2, n=24, L=4, kappa=2.0),
        topology=rapi.TopologySpec(family="erdos_renyi", p=0.6, seed=1),
        init=rapi.InitSpec(T_pm=10, T_con=5),
        solver=rapi.SolverSpec(name="dif_altgdmin", T_GD=T_GD, T_con=3))


def _port_spec(spec):
    return tapi.ExperimentSpec.from_dict(spec.to_dict())


def _port_mat(mat):
    arrays = {"Xg": mat.Xg, "yg": mat.yg, "W": mat.W, "adj": mat.adj,
              "U0": mat.init.U0, "R_diag": mat.init.R_diag,
              "alpha": mat.init.alpha, "U_star": mat.problem.U_star,
              "B_star": mat.problem.B_star, "eta": mat.eta,
              "mu": mat.problem.mu, "sigma_max": mat.problem.sigma_max,
              "sigma_min": mat.problem.sigma_min}
    return tapi.materialized_from_arrays(
        {k: np.asarray(v) for k, v in arrays.items()}, device="cpu",
        dtype="float64")


@pytest.fixture(scope="module")
def segmented_runs(tmp_path_factory):
    spec = _spec()
    ref_dir = str(tmp_path_factory.mktemp("ref_ck"))
    port_dir = str(tmp_path_factory.mktemp("port_ck"))
    mat = rapi.materialize(spec, key=0)
    ref_seg = rapi.run_experiment(spec, key=0, materialized=mat,
                                  checkpoint_every=4, checkpoint_dir=ref_dir)
    pmat = _port_mat(mat)
    seg = tapi.run_experiment(_port_spec(spec), materialized=pmat,
                              checkpoint_every=4, checkpoint_dir=port_dir)
    plain = tapi.run_experiment(_port_spec(spec), materialized=pmat)
    return spec, port_dir, ref_dir, seg, plain, ref_seg


def test_segmented_run_is_bit_identical(segmented_runs):
    *_, seg, plain, _ = segmented_runs
    assert np.array_equal(seg.sd_max, plain.sd_max)
    assert np.array_equal(seg.sd_mean, plain.sd_mean)
    assert np.array_equal(seg.spread, plain.spread)
    assert torch.equal(seg.U_nodes, plain.U_nodes)
    assert torch.equal(seg.B_nodes, plain.B_nodes)
    assert np.array_equal(seg.time_axis, plain.time_axis)


def test_segmented_run_matches_reference(segmented_runs):
    spec, port_dir, ref_dir, seg, _, ref_seg = segmented_runs
    tol = dict(rtol=0, atol=1e-8)
    for name in ("sd_max", "sd_mean", "spread"):
        np.testing.assert_allclose(getattr(seg, name),
                                   np.asarray(getattr(ref_seg, name)),
                                   err_msg=name, **tol)
    for name in ("U_nodes", "B_nodes"):
        np.testing.assert_allclose(_np(getattr(seg, name)),
                                   np.asarray(getattr(ref_seg, name)),
                                   err_msg=name, **tol)
    np.testing.assert_array_equal(seg.time_axis, ref_seg.time_axis)
    p = spec.problem
    for step in (0, 4, 8, 12, 16):
        U = load_representation(port_dir, step, d=p.d, r=p.r,
                                dtype=torch.float64, device="cpu")
        U_ref = rsrv.load_representation(ref_dir, step, d=p.d, r=p.r,
                                         dtype=jnp.float64)
        np.testing.assert_allclose(_np(U), np.asarray(U_ref), **tol)


def test_segmented_run_publishes_schedule(segmented_runs):
    spec, port_dir, *_ = segmented_runs
    steps = sorted(int(s.split("_")[1]) for s in os.listdir(port_dir))
    assert steps == [0, 4, 8, 12, 16]
    assert latest_step(port_dir) == spec.solver.T_GD
    U = load_representation(port_dir, 16, d=spec.problem.d,
                            r=spec.problem.r, dtype=torch.float64,
                            device="cpu")
    assert U.shape == (spec.problem.d, spec.problem.r)


def test_drifting_checkpoints_reduce_serving_error(segmented_runs):
    """A fixed cohort's θ̂ error falls at every published checkpoint,
    from the step-0 (spectral init) U to the final U, through the
    hot-swap reader."""
    spec, port_dir, _, seg, _, _ = segmented_runs
    p = spec.problem
    reqs = RequestGenerator(seg.materialized.problem.U_star, t_new=12,
                            seed=3).generate(24)
    errs = []
    eng = None
    for step in (0, 4, 8, 12, 16):
        U = load_representation(port_dir, step, d=p.d, r=p.r,
                                dtype=torch.float64, device="cpu")
        if eng is None:
            eng = ServingEngine(U, max_batch=24, backend="torch-ref",
                                version=step)
        else:
            eng.update_representation(U, version=step)
        _, theta, version = eng.solve([q.X for q in reqs],
                                      [q.y for q in reqs])
        assert version == step
        theta = _np(theta)
        errs.append(float(np.mean(
            [np.linalg.norm(theta[i] - q.theta_star)
             / np.linalg.norm(q.theta_star) for i, q in enumerate(reqs)])))
    assert all(b < a for a, b in zip(errs, errs[1:])), errs
    assert errs[-1] < 0.75 * errs[0], errs


def test_checkpoint_kwargs_guards(tmp_path):
    spec = _port_spec(_spec(T_GD=2))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tapi.run_experiment(spec, key=0, device="cpu", checkpoint_every=1)
    with pytest.raises(ValueError, match=">= 1"):
        tapi.run_experiment(spec, key=0, device="cpu", checkpoint_every=0,
                            checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="simulator"):
        tapi.run_experiment(dataclasses.replace(spec, substrate="mesh"),
                            key=0, device="cpu", checkpoint_every=1,
                            checkpoint_dir=str(tmp_path))
    folds = dataclasses.replace(
        spec, problem=dataclasses.replace(spec.problem, n_folds=2))
    with pytest.raises(ValueError, match="n_folds"):
        tapi.run_experiment(folds, key=0, device="cpu", checkpoint_every=1,
                            checkpoint_dir=str(tmp_path))
    assert not os.listdir(tmp_path), "a refused run publishes nothing"


def test_segmented_run_of_the_fusion_center_chains_its_iterate(tmp_path):
    """The fusion center carries one (d, r) iterate, published as a
    one-node stack; its segmented run equals the plain one bit for
    bit."""
    spec = dataclasses.replace(_port_spec(_spec(T_GD=6)),
                               solver=dataclasses.replace(
                                   _port_spec(_spec()).solver,
                                   name="centralized_altgdmin", T_GD=6))
    mat = tapi.materialize(spec, key=2, device="cpu")
    seg = tapi.run_experiment(spec, materialized=mat, checkpoint_every=4,
                              checkpoint_dir=str(tmp_path))
    plain = tapi.run_experiment(spec, materialized=mat)
    assert np.array_equal(seg.sd_max, plain.sd_max)
    assert torch.equal(seg.U_nodes, plain.U_nodes)
    assert sorted(os.listdir(tmp_path)) == ["step_000000000",
                                            "step_000000004",
                                            "step_000000006"]
