"""The sparse consensus tier of the port held against the JAX package on
the CPU, inputs built by ``repro`` (x64 on) and carried across as numpy.
The cases mirror ``tests/test_sparse.py``:

* the ``*_sparse`` weight builders bit for bit against the reference's
  for every graph family and weight scheme, the circulant fold, and
  ``SparseWeights.power`` with its fill-budget fall-back;
* ``sparse_round`` / ``stacked_sparse_product`` at f64 within 1e-12, and
  the padding's neutrality bit for bit;
* every rule's sparse simulator mixer against the reference's sparse
  mixer at f64 within 1e-12 (the masked ones under one numpy mask), and
  against the port's own dense mixer;
* the ``maybe_sparsify`` policy, the one-node-a-rank mesh's densify;
* the spectral init at L = 1024 on the sparse tier within 1e-10;
* all 12 solvers through ``run_experiment`` at the reference's
  ``_small_spec`` with ``representation="sparse"``, against the
  reference within 1e-8 (its sparse state carried across), and sparse ≡
  dense within rtol 1e-7 / atol 1e-9;
* no densify: L = 10 000 on a Barabási–Albert graph with
  ``SparseWeights.to_dense`` and ``SparseGraph.adj`` made to raise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.core import spectral as rspectral  # noqa: E402
from repro.core.problem import generate_problem, node_view  # noqa: E402
from repro.distributed import consensus as rcons  # noqa: E402
from repro.distributed import graphs as rgraphs  # noqa: E402
from repro.distributed import mixing as rmixing  # noqa: E402
from repro_torch.core import spectral as tspectral  # noqa: E402
from repro_torch.distributed import consensus as tcons  # noqa: E402
from repro_torch.distributed import graphs as tgraphs  # noqa: E402
from repro_torch.distributed import mixing as tmixing  # noqa: E402

EXACT = dict(rtol=0, atol=1e-12)
SW_FIELDS = ("rows", "cols", "vals", "diag")


def _same_sw(got, want):
    """Two SparseWeights equal field for field, dtypes included."""
    assert got.n == want.n
    for field in SW_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


# ------------------------------------------------------------- builders

# tests/test_sparse.py's families at L = 40, built by each package's own
# generator (bit-identical graphs, tests/test_torch_graphs.py)
FAMILIES = {
    "erdos_renyi": lambda g: g.erdos_renyi(40, p=0.15, seed=3),
    "ring": lambda g: g.ring(40),
    "barabasi_albert": lambda g: g.barabasi_albert(40, m=2, seed=0),
    "hierarchical": lambda g: g.hierarchical(40, branching=4),
    "cluster_cliques": lambda g: g.cluster_of_cliques(40, clique=8, seed=2),
}
SCHEMES = ("metropolis_weights_sparse", "equal_neighbor_weights_sparse",
           "lazy_weights_sparse", "neighbor_average_weights_sparse")


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sparse_builders_bitwise(family, scheme):
    rg, tg = FAMILIES[family](rgraphs), FAMILIES[family](tgraphs)
    got = getattr(tmixing, scheme)(tg)
    _same_sw(got, getattr(rmixing, scheme)(rg))
    # a dense Graph takes the same path through its sparse form
    _same_sw(getattr(tmixing, scheme)(tg.to_dense()), got)
    if scheme == "neighbor_average_weights_sparse":
        np.testing.assert_allclose(
            got.to_dense(),
            tcons.neighbor_average_matrix(tg.to_dense()).numpy(), **EXACT)
    else:
        dense = getattr(tmixing, scheme.replace("_sparse", ""))(
            tg.to_dense())
        np.testing.assert_allclose(got.to_dense(), dense, rtol=0,
                                   atol=1e-14)


def test_lazy_beta_and_circulant_fold_bitwise():
    g = tgraphs.erdos_renyi(30, p=0.2, seed=1)
    _same_sw(tmixing.lazy_weights_sparse(g, 0.3),
             rmixing.lazy_weights_sparse(rgraphs.erdos_renyi(30, p=0.2,
                                                             seed=1), 0.3))
    # colliding shifts fold (3 ≡ −3 mod 6), shifts ≡ 0 fold to the diagonal
    for L, shifts, sw in ((6, (-1, 1, 3, -3), None), (8, (0, 2, 10), 0.4),
                          (12, (-1, 1), None)):
        got = tmixing.circulant_weights_sparse(L, shifts, sw)
        _same_sw(got, rmixing.circulant_weights_sparse(L, shifts, sw))
        np.testing.assert_allclose(
            got.to_dense(), tmixing.circulant_weights(L, shifts, sw),
            rtol=0, atol=1e-15)


def test_power_and_its_budget_fall_back():
    rg, tg = (m.erdos_renyi(60, p=0.12, seed=1) for m in (rgraphs, tgraphs))
    rsw, tsw = (rmixing.metropolis_weights_sparse(rg),
                tmixing.metropolis_weights_sparse(tg))
    _same_sw(tsw, rsw)
    for T in (1, 2, 3):
        got, want = tsw.power(T), rsw.power(T)
        assert (got is None) == (want is None) == (T == 3)
        if got is not None:
            _same_sw(got, want)
    np.testing.assert_allclose(
        tsw.power(2).to_dense(), np.linalg.matrix_power(tsw.to_dense(), 2),
        rtol=0, atol=1e-12)
    # a tiny fill budget forces the per-round fall-back
    assert tsw.power(4, max_fill_factor=1.01) is None
    assert rsw.power(4, max_fill_factor=1.01) is None
    with pytest.raises(ValueError):
        tsw.power(0)
    csr = tsw.scipy_csr()
    np.testing.assert_array_equal(csr.toarray(), tsw.to_dense())


# ------------------------------------------------------- sparse rounds

def _setup(L=24, seed=0, width=(7, 5)):
    """tests/test_sparse.py's ``_parity_setup``: ER(24, 0.3) Metropolis,
    both packages' SparseWeights, and a seeded numpy Z (L, 7, 5)."""
    rsw = rmixing.metropolis_weights_sparse(rgraphs.erdos_renyi(L, 0.3,
                                                                seed=seed))
    tsw = tmixing.metropolis_weights_sparse(tgraphs.erdos_renyi(L, 0.3,
                                                                seed=seed))
    Z = np.random.default_rng(seed).standard_normal((L,) + width)
    return rsw, tsw, Z


def test_sparse_arrays_and_rounds_match_reference():
    rsw, tsw, Z = _setup()
    for got, want in zip(tcons._sparse_arrays(tsw),
                         rcons._sparse_arrays(rsw)):
        np.testing.assert_array_equal(got, want)
    L = tsw.n
    rows, cols, vals, diag = tcons.sparse_operands(tsw, "cpu", torch.float64)
    assert rows.dtype == torch.int64 and rows.numel() % tcons._SPARSE_PAD == 0
    assert tcons.sparse_operands(tsw, "cpu", torch.float64)[0] is rows
    zf = Z.reshape(L, -1)
    ra = [jnp.asarray(a) for a in rcons._sparse_arrays(rsw)]
    np.testing.assert_allclose(
        tcons.sparse_round(torch.as_tensor(zf), rows, cols, vals, diag,
                           L).numpy(),
        np.asarray(rcons.sparse_round(jnp.asarray(zf), *ra, L)), **EXACT)
    np.testing.assert_allclose(
        tcons.sparse_offdiag_apply(torch.as_tensor(zf), rows, cols, vals,
                                   L).numpy(),
        np.asarray(rcons.sparse_offdiag_apply(jnp.asarray(zf), *ra[:3], L)),
        **EXACT)
    for T_con in (0, 1, 3):
        got = tcons.stacked_sparse_product(torch.as_tensor(Z), tsw, T_con)
        want = rcons.stacked_sparse_product(jnp.asarray(Z), rsw, T_con)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
        # stacked_product routes a SparseWeights to the sparse product
        np.testing.assert_array_equal(
            tcons.stacked_product(torch.as_tensor(Z), tsw, T_con).numpy(),
            got.numpy())
        np.testing.assert_allclose(
            got.numpy(),
            tcons.stacked_product(torch.as_tensor(Z),
                                  torch.as_tensor(tsw.to_dense()),
                                  T_con).numpy(), **EXACT)


def test_padding_is_neutral_bitwise():
    _, tsw, Z = _setup()
    rows, cols, vals, diag = tcons.sparse_operands(tsw, "cpu", torch.float64)
    zf = torch.as_tensor(Z.reshape(tsw.n, -1))
    base = tcons.sparse_round(zf, rows, cols, vals, diag, tsw.n)
    pad = tcons._SPARSE_PAD
    more = tcons.sparse_round(
        zf, torch.cat([rows, torch.full((pad,), tsw.n)]),
        torch.cat([cols, torch.zeros(pad, dtype=torch.int64)]),
        torch.cat([vals, torch.zeros(pad, dtype=vals.dtype)]), diag, tsw.n)
    assert torch.equal(base, more)


# ------------------------------------------------- every rule's mixer

STATELESS = ("gossip", "exact_diffusion", "beyond_central")
STATEFUL = {"topk_gossip": dict(compression_k=3),
            "quantized_gossip": dict(compression="int8"),
            "event_gossip": dict(event_threshold=0.05)}
MASKED = ("partial_gossip", "push_sum_gossip", "stale_gossip")
RULES = STATELESS + ("neighbor",) + tuple(STATEFUL) + MASKED


def _mask(seed=3, L=24):
    return np.random.default_rng(seed).random(L) > 0.3


def _mixers(rule, r_topo, t_topo, t_dense, Z, backend="torch-ref"):
    """(reference sparse, port sparse, port dense) outputs of one rule's
    simulator mixer on Z (the state's too, for the stateful rules)."""
    rr, tr = rcons.get_rule(rule), tcons.get_rule(rule)
    Zr, Zt = jnp.asarray(Z), torch.as_tensor(Z)
    if rule in STATEFUL:
        kw = STATEFUL[rule]
        outs = [rr.make_sim_state_mixer(r_topo, 3, backend="xla-ref", **kw)(
            Zr, rr.init_state(Zr, **kw))]
        for topo in (t_topo, t_dense):
            outs.append(tr.make_sim_state_mixer(topo, 3, backend=backend,
                                                **kw)(
                Zt, tr.init_state(Zt, **kw)))
        return outs
    if rule in MASKED:
        m = _mask()
        if rule == "stale_gossip":
            st_r = jnp.asarray(np.random.default_rng(9).standard_normal(
                Z.shape))
            outs = [rr.make_sim_masked_state_mixer(r_topo, 3,
                                                   backend="xla-ref")(
                Zr, st_r, jnp.asarray(m))]
            outs += [tr.make_sim_masked_state_mixer(topo, 3,
                                                    backend=backend)(
                Zt, torch.as_tensor(np.array(st_r)), torch.as_tensor(m))
                for topo in (t_topo, t_dense)]
            return outs
        outs = [rr.make_sim_masked_mixer(r_topo, 3, backend="xla-ref")(
            Zr, jnp.asarray(m))]
        outs += [tr.make_sim_masked_mixer(topo, 3, backend=backend)(
            Zt, torch.as_tensor(m)) for topo in (t_topo, t_dense)]
        return outs
    outs = [rr.make_sim_mixer(r_topo, 3, backend="xla-ref")(Zr)]
    outs += [tr.make_sim_mixer(topo, 3, backend=backend)(Zt)
             for topo in (t_topo, t_dense)]
    return outs


def _flat(out):
    """An output, or an (iterate, state) pair, as a list of numpy arrays
    (a stochastic rule's round count dropped)."""
    if isinstance(out, tuple):
        return [np.asarray(o) for o in out if not isinstance(o, int)]
    return [np.asarray(out)]


@pytest.mark.parametrize("rule", RULES)
def test_rule_sparse_mixer_matches_reference(rule):
    rsw, tsw, Z = _setup()
    if rule == "neighbor":
        rg, tg = (m.erdos_renyi(24, 0.3, seed=0) for m in (rgraphs, tgraphs))
        r_topo = rcons.neighbor_average_matrix(rg)
        t_topo = tcons.neighbor_average_matrix(tg)
        assert isinstance(t_topo, tmixing.SparseWeights)
        _same_sw(t_topo, r_topo)
        t_dense = tcons.neighbor_average_matrix(
            torch.as_tensor(tg.adj, dtype=torch.float64))
    else:
        r_topo, t_topo = rsw, tsw
        t_dense = torch.as_tensor(tsw.to_dense())
    ref, sparse, dense = _mixers(rule, r_topo, t_topo, t_dense, Z)
    for a, b, c in zip(_flat(ref), _flat(sparse), _flat(dense)):
        np.testing.assert_allclose(b, a, err_msg=f"{rule} vs reference",
                                   **EXACT)
        np.testing.assert_allclose(b, c, err_msg=f"{rule} vs dense",
                                   **EXACT)


def test_masked_rules_under_full_mask_are_gossip():
    """An always-on mask leaves the sparse partial and stale rounds the
    sparse gossip rounds bit for bit (the fold multiplies by exact ones
    and adds exact zeros)."""
    _, tsw, Z = _setup()
    Zt = torch.as_tensor(Z)
    ones = torch.ones(tsw.n, dtype=torch.bool)
    gossip = tcons.stacked_sparse_product(Zt, tsw, 3)
    partial = tcons.get_rule("partial_gossip").make_sim_masked_mixer(tsw, 3)
    assert torch.equal(partial(Zt, ones), gossip)
    stale = tcons.get_rule("stale_gossip").make_sim_masked_state_mixer(
        tsw, 3)
    assert torch.equal(stale(Zt, torch.zeros_like(Zt), ones)[0], gossip)


def test_fused_gossip_hoists_the_power_within_its_budget():
    """On the fused backend the gossip mixer takes W^{T_con} in one round
    while the power's fill stays within budget (f32 round-off of the
    exact product), the per-round product past it and for float64."""
    _, tsw, Z = _setup()
    exact = tcons.stacked_product(torch.as_tensor(Z),
                                  torch.as_tensor(tsw.to_dense()), 5)
    rule = tcons.get_rule("gossip")
    mix = rule.make_sim_mixer(tsw, 5, backend="cuda")
    assert tcons._sparse_power(tsw, 5) is not None
    np.testing.assert_allclose(mix(torch.as_tensor(Z)).numpy(),
                               exact.numpy(), **EXACT)
    got32 = mix(torch.as_tensor(Z, dtype=torch.float32))
    np.testing.assert_allclose(got32.numpy(), exact.numpy(), rtol=0,
                               atol=1e-5)
    per_round = tcons.stacked_sparse_product(
        torch.as_tensor(Z, dtype=torch.float32), tsw, 5)
    assert not torch.equal(got32, per_round)     # the hoist was taken
    # past the budget (a BA hub's W^2 fills far beyond 8·nnz at L = 2000)
    big = tmixing.metropolis_weights_sparse(
        tgraphs.barabasi_albert(2000, m=3, seed=0))
    assert big.power(3) is None
    Zb = torch.as_tensor(np.random.default_rng(1).standard_normal((2000, 3)),
                         dtype=torch.float32)
    assert torch.equal(rule.make_sim_mixer(big, 3, backend="cuda")(Zb),
                       tcons.stacked_sparse_product(Zb, big, 3))


# ------------------------------------------------- policy and callers

def test_maybe_sparsify_policy():
    small = tmixing.metropolis_weights(tgraphs.erdos_renyi(32, 0.2, seed=0))
    for W in (small, torch.as_tensor(small)):
        assert tcons.maybe_sparsify(W) is W          # below the node cutoff
    L = tcons.SPARSE_MIN_NODES
    assert L == rcons.SPARSE_MIN_NODES and tcons.SPARSE_DENSITY_THRESHOLD \
        == rcons.SPARSE_DENSITY_THRESHOLD
    big = tmixing.metropolis_weights_sparse(
        tgraphs.erdos_renyi(L, p=0.01, seed=0)).to_dense()
    want = rcons.maybe_sparsify(jnp.asarray(big))
    for W in (big, torch.as_tensor(big)):
        got = tcons.maybe_sparsify(W)
        assert isinstance(got, tmixing.SparseWeights)
        _same_sw(got, want)
    dense = tmixing.metropolis_weights(tgraphs.complete(L))
    assert tcons.maybe_sparsify(dense) is dense      # above the density
    sw = tmixing.metropolis_weights_sparse(tgraphs.ring(16))
    assert tcons.maybe_sparsify(sw) is sw            # passes through
    assert tcons.maybe_sparsify(None) is None
    vec = torch.ones(L)
    assert tcons.maybe_sparsify(vec) is vec


def test_mesh_weights_densify_a_sparse_w():
    """The one-node-a-rank mesh takes a forced-sparse W at small L by
    densifying it, as the reference does."""
    rsw, tsw, _ = _setup()
    got = tcons.mesh_weights_from_matrix(tsw)
    want = rcons.mesh_weights_from_matrix(rsw)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    dense = tcons.mesh_weights_from_matrix(torch.as_tensor(tsw.to_dense()))
    np.testing.assert_array_equal(got[1], dense[1])


def test_spectral_init_on_the_sparse_tier():
    """The reference's L = 1024 init (tests/test_sparse.py): ER(1024,
    6/L, seed 5) Metropolis, d = 8, r = 2, n = 10; every AGREE on the
    sparse tier, from the dense W (auto) and from the SparseWeights."""
    L = 1024
    rsw = rmixing.metropolis_weights_sparse(rgraphs.erdos_renyi(
        L, p=6.0 / L, seed=5))
    W = rsw.to_dense()
    assert isinstance(rcons.maybe_sparsify(W), rmixing.SparseWeights)
    prob = generate_problem(jax.random.PRNGKey(0), d=8, T=L, r=2, n=10,
                            L=L, kappa=1.2)
    Xg, yg = node_view(prob)
    kw = dict(kappa=prob.kappa, mu=prob.mu, r=2, T_pm=3, T_con=2)
    key = jax.random.PRNGKey(1)
    ref = rspectral.decentralized_spectral_init(key, Xg, yg, W, **kw)
    start = torch.as_tensor(np.asarray(
        jax.random.normal(key, (8, 2), dtype=jnp.float64)))
    tsw = tmixing.metropolis_weights_sparse(tgraphs.erdos_renyi(
        L, p=6.0 / L, seed=5))
    for topo in (torch.as_tensor(W), tsw):
        got = tspectral.decentralized_spectral_init(
            None, torch.as_tensor(np.asarray(Xg)),
            torch.as_tensor(np.asarray(yg)), topo, U_init=start, **kw)
        for a, b, what in ((got.U0, ref.U0, "U0"),
                           (got.R_diag, ref.R_diag, "R_diag"),
                           (got.alpha, ref.alpha, "alpha")):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-10, err_msg=what)


# ------------------------------------------------------------- solvers

def _small_spec(name, representation, pkg=rapi):
    """tests/test_sparse.py's ``_small_spec``."""
    return pkg.ExperimentSpec(
        problem=pkg.ProblemSpec(d=16, T=48, r=2, n=12, L=24, kappa=1.2),
        topology=pkg.TopologySpec(family="erdos_renyi", p=0.3, seed=3,
                                  weights="metropolis",
                                  representation=representation),
        init=pkg.InitSpec(T_pm=4, T_con=2),
        solver=pkg.SolverSpec(name=name, T_GD=3, T_con=2))


def _sparse_arrays_of(mat):
    """The reference's sparse materialized state as host arrays: W by
    its SparseWeights fields, no dense W or adjacency."""
    W = mat.W
    assert isinstance(W, rmixing.SparseWeights)
    assert isinstance(mat.adj, rgraphs.SparseGraph)
    return {"Xg": np.asarray(mat.Xg), "yg": np.asarray(mat.yg),
            "W_rows": W.rows, "W_cols": W.cols, "W_vals": W.vals,
            "W_diag": W.diag, "n": W.n,
            "U0": np.asarray(mat.init.U0),
            "R_diag": np.asarray(mat.init.R_diag),
            "alpha": np.asarray(mat.init.alpha),
            "U_star": np.asarray(mat.problem.U_star),
            "B_star": np.asarray(mat.problem.B_star), "eta": mat.eta,
            "mu": mat.problem.mu, "sigma_max": mat.problem.sigma_max,
            "sigma_min": mat.problem.sigma_min}


@pytest.fixture(scope="module")
def ref_sparse_mat():
    mat = rapi.materialize(_small_spec("dif_altgdmin", "sparse"), key=0)
    port = tapi.materialized_from_arrays(_sparse_arrays_of(mat),
                                         device="cpu", dtype="float64")
    return mat, port


def _port_spec(spec):
    d = spec.to_dict()
    d["engine"]["backend"] = "torch-ref"
    return tapi.ExperimentSpec.from_dict(d)


@pytest.mark.parametrize("name", tapi.solver_names())
def test_solver_sparse_matches_reference(ref_sparse_mat, name):
    mat, port = ref_sparse_mat
    assert isinstance(port.W, tmixing.SparseWeights)
    assert isinstance(port.adj, tgraphs.SparseGraph)
    _same_sw(port.W, mat.W)
    np.testing.assert_array_equal(port.adj.indptr, mat.adj.indptr)
    np.testing.assert_array_equal(port.adj.col_idx, mat.adj.col_idx)
    spec = _small_spec(name, "sparse")
    ref = rapi.run_experiment(spec, materialized=mat)
    got = tapi.run_experiment(_port_spec(spec), materialized=port)
    tol = dict(rtol=0, atol=1e-8)
    for field in ("sd_max", "sd_mean", "spread"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field),
                                   err_msg=field, **tol)
    for field in ("U_nodes", "B_nodes"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   err_msg=field, **tol)
    np.testing.assert_array_equal(got.time_axis, ref.time_axis)


@pytest.mark.parametrize("name", tapi.solver_names())
def test_solver_sparse_equals_dense(name):
    """The port's own materializations: the sparse tier (W a
    SparseWeights, adj the SparseGraph) against the dense one."""
    td = tapi.run_experiment(_small_spec(name, "dense", tapi), 0,
                             device="cpu")
    ts = tapi.run_experiment(_small_spec(name, "sparse", tapi), 0,
                             device="cpu")
    assert torch.is_tensor(td.materialized.W)
    assert isinstance(ts.materialized.W, tmixing.SparseWeights)
    assert isinstance(ts.materialized.adj, tgraphs.SparseGraph)
    np.testing.assert_allclose(ts.U_nodes.numpy(), td.U_nodes.numpy(),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(ts.sd_max, td.sd_max, rtol=1e-7, atol=1e-9)


def test_representation_validation_and_sparse_weights_spec():
    with pytest.raises(ValueError):
        tapi.TopologySpec(representation="csr")
    t = tapi.TopologySpec(family="barabasi_albert", ba_m=2,
                          representation="sparse")
    assert t.use_sparse(24)
    assert not tapi.TopologySpec(representation="dense").use_sparse(10_000)
    for kw in (dict(weights="metropolis"), dict(weights="equal_neighbor"),
               dict(weights="lazy", beta=0.3),
               dict(family="circulant", weights="circulant",
                    shifts=(-2, 1, 3))):
        ts, rs = tapi.TopologySpec(**kw), rapi.TopologySpec(**kw)
        _same_sw(ts.build_sparse_weights(30), rs.build_sparse_weights(30))


# ------------------------------------------------------------ no densify

@pytest.mark.parametrize("name", ["dif_altgdmin", "dgd_altgdmin"])
def test_large_l_never_densifies(monkeypatch, name):
    """L = 10 000 on a Barabási–Albert graph (m = 3): materialize and run
    with every densify made to raise."""
    def refuse(*_a, **_k):
        raise AssertionError("the sparse tier densified")
    monkeypatch.setattr(tmixing.SparseWeights, "to_dense", refuse)
    monkeypatch.setattr(tgraphs.SparseGraph, "adj", property(refuse))
    L = 10_000
    spec = tapi.ExperimentSpec(
        problem=tapi.ProblemSpec(d=8, T=L, r=2, n=8, L=L, kappa=1.2),
        topology=tapi.TopologySpec(family="barabasi_albert", ba_m=3, seed=0,
                                   weights="metropolis"),
        init=tapi.InitSpec(T_pm=2, T_con=2),
        solver=tapi.SolverSpec(name=name, T_GD=2, T_con=2))
    assert spec.topology.use_sparse(L)              # auto takes the tier
    trace = tapi.run_experiment(spec, 0, device="cpu")
    assert isinstance(trace.materialized.W, tmixing.SparseWeights)
    assert trace.materialized.W.n_edges == trace.materialized.graph.n_edges
    assert trace.U_nodes.shape == (L, 8, 2) and trace.sd_max.shape == (2,)
    assert np.all(np.isfinite(trace.sd_max))
    assert np.all(np.isfinite(trace.U_nodes.numpy()))
