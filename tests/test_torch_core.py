"""The port's core modules against the JAX package's on the same
numpy-made (or reference-made) inputs at float64: metrics, the
positive-diagonal QR, AGREE, the decentralized spectral init started
from the reference's own Gaussian draw, η; plus the problem generator's
invariants (the two packages draw different random numbers, so the
generator is held to its properties, not to the reference's values)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.agree import agree as r_agree  # noqa: E402
from repro.core.agree import agree_power as r_agree_power  # noqa: E402
from repro.core import metrics as rmet  # noqa: E402
from repro.core import spectral as rspec  # noqa: E402
from repro.core.altgdmin import resolve_eta as r_resolve_eta  # noqa: E402
from repro.distributed import erdos_renyi, metropolis_weights  # noqa: E402
from repro_torch.core import agree as tagree  # noqa: E402
from repro_torch.core import metrics as tmet  # noqa: E402
from repro_torch.core import spectral as tspec  # noqa: E402
from repro_torch.core.altgdmin import resolve_eta  # noqa: E402
from repro_torch.core.problem import (generate_problem,  # noqa: E402
                                      node_view, split_samples)

EXACT = dict(rtol=0, atol=1e-10)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=EXACT):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _orth(rng, *shape):
    return np.linalg.qr(rng.standard_normal(shape))[0]


# ---------------------------------------------------------------- metrics

def test_subspace_distances_match_reference():
    rng = np.random.default_rng(0)
    U_nodes, U_star = _orth(rng, 5, 40, 3), _orth(rng, 40, 3)
    sd = tmet.subspace_distance(_t(U_nodes), _t(U_star))
    for g in range(5):
        _close(sd[g], rmet.subspace_distance(U_nodes[g], U_star))
        _close(tmet.subspace_distance_F(_t(U_nodes[g]), _t(U_star)),
               rmet.subspace_distance_F(U_nodes[g], U_star))
    th, ts = rng.standard_normal((40, 6)), rng.standard_normal((40, 6))
    _close(tmet.task_error(_t(th), _t(ts)), rmet.task_error(th, ts))


@pytest.mark.parametrize("L", [7, tmet.SPREAD_EXACT_MAX + 3])
def test_consensus_spread_matches_reference(L):
    """Exact pairwise diameter below SPREAD_EXACT_MAX, radius above."""
    assert tmet.SPREAD_EXACT_MAX == rmet.SPREAD_EXACT_MAX
    U = np.random.default_rng(1).standard_normal((L, 4, 2))
    _close(tmet.consensus_spread(_t(U)), rmet.consensus_spread(U))


# ---------------------------------------------------------------- QR

def test_qr_pos_matches_reference_including_zero_diagonal():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((4, 30, 3))
    M[1, :, 1] = 0.0                      # R[1, 1, 1] = 0: sign counts as +1
    Q, R = tspec._qr_pos(_t(M))
    Qr, Rr = rspec._qr_pos(jnp.asarray(M))
    _close(Q, Qr, dict(rtol=0, atol=1e-12))
    _close(R, Rr, dict(rtol=0, atol=1e-12))
    d = torch.diagonal(R, dim1=-2, dim2=-1)
    assert bool((d >= 0).all())


# ---------------------------------------------------------------- AGREE

@pytest.mark.parametrize("T_con", [0, 1, 7])
def test_agree_matches_reference(T_con):
    W = metropolis_weights(erdos_renyi(9, 0.4, seed=3))
    Z = np.random.default_rng(3).standard_normal((9, 12, 3))
    _close(tagree.agree(_t(Z), _t(W), T_con),
           r_agree(jnp.asarray(Z), jnp.asarray(W), T_con),
           dict(rtol=0, atol=1e-12))
    if T_con:
        _close(tagree.agree_power(_t(Z), _t(W), T_con),
               r_agree_power(jnp.asarray(Z), jnp.asarray(W), T_con))


# ---------------------------------------------------------------- init

@pytest.mark.parametrize("broadcast", [True, False])
def test_spectral_init_matches_reference_from_its_gaussian_start(broadcast):
    """U0, R_diag and alpha agree to 1e-10 at f64 given the reference's
    common (d, r) start ``normal(fold_in(key, 1), (d, r))``."""
    L, tpn, n, d, r = 6, 4, 25, 60, 3
    rng = np.random.default_rng(4)
    U_star = _orth(rng, d, r)
    X = rng.standard_normal((L, tpn, n, d))
    b = rng.standard_normal((L, tpn, r))
    y = np.einsum("gtnd,dr,gtr->gtn", X, U_star, b)
    W = metropolis_weights(erdos_renyi(L, 0.5, seed=1))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    kw = dict(kappa=1.5, mu=1.2, r=r, T_pm=20, T_con=8, broadcast=broadcast)
    ref = rspec.decentralized_spectral_init(
        key, jnp.asarray(X), jnp.asarray(y), jnp.asarray(W), **kw)
    start = jax.random.normal(key, (d, r), dtype=jnp.float64)
    got = tspec.decentralized_spectral_init(
        None, _t(X), _t(y), _t(W), U_init=_t(start), **kw)
    _close(got.U0, ref.U0)
    _close(got.R_diag, ref.R_diag)
    _close(got.alpha, ref.alpha)
    eta = resolve_eta(None, n, R_diag=got.R_diag, L=L)
    assert abs(eta - r_resolve_eta(None, n, R_diag=ref.R_diag, L=L)) \
        <= 1e-10 * eta


# ---------------------------------------------------------------- problem

@pytest.fixture(scope="module")
def problem():
    return generate_problem(torch.Generator().manual_seed(0), d=50, T=24,
                            r=4, n=12, L=6, kappa=2.0)


def test_problem_generator_invariants(problem):
    p = problem
    assert (p.d, p.T, p.r, p.n, p.L) == (50, 24, 4, 12, 6)
    assert p.X.dtype == torch.float64
    _close(p.y, torch.einsum("tnd,dt->tn", p.X, p.Theta_star),
           dict(rtol=1e-9, atol=0))
    _close(p.U_star.T @ p.U_star, np.eye(4))
    sv = torch.linalg.svdvals(p.Theta_star).numpy()
    assert sv[3] > 1e-8 and sv[4] < 1e-8
    assert p.kappa == 2.0 and p.sigma_min == 1.0
    assert 1.0 <= p.mu < 4.0
    again = generate_problem(torch.Generator().manual_seed(0), d=50, T=24,
                             r=4, n=12, L=6, kappa=2.0)
    assert torch.equal(again.X, p.X)                 # seeded: reproducible


def test_problem_generator_requires_L_divides_T():
    with pytest.raises(ValueError, match=r"L \| T"):
        generate_problem(torch.Generator(), d=10, T=10, r=2, n=5, L=4)


def test_node_view_and_sample_split(problem):
    p = problem
    Xg, yg = node_view(p)
    assert Xg.shape == (6, 4, 12, 50) and yg.shape == (6, 4, 12)
    assert torch.equal(Xg.reshape(24, 12, 50), p.X)
    sp = split_samples(p, 3)
    assert sp.X.shape == (3, 24, 4, 50) and sp.y.shape == (3, 24, 4)
    assert torch.equal(sp.X.permute(1, 0, 2, 3).reshape(p.X.shape), p.X)
    Xf, yf = node_view(sp)
    assert Xf.shape == (3, 6, 4, 4, 50) and yf.shape == (3, 6, 4, 4)
    with pytest.raises(ValueError, match="must divide"):
        split_samples(p, 5)
