"""The port's topologies and mixing weights are the JAX package's, bit
for bit: both are pure numpy on the same seeded streams, so every
generator must give the same CSR arrays and every dense weight builder
the same matrix."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.distributed import graphs as rg  # noqa: E402
from repro.distributed import mixing as rm  # noqa: E402
from repro_torch.distributed import graphs as tg  # noqa: E402
from repro_torch.distributed import mixing as tm  # noqa: E402


def _same_graph(a, b):
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.col_idx, b.col_idx)
    assert a.indptr.dtype == b.indptr.dtype
    assert a.col_idx.dtype == b.col_idx.dtype


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
@pytest.mark.parametrize("L,p", [(6, 0.5), (20, 0.5), (100, 0.2)])
def test_erdos_renyi_dense_draw_bitwise(L, p, seed):
    _same_graph(tg.erdos_renyi(L, p, seed=seed),
                rg.erdos_renyi(L, p, seed=seed))


@pytest.mark.parametrize("seed", [0, 3])
def test_erdos_renyi_above_dense_max_bitwise(seed):
    """Above ER_DENSE_MAX the G(L, M) edge-count sampler runs."""
    L = tg.ER_DENSE_MAX + 52
    assert tg.ER_DENSE_MAX == rg.ER_DENSE_MAX
    _same_graph(tg.erdos_renyi(L, 0.005, seed=seed),
                rg.erdos_renyi(L, 0.005, seed=seed))


def test_erdos_renyi_ring_overlay_fallback_bitwise():
    """Too sparse to connect within max_tries: the ring overlay."""
    a = tg.erdos_renyi(30, 0.01, seed=5, max_tries=3)
    b = rg.erdos_renyi(30, 0.01, seed=5, max_tries=3)
    _same_graph(a, b)
    assert a.is_connected()
    _same_graph(tg.erdos_renyi(30, 0.01, seed=5, ensure_connected=False),
                rg.erdos_renyi(30, 0.01, seed=5, ensure_connected=False))


@pytest.mark.parametrize("name,args", [
    ("ring", (9,)), ("ring", (1,)), ("path_graph", (7,)),
    ("torus2d", (3, 4)), ("hypercube", (4,)), ("complete", (6,)),
    ("star", (8,)), ("circulant", (10, (-2, 1, 3))),
    ("barabasi_albert", (40, 3, 4)), ("hierarchical", (30, 3)),
    ("cluster_of_cliques", (27, 5, 2)),
])
def test_generators_bitwise(name, args):
    a, b = getattr(tg, name)(*args), getattr(rg, name)(*args)
    _same_graph(a, b)
    assert a.n_edges == b.n_edges and a.max_degree == b.max_degree
    assert a.is_connected() == b.is_connected()
    assert np.array_equal(a.adj, b.adj)
    assert np.array_equal(tg.reverse_cuthill_mckee(a),
                          rg.reverse_cuthill_mckee(b))


@pytest.mark.parametrize("seed", [0, 1, 4])
@pytest.mark.parametrize("L", [6, 20, 100])
def test_dense_weight_builders_bitwise(L, seed):
    gt = tg.erdos_renyi(L, 0.4, seed=seed)
    gr = rg.erdos_renyi(L, 0.4, seed=seed)
    for name in ("metropolis_weights", "equal_neighbor_weights"):
        wt, wr = getattr(tm, name)(gt), getattr(rm, name)(gr)
        assert np.array_equal(wt, wr), name
    assert np.array_equal(tm.lazy_weights(gt, 0.3), rm.lazy_weights(gr, 0.3))
    w = tm.metropolis_weights(gt)
    assert tm.is_doubly_stochastic(w) and tm.gamma(w) == rm.gamma(w) < 1.0


@pytest.mark.parametrize("L,shifts,sw", [(8, (-1, 1), None),
                                         (9, (-2, 1, 3), 0.4),
                                         (4, (2, 2), None)])
def test_circulant_weights_bitwise(L, shifts, sw):
    assert np.array_equal(tm.circulant_weights(L, shifts, sw),
                          rm.circulant_weights(L, shifts, sw))
