"""``repro_torch.distributed``'s public names against ``repro.distributed``
(every name, with ``mesh_gossip`` in place of ``shard_map_gossip``),
``rule_names``, ``ring_weights`` and ``torus_shifts`` equal to the
reference's, and the two mesh helpers on a 4-rank gloo group: AGREE by
``mesh_gossip`` (the uniform ring and a given W) equal to the dense
product W^T_con Z at f64 and to ``roll_gossip``, and ``axis_mean`` the
node mean.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.distributed as rdist  # noqa: E402
import repro_torch.distributed as tdist  # noqa: E402
from repro_torch.distributed import mixing  # noqa: E402
from repro_torch.distributed.mesh import NodeMesh, spawn  # noqa: E402

L, T_CON = 4, 3
TOL = dict(rtol=1e-12, atol=1e-12)


def test_exports_cover_the_reference():
    want = {n for n, v in vars(rdist).items()
            if not n.startswith("_") and not inspect.ismodule(v)}
    got = {n for n, v in vars(tdist).items()
           if not n.startswith("_") and not inspect.ismodule(v)}
    assert "shard_map_gossip" in want and "shard_map_gossip" not in got
    assert (want - {"shard_map_gossip"}) | {"mesh_gossip"} <= got


def test_rule_names_equal_reference():
    """The built-in rules are the reference's; other test modules of the
    same process may have registered planted rules beside them."""
    names = tdist.rule_names()
    assert names == tuple(sorted(tdist.COMBINE_RULES))
    assert set(rdist.rule_names()) <= set(names)
    assert {n for n in names if not n.startswith("planted")} == \
        set(rdist.rule_names())


@pytest.mark.parametrize("shifts,sw", [((-1, 1), None), ((-1, 1), 0.5),
                                       ((-1, 1, -3, 3), None), ((2,), 0.25)])
def test_ring_weights_equal_reference(shifts, sw):
    assert tdist.ring_weights(shifts, sw) == rdist.ring_weights(shifts, sw)


def test_torus_shifts_equal_reference():
    for rows, cols in ((2, 2), (4, 8), (3, 5)):
        assert tdist.torus_shifts(rows, cols) == \
            rdist.torus_shifts(rows, cols)


def _blocks():
    g = np.random.default_rng(0)
    return g.standard_normal((L, 6, 3))


def _ring_w():
    return mixing.metropolis_weights(tdist.ring(L))


def mesh_helpers_rank():
    """One rank's mesh_gossip (ring, then W) and axis_mean of its block."""
    mesh = NodeMesh("cpu")
    z = torch.as_tensor(_blocks()[mesh.rank])
    ring = tdist.mesh_gossip(z, mesh, T_CON)
    w = tdist.mesh_gossip(z, mesh, T_CON, W=torch.as_tensor(_ring_w()))
    mean = tdist.axis_mean({"z": z, "pair": [z, 2 * z]}, mesh)
    return (ring.numpy(), w.numpy(), mean["z"].numpy(),
            mean["pair"][1].numpy())


@pytest.fixture(scope="module")
def mesh_out():
    return spawn(mesh_helpers_rank, L, backend="gloo", timeout=120)


def test_mesh_gossip_equals_dense_product(mesh_out):
    Z = _blocks()
    W = mixing.circulant_weights(L, (-1, 1))          # the uniform ring
    want = np.einsum("gh,hij->gij", np.linalg.matrix_power(W, T_CON), Z)
    got = np.stack([r[0] for r in mesh_out])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, tdist.roll_gossip(torch.as_tensor(Z), T_CON).numpy(), **TOL)
    Wm = _ring_w()
    want = np.einsum("gh,hij->gij", np.linalg.matrix_power(Wm, T_CON), Z)
    np.testing.assert_allclose(np.stack([r[1] for r in mesh_out]), want,
                               **TOL)


def test_axis_mean_is_the_node_mean(mesh_out):
    Z = _blocks()
    for r in mesh_out:
        np.testing.assert_allclose(r[2], Z.mean(0), **TOL)
        np.testing.assert_allclose(r[3], 2 * Z.mean(0), **TOL)
