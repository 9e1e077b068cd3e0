"""The plain versions that hold the streaming Gram and the one-tile mixing
kernels on the card, against the JAX package's Pallas kernels run in
interpret mode on the same numpy-made inputs.

``ref.ref_task_gram`` / ``ref.ref_single_task_gram`` against
``node_task_gram`` / ``task_gram`` at the sample-split fold's n = 15, at
the largest rank capacity (r = 16) and at a ragged d = 97, and
``ref.ref_mix_rows`` against ``mix_rows`` at one node and at 100 nodes.
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the CUDA kernels
to these plain versions.  Tolerances are the reference's own cross-
backend ones (tests/test_altgdmin_engine.py): rtol = atol = 1e-4 at f32,
5e-2 at bf16.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import altgdmin_ls as rls  # noqa: E402
from repro.kernels import gossip_axpy as rga  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}

# (L, tpn, n, d, r): path A's fold (n = 15), rank capacity 16, ragged d,
# and the three together
GRAM_CASES = [(2, 3, 15, 64, 4), (2, 2, 20, 64, 16), (3, 2, 18, 97, 4),
              (2, 2, 15, 97, 16)]
# (T, n, d, r) of the single-basis Gram, likewise
SINGLE_CASES = [(3, 15, 64, 4), (4, 20, 64, 16), (3, 18, 97, 3)]


def _both(arrays, dtype):
    """The same arrays as jax arrays and CPU torch tensors of ``dtype``."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.as_tensor(a).to(td) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float64).numpy(),
                               np.asarray(want, np.float64), **tol)


def _gram_instance(L, tpn, n, d, r, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((L, tpn, n, d))
    U = np.stack([np.linalg.qr(rng.standard_normal((d, r)))[0]
                  for _ in range(L)])
    y = rng.standard_normal((L, tpn, n))
    return X, U, y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GRAM_CASES)
def test_node_task_gram_plain_matches_pallas_interpret(case, dtype):
    (jX, jU, jy), (X, U, y) = _both(_gram_instance(*case, seed=7), dtype)
    G_ref, c_ref = rls.node_task_gram(jX, jU, jy, blk_d=case[3],
                                      interpret=True)
    G, c = ref.ref_task_gram(X, U, y)
    assert G.dtype == c.dtype == torch.float32
    _close(G, G_ref, TOL[dtype])
    _close(c, c_ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SINGLE_CASES)
def test_single_task_gram_plain_matches_pallas_interpret(case, dtype):
    T, n, d, r = case
    X, U, y = (a[0] for a in _gram_instance(1, T, n, d, r, seed=8))
    (jX, jU, jy), (tX, tU, ty) = _both((X, U, y), dtype)
    G_ref, c_ref = rls.task_gram(jX, jU, jy, blk_d=d, interpret=True)
    G, c = ref.ref_single_task_gram(tX, tU, ty)
    _close(G, G_ref, TOL[dtype])
    _close(c, c_ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,M", [(1, 512), (100, 256)])
def test_mix_rows_plain_matches_pallas_interpret(L, M, dtype):
    rng = np.random.default_rng(L)
    W = rng.random((L, L))
    W = W / W.sum(axis=1, keepdims=True)
    (jZ,), (Z,) = _both([rng.standard_normal((L, M))], dtype)
    out_ref = rga.mix_rows(jnp.asarray(W, jnp.float32), jZ, blk_c=128,
                           interpret=True)
    out = ref.ref_mix_rows(torch.as_tensor(W, dtype=torch.float32), Z)
    assert out.dtype == Z.dtype and out.shape == (L, M)
    _close(out, out_ref, TOL[dtype])
