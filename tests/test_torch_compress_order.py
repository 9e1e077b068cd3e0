"""The top-k row order of the port's plain version against the JAX
package's, on blocks whose norms hold NaN, +inf and ties, on the CPU.

``repro_torch.kernels.ref.ref_compress_topk`` (a stable descending sort,
the plain version the CUDA kernel equals bit for bit) is held to
``repro.kernels.ref.ref_compress_topk`` (``lax.top_k``): both put a NaN
norm above every number, +inf included, and equal norms, NaN among NaN,
in ascending row index.  The entries are small integers, so every norm
is exact in both packages whatever their order of summation; indices and
rows must be equal (NaN rows compare equal).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def _block(kind, N=3, d=24, r=3, seed=0):
    """An (N, d, r) integer-valued block with the pattern ``kind`` of
    ``ref.topk_special_block`` planted in it."""
    M = np.random.default_rng(seed).integers(-3, 4, (N, d, r)).astype(float)
    return ref.topk_special_block(torch.as_tensor(M), kind).numpy()


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("kind", ref.TOPK_SPECIAL_KINDS)
def test_topk_order_matches_lax_top_k(kind, dtype):
    M = _block(kind)
    d = M.shape[1]
    for k in (1, d // 2, d):
        v_ref, i_ref = jref.ref_compress_topk(
            jnp.asarray(M, getattr(jnp, dtype)), k)
        v, i = ref.ref_compress_topk(
            torch.as_tensor(M).to(getattr(torch, dtype)), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_array_equal(v.to(torch.float64).numpy(),
                                      np.asarray(v_ref, np.float64))


def test_nan_rows_come_first_in_index_order():
    """The worked case: norms [1, nan, 3, 3, nan, 0.5] order as rows
    [1, 4, 2, 3, 0, 5] in both packages."""
    norms = np.array([1, np.nan, 3, 3, np.nan, 0.5])
    M = np.sqrt(norms)[None, :, None]
    _, i_ref = jref.ref_compress_topk(jnp.asarray(M, jnp.float32), 6)
    _, i = ref.ref_compress_topk(torch.as_tensor(M, dtype=torch.float32), 6)
    assert i[0].tolist() == [1, 4, 2, 3, 0, 5]
    assert np.asarray(i_ref)[0].tolist() == [1, 4, 2, 3, 0, 5]
