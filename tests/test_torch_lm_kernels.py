"""The port's LM kernels' plain versions and ops against the JAX package,
on the CPU.

* ``ref.ref_attention`` and ``ops.flash_attention`` (torch-ref) against
  ``repro``'s ``ref.ref_attention`` and ``ops.flash_attention`` on
  ``pallas-interpret`` (blocks of 16), at tests/test_kernels.py's shapes
  and tolerances (rtol = atol = 2e-5 at f32, 2e-2 at bf16), sliding
  windows included.
* ``causal=False`` on a ragged key length, held against the JAX
  package's ``ref_attention`` (its Pallas route zero-pads the keys into
  the softmax there, a reference caveat the port does not copy), and
  rows that see no key (Sq > Skv): 0 in the port, the mean of V in the
  JAX package's plain version, equal everywhere else.
* ``ref.ref_ssd`` and ``ops.ssd_scan`` against ``repro``'s ``ref.ref_ssd``
  and ``ops.ssd_scan`` on ``pallas-interpret`` (rtol = atol = 1e-4 at
  f32, 5e-2 at bf16).
* ``backend="cuda"`` on CPU tensors raises, and so do the kernel
  wrappers themselves: on the CPU only the plain versions run.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = ("float32", "bfloat16")
# tests/test_kernels.py's flash shapes: (B, Sq, Skv, H, Hkv, D)
FLASH_SHAPES = [(1, 64, 64, 2, 2, 32), (2, 32, 32, 4, 1, 16),
                (1, 64, 64, 4, 2, 32), (1, 16, 48, 2, 2, 32),
                (1, 40, 40, 2, 2, 32)]
# and its SSD shapes: (B, S, H, P, N, chunk)
SSD_SHAPES = [(1, 32, 2, 16, 8, 8), (2, 48, 3, 8, 16, 16),
              (1, 20, 2, 16, 8, 8), (1, 64, 1, 32, 32, 64)]


def _cast(a, dtype):
    """A float32 numpy array rounded to ``dtype`` (numpy, for JAX) and the
    same values as a torch tensor."""
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return a, torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    a = a.astype(np.float32)
    return a, torch.from_numpy(a.copy())


def _np(t):
    return t.detach().float().numpy()


def _qkv(B, Sq, Skv, H, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [_cast(rng.standard_normal(s, dtype=np.float32), dtype)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _bhsd(a):
    return jnp.swapaxes(jnp.asarray(a), 1, 2)


# ---------------------------------------------------------------- flash

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D", FLASH_SHAPES)
def test_ref_attention_matches_jax_ref(B, Sq, Skv, H, Hkv, D, dtype):
    (qn, qt), (kn, kt), (vn, vt) = _qkv(B, Sq, Skv, H, Hkv, D, dtype)
    got = ref.ref_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                            vt.transpose(1, 2))
    want = rref.ref_attention(_bhsd(qn), _bhsd(kn), _bhsd(vn))
    assert got.dtype == qt.dtype
    _close(_np(got), want, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D", FLASH_SHAPES)
def test_flash_attention_op_matches_jax_pallas(B, Sq, Skv, H, Hkv, D, dtype):
    (qn, qt), (kn, kt), (vn, vt) = _qkv(B, Sq, Skv, H, Hkv, D, dtype, seed=1)
    got = ops.flash_attention(qt, kt, vt)
    want = rops.flash_attention(jnp.asarray(qn), jnp.asarray(kn),
                                jnp.asarray(vn), blk_q=16, blk_k=16,
                                backend="pallas-interpret")
    assert got.shape == qt.shape and got.dtype == qt.dtype
    _close(_np(got), want, FLASH_TOL[dtype])


@pytest.mark.parametrize("window", [8, 16, 33])
def test_flash_attention_sliding_window_matches_jax(window):
    (qn, qt), (kn, kt), (vn, vt) = _qkv(1, 64, 64, 2, 2, 32, "float32",
                                        seed=2)
    got = ops.flash_attention(qt, kt, vt, window=window)
    want = rops.flash_attention(jnp.asarray(qn), jnp.asarray(kn),
                                jnp.asarray(vn), window=window, blk_q=16,
                                blk_k=16, backend="pallas-interpret")
    _close(_np(got), want, FLASH_TOL["float32"])


@pytest.mark.parametrize("window", [None, 7])
def test_noncausal_ragged_keys_match_jax_ref(window):
    """causal=False with Skv = 40 (not a multiple of any block): exact
    against the JAX package's plain version, where its Pallas route
    zero-pads keys into the softmax (ROADMAP.md, Queue 3)."""
    (qn, qt), (kn, kt), (vn, vt) = _qkv(1, 40, 40, 2, 2, 32, "float32",
                                        seed=3)
    got = ops.flash_attention(qt, kt, vt, causal=False, window=window)
    want = rref.ref_attention(_bhsd(qn), _bhsd(kn), _bhsd(vn), causal=False,
                              window=window)
    _close(_np(got), jnp.swapaxes(want, 1, 2), FLASH_TOL["float32"])


def test_rows_that_see_no_key_are_zero():
    """Sq = 64 > Skv = 40: the first 24 query rows see no key.  The port
    gives them 0 (as its kernel does), the JAX package's plain version
    the mean of V; every other row agrees."""
    (qn, qt), (kn, kt), (vn, vt) = _qkv(1, 64, 40, 2, 1, 32, "float32",
                                        seed=4)
    got = _np(ops.flash_attention(qt, kt, vt))
    want = np.asarray(jnp.swapaxes(rref.ref_attention(
        _bhsd(qn), _bhsd(kn), _bhsd(vn)), 1, 2))
    assert np.all(got[:, :24] == 0.0)
    _close(want[:, :24], np.broadcast_to(vn.mean(axis=1, keepdims=True)
                                         .repeat(2, axis=2), (1, 24, 2, 32)),
           FLASH_TOL["float32"])
    _close(got[:, 24:], want[:, 24:], FLASH_TOL["float32"])


# ---------------------------------------------------------------- SSD

def _ssd_inputs(B, S, H, P, N, dtype, seed=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    x = _cast(f(B, S, H, P), dtype)
    dt = np.log1p(np.exp(f(B, S, H))) * np.float32(0.1)
    A = -np.exp(f(H) * np.float32(0.3))
    Bm, Cm = _cast(f(B, S, N), dtype), _cast(f(B, S, N), dtype)
    D = np.full((H,), 0.5, np.float32)
    return x, dt.astype(np.float32), A.astype(np.float32), Bm, Cm, D


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ref_ssd_matches_jax_ref(B, S, H, P, N, chunk, dtype):
    (xn, xt), dt, A, (Bn, Bt), (Cn, Ct), D = _ssd_inputs(B, S, H, P, N, dtype)
    y, h = ref.ref_ssd(xt, torch.from_numpy(dt), torch.from_numpy(A), Bt, Ct,
                       torch.from_numpy(D))
    y_ref, h_ref = rref.ref_ssd(jnp.asarray(xn), dt, A, jnp.asarray(Bn),
                                jnp.asarray(Cn), D)
    assert y.dtype == xt.dtype and h.dtype == torch.float32
    _close(_np(y), y_ref, SSD_TOL[dtype])
    _close(_np(h), h_ref, SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_op_matches_jax_pallas(B, S, H, P, N, chunk, dtype):
    (xn, xt), dt, A, (Bn, Bt), (Cn, Ct), D = _ssd_inputs(B, S, H, P, N, dtype,
                                                         seed=6)
    y, h = ops.ssd_scan(xt, torch.from_numpy(dt), torch.from_numpy(A), Bt, Ct,
                        torch.from_numpy(D), chunk=chunk)
    y_ref, h_ref = rops.ssd_scan(jnp.asarray(xn), jnp.asarray(dt),
                                 jnp.asarray(A), jnp.asarray(Bn),
                                 jnp.asarray(Cn), jnp.asarray(D), chunk=chunk,
                                 backend="pallas-interpret")
    assert y.shape == xt.shape and h.shape == (B, H, P, N)
    _close(_np(y), y_ref, SSD_TOL[dtype])
    _close(_np(h), h_ref, SSD_TOL[dtype])


# ---------------------------------------------------------------- routes

def _flash_args():
    return [t for _, t in _qkv(1, 8, 8, 2, 1, 16, "float32")]


def _ssd_args():
    (_, xt), dt, A, (_, Bt), (_, Ct), D = _ssd_inputs(1, 8, 2, 4, 4,
                                                      "float32")
    return [xt, torch.from_numpy(dt), torch.from_numpy(A), Bt, Ct,
            torch.from_numpy(D)]


@pytest.mark.parametrize("op,args", [(ops.flash_attention, _flash_args),
                                     (ops.ssd_scan, _ssd_args)])
def test_cuda_backend_on_cpu_tensors_raises(op, args):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        op(*args(), backend="cuda")
    with ops.backend_scope("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            op(*args())


@pytest.mark.parametrize("kernel,args", [(tfa.flash_attention, _flash_args),
                                         (tssd.ssd_scan, _ssd_args)])
def test_kernel_wrappers_reject_cpu_tensors(kernel, args):
    with pytest.raises(ValueError, match="needs .* on a CUDA device"):
        kernel(*args())
