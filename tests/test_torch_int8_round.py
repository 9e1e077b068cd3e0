"""The int8 wire's round on the CPU: the port's plain version
``ref.ref_int8_round`` (what the ``int8_round`` kernel computes on the
card) against the JAX package's ``QuantizedGossipCombine.refresh``,
bit for bit, and the port's ``refresh`` on ``torch-ref`` against the
operations it ran before the round was lifted into ``ref.py``.

The inputs are made with numpy and hold a block of zeros (the scale
clamps to the dtype's ``tiny``), a block with a NaN and one with an inf
(scale and x̂' compared with NaN positions equal; q only on the nodes
whose scale is finite, since the int8 value of a NaN quotient is the
platform's), and a block whose entries land exactly on .5 of a quantum
(half to even).  The stochastic wire draws its dither with the port's
counter-based hash, not ``jax.random``, so it is held to the numpy
formula ``floor(delta / scale + u)`` given one dither instead.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import get_rule as ref_get_rule  # noqa: E402
from repro_torch.distributed import consensus  # noqa: E402
from repro_torch.kernels import compress, ops, ref  # noqa: E402

DTYPES = ["float32", "float64", "bfloat16"]
WIRES = ["int8", "int8_stochastic"]
N, D, R = 7, 20, 3
ZEROS, NAN, INF, HALVES = 1, 2, 3, 4        # the special nodes


def _blocks(seed=0):
    """(Z, xhat) as float64 numpy arrays (N, D, R): random nodes, a
    zero delta, a NaN, an inf, and a node of half quanta (scale 1/8:
    the max entry is 127/8, the others (k + 1/2)/8, exact in bf16)."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((N, D, R)) * np.array([1, 1, 1, 1, 1, 1e3,
                                                   1e-3])[:, None, None]
    xhat = rng.standard_normal((N, D, R)) * 0.5
    xhat[ZEROS] = Z[ZEROS]
    Z[NAN, 3, 1] = np.nan
    Z[INF, 5, 0] = np.inf
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, -126.5,
                       3.5, 64.5])
    xhat[HALVES] = 0.0
    Z[HALVES] = rng.integers(-100, 100, (D, R)) / 8.0
    Z[HALVES].flat[:halves.size] = halves / 8.0
    Z[HALVES, D - 1, R - 1] = 127 / 8.0
    return Z, xhat


def _to_torch(a, dtype):
    return torch.as_tensor(a).to(getattr(torch, dtype))


def _to_numpy(t):
    """A torch tensor as numpy, bf16 as ml_dtypes' bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same(got, want):
    """Equal bit for bit, NaN positions equal (any NaN payload)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want.astype(np.float64))
    np.testing.assert_array_equal(np.isnan(got.astype(np.float64)), nan)
    bits = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[got.dtype.itemsize]
    np.testing.assert_array_equal(got.view(bits)[~nan], want.view(bits)[~nan])


def _finite_nodes(scale):
    return np.isfinite(np.asarray(scale, np.float64)).reshape(-1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_round_equals_jax_refresh(dtype):
    """ref_int8_round ≡ the JAX package's refresh for compression="int8"
    on xla-ref: q, scale and x̂' bit for bit."""
    Z, xhat = _blocks()
    q, scale, xn = ref.ref_int8_round(_to_torch(Z, dtype),
                                      _to_torch(xhat, dtype))
    rule = ref_get_rule("quantized_gossip")
    jZ, jx = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (Z, xhat))
    (jq, jscale), jxn = rule.refresh(jZ, jx, jnp.arange(N), 0,
                                     backend="xla-ref", wire="int8")
    _same(_to_numpy(scale), np.asarray(jscale))
    _same(_to_numpy(xn), np.asarray(jxn))
    fin = _finite_nodes(_to_numpy(scale))
    assert not fin[NAN] and not fin[INF] and fin.sum() == N - 2
    np.testing.assert_array_equal(q.numpy()[fin], np.asarray(jq)[fin])
    # the zero block clamps its scale to tiny and sends zeros; the half
    # quanta round to even
    assert float(scale[ZEROS]) == torch.finfo(getattr(torch, dtype)).tiny
    assert not q[ZEROS].any() and torch.equal(xn[ZEROS], _to_torch(
        xhat, dtype)[ZEROS])
    assert float(scale[HALVES]) == 1 / 8
    np.testing.assert_array_equal(
        q[HALVES].flatten()[:10].numpy(),
        [0, 2, 2, 0, -2, -2, 126, -126, 4, 64])


@pytest.mark.parametrize("dtype", DTYPES)
def test_stochastic_round_equals_numpy_formula(dtype):
    """Given one dither u, the stochastic wire's q is floor(delta / scale
    + u) clamped to ±127, every operation rounded to the dtype as numpy
    (ml_dtypes for bf16) rounds it, and x̂' = x̂ + q · scale."""
    Z, xhat = _blocks(1)
    u = np.random.default_rng(2).random((N, D, R))
    tZ, tx, tu = (_to_torch(a, dtype) for a in (Z, xhat, u))
    q, scale, xn = ref.ref_int8_round(tZ, tx, tu)
    npdt = np.dtype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    nZ, nx, nu = (_to_numpy(t) for t in (tZ, tx, tu))
    delta = (nZ - nx).astype(npdt)
    with np.errstate(invalid="ignore"):
        s = (np.max(np.abs(delta), axis=(1, 2), keepdims=True)
             / npdt.type(127)).astype(npdt)
        s = np.where(np.isnan(s), s, np.maximum(s, torch.finfo(getattr(torch, dtype)).tiny))
        s = s.astype(npdt)
        qf = np.floor((delta / s).astype(npdt) + nu).astype(npdt)
        qf = np.clip(qf.astype(np.float64), -127, 127)
        want = (nx + (q.numpy().astype(npdt) * s).astype(npdt)).astype(npdt)
    _same(_to_numpy(scale), s)
    fin = _finite_nodes(s)
    np.testing.assert_array_equal(q.numpy()[fin],
                                  qf[fin].astype(np.int8))
    _same(_to_numpy(xn)[fin], want[fin])
    assert np.isnan(_to_numpy(xn)[~fin].astype(np.float64)).all()


def _refresh_before_the_lift(Z, xhat, node_ids, count, wire):
    """The int8 branch of QuantizedGossipCombine.refresh on torch-ref as
    it read before its round moved into ref.py."""
    delta = Z - xhat
    scale = torch.amax(torch.abs(delta), dim=(-2, -1), keepdim=True) / 127.0
    scale = torch.clamp(scale, min=torch.finfo(delta.dtype).tiny)
    if wire == "int8_stochastic":
        u = consensus.stochastic_dither(count, node_ids, Z.shape[1:],
                                        Z.dtype)
        qf = torch.floor(delta / scale + u)
    else:
        qf = torch.round(delta / scale)
    q = torch.clamp(qf, -127, 127).to(torch.int8)
    return (q, scale), xhat + q.to(scale.dtype) * scale


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_refresh_on_torch_ref_is_unchanged_by_the_lift(dtype, wire):
    Z, xhat = _blocks(3)
    tZ, tx = _to_torch(Z, dtype), _to_torch(xhat, dtype)
    ids = torch.arange(N)
    rule = consensus.get_rule("quantized_gossip")
    for count in (0, 5):
        (q, scale), xn = rule.refresh(tZ, tx, ids, count,
                                      backend="torch-ref", wire=wire)
        (q0, scale0), xn0 = _refresh_before_the_lift(tZ, tx, ids, count,
                                                     wire)
        assert torch.equal(q, q0)
        _same(_to_numpy(scale), _to_numpy(scale0))
        _same(_to_numpy(xn), _to_numpy(xn0))


@pytest.mark.parametrize("wire", WIRES)
def test_ops_int8_round_routes_cpu_tensors_to_the_plain_version(wire):
    Z, xhat = (_to_torch(a, "float32") for a in _blocks(4))
    u = torch.rand(Z.shape) if wire == "int8_stochastic" else None
    got = ops.int8_round(Z, xhat, u)                  # auto → torch-ref
    want = ref.ref_int8_round(Z, xhat, u)
    for g, w in zip(got, want):
        _same(_to_numpy(g), _to_numpy(w))
    with pytest.raises(ValueError, match="CUDA"):
        ops.int8_round(Z, xhat, u, backend="cuda")


def test_int8_round_kernel_wrapper_needs_the_card():
    Z = torch.zeros((2, 8, 2))
    with pytest.raises(ValueError, match="CUDA device"):
        compress.int8_round(Z, Z)
