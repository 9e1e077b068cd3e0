"""The port's kernel ops (``repro_torch.kernels.ops``) against the JAX
package's (``repro.kernels.ops``) on the same numpy-made inputs, and the
port's backend dispatch rules.

On the CPU the port's ops run their plain versions (``torch-ref``); the
reference runs its Pallas kernels in interpret mode and its ``xla-ref``
oracle.  Tolerances are the reference's own cross-backend ones
(tests/test_altgdmin_engine.py): rtol = atol = 1e-4 at f32 and 5e-2 at
bf16.  Both packages compute these ops in f32 whatever the input dtype,
so f64 inputs are held to the f32 tolerance; the dtype-preserving engine
phases are held to 1e-10 at f64.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.engine import AltgdminEngine as RefEngine  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core.engine import (AltgdminEngine,  # noqa: E402
                                     default_engine_backend, resolve_engine)
from repro_torch.kernels import altgdmin_ls, gossip_axpy, ops  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
REF_BACKENDS = ("pallas-interpret", "xla-ref")

# (L, tpn, n, d, r): d a multiple of the reference's 32-wide block or
# ragged (the reference pads it, the port does not); tpn = 1 included.
CASES = [(3, 1, 20, 64, 3), (2, 3, 18, 97, 4), (2, 1, 30, 64, 10),
         (3, 2, 25, 97, 10)]


def _instance(L, tpn, n, d, r, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((L, tpn, n, d))
    U = np.stack([np.linalg.qr(rng.standard_normal((d, r)))[0]
                  for _ in range(L)])
    y = rng.standard_normal((L, tpn, n))
    return X, U, y


def _both(arrays, dtype):
    """The same arrays as jax arrays and CPU torch tensors of ``dtype``."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.as_tensor(a).to(td) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float64).numpy(),
                               np.asarray(want, np.float64), **tol)


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("backend", REF_BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_fused_step_matches_reference(case, dtype, backend):
    (jX, jU, jy), (X, U, y) = _both(_instance(*case), dtype)
    B_ref, G_ref = rops.altgdmin_fused_step(jX, jU, jy, blk_d=32,
                                            backend=backend)
    B, G = ops.altgdmin_fused_step(X, U, y)
    assert B.dtype == G.dtype == torch.float32
    _close(B, B_ref, TOL[dtype])
    _close(G, G_ref, TOL[dtype])


@pytest.mark.parametrize("backend", REF_BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_node_minimize_B_matches_reference(case, dtype, backend):
    (jX, jU, jy), (X, U, y) = _both(_instance(*case, seed=1), dtype)
    B_ref = rops.altgdmin_node_minimize_B(jX, jU, jy, blk_d=32,
                                          backend=backend)
    _close(ops.altgdmin_node_minimize_B(X, U, y), B_ref, TOL[dtype])


@pytest.mark.parametrize("backend", REF_BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,shape", [(5, (40, 3)), (20, (600, 4)),
                                     (7, (97, 10))])
def test_mix_nodes_matches_reference(L, shape, dtype, backend):
    rng = np.random.default_rng(2)
    W = rng.random((L, L))
    W = W / W.sum(axis=1, keepdims=True)
    (jZ,), (Z,) = _both([rng.standard_normal((L,) + shape)], dtype)
    out_ref = rops.mix_nodes(jZ, jnp.asarray(W, jnp.float32), blk_c=128,
                             backend=backend)
    out = ops.mix_nodes(Z, torch.as_tensor(W, dtype=torch.float32))
    assert out.dtype == Z.dtype and out.shape == Z.shape
    _close(out, out_ref, TOL[dtype])


def test_f64_inputs_compute_in_f32_like_the_reference():
    """f64 operands: both packages cast to f32 inside these ops."""
    X, U, y = _instance(2, 3, 18, 97, 4, seed=3)
    jargs = [jnp.asarray(a, jnp.float64) for a in (X, U, y)]
    targs = [torch.as_tensor(a) for a in (X, U, y)]
    B_ref, G_ref = rops.altgdmin_fused_step(*jargs, backend="xla-ref")
    B, G = ops.altgdmin_fused_step(*targs)
    _close(B, B_ref, TOL["float32"])
    _close(G, G_ref, TOL["float32"])
    _close(ops.altgdmin_node_minimize_B(*targs),
           rops.altgdmin_node_minimize_B(*jargs, backend="xla-ref"),
           TOL["float32"])


@pytest.mark.parametrize("case", CASES[:2])
def test_engine_phases_f64_match_xla_ref(case):
    """The torch-ref engine is dtype-preserving: at f64 its min-B and
    gradient match the reference's xla-ref engine to 1e-10."""
    X, U, y = _instance(*case, seed=4)
    jargs = [jnp.asarray(a, jnp.float64) for a in (X, U, y)]
    targs = [torch.as_tensor(a) for a in (X, U, y)]
    ref_eng, eng = RefEngine("xla-ref"), AltgdminEngine("torch-ref")
    B_ref, G_ref = ref_eng.min_grad(jargs[1], jargs[0], jargs[2], jargs[0],
                                    jargs[2], same_data=True)
    B, G = eng.min_grad(targs[1], targs[0], targs[2], targs[0], targs[2],
                        same_data=True)
    assert B.dtype == G.dtype == torch.float64
    _close(B, B_ref, dict(rtol=0, atol=1e-10))
    _close(G, G_ref, dict(rtol=0, atol=1e-10))
    _close(eng.minimize_B(targs[1], targs[0], targs[2]),
           ref_eng.minimize_B(jargs[1], jargs[0], jargs[2]),
           dict(rtol=0, atol=1e-10))


# ---------------------------------------------------------------- dispatch

def test_bad_backend_name_raises():
    X, U, y = (torch.as_tensor(a) for a in _instance(*CASES[0]))
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.altgdmin_fused_step(X, U, y, backend="pallas")
    with pytest.raises(ValueError):
        ops.resolve_backend("xla-ref")
    with pytest.raises(ValueError, match="unknown engine backend"):
        AltgdminEngine("pallas-interpret")


def test_cuda_backend_on_cpu_tensors_raises():
    X, U, y = (torch.as_tensor(a) for a in _instance(*CASES[0]))
    Z, W = torch.zeros(3, 8), torch.eye(3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.altgdmin_fused_step(X, U, y, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.altgdmin_node_minimize_B(X, U, y, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.mix_nodes(Z, W, backend="cuda")
    # the kernel wrappers themselves launch or raise: never a CPU fallback
    with pytest.raises(ValueError, match="CUDA device"):
        altgdmin_ls.node_fused_iter(X, U, y)
    with pytest.raises(ValueError, match="CUDA device"):
        altgdmin_ls.node_task_gram(X, U, y)
    with pytest.raises(ValueError, match="CUDA device"):
        gossip_axpy.mix_rows(W, Z)


def test_backend_resolution_order(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_TORCH_ENGINE_BACKEND", raising=False)
    # auto: the tensors' device decides
    assert ops.default_backend(torch.device("cpu")) == "torch-ref"
    assert ops.default_backend(torch.device("cuda")) == "cuda"
    assert AltgdminEngine(device="cpu").backend == "torch-ref"
    # env beats auto; the engine's own variable beats the kernel one
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "cuda")
    assert ops.default_backend("cpu") == "cuda"
    monkeypatch.setenv("REPRO_TORCH_ENGINE_BACKEND", "torch-ref")
    assert default_engine_backend("cpu") == "torch-ref"
    # a scope beats env; an explicit argument beats the scope
    with ops.backend_scope("torch-ref"):
        assert ops.default_backend("cuda") == "torch-ref"
        assert ops.resolve_backend("cuda", "cpu") == "cuda"
    assert ops.default_backend("cpu") == "cuda"
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "xla-ref")
    with pytest.raises(ValueError, match="REPRO_TORCH_KERNEL_BACKEND"):
        ops.default_backend("cpu")


def test_reference_env_vars_do_not_reach_the_port(monkeypatch):
    """A value left over for the JAX package must not break the port."""
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_TORCH_ENGINE_BACKEND", raising=False)
    monkeypatch.setenv("REPRO_ENGINE_BACKEND", "pallas-interpret")
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "pallas-interpret")
    assert AltgdminEngine(device="cpu").backend == "torch-ref"
    X, U, y = (torch.as_tensor(a) for a in _instance(*CASES[0]))
    B, G = ops.altgdmin_fused_step(X, U, y)
    assert torch.isfinite(G).all()


def test_resolve_engine_rejects_conflicts():
    eng = AltgdminEngine("torch-ref")
    assert resolve_engine(eng) is eng
    assert resolve_engine(eng, "torch-ref") is eng
    with pytest.raises(ValueError, match="conflicting"):
        resolve_engine(eng, "cuda")


def test_cuda_engine_has_no_sample_split_gradient_yet():
    X, U, y = (torch.as_tensor(a) for a in _instance(*CASES[0]))
    B = torch.zeros(X.shape[0], X.shape[1], U.shape[2], dtype=X.dtype)
    with pytest.raises(NotImplementedError, match="node_task_grad_tiles"):
        AltgdminEngine("cuda").grad_U(U, B, X, y)
