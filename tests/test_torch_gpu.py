"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same inputs, the dtype rules of the ops, and a
small end-to-end run through the kernels against the torch-ref backend.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one.  The file imports neither jax nor the JAX package, so it runs on
the machine with the card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the reference's cross-backend ones: rtol = atol = 1e-4 at
f32, 5e-2 at bf16; trajectories rtol 1e-4, atol 1e-5.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
# (L, tpn, n, d, r): Experiment 1, Experiment 2, ragged d and odd r,
# and the rank capacity's edge
SHAPES = [(20, 30, 30, 600, 4), (100, 1, 50, 100, 10), (3, 5, 20, 97, 3),
          (2, 2, 40, 33, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _instance(shape, dtype, seed=0):
    L, tpn, n, d, r = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((L, tpn, n, d), generator=g, device="cuda")
    U = torch.linalg.qr(torch.randn((L, d, r), generator=g,
                                    device="cuda"))[0]
    y = torch.randn((L, tpn, n), generator=g, device="cuda")
    return X.to(dtype), U.to(dtype), y.to(dtype)


def _close(got, want, tol):
    torch.testing.assert_close(got.double(), want.double(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_altgdmin_kernels_match_plain(cuda, shape, dtype):
    from repro_torch.kernels import altgdmin_ls, ref
    X, U, y = _instance(shape, dtype)
    B, tiles = altgdmin_ls.node_fused_iter(X, U, y)
    B_ref, tiles_ref = ref.ref_fused_iter(X, U, y)
    assert B.dtype == tiles.dtype == torch.float32
    _close(B, B_ref, TOL[dtype])
    _close(tiles, tiles_ref, TOL[dtype])
    G, c = altgdmin_ls.node_task_gram(X, U, y)
    G_ref, c_ref = ref.ref_task_gram(X, U, y)
    _close(G, G_ref, TOL[dtype])
    _close(c, c_ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,M", [(20, 2400), (100, 1000), (3, 291),
                                 (37, 129)])
def test_mix_rows_matches_plain(cuda, L, M, dtype):
    from repro_torch.kernels import gossip_axpy, ref
    g = torch.Generator(device="cuda").manual_seed(L)
    W = torch.rand((L, L), generator=g, device="cuda")
    W = W / W.sum(dim=1, keepdim=True)
    Z = torch.randn((L, M), generator=g, device="cuda").to(dtype)
    out = gossip_axpy.mix_rows(W, Z)
    assert out.dtype == dtype
    _close(out, ref.ref_mix_rows(W, Z), TOL[dtype])


def test_ops_cast_f64_like_the_reference(cuda):
    """f64 operands go through the f32 kernels and come back f32 (B,
    grad) or in Z's dtype (mix)."""
    from repro_torch.kernels import ops
    X, U, y = _instance(SHAPES[2], torch.float64)
    B, G = ops.altgdmin_fused_step(X, U, y)            # auto → cuda
    B_ref, G_ref = ops.altgdmin_fused_step(X, U, y, backend="torch-ref")
    _close(B, B_ref, TOL[torch.float32])
    _close(G, G_ref, TOL[torch.float32])
    _close(ops.altgdmin_node_minimize_B(X, U, y),
           ops.altgdmin_node_minimize_B(X, U, y, backend="torch-ref"),
           TOL[torch.float32])
    Z = U.reshape(U.shape[0], -1)
    W = torch.full((3, 3), 1 / 3, dtype=torch.float64, device="cuda")
    out = ops.mix_nodes(Z, W)
    assert out.dtype == torch.float64
    _close(out, ops.mix_nodes(Z, W, backend="torch-ref"), TOL[torch.float32])


def test_rank_above_capacity_raises(cuda):
    from repro_torch.kernels import altgdmin_ls
    X, U, y = _instance((2, 1, 20, 40, 17), torch.float32)
    with pytest.raises(ValueError, match="R_MAX"):
        altgdmin_ls.node_fused_iter(X, U, y)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_small_run_through_kernels_matches_torch_ref(cuda, dtype):
    """dif_altgdmin end to end on the card: the cuda backend launches the
    fused iteration and (f32 only) the mixing kernel once per iteration
    and the Gram kernel once, and its trajectory matches torch-ref."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, TopologySpec,
                                 materialize, run_experiment)
    from repro_torch.kernels import _build
    spec = ExperimentSpec(
        problem=ProblemSpec(d=60, T=60, r=3, n=25, L=6, kappa=1.5,
                            dtype=dtype),
        topology=TopologySpec(family="erdos_renyi", p=0.5, seed=3),
        init=InitSpec(T_pm=20, T_con=8),
        solver=SolverSpec(T_GD=150, T_con=3),
        engine=EngineSpec(backend="cuda"))
    mat = materialize(spec, key=1)
    _build.LAUNCHES.clear()
    got = run_experiment(spec, key=1, materialized=mat)
    launches = dict(_build.LAUNCHES)
    mixes = 150 if dtype == "float32" else 0     # f64 mixes stay exact
    assert launches.get("node_fused_iter") == 150
    assert launches.get("mix_rows", 0) == mixes
    assert launches.get("node_task_gram") == 1
    ref = run_experiment(dataclasses.replace(
        spec, engine=EngineSpec(backend="torch-ref")), key=1,
        materialized=mat)
    np.testing.assert_allclose(got.sd_max, ref.sd_max, rtol=1e-4, atol=1e-5)
    assert got.U_nodes.dtype == getattr(torch, dtype)
    assert got.final_sd_max < 1e-2 * got.sd_max[0]
