"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same inputs (``compress_topk`` and ``dequant``
bit for bit), the dtype rules of the ops, and small end-to-end runs
through the kernels (the dense, the sample-split and the compressed
paths, and a 2-rank gloo mesh) against the torch-ref backend or the
simulator, with their launch counts.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one.  The file imports neither jax nor the JAX package, so it runs on
the machine with the card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the reference's cross-backend ones: rtol = atol = 1e-4 at
f32, 5e-2 at bf16; trajectories rtol 1e-4, atol 1e-5; gossip_combine's
f32 rtol = atol = 1e-6 (the reference's kernel test).
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_tiles_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels import altgdmin_ls, ref
    X, U, y = _instance(shape, dtype, seed=1)
    B = torch.randn((shape[0], shape[1], shape[4]), device="cuda")
    tiles = altgdmin_ls.node_task_grad_tiles(X, U, B, y)
    assert tiles.dtype == torch.float32
    _close(tiles, ref.ref_node_grad_tiles(X, U, B, y), TOL[dtype])


# (N, d, r, k): the dif_topk path's shape, Experiment 2's, ragged
TOPK = [(20, 600, 4, 150), (100, 100, 10, 25), (3, 97, 3, 1), (3, 97, 3, 97)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d,r,k", TOPK)
def test_compress_topk_kernel_equals_plain(cuda, N, d, r, k, dtype):
    from repro_torch.kernels import compress, ref
    g = torch.Generator(device="cuda").manual_seed(d + k)
    M = torch.randn((N, d, r), generator=g, device="cuda").to(dtype)
    M[:, d // 2] = M[:, 0]                       # exact ties
    M[:, d - 1] = M[:, 0]
    vals, idx = compress.compress_topk(M, k)
    v_ref, i_ref = ref.ref_compress_topk(M, k)
    assert idx.dtype == torch.int32 and vals.dtype == dtype
    assert torch.equal(idx, i_ref)
    assert torch.equal(vals, v_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d,r", [(20, 600, 4), (100, 100, 10), (3, 97, 3)])
def test_dequant_kernel_equals_plain(cuda, N, d, r, dtype):
    from repro_torch.kernels import compress, ref
    g = torch.Generator(device="cuda").manual_seed(N)
    q = torch.randint(-127, 128, (N, d, r), generator=g, device="cuda",
                      dtype=torch.int8)
    scale = (torch.rand((N, 1, 1), generator=g, device="cuda")
             + 1e-3).to(dtype)
    out = compress.dequant(q, scale)
    assert out.dtype == dtype
    assert torch.equal(out, ref.ref_dequant(q, scale))


COMPRESSED = {"node_fused_iter": 40, "node_task_gram": 1,
              "node_task_grad_tiles": 0, "mix_rows": 120}


@pytest.mark.parametrize("name,kw,counts", [
    ("dif_altgdmin", {}, {"node_fused_iter": 0, "node_task_gram": 41,
                          "node_task_grad_tiles": 40, "mix_rows": 40}),
    ("dif_topk", {"compression_k": 15}, {**COMPRESSED, "compress_topk": 120,
                                         "dequant": 0}),
    ("dif_quantized", {"compression": "int8"}, {**COMPRESSED,
                                                "dequant": 120,
                                                "compress_topk": 0}),
    ("dif_event", {"event_threshold": 0.02}, COMPRESSED)])
def test_slice_paths_through_kernels_match_torch_ref(cuda, name, kw, counts):
    """The sample-split path (n_folds = 2) and the compressed trio end to
    end on the card: the launches per run, and the trajectory against
    torch-ref.  dif_topk and the int8 wire are held over their first 10
    iterations only: row selection and rounding to int8 are
    discontinuous, so once the f32 round-off of mix_rows (against the
    plain product's) flips one row or one rounding, the two runs part
    by a quantum; their final values stay within 10 %."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, TopologySpec,
                                 materialize, run_experiment)
    from repro_torch.kernels import _build
    spec = ExperimentSpec(
        problem=ProblemSpec(d=60, T=60, r=3, n=24, L=6, kappa=1.5,
                            dtype="float32",
                            n_folds=2 if name == "dif_altgdmin" else 0),
        topology=TopologySpec(family="erdos_renyi", p=0.5, seed=3),
        init=InitSpec(T_pm=20, T_con=8),
        solver=SolverSpec(name=name, T_GD=40, T_con=3, **kw),
        engine=EngineSpec(backend="cuda"))
    mat = materialize(spec, key=1)
    _build.LAUNCHES.clear()
    got = run_experiment(spec, key=1, materialized=mat)
    launches = dict(_build.LAUNCHES)
    for kernel, n in counts.items():
        assert launches.get(kernel, 0) == n, (kernel, launches)
    ref = run_experiment(dataclasses.replace(
        spec, engine=EngineSpec(backend="torch-ref")), key=1,
        materialized=mat)
    upto = 10 if name in ("dif_topk", "dif_quantized") else None
    np.testing.assert_allclose(got.sd_max[:upto], ref.sd_max[:upto],
                               rtol=1e-4, atol=1e-5)
    assert abs(got.final_sd_max - ref.final_sd_max) <= 0.1 * ref.final_sd_max
    assert np.all(np.isfinite(got.sd_max))
    assert got.final_sd_max < got.sd_max[0]


# (n, K): the mesh round at Experiment 1 (d·r = 2400; K = 2 on a ring,
# 19 at ER p = 0.5), the roll form's (L·d·r, ring), ragged n, tiny n
COMBINE = [(2400, 2), (2400, 19), (48000, 2), (2401, 19), (7, 1)]


@pytest.mark.parametrize("tensor_weights", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,K", COMBINE)
def test_gossip_combine_matches_plain(cuda, n, K, dtype, tensor_weights):
    from repro_torch.kernels import _build, ops, ref
    g = torch.Generator(device="cuda").manual_seed(n + K)
    z = torch.randn(n, generator=g, device="cuda").to(dtype)
    nbrs = torch.randn((K, n), generator=g, device="cuda").to(dtype)
    w = torch.rand(K + 1, generator=g, device="cuda")
    w = w / w.sum()
    weights = w if tensor_weights else tuple(w.tolist())
    _build.LAUNCHES.clear()
    out = ops.gossip_combine(z, nbrs, weights)          # auto → cuda
    assert _build.LAUNCHES["gossip_combine"] == 1
    assert out.dtype == dtype and out.shape == z.shape
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32
           else TOL[torch.bfloat16])
    _close(out, ref.ref_gossip_combine(z, nbrs, weights), tol)


def test_two_rank_gloo_mesh_through_the_kernels(cuda):
    """dif_altgdmin on a 2-rank gloo mesh on the card (staged through the
    host): T_con·T_GD gossip_combine launches per rank, and the sd_max
    trace of the port's simulator on the card."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, TopologySpec,
                                 materialize, run_experiment)
    from repro_torch.api.runner import run_on_mesh
    from repro_torch.distributed.mesh import spawn
    from repro_torch.kernels import _build
    _build.build()                  # the ranks load it, never race on nvcc
    spec = ExperimentSpec(
        problem=ProblemSpec(d=60, T=20, r=3, n=25, L=2, kappa=1.5,
                            dtype="float32"),
        topology=TopologySpec(family="complete"),
        init=InitSpec(T_pm=20, T_con=3),
        solver=SolverSpec(T_GD=40, T_con=3),
        engine=EngineSpec(backend="cuda"), substrate="mesh")
    ranks = spawn(run_on_mesh, 2, args=("cuda", [spec.to_dict()], 1),
                  backend="gloo", device="cuda", timeout=300)
    sim = run_experiment(dataclasses.replace(spec, substrate="simulator"),
                         key=1, materialized=materialize(spec, key=1))
    for (hw,) in ranks:
        assert hw["transport"] == "gloo, staged through host memory"
        assert hw["launches"]["gossip_combine"] == 3 * 40
        assert hw["launches"]["node_fused_iter"] == 40
        np.testing.assert_allclose(hw["sd_max"], sim.sd_max, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(hw["U_nodes"], ranks[0][0]["U_nodes"])
    assert ranks[0][0]["sd_max"][-1] < ranks[0][0]["sd_max"][0]
