"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same inputs (``compress_topk``, ``dequant`` and
``gossip_combine`` bit for bit), the dtype rules of the ops, and small
end-to-end runs through the kernels (the dense, the sample-split and the
compressed paths, the masked trio under dropout, and 2-rank gloo meshes)
against the torch-ref backend or the simulator, with their launch
counts; the single-basis kernels and the
serving side (``ServingEngine`` against torch-ref, slot and bucket
padding bit for bit, checkpoints of CUDA tensors, a segmented run).

Every test here needs a CUDA device (marker ``gpu``) and skips without
one.  The file imports neither jax nor the JAX package, so it runs on
the machine with the card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the reference's cross-backend ones: rtol = atol = 1e-4 at
f32, 5e-2 at bf16; trajectories rtol 1e-4, atol 1e-5; gossip_combine
bit for bit (its plain version's products and sums in the same order).
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


def _grad_oracle(X, U, B, y):
    """ref_node_grad_tiles' formula in f64 on the same inputs: the
    oracle that judges the gradient kernel and its f32 plain version."""
    Xd, Bd = X.double(), B.double()
    resid = ((Xd @ U.double()[:, None]) @ Bd[..., None])[..., 0] - y.double()
    return (Xd.mT @ resid[..., None]) * Bd[:, :, None, :]


def _b_draw(shape, seed):
    """A seeded B for the gradient kernel's tests."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((shape[0], shape[1], shape[4]), generator=g,
                       device="cuda")


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


# past the resident fused kernel's shared-memory budget (half of X_t's
# columns in 227 KB a CTA) at each dtype: X_t of 200 x 600 in f32 (243 KB
# a half), 400 x 600 in bf16 (243 KB), where the two-pass kernel runs
FUSED_PAST_BUDGET = {torch.float32: (2, 2, 200, 600, 4),
                     torch.bfloat16: (2, 2, 400, 600, 4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_iter_resident_and_two_pass_kernels_match_plain(cuda, dtype):
    """Every shape through the kernel that holds X_t in shared memory,
    on one and on two CTAs a task (forced; SHAPES' test takes the
    kernel's pick), a task past its budget through the two-pass kernel,
    each within TOL of the plain version; the kernel launched is the one
    the C entry reports."""
    from repro_torch.kernels import _build, altgdmin_ls, ref
    cases = [(shape, ctas, "fused_resident_kernel") for shape in SHAPES
             for ctas in (1, 2)]
    for shape, ctas, kernel in cases + [
            (FUSED_PAST_BUDGET[dtype], None, "fused_iter_kernel")]:
        X, U, y = _instance(shape, dtype, seed=3)
        _build.KERNEL_LAUNCHES.clear()
        B, tiles = altgdmin_ls.node_fused_iter(X, U, y, ctas_per_task=ctas)
        assert dict(_build.KERNEL_LAUNCHES) == {kernel: 1}
        B_ref, tiles_ref = ref.ref_fused_iter(X, U, y)
        _close(B, B_ref, TOL[dtype])
        _close(tiles, tiles_ref, TOL[dtype])


# gossip_mix_rows' kernels: a tile of Z and 32 rows of W in shared memory
# (L up to about 500 in f32), or the h-tiled loop past that
MIX_TILE, MIX_HTILED = "mix_tile_kernel", "mix_rows_kernel"


def _mix_operands(L, M, dtype):
    g = torch.Generator(device="cuda").manual_seed(L)
    W = torch.rand((L, L), generator=g, device="cuda")
    W = W / W.sum(dim=1, keepdim=True)
    return W, torch.randn((L, M), generator=g, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,M,kernel", [
    (20, 2400, MIX_TILE), (20, 1, MIX_TILE), (100, 1000, MIX_TILE),
    (3, 291, MIX_TILE),
    (37, 129, MIX_TILE), (1, 2400, MIX_TILE), (20, 2398, MIX_TILE),
    (300, 2400, MIX_TILE), (300, 129, MIX_TILE), (700, 600, MIX_HTILED),
    (700, 129, MIX_HTILED)])
def test_mix_rows_matches_plain(cuda, L, M, kernel, dtype):
    """One node to past the one-tile kernel's shared memory, M a multiple
    of 16 columns or not, rows 16-byte aligned or not (M = 2398: its
    element-by-element path), push-sum's (L, 1) weight column, each
    through the kernel the C entry reports."""
    from repro_torch.kernels import _build, gossip_axpy, ref
    W, Z = _mix_operands(L, M, dtype)
    _build.KERNEL_LAUNCHES.clear()
    out = gossip_axpy.mix_rows(W, Z)
    assert dict(_build.KERNEL_LAUNCHES) == {kernel: 1}
    assert out.dtype == dtype
    _close(out, ref.ref_mix_rows(W, Z), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mix_rows_column_slice_and_unaligned_base(cuda, dtype):
    """Z as a column slice of a wider array (copied to a contiguous one),
    and as a contiguous view one element past an aligned base (the
    one-tile kernel's element-by-element path)."""
    from repro_torch.kernels import gossip_axpy, ref
    W, wide = _mix_operands(20, 2401, dtype)
    sliced = wide[:, 1:]
    flat = torch.randn(20 * 2400 + 1, device="cuda").to(dtype)
    shifted = flat[1:].view(20, 2400)
    assert shifted.data_ptr() % 16 != 0
    for Z in (sliced, shifted):
        out = gossip_axpy.mix_rows(W, Z)
        assert out.shape == (20, 2400) and out.dtype == dtype
        _close(out, ref.ref_mix_rows(W, Z), TOL[dtype])


# node_task_gram's shapes beyond SHAPES, with the form of
# stream_gram_kernel each launches (U_g's rows in shared memory, or read
# through L1 past the shared-memory budget): path A's fold of Experiment
# 1, tasks past the resident fused kernel's budget (two chunks of A's
# rows), n past 1500 in chunks of 256 rows with a ragged end, ragged d
# in chunks, and d r past the budget on a grid of 132 tasks
GRAM_STAGED, GRAM_L1 = "stream_gram_kernel", "stream_gram_kernel/u_from_l1"
GRAM_SHAPES = [(s, {torch.float32: GRAM_STAGED, torch.bfloat16: GRAM_STAGED})
               for s in SHAPES + [(20, 30, 15, 600, 4), (2, 2, 400, 600, 4),
                                  (2, 4, 1999, 64, 4), (1, 8, 1030, 97, 8)]]
GRAM_SHAPES += [((4, 33, 16, 4096, 16),
                 {torch.float32: GRAM_L1, torch.bfloat16: GRAM_STAGED}),
                ((1, 132, 16, 8192, 16),
                 {torch.float32: GRAM_L1, torch.bfloat16: GRAM_L1})]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kernel", GRAM_SHAPES)
def test_gram_kernel_matches_plain(cuda, shape, kernel, dtype):
    """The streaming Gram kernel within TOL of the plain version, through
    the form the C entry reports, at any n and d."""
    from repro_torch.kernels import _build, altgdmin_ls, ref
    X, U, y = _instance(shape, dtype, seed=4)
    _build.KERNEL_LAUNCHES.clear()
    G, c = altgdmin_ls.node_task_gram(X, U, y)
    assert dict(_build.KERNEL_LAUNCHES) == {kernel[dtype]: 1}
    G_ref, c_ref = ref.ref_task_gram(X, U, y)
    _close(G, G_ref, TOL[dtype])
    _close(c, c_ref, TOL[dtype])


@pytest.mark.parametrize("shape", [(32, 16, 600, 4), (4, 16, 4096, 16)])
def test_gram_kernel_repeats_bit_for_bit(cuda, shape):
    """Fifty launches give one result, in either form: no launch reads a
    ring slot before its copy lands or after its refill."""
    from repro_torch.kernels import altgdmin_ls
    X, U, y = _single(shape, torch.float32, seed=7)
    G0, c0 = altgdmin_ls.task_gram(X, U, y)
    runs = [altgdmin_ls.task_gram(X, U, y) for _ in range(50)]
    assert all(torch.equal(G, G0) and torch.equal(c, c0) for G, c in runs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernel_ignores_zero_rows_and_other_tasks(cuda, dtype):
    """Zero rows appended to every task and dummy tasks appended to the
    launch (the serving engine's padding) leave the real tasks' G and c
    bit for bit as they are, though they change the kernel's warps (eight
    for two tasks, four for 270) and so its chunks of A's rows (256 and
    141 rows, 256 and 144)."""
    from repro_torch.kernels import _build, altgdmin_ls
    X, U, y = _single((2, 397, 600, 4), dtype, seed=6)
    _build.KERNEL_LAUNCHES.clear()
    G, c = altgdmin_ls.task_gram(X, U, y)
    Xp = torch.zeros((270, 400, 600), dtype=dtype, device="cuda")
    yp = torch.zeros((270, 400), dtype=dtype, device="cuda")
    Xp[:2, :397], yp[:2, :397] = X, y
    Gp, cp = altgdmin_ls.task_gram(Xp, U, yp)
    assert dict(_build.KERNEL_LAUNCHES) == {GRAM_STAGED: 2}
    assert torch.equal(Gp[:2], G) and torch.equal(cp[:2], c)


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


# (L, tpn, n, d, r) of the gradient kernel's forms: path A's fold of
# Experiment 1, the serving cohort (one node of 64 tasks), d = 97 (element
# by element), r = 8 and 16, and n past the resident form's shared memory
# at each dtype (FUSED_PAST_BUDGET's tasks, X_t's share 200 or 400 x 320
# columns; and n = 400 at both), which runs the two-pass kernel.  The
# third field: whether the f32 plain version is close enough to the f64
# oracle to judge the kernel.  At n = 400 it is not: over 32 seeded
# draws on an H100 its error reached 3.1e-4, the kernel's 8.7e-5, so
# that case is held against the oracle alone (python3 chip_smoke.py
# --grad-oracle).
GRAD_RESIDENT, GRAD_TWO_PASS = "fused_resident_kernel/grad", "grad_tiles_kernel"
GRAD_N400 = {torch.float32: (2, 2, 400, 600, 4),
             torch.bfloat16: (2, 2, 400, 600, 4)}
GRAD_FORMS = [((20, 30, 15, 600, 4), GRAD_RESIDENT, True),
              ((1, 64, 16, 600, 4), GRAD_RESIDENT, True),
              ((3, 5, 20, 97, 3), GRAD_RESIDENT, True),
              ((2, 3, 20, 100, 8), GRAD_RESIDENT, True),
              ((2, 3, 16, 600, 16), GRAD_RESIDENT, True),
              (FUSED_PAST_BUDGET, GRAD_TWO_PASS, True),
              (GRAD_N400, GRAD_TWO_PASS, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kernel,vs_plain", GRAD_FORMS)
def test_grad_tiles_forms_match_plain(cuda, shape, kernel, vs_plain, dtype):
    """node_task_grad_tiles within TOL of the f64 oracle, and of
    ref_node_grad_tiles where that is close enough to judge it, through
    the form the C entry reports; the resident form gives the same bits
    on one and on two CTAs a task."""
    from repro_torch.kernels import _build, altgdmin_ls, ref
    if isinstance(shape, dict):
        shape = shape[dtype]
    X, U, y = _instance(shape, dtype, seed=5)
    B = _b_draw(shape, seed=5)
    _build.KERNEL_LAUNCHES.clear()
    tiles = altgdmin_ls.node_task_grad_tiles(X, U, B, y)
    assert dict(_build.KERNEL_LAUNCHES) == {kernel: 1}
    _close(tiles, _grad_oracle(X, U, B, y), TOL[dtype])
    if vs_plain:
        _close(tiles, ref.ref_node_grad_tiles(X, U, B, y), TOL[dtype])
    if kernel == GRAD_RESIDENT:
        one, two = (altgdmin_ls.node_task_grad_tiles(X, U, B, y,
                                                     ctas_per_task=c)
                    for c in (1, 2))
        assert torch.equal(one, tiles) and torch.equal(two, tiles)


def test_task_grad_tiles_repeats_and_ignores_added_tasks(cuda):
    """Fifty launches of task_grad_tiles at the serving batch give one
    result, and the same tasks launched beside 150 zero tasks (which
    turns the launch from two CTAs a task to one) give the same bits."""
    from repro_torch.kernels import altgdmin_ls
    X, U, y = _single((32, 16, 600, 4), torch.float32, seed=8)
    B = torch.randn((32, 4), device="cuda")
    first = altgdmin_ls.task_grad_tiles(X, U, B, y)
    assert all(torch.equal(altgdmin_ls.task_grad_tiles(X, U, B, y), first)
               for _ in range(50))
    pad = 150
    Xp = torch.cat([X, torch.zeros((pad, 16, 600), device="cuda")])
    yp = torch.cat([y, torch.zeros((pad, 16), device="cuda")])
    Bp = torch.cat([B, torch.zeros((pad, 4), device="cuda")])
    assert torch.equal(altgdmin_ls.task_grad_tiles(Xp, U, Bp, yp)[:32], first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_tiles_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels import altgdmin_ls, ref
    X, U, y = _instance(shape, dtype, seed=1)
    B = _b_draw(shape, seed=1)
    tiles = altgdmin_ls.node_task_grad_tiles(X, U, B, y)
    assert tiles.dtype == torch.float32
    _close(tiles, _grad_oracle(X, U, B, y), TOL[dtype])
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


def _bits(t):
    """A float tensor's bit patterns, so that NaN compares equal."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["nan_few", "nan_many", "inf", "equal",
                                  "ties"])
@pytest.mark.parametrize("N,d,r", [(20, 600, 4), (3, 97, 3)])
def test_compress_topk_nan_inf_and_ties_equal_plain(cuda, N, d, r, kind,
                                                    dtype):
    """NaN above every number, +inf next, ties in index order, and never
    a row past d: the kernel's order is the plain version's, bit for bit,
    at k = d/2 and k = d."""
    from repro_torch.kernels import compress, ref
    g = torch.Generator(device="cuda").manual_seed(d)
    M = ref.topk_special_block(
        torch.randn((N, d, r), generator=g, device="cuda"), kind).to(dtype)
    for k in (d // 2, d):
        vals, idx = compress.compress_topk(M, k)
        v_ref, i_ref = ref.ref_compress_topk(M, k)
        assert torch.equal(idx, i_ref)
        assert torch.equal(_bits(vals), _bits(v_ref))


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


# (N, d, r) of the int8 round: the dif_quantized path's shape, Experiment
# 2's width at L = 100, a ragged d with r = 16, a node past what one CTA
# holds in registers (a cluster of 8, each CTA reading its share twice),
# and d r not a multiple of the 16-byte vector (element by element)
ROUND = [(20, 600, 4), (100, 1000, 4), (3, 291, 16), (3, 8192, 16),
         (5, 97, 3)]


def _round_operands(N, d, r, dtype, wire, seed=0):
    """Z, xhat (N + 3, d, r): N random nodes, then a zero delta (the
    scale clamps to tiny), a NaN and an inf; u the stochastic wire's
    dither (None for round half to even)."""
    from repro_torch.distributed.consensus import stochastic_dither
    g = torch.Generator(device="cuda").manual_seed(seed + N + d)
    Z = torch.randn((N + 3, d, r), generator=g, device="cuda")
    Z[N - 1] *= 1e3
    xhat = 0.5 * torch.randn((N + 3, d, r), generator=g, device="cuda")
    xhat[N] = Z[N]
    Z[N + 1, d // 2, 0] = float("nan")
    Z[N + 2, d - 1, r - 1] = float("inf")
    Z, xhat = Z.to(dtype), xhat.to(dtype)
    u = (stochastic_dither(3, torch.arange(N + 3, device="cuda"),
                           (d, r), dtype) if wire == "int8_stochastic"
         else None)
    return Z, xhat, u


def _same_nan(got, want):
    """Bit for bit, NaN positions equal (any NaN payload)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("wire", ["int8", "int8_stochastic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d,r", ROUND)
def test_int8_round_kernel_equals_plain(cuda, N, d, r, dtype, wire):
    """The whole int8 round in one launch equals ref_int8_round bit for
    bit: scale and x̂' with NaN positions equal, q on every node whose
    scale is finite."""
    from repro_torch.kernels import _build, compress, ref
    Z, xhat, u = _round_operands(N, d, r, dtype, wire)
    _build.KERNEL_LAUNCHES.clear()
    q, scale, xn = compress.int8_round(Z, xhat, u)
    assert dict(_build.KERNEL_LAUNCHES) == {"int8_round_kernel": 1}
    q0, scale0, xn0 = ref.ref_int8_round(Z, xhat, u)
    assert q.dtype == torch.int8 and scale.dtype == xn.dtype == dtype
    assert scale.shape == (N + 3, 1, 1)
    _same_nan(scale, scale0)
    _same_nan(xn, xn0)
    fin = torch.isfinite(scale0.flatten())
    assert int(fin.sum()) == N + 1          # the NaN and the inf node
    assert torch.equal(q[fin], q0[fin])


@pytest.mark.parametrize("N,d,r", [(20, 600, 4), (3, 8192, 16)])
def test_int8_round_kernel_repeats_bit_for_bit(cuda, N, d, r):
    """Fifty launches give one result, one CTA a node or a cluster."""
    from repro_torch.kernels import compress
    Z, xhat, u = _round_operands(N, d, r, torch.float32, "int8_stochastic")
    first = compress.int8_round(Z, xhat, u)
    for _ in range(50):
        for got, want in zip(compress.int8_round(Z, xhat, u), first):
            assert torch.equal(_bits(got) if got.is_floating_point()
                               else got, _bits(want)
                               if want.is_floating_point() else want)


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


# (n, K, offset): the mesh round at Experiment 1 (d·r = 2400; K = 2 on a
# ring, 19 at ER p = 0.5), the roll form's (L·d·r, ring), ragged n, tiny
# n, the register form's edge (K = 7) and the tile's first K (8), K = 40
# (one shared-memory stage of 64 rows), K = 130 (three staged groups,
# aligned and ragged), and z one element past an aligned base
COMBINE = [(2400, 2, 0), (2400, 19, 0), (48000, 2, 0), (2401, 19, 0),
           (7, 1, 0), (2401, 7, 0), (2400, 8, 0), (2400, 40, 0),
           (2400, 130, 0), (2401, 130, 0), (2400, 19, 1)]
COMBINE_STAGE_ROWS, COMBINE_REG_ROWS = 64, 8


@pytest.mark.parametrize("tensor_weights", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,K,offset", COMBINE)
def test_gossip_combine_matches_plain(cuda, n, K, offset, dtype,
                                      tensor_weights):
    """Bit for bit equal to the plain version (the same products and
    sums in the same order), through the form the C entry reports."""
    from repro_torch.kernels import _build, ops, ref
    g = torch.Generator(device="cuda").manual_seed(n + K)
    z = torch.randn(n + offset, generator=g, device="cuda").to(dtype)[offset:]
    nbrs = torch.randn((K, n), generator=g, device="cuda").to(dtype)
    w = torch.rand(K + 1, generator=g, device="cuda")
    w = w / w.sum()
    weights = w if tensor_weights else tuple(w.tolist())
    _build.LAUNCHES.clear()
    _build.KERNEL_LAUNCHES.clear()
    out = ops.gossip_combine(z, nbrs, weights)          # auto → cuda
    assert _build.LAUNCHES["gossip_combine"] == 1
    form = ("combine_regs_kernel" if K + 1 <= COMBINE_REG_ROWS
            else "combine_tile_kernel/staged" if K + 1 > COMBINE_STAGE_ROWS
            else "combine_tile_kernel")
    assert dict(_build.KERNEL_LAUNCHES) == {form: 1}
    assert out.dtype == dtype and out.shape == z.shape
    assert torch.equal(out, ref.ref_gossip_combine(z, nbrs, weights))


@pytest.mark.parametrize("name", ["dif_partial", "dif_stale", "dif_pushsum"])
def test_masked_trio_through_kernels_matches_torch_ref(cuda, name):
    """The dropout-tolerant trio at the reference's TINY shape under its
    30 % bernoulli dropout (tests/test_system.py), f32 on the card: the
    launches per run equal the program's DispatchBudget (mix_rows once a
    round, twice for push-sum), and the trajectory agrees with torch-ref
    on the card."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, SystemSpec,
                                 TopologySpec, materialize, run_experiment)
    from repro_torch.core.program import get_program
    from repro_torch.kernels import _build
    T_GD, T_con = 30, 3
    spec = ExperimentSpec(
        problem=ProblemSpec(d=36, T=24, r=3, n=22, L=8, kappa=1.5,
                            dtype="float32"),
        topology=TopologySpec(family="erdos_renyi", p=0.5, seed=3),
        init=InitSpec(T_pm=12, T_con=5),
        solver=SolverSpec(name=name, T_GD=T_GD, T_con=T_con),
        engine=EngineSpec(backend="cuda"),
        system=SystemSpec(availability="bernoulli", p_on=0.7, seed=7))
    mat = materialize(spec, key=0)
    _build.LAUNCHES.clear()
    _build.KERNEL_LAUNCHES.clear()
    got = run_experiment(spec, key=0, materialized=mat)
    per_iter = get_program(name).dispatch_budget.per_iter("simulator",
                                                           T_con, 0, 1)
    mix = (per_iter - 1) * T_GD
    assert dict(_build.LAUNCHES) == {"node_fused_iter": T_GD,
                                     "mix_rows": mix, "node_task_gram": 1}
    assert dict(_build.KERNEL_LAUNCHES) == {
        "fused_resident_kernel": T_GD, "mix_tile_kernel": mix,
        "stream_gram_kernel": 1}
    ref = run_experiment(dataclasses.replace(
        spec, engine=EngineSpec(backend="torch-ref")), key=0,
        materialized=mat)
    np.testing.assert_allclose(got.sd_max, ref.sd_max, rtol=1e-4, atol=1e-5)
    _close(got.U_nodes, ref.U_nodes, dict(rtol=1e-4, atol=1e-5))
    assert got.time_axis_source == "simulated"
    np.testing.assert_array_equal(got.time_axis, ref.time_axis)
    assert got.final_sd_max < got.sd_max[0]


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


@pytest.mark.parametrize("name,knobs", [
    ("dif_quantized", {"compression": "int8"}), ("dif_pushsum", {})])
def test_two_rank_gloo_mesh_stateful_and_masked(cuda, name, knobs):
    """dif_quantized (int8), and dif_pushsum under the reference's 30 %
    bernoulli dropout, on a 2-rank gloo mesh on the card: each rank's
    launches are the program's DispatchBudget on the mesh (K = 1 shift),
    its sends R·K·wire_mesh, and its sd_max trace the port's simulator's
    on the card (rtol 1e-4, atol 1e-5); push-sum's U_nodes and B_nodes
    too.  The int8 wire rounds every entry half to even, so the f32
    round-off of the mesh's combine (against the simulator's dense
    product) can move a payload entry by one quantum: its iterates part
    by about that (6.4e-5 here on an H100; at Experiment 1 chip_smoke.py
    holds them within rtol 1e-4, atol 1e-5); at f64 the two agree within
    1e-15 (tests/test_torch_mesh_state.py)."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, SystemSpec,
                                 TopologySpec, materialize, run_experiment)
    from repro_torch.api.runner import run_on_mesh
    from repro_torch.distributed.mesh import spawn
    from repro_torch.kernels import _build
    _build.build()                  # the ranks load it, never race on nvcc
    T_GD, T_con = 40, 3
    spec = ExperimentSpec(
        problem=ProblemSpec(d=60, T=20, r=3, n=25, L=2, kappa=1.5,
                            dtype="float32"),
        topology=TopologySpec(family="complete"),
        init=InitSpec(T_pm=20, T_con=3),
        solver=SolverSpec(name=name, T_GD=T_GD, T_con=T_con, **knobs),
        engine=EngineSpec(backend="cuda"), substrate="mesh",
        system=(SystemSpec(availability="bernoulli", p_on=0.7, seed=7)
                if name == "dif_pushsum" else None))
    ranks = spawn(run_on_mesh, 2, args=("cuda", [spec.to_dict()], 1),
                  backend="gloo", device="cuda", timeout=300)
    sim = run_experiment(dataclasses.replace(spec, substrate="simulator"),
                         key=1, materialized=materialize(spec, key=1))
    rounds = T_con * T_GD
    want = {"node_fused_iter": T_GD, "gossip_combine": rounds,
            "node_task_gram": 1}
    if name == "dif_quantized":     # the round, then K = 1 decode
        want["dequant"] = 2 * rounds
    for (hw,) in ranks:
        assert hw["launches"] == want
        if name == "dif_quantized":
            assert hw["kernel_launches"]["int8_round_kernel"] == rounds
            assert hw["kernel_launches"]["dequant_kernel"] == rounds
        assert hw["sends"] == rounds * 2            # wire_mesh 2, K = 1
        np.testing.assert_allclose(hw["sd_max"], sim.sd_max, rtol=1e-4,
                                   atol=1e-5)
        for field in ("U_nodes", "B_nodes") if name == "dif_pushsum" else ():
            np.testing.assert_allclose(hw[field],
                                       getattr(sim, field).cpu().numpy(),
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(hw["U_nodes"], ranks[0][0]["U_nodes"])
    if spec.system is not None:
        assert not spec.system.availability_mask(T_GD, 2).all()
    assert ranks[0][0]["sd_max"][-1] < ranks[0][0]["sd_max"][0]


def test_two_rank_virtual_tier_through_the_kernels(cuda):
    """L = 8 on 2 gloo ranks on the card (the virtual-node tier, block 4,
    one cross-rank class): dif_altgdmin and dif_topk (k = d, every row
    refreshed) against the port's simulator on the card (sd_max,
    U_nodes and B_nodes at rtol 1e-4, atol 1e-5), dif_quantized (int8)
    at its final sd_max (within 10 %, as chip_smoke.py holds dif_topk at
    k = 150): the virtual round sums in another order than the
    simulator's mix_rows, and the int8 wire rounds every entry half to
    even, so round-off can move a payload entry by a quantum (its trace
    parted by 2.4e-5 at this shape on an H100; at Experiment 1
    chip_smoke.py holds it within rtol 1e-4, atol 1e-5).  Each rank's
    launches are the virtual DispatchBudget's: one node_fused_iter an
    iteration, one compress_topk / int8_round_kernel a round, no
    gossip_combine, mix_rows or dequant_kernel; its sends
    R·K·wire_virtual."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, TopologySpec,
                                 materialize, run_experiment)
    from repro_torch.api.runner import run_on_mesh
    from repro_torch.distributed.mesh import spawn
    from repro_torch.kernels import _build
    _build.build()                  # the ranks load it, never race on nvcc
    T_GD, T_con, d = 40, 3, 60
    base = ExperimentSpec(
        problem=ProblemSpec(d=d, T=40, r=3, n=25, L=8, kappa=1.5,
                            dtype="float32"),
        topology=TopologySpec(family="erdos_renyi", p=0.6, seed=2),
        init=InitSpec(T_pm=20, T_con=3),
        solver=SolverSpec(T_GD=T_GD, T_con=T_con),
        engine=EngineSpec(backend="cuda"), substrate="mesh")
    runs = (("dif_altgdmin", {}), ("dif_topk", {"compression_k": d}),
            ("dif_quantized", {"compression": "int8"}))
    specs = [dataclasses.replace(base, solver=dataclasses.replace(
        base.solver, name=name, **kw)) for name, kw in runs]
    ranks = spawn(run_on_mesh, 2, args=("cuda", [s.to_dict() for s in specs],
                                        1),
                  backend="gloo", device="cuda", timeout=300)
    mat = materialize(base, key=1)
    rounds = T_con * T_GD
    for i, (spec, (name, _)) in enumerate(zip(specs, runs)):
        sim = run_experiment(dataclasses.replace(spec, substrate="simulator"),
                             key=1, materialized=mat)
        want = {"node_fused_iter": T_GD, "node_task_gram": 1}
        want_kernels = {}
        if name == "dif_topk":
            want["compress_topk"] = rounds
        elif name == "dif_quantized":
            want["dequant"] = rounds
            want_kernels["int8_round_kernel"] = rounds
        for g in range(2):
            hw = ranks[g][i]
            assert hw["launches"] == want, (name, hw["launches"])
            assert hw["kernel_launches"].get("dequant_kernel", 0) == 0
            for key, v in want_kernels.items():
                assert hw["kernel_launches"][key] == v
            assert hw["sends"] == rounds * 1 * 1    # K = 1, wire_virtual 1
            np.testing.assert_array_equal(hw["U_nodes"],
                                          ranks[0][i]["U_nodes"])
            if name == "dif_quantized":
                assert abs(hw["sd_max"][-1] - sim.sd_max[-1]) \
                    < 0.1 * sim.sd_max[-1]
                continue
            np.testing.assert_allclose(hw["sd_max"], sim.sd_max, rtol=1e-4,
                                       atol=1e-5, err_msg=name)
            for field in ("U_nodes", "B_nodes"):
                np.testing.assert_allclose(
                    hw[field], getattr(sim, field).cpu().numpy(), rtol=1e-4,
                    atol=1e-5, err_msg=f"{name} {field}")
        assert ranks[0][i]["sd_max"][-1] < ranks[0][i]["sd_max"][0]


# (T, n, d, r): the serving cohort and a serving batch at Experiment 1's
# width, the JAX package's kernel benchmark row, a ragged d, the rank
# capacity's edge, one task
SINGLE = [(64, 16, 600, 4), (32, 16, 600, 4), (32, 30, 600, 4),
          (3, 20, 100, 8), (5, 40, 33, 16), (1, 50, 256, 2)]


def _single(shape, dtype, seed=0):
    T, n, d, r = shape
    X, U, y = _instance((1, T, n, d, r), dtype, seed)
    return X[0], U[0], y[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SINGLE)
def test_single_basis_kernels_match_plain(cuda, shape, dtype):
    from repro_torch.kernels import _build, altgdmin_ls, ref
    X, U, y = _single(shape, dtype, seed=2)
    B = torch.randn((shape[0], shape[3]), device="cuda")
    _build.LAUNCHES.clear()
    G, c = altgdmin_ls.task_gram(X, U, y)
    tiles = altgdmin_ls.task_grad_tiles(X, U, B, y)
    assert dict(_build.LAUNCHES) == {"task_gram": 1, "task_grad_tiles": 1}
    assert G.dtype == c.dtype == tiles.dtype == torch.float32
    G_ref, c_ref = ref.ref_single_task_gram(X, U, y)
    _close(G, G_ref, TOL[dtype])
    _close(c, c_ref, TOL[dtype])
    _close(tiles, ref.ref_single_grad_tiles(X, U, B, y), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SINGLE)
def test_single_basis_gram_reports_its_kernel(cuda, shape, dtype):
    """task_gram at the serving shapes within TOL of the plain version,
    reported as one launch of the staged form."""
    from repro_torch.kernels import _build, altgdmin_ls, ref
    X, U, y = _single(shape, dtype, seed=5)
    _build.KERNEL_LAUNCHES.clear()
    G, c = altgdmin_ls.task_gram(X, U, y)
    assert dict(_build.KERNEL_LAUNCHES) == {GRAM_STAGED: 1}
    G_ref, c_ref = ref.ref_single_task_gram(X, U, y)
    _close(G, G_ref, TOL[dtype])
    _close(c, c_ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_single_basis_ops_match_torch_ref(cuda, dtype):
    """ops.altgdmin_minimize_B / altgdmin_gradient on cuda against their
    plain route; f64 operands go through the f32 kernels."""
    from repro_torch.kernels import ops
    X, U, y = _single(SINGLE[1], dtype, seed=3)
    B = ops.altgdmin_minimize_B(X, U, y)                # auto → cuda
    assert B.dtype == torch.float32 and B.shape == (32, 4)
    _close(B, ops.altgdmin_minimize_B(X, U, y, backend="torch-ref"),
           TOL[torch.float32])
    g = ops.altgdmin_gradient(X, U, B, y)
    assert g.dtype == torch.float32 and g.shape == (600, 4)
    _close(g, ops.altgdmin_gradient(X, U, B, y, backend="torch-ref"),
           TOL[torch.float32])


def _serving_requests(seed, t_news, d=600):
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal((t, d)) for t in t_news],
            [rng.standard_normal(t) for t in t_news])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_serving_engine_on_cuda_matches_torch_ref(cuda, dtype):
    """One node_task_gram launch a batch; B against the torch-ref engine
    on the card (f64 U: the kernel computes in f32, B comes back in U's
    dtype)."""
    from repro_torch.kernels import _build
    from repro_torch.serving import ServingEngine
    U = torch.linalg.qr(torch.randn(600, 4, device="cuda",
                                    dtype=torch.float64))[0].to(dtype)
    X_list, y_list = _serving_requests(0, (8, 16, 32, 12, 16))
    eng = ServingEngine(U, max_batch=8)
    assert eng.engine.backend == "cuda"
    _build.LAUNCHES.clear()
    B, theta, version = eng.solve(X_list, y_list)
    assert dict(_build.LAUNCHES) == {"node_task_gram": 1}
    assert B.dtype == dtype and B.is_cuda and theta.shape == (5, 600)
    B_ref, theta_ref, _ = ServingEngine(U, max_batch=8,
                                        backend="torch-ref").solve(X_list,
                                                                   y_list)
    _close(B, B_ref, dict(rtol=1e-4, atol=1e-5))
    _close(theta, theta_ref, dict(rtol=1e-4, atol=1e-5))


def test_serving_padding_is_bitwise_exact_on_cuda(cuda):
    """Slot padding (max_batch 3 vs 8) and bucket padding (pad_n_to 8 vs
    32) leave the real solutions bit for bit equal on the card."""
    from repro_torch.serving import ServingEngine
    U = torch.linalg.qr(torch.randn(600, 4, device="cuda"))[0]
    X_list, y_list = _serving_requests(1, (7, 11, 13))
    tight = ServingEngine(U, max_batch=3).solve(X_list, y_list)[0]
    slack = ServingEngine(U, max_batch=8).solve(X_list, y_list)[0]
    assert torch.equal(tight, slack)
    b8 = ServingEngine(U, max_batch=4, pad_n_to=8).solve(X_list, y_list)[0]
    b32 = ServingEngine(U, max_batch=4, pad_n_to=32).solve(X_list,
                                                           y_list)[0]
    assert torch.equal(b8, b32)


def test_checkpoint_round_trip_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.serving import HotSwapSource, publish_representation
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"U": torch.randn(600, 4, generator=g, device="cuda"),
            "h": torch.randn(8, generator=g, device="cuda").to(torch.bfloat16),
            "k": [torch.arange(5, device="cuda")]}
    save_checkpoint(str(tmp_path / "ck"), 1, tree)
    out = restore_checkpoint(str(tmp_path / "ck"), 1,
                             {k: (torch.zeros_like(v) if torch.is_tensor(v)
                                  else [torch.zeros_like(v[0])])
                              for k, v in tree.items()})
    for a, b in ((tree["U"], out["U"]), (tree["h"], out["h"]),
                 (tree["k"][0], out["k"][0])):
        assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b)
    publish_representation(str(tmp_path / "pub"), 3, tree["U"][None])
    step, U = HotSwapSource(str(tmp_path / "pub"), d=600, r=4).poll()
    assert step == 3 and U.is_cuda and U.dtype == torch.float32
    torch.testing.assert_close(U.T @ U, torch.eye(4, device="cuda"),
                               rtol=0, atol=1e-5)


def test_segmented_run_on_cuda_is_bit_identical(cuda, tmp_path):
    """checkpoint_every on the card: the segmented trajectory equals the
    unsegmented one bit for bit, and every segment publishes."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, TopologySpec,
                                 materialize, run_experiment)
    spec = ExperimentSpec(
        problem=ProblemSpec(d=60, T=60, r=3, n=25, L=6, kappa=1.5,
                            dtype="float32"),
        topology=TopologySpec(family="erdos_renyi", p=0.5, seed=3),
        init=InitSpec(T_pm=20, T_con=8),
        solver=SolverSpec(T_GD=30, T_con=3),
        engine=EngineSpec(backend="cuda"))
    mat = materialize(spec, key=1)
    seg = run_experiment(spec, materialized=mat, checkpoint_every=10,
                         checkpoint_dir=str(tmp_path))
    plain = run_experiment(spec, materialized=mat)
    assert np.array_equal(seg.sd_max, plain.sd_max)
    assert torch.equal(seg.U_nodes, plain.U_nodes)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"step_{s:09d}" for s in (0, 10, 20, 30)]


# ------------------------------------------------------------ LM kernels

# flash_attention's (B, Sq, Skv, H, Hkv, D, causal, window): square GQA,
# MQA, cross lengths with aligned ends, a ragged length, rows that see no
# key (Sq > Skv), a window, D = 112 (zamba2's head) and causal=False on a
# ragged key length; then the tiling's edges: one query and a q-tile
# plus one against three key tiles, D = 64, 256 and 40 (not a multiple
# of 16), a window smaller than a tile, causal=False over 200 keys and
# Sq > Skv across several q-tiles.  The reference's tolerances: 2e-5 /
# 2e-2.
FLASH = [(1, 64, 64, 4, 2, 32, True, None), (2, 32, 32, 4, 1, 16, True, None),
         (1, 16, 200, 2, 2, 64, True, None), (2, 100, 100, 4, 2, 128, True,
                                              None),
         (1, 64, 40, 2, 1, 32, True, None), (1, 150, 150, 2, 2, 32, True, 33),
         (2, 70, 70, 4, 2, 112, True, None), (1, 40, 40, 2, 2, 32, False,
                                              None),
         (2, 1, 129, 4, 2, 64, True, None), (1, 65, 129, 4, 2, 64, True, None),
         (1, 300, 300, 2, 1, 64, True, None),
         (1, 130, 130, 2, 2, 256, True, None),
         (2, 70, 70, 2, 2, 40, True, None), (1, 150, 150, 2, 2, 64, True, 7),
         (1, 100, 200, 4, 2, 64, False, None),
         (1, 300, 90, 2, 1, 64, True, None)]
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# ssd_scan's (B, S, H, P, N, chunk), the reference's shapes and a ragged
# chunk; tolerances 1e-4 / 5e-2
SSD = [(1, 32, 2, 16, 8, 8), (2, 48, 3, 8, 16, 16), (1, 20, 2, 16, 8, 8),
       (1, 64, 1, 32, 32, 64), (2, 300, 4, 64, 128, 128)]
SSD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,window", FLASH)
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, H, Hkv, D,
                                              causal, window, dtype):
    from repro_torch.kernels import _build, flash_attention, ref
    g = torch.Generator(device="cuda").manual_seed(Sq + Skv)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    before = _build.LAUNCHES["flash_attention"]
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    want = ref.ref_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal,
                             window=window).transpose(1, 2)
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_unaligned_rows_and_bases(cuda, dtype):
    """Rows of D = 20 (40 bytes in bf16) and bases 2 bytes past an
    allocation: the kernel copies element by element there, with the
    same result."""
    from repro_torch.kernels import flash_attention, ref
    g = torch.Generator(device="cuda").manual_seed(5)

    def unaligned(shape):
        buf = torch.randn(int(np.prod(shape)) + 1, generator=g,
                          device="cuda").to(dtype)
        return buf[1:].view(shape)

    for D in (20, 64):
        q = unaligned((2, 80, 4, D))
        k, v = unaligned((2, 80, 2, D)), unaligned((2, 80, 2, D))
        out = flash_attention.flash_attention(q, k, v, causal=True)
        want = ref.ref_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2)).transpose(1, 2)
        _close(out, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD)
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dtype):
    from repro_torch.kernels import _build, ref, ssd_scan
    g = torch.Generator(device="cuda").manual_seed(S + H)
    x = torch.randn((B, S, H, P), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda")) * 0.1
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    Bm, Cm = (torch.randn((B, S, N), generator=g, device="cuda").to(dtype)
              for _ in range(2))
    D = torch.full((H,), 0.5, device="cuda")
    before = _build.LAUNCHES["ssd_scan"]
    y, h = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
    assert _build.LAUNCHES["ssd_scan"] == before + 1
    y_ref, h_ref = ref.ref_ssd(x, dt, A, Bm, Cm, D)
    assert y.dtype == dtype and h.dtype == torch.float32
    _close(y, y_ref, SSD_TOL[dtype])
    _close(h, h_ref, SSD_TOL[dtype])


def _ssd_case(B, S, H, P, N, dtype, seed, a_scale=1.0, unaligned=False):
    """tests/test_kernels.py's draws of x, dt, A, Bm, Cm, D (A times
    ``a_scale``); with ``unaligned``, x, Bm and Cm start one element past
    an allocation."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape):
        if not unaligned:
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        buf = torch.randn(int(np.prod(shape)) + 1, generator=g,
                          device="cuda").to(dtype)
        return buf[1:].view(shape)

    x = draw((B, S, H, P))
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda")) * 0.1
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    Bm, Cm = draw((B, S, N)), draw((B, S, N))
    return x, dt, A * a_scale, Bm, Cm, torch.full((H,), 0.5, device="cuda")


# (name, B, S, H, P, N, chunk, A scale): many chunks of 64 with |A| dt
# about 3 a token, so exp(cum) underflows to 0 inside every chunk; S not
# a multiple of Q at mamba2-130m's widths
SSD_HARD = [("strong_decay", 2, 1024, 4, 64, 128, 64, 40.0),
            ("ragged_mamba2", 2, 1000, 24, 64, 128, 128, 1.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,S,H,P,N,chunk,a_scale", SSD_HARD)
def test_ssd_scan_strong_decay_and_ragged_match_plain(cuda, name, B, S, H,
                                                      P, N, chunk, a_scale,
                                                      dtype):
    from repro_torch.kernels import ref, ssd_scan
    args = _ssd_case(B, S, H, P, N, dtype, seed=S + N, a_scale=a_scale)
    if name == "strong_decay":     # exp(cum) is 0 in f32 within a chunk
        x, dt, A = args[:3]
        cum = (dt * A)[:, :chunk].cumsum(1)
        assert float(cum.min()) < -110.0
    y, h = ssd_scan.ssd_scan(*args, chunk=chunk)
    y_ref, h_ref = ref.ref_ssd(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    _close(y, y_ref, SSD_TOL[dtype])
    _close(h, h_ref, SSD_TOL[dtype])


_SSD_PASSES = {"chunk_state_kernel": 1, "state_pass_kernel": 1,
               "chunk_out_kernel": 1}


# bf16 on each side of the tensor-core passes' reach: P = 128 with N =
# 256 (their widest tiles), P or N past those, and P 72 / N 136 (tiles of
# 128 x 256) with Q = 64, whose blocks fit shared memory, and Q = 128,
# whose do not while the CUDA-core kernel's does
@pytest.mark.parametrize("P,N,chunk,kernels", [
    (128, 256, 32, _SSD_PASSES),
    (256, 64, 64, {"ssd_kernel": 1}),
    (64, 264, 32, {"ssd_kernel": 1}),
    (72, 136, 64, _SSD_PASSES),
    (72, 136, 128, {"ssd_kernel": 1})])
def test_ssd_scan_bf16_picks_kernel_by_shape(cuda, P, N, chunk, kernels):
    """Every bf16 shape whose block fits shared memory runs: the three
    tensor-core passes where they take it, else the CUDA-core kernel;
    each within SSD_TOL of the plain version."""
    from repro_torch.kernels import _build, ref, ssd_scan
    args = _ssd_case(1, 200, 2, P, N, torch.bfloat16, seed=P + N + chunk)
    _build.KERNEL_LAUNCHES.clear()
    y, h = ssd_scan.ssd_scan(*args, chunk=chunk)
    assert dict(_build.KERNEL_LAUNCHES) == kernels
    y_ref, h_ref = ref.ref_ssd(*args)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(h, h_ref, SSD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,N,chunk", [(20, 24, 24), (64, 20, 40),
                                       (72, 136, 32)])
def test_ssd_scan_unaligned_rows_and_bases(cuda, P, N, chunk, dtype):
    """Rows of P or N not a multiple of 8, bases one element past an
    allocation, and widths past 64 / 128 (the next tile sizes): the
    kernels copy element by element where 16-byte copies do not fit."""
    from repro_torch.kernels import ref, ssd_scan
    args = _ssd_case(2, 100, 3, P, N, dtype, seed=P + N, unaligned=True)
    y, h = ssd_scan.ssd_scan(*args, chunk=chunk)
    y_ref, h_ref = ref.ref_ssd(*args)
    _close(y, y_ref, SSD_TOL[dtype])
    _close(h, h_ref, SSD_TOL[dtype])


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-130m",
                                  "granite-20b", "command-r-35b",
                                  "phi4-mini-3.8b", "musicgen-medium"])
def test_smoke_model_through_the_kernels_matches_torch_ref(cuda, name):
    """A smoke config's forward on the card through the LM kernel (one
    launch a layer) against the torch-ref route on the same weights, and
    generate() end to end; prefill ≡ decode at 2e-3.  granite's smoke
    keeps its one KV head (MQA), command-r's its parallel block,
    phi4's its tied embeddings, musicgen's its MHA at head dim 64."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve
    from repro_torch.models import LanguageModel, init_params
    cfg = get_config(name).smoke()
    model = LanguageModel(cfg, init_params(cfg, seed=0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    kernel = "ssd_scan" if name.startswith("mamba") else "flash_attention"
    _build.LAUNCHES.clear()
    got = model(toks)
    assert _build.LAUNCHES[kernel] == cfg.n_layers
    with ops.backend_scope("torch-ref"):
        want = model(toks)
    assert _build.LAUNCHES[kernel] == cfg.n_layers
    _close(got, want, dict(rtol=1e-4, atol=1e-4))
    _, stats = serve.generate_tokens(model, toks, 4,
                                     keep_prefill_logits=True)
    _close(stats["prefill_logits"], got, dict(rtol=2e-3, atol=2e-3))
    tokens, _ = serve.generate(name, batch=2, prompt_len=8, gen=4)
    assert tokens.is_cuda and tokens.shape == (2, 4)


# the kernels at the shapes of the plans past the scan stacks: MLA's head
# dim 192 (128 heads, V padded to it) with its scale passed explicitly
# ((dn + dr)^-1/2, and another), llava's GQA 32/8 past its 4096-token
# window, zamba2's SSM heads (112 of P 64, N 64)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [192 ** -0.5, 0.1])
def test_flash_attention_mla_head_dim_with_scale(cuda, dtype, scale):
    from repro_torch.kernels import flash_attention, ref
    g = torch.Generator(device="cuda").manual_seed(192)
    q, k, v = (torch.randn((2, 300, 128, 192), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    out = flash_attention.flash_attention(q, k, v, causal=True, scale=scale)
    want = ref.ref_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), scale=scale).transpose(1, 2)
    _close(out, want, FLASH_TOL[dtype])


def test_flash_attention_gqa_window_past_it(cuda):
    """llava-next's attention at its prefill: B 1, S 8192, 32 query heads
    on 8 KV heads, D 128, window 4096, bf16."""
    from repro_torch.kernels import flash_attention, ref
    g = torch.Generator(device="cuda").manual_seed(4096)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
               for s in ((1, 8192, 32, 128), (1, 8192, 8, 128),
                         (1, 8192, 8, 128)))
    out = flash_attention.flash_attention(q, k, v, causal=True, window=4096)
    want = ref.ref_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), window=4096).transpose(1, 2)
    _close(out, want, FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_zamba2_heads(cuda, dtype):
    """zamba2-7b's SSM: 112 heads of P 64, N 64, chunk 128; at bf16 the
    three tensor-core passes, one launch each."""
    from repro_torch.kernels import _build, ref, ssd_scan
    args = _ssd_case(2, 512, 112, 64, 64, dtype, seed=112)
    _build.KERNEL_LAUNCHES.clear()
    y, h = ssd_scan.ssd_scan(*args, chunk=128)
    if dtype == torch.bfloat16:
        assert dict(_build.KERNEL_LAUNCHES) == _SSD_PASSES
    y_ref, h_ref = ref.ref_ssd(*args)
    _close(y, y_ref, SSD_TOL[dtype])
    _close(h, h_ref, SSD_TOL[dtype])


def _plan_launches(cfg):
    """The LM kernels' launches of one forward of ``cfg``: one flash a
    attention layer (and a zamba group's shared block), one ssd_scan an
    SSM layer."""
    from repro_torch.models.transformer import build_plan
    out = {}
    for seg in build_plan(cfg):
        if seg[0] == "zamba":
            out["ssd_scan"] = out.get("ssd_scan", 0) + seg[1] * seg[2]
            out["flash_attention"] = out.get("flash_attention", 0) + seg[1]
        else:
            name = "flash_attention" if seg[1][0] == "attn" else "ssd_scan"
            out[name] = out.get(name, 0) + seg[2]
    return out


@pytest.mark.parametrize("name", ["arctic-480b", "deepseek-v3-671b",
                                  "zamba2-7b", "llava-next-mistral-7b"])
def test_new_plans_smoke_through_the_kernels(cuda, name):
    """The smoke MoE, MLA, zamba and vlm models on the card through their
    LM kernels against the torch-ref route on the same weights (the MoE
    aux loss too), with the launches by kernel; prefill ≡ teacher-forced
    decode at 2e-3 (a MoE's at a capacity at which the forward drops no
    token)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve
    from repro_torch.models import LanguageModel, init_params
    from repro_torch.models import transformer as tfm
    from repro_torch.models.frontends import vlm_batch_stub
    cfg = get_config(name).smoke()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    model = LanguageModel(cfg, init_params(cfg, seed=0))
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = (vlm_batch_stub(g, 2, 40, cfg) if cfg.modality == "vlm" else
             {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                      device="cuda", generator=g)})
    _build.LAUNCHES.clear()
    got, aux = tfm.forward(model.params, batch, cfg)
    assert dict(_build.LAUNCHES) == _plan_launches(cfg)
    with ops.backend_scope("torch-ref"):
        want, want_aux = tfm.forward(model.params, batch, cfg)
    assert dict(_build.LAUNCHES) == _plan_launches(cfg)
    _close(got, want, dict(rtol=1e-4, atol=1e-4))
    _close(aux, want_aux, dict(rtol=1e-4, atol=1e-4))
    toks = batch["tokens"]
    _, stats = serve.generate_tokens(model, toks, 4,
                                     keep_prefill_logits=True)
    _close(stats["prefill_logits"], model(toks), dict(rtol=2e-3, atol=2e-3))
    tokens, _ = serve.generate(name, batch=2, prompt_len=8, gen=4)
    assert tokens.is_cuda and tokens.shape == (2, 4)


# ------------------------------------------------------- the sparse tier

def _sparse_setup(L, seed=0, family="erdos_renyi"):
    from repro_torch.distributed import graphs, mixing
    g = (graphs.erdos_renyi(L, 0.3, seed=seed) if family == "erdos_renyi"
         else graphs.barabasi_albert(L, m=3, seed=seed))
    return g, mixing.metropolis_weights_sparse(g)


def test_sparse_round_on_the_card_matches_the_cpu(cuda):
    """One segment-sum round and three stacked ones at f64 on a BA graph:
    the card's atomic sums against the CPU's sequential ones."""
    from repro_torch.distributed import consensus as cons
    _, sw = _sparse_setup(5000, family="barabasi_albert")
    Z = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (5000, 16, 2)))
    ops_cpu = cons.sparse_operands(sw, "cpu", torch.float64)
    ops_gpu = cons.sparse_operands(sw, cuda, torch.float64)
    assert ops_gpu[0].is_cuda and ops_gpu[0].dtype == torch.int64
    zf = Z.reshape(5000, -1)
    want = cons.sparse_round(zf, *ops_cpu, 5000)
    got = cons.sparse_round(zf.to(cuda), *ops_gpu, 5000)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-12)
    torch.testing.assert_close(
        cons.stacked_sparse_product(Z.to(cuda), sw, 3).cpu(),
        cons.stacked_sparse_product(Z, sw, 3), rtol=0, atol=1e-12)


SPARSE_RULES = {"gossip": None, "exact_diffusion": None,
                "beyond_central": None, "neighbor": None,
                "topk_gossip": dict(compression_k=3),
                "quantized_gossip": dict(compression="int8"),
                "event_gossip": dict(event_threshold=0.05),
                "partial_gossip": "masked", "push_sum_gossip": "masked",
                "stale_gossip": "masked_state"}


@pytest.mark.parametrize("rule", list(SPARSE_RULES))
def test_rule_sparse_mixer_on_the_card_matches_its_dense_form(cuda, rule):
    """Each rule's sparse mixer (segment sums on the card) against its
    dense form (the mix_rows kernel) at f32, L = 64, on the cuda
    backend, within the f32 tolerance; no sparse round launches a mixing
    kernel."""
    from repro_torch.distributed import consensus as cons
    from repro_torch.kernels import _build
    g, sw = _sparse_setup(64, seed=2)
    if rule == "neighbor":
        sw = cons.neighbor_average_matrix(g)
        dense = cons.neighbor_average_matrix(
            torch.as_tensor(g.adj, dtype=torch.float64))
    else:
        dense = torch.as_tensor(sw.to_dense())
    dense = dense.to(cuda, torch.float32)
    Z = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (64, 7, 5)), dtype=torch.float32, device=cuda)
    m = torch.as_tensor(np.random.default_rng(3).random(64) > 0.3,
                        device=cuda)
    r = cons.get_rule(rule)
    kind = SPARSE_RULES[rule]

    def run(topo):
        if isinstance(kind, dict):
            out = r.make_sim_state_mixer(topo, 3, backend="cuda", **kind)(
                Z, r.init_state(Z, **kind))
            return out[0]
        if kind == "masked":
            return r.make_sim_masked_mixer(topo, 3, backend="cuda")(Z, m)
        if kind == "masked_state":
            return r.make_sim_masked_state_mixer(topo, 3, backend="cuda")(
                Z, torch.zeros_like(Z), m)[0]
        return r.make_sim_mixer(topo, 3, backend="cuda")(Z)
    _build.LAUNCHES.clear()
    got = run(sw)
    torch.cuda.synchronize()
    assert not {"mix_rows", "gossip_combine"} & set(_build.LAUNCHES)
    _close(got, run(dense), TOL[torch.float32])


def test_fused_iter_at_the_sparse_tier_shape_matches_plain(cuda):
    """node_fused_iter and node_task_gram at the scale configuration's
    shape: 100 000 tasks, one a node, n = 8, d = 16, r = 2."""
    from repro_torch.kernels import altgdmin_ls, ref
    X, U, y = _instance((100_000, 1, 8, 16, 2), torch.float32, seed=5)
    B, tiles = altgdmin_ls.node_fused_iter(X, U, y)
    B_ref, tiles_ref = ref.ref_fused_iter(X, U, y)
    _close(B, B_ref, TOL[torch.float32])
    _close(tiles, tiles_ref, TOL[torch.float32])
    G, c = altgdmin_ls.node_task_gram(X, U, y)
    G_ref, c_ref = ref.ref_task_gram(X, U, y)
    _close(G, G_ref, TOL[torch.float32])
    _close(c, c_ref, TOL[torch.float32])


def test_sparse_run_on_the_card_matches_torch_ref(cuda):
    """dif_altgdmin on the sparse tier at L = 1024 (auto): the cuda run
    launches node_fused_iter once an iteration and node_task_gram once,
    no mixing kernel, and tracks torch-ref on the card."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, TopologySpec,
                                 materialize, run_experiment)
    from repro_torch.distributed.mixing import SparseWeights
    from repro_torch.kernels import _build
    L, T_GD = 1024, 10
    spec = ExperimentSpec(
        problem=ProblemSpec(d=8, T=L, r=2, n=10, L=L, kappa=1.2,
                            dtype="float32"),
        topology=TopologySpec(family="erdos_renyi", p=6.0 / L, seed=5),
        init=InitSpec(T_pm=3, T_con=2),
        solver=SolverSpec(name="dif_altgdmin", T_GD=T_GD, T_con=3),
        engine=EngineSpec(backend="cuda"))
    mat = materialize(spec, 0, device=cuda)
    assert isinstance(mat.W, SparseWeights)
    _build.LAUNCHES.clear()
    got = run_experiment(spec, materialized=mat)
    assert dict(_build.LAUNCHES) == {"node_fused_iter": T_GD,
                                     "node_task_gram": 1}
    want = run_experiment(dataclasses.replace(
        spec, engine=EngineSpec(backend="torch-ref")), materialized=mat)
    np.testing.assert_allclose(got.sd_max, want.sd_max, rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------------- training on the card
# The autograd wrappers of the LM kernels (models.attention.kernel_attention
# and models.ssm.kernel_ssd: the kernel forward, the plain core's gradient)
# against the plain core under autograd on the same inputs: the forward
# within the kernels' tolerances above, each input's gradient within the
# relative L2 bounds that chip_smoke.py holds the bf16 models to (0.05
# attention, 0.10 SSD).  The backward IS the plain core's vjp on the saved
# inputs, so the gradients agree to the plain core's own reproducibility.
GRAD_REL_L2 = {"attention": 0.05, "ssd": 0.10}


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _hold_autograd(wrapped, plain, inputs, fwd_tol, grad_rel_l2):
    """Forward and input gradients of ``wrapped`` against ``plain``; every
    input needs a gradient, and gets one that is not None."""
    g = torch.Generator(device="cuda").manual_seed(11)
    a = [x.detach().clone().requires_grad_() for x in inputs]
    b = [x.detach().clone().requires_grad_() for x in inputs]
    out, want = wrapped(*a), plain(*b)
    _close(out, want, fwd_tol)
    assert out.requires_grad, "the kernel's output has no autograd graph"
    w = torch.randn(want.shape, generator=g, device="cuda").to(want.dtype)
    got_g = torch.autograd.grad((out.float() * w).sum(), a,
                                allow_unused=True)
    want_g = torch.autograd.grad((want.float() * w).sum(), b)
    for i, (gg, wg) in enumerate(zip(got_g, want_g)):
        assert gg is not None, f"input {i} got no gradient"
        assert _rel_l2(gg, wg) <= grad_rel_l2, (i, _rel_l2(gg, wg))


def _attention_autograd_case(dtype):
    from repro_torch.models import attention as attn
    g = torch.Generator(device="cuda").manual_seed(12)
    B, S, H, Hkv, D = 2, 256, 4, 2, 128
    inputs = [torch.randn(s, generator=g, device="cuda").to(dtype)
              for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    pos = torch.arange(S, device="cuda").expand(B, S)
    return (lambda q, k, v: attn.kernel_attention(q, k, v, pos),
            lambda q, k, v: attn.attention_dispatch(q, k, v, pos, pos),
            inputs, FLASH_TOL[dtype], GRAD_REL_L2["attention"])


def _ssd_autograd_case(dtype):
    """mamba2-130m's head width and state (P 64, N 128, chunk 128), the
    decay of _ssd_case's draws."""
    from repro_torch.models import ssm
    Q = 128
    return (lambda *a: ssm.kernel_ssd(*a, Q),
            lambda *a: ssm.ssd_chunked(*a, Q)[0].to(dtype),
            list(_ssd_case(2, 256, 4, 64, 128, dtype, seed=13)),
            SSD_TOL[dtype], GRAD_REL_L2["ssd"])


AUTOGRAD_CASES = {"attention": _attention_autograd_case,
                  "ssd": _ssd_autograd_case}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["attention", "ssd"])
def test_kernel_autograd_wrapper_matches_the_plain_core(cuda, case, dtype):
    from repro_torch.kernels import _build
    kernel = {"attention": "flash_attention", "ssd": "ssd_scan"}[case]
    _build.LAUNCHES.clear()
    _hold_autograd(*AUTOGRAD_CASES[case](dtype))
    assert _build.LAUNCHES[kernel] == 1


@pytest.mark.parametrize("case", ["attention", "ssd"])
def test_a_detached_kernel_output_fails_the_autograd_check(cuda, case,
                                                          monkeypatch):
    """A planted fault: the wrapper returning the kernel's output with no
    autograd graph (what a bare ctypes call gives).  The check above must
    catch it."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "with_plain_backward",
                        lambda kernel, plain, *inputs: kernel(*inputs))
    with pytest.raises(AssertionError, match="no autograd graph"):
        _hold_autograd(*AUTOGRAD_CASES[case](torch.bfloat16))


@pytest.mark.parametrize("name", [
    "qwen3-1.7b", "mamba2-130m", "granite-20b", "command-r-35b",
    "phi4-mini-3.8b", "musicgen-medium", "arctic-480b", "deepseek-v3-671b",
    "zamba2-7b", "llava-next-mistral-7b"])
def test_smoke_train_step_on_the_card_matches_torch_ref(cuda, name):
    """Two fused diffusion steps of a smoke config (f32, no remat), 4
    nodes, through the kernels against the torch-ref route: losses
    within 1e-4, the first step's gradients within rtol 1e-4 / atol
    1e-5, every leaf's gradient on every node nonzero, and the launches
    of each step: the LM kernels of a forward (``_plan_launches``) a
    node, twice under remat, one gossip_combine a communicated leaf;
    none on torch-ref.  The MoE plans run their dispatch's backward and
    the aux loss under autograd, zamba2 its group, llava its patch
    embeddings before the text."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.aggregation import (AggregationConfig,
                                                     _split_local)
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_batch
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, constant
    from repro_torch.utils.trees import tree_leaves
    cfg = get_config(name).smoke()
    params = steps.replicate_for_nodes(init_params(cfg, seed=0), 4)
    batch = {k: v.to("cuda") for k, v in make_batch(
        cfg, torch.Generator().manual_seed(2), 4, 2, 64).items()}
    agg = AggregationConfig(strategy="diffusion", local_patterns=("embed",))
    n_comm = sum(tree_leaves(_split_local(params, agg.local_patterns)))
    launches = {kernel: 4 * n * (2 if cfg.remat else 1)
                for kernel, n in _plan_launches(cfg).items()}
    _build.LAUNCHES.clear()
    _, grads = steps.node_value_and_grad(params, batch, cfg, 4)
    assert dict(_build.LAUNCHES) == launches
    with ops.backend_scope("torch-ref"):
        _, want = steps.node_value_and_grad(params, batch, cfg, 4)
    for got, ref in zip(tree_leaves(grads), tree_leaves(want)):
        _close(got, ref, dict(rtol=1e-4, atol=1e-5))
        assert all(bool(got[i].abs().max() > 0) for i in range(4))
    losses = []
    for route in ("cuda", "torch-ref"):
        opt = adamw(constant(1e-3))
        state = steps.TrainState(params, opt.init(params),
                                 torch.zeros((), dtype=torch.int32,
                                             device="cuda"))
        step = steps.make_train_step_fused(cfg, opt, agg, 4)
        with ops.backend_scope(route):
            got = []
            for _ in range(2):
                _build.LAUNCHES.clear()
                state, metrics = step(state, batch)
                got.append(metrics["loss_per_node"])
                if route == "cuda":
                    assert dict(_build.LAUNCHES) == {
                        **launches, "gossip_combine": n_comm}
                else:
                    assert not _build.LAUNCHES
        losses.append(torch.stack(got))
    _close(losses[0], losses[1], dict(rtol=1e-4, atol=1e-4))


def test_lint_budget_with_real_kernels_equals_the_recording(cuda):
    """JX001 on the simulator with the real kernels (no recording
    context): clean for all twelve programs, and each case's launches
    an iteration and outside the loop, by kernel, are the CPU
    recording's."""
    from repro_torch.analysis import harness, torchlint
    from repro_torch.core.program import get_program, program_names
    for name in program_names():
        card = harness.run_case(name, "simulator", device="cuda")
        cpu = harness.run_case(name, "simulator", record_ops=False)
        budget = get_program(name).dispatch_budget
        assert torchlint.check_dispatch_budget(card, budget) == [], name
        assert card.launches == cpu.launches, name
        assert card.launches_by_kernel == cpu.launches_by_kernel, name


@pytest.mark.parametrize("kind", ["prefill", "train", "train_ssm"])
def test_dryrun_counts_equal_real_launches(cuda, kind):
    """The dry run on the meta device (inside ``_build.recording()``)
    against the real step on the card, on one device (mesh (1, 1)): the kernel
    launches it counts equal the real step's ``_build.LAUNCHES``, and
    its argument bytes the real arguments' bytes exactly; a bf16 smoke
    model, remat on, two replicas for training."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, specs, steps
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.trees import tree_leaves
    arch = "mamba2-130m" if kind == "train_ssm" else "qwen3-1.7b"
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16",
                              remat=True)
    mesh = MeshShape(("data", "model"), (1, 1))
    g = torch.Generator(device="cuda").manual_seed(0)
    if kind == "prefill":
        rec = dryrun.run_one(arch, InputShape("p", 128, 2, "prefill"),
                             mesh=mesh, cfg=cfg)
        params = tfm.serving_params(tfm.init_params(cfg, device=cuda), cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 128),
                                         generator=g, device=cuda)}
        args = (params, batch)
        step = steps.make_prefill_step(cfg)
    else:
        rec = dryrun.run_one(arch, InputShape("t", 128, 4, "train"),
                             mesh=mesh, cfg=cfg, n_nodes=2)
        params = steps.replicate_for_nodes(
            tfm.init_params(cfg, device=cuda), 2)
        opt = specs.make_optimizer(cfg)
        state = steps.TrainState(params, opt.init(params),
                                 torch.zeros((), dtype=torch.int32,
                                             device=cuda))
        tok = torch.randint(0, cfg.vocab_size, (2, 2, 128), generator=g,
                            device=cuda)
        args = (state, {"tokens": tok, "labels": tok})
        step = steps.make_train_step_fused(cfg, opt,
                                           specs.make_aggregation(), 2)
    assert rec["memory"]["argument_bytes"] == sum(
        t.numel() * t.element_size() for t in tree_leaves(args))
    _build.LAUNCHES.clear()
    step(*args)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == rec["kernel_launches"]
