#!/usr/bin/env python3
"""Chip smoke check of the PyTorch/CUDA port (``repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure:

  1. card    — the card's name and power limit (nvidia-smi), torch/CUDA
               versions;
  2. build   — builds every CUDA kernel from ``src/repro_torch/kernels/
               csrc`` (one nvcc per source, in parallel);
  3. kernels — each kernel against its plain PyTorch version on the same
               inputs on the card, at the paper's Experiment 1 shape (the
               main path's), the Experiment 2 shape and a ragged shape;
               f32 and bf16 inputs, plus f64 through the engine op; the
               reference tolerances (rtol = atol = 1e-4 at f32, 5e-2 at
               bf16); kernel, plain and library times (median of CUDA-
               event-timed launch batches) beside the card's bound;
  4. main    — ``run_experiment`` on the EXPERIMENT1 preset (T_con=10,
               L=20, d=T=600, r=4, n=30, ER p=0.5 Metropolis, T_pm=30,
               T_GD=500) at float32 on the cuda backend, with the launch
               counts set to 0 just before and read just after; then the
               same spec and key on the torch-ref backend on the card,
               whose sd_max trace must agree (rtol 1e-4, atol 1e-5);
  5. profile — torch.profiler over 20 outer iterations: device time by
               kernel and the device's busy share;
  6. slice kernels — node_task_grad_tiles against its plain version at
               the sample-split fold of Experiment 1 (n = 15), Experiment
               2 and the ragged shape, f32 and bf16 (the tolerances
               above), f64 through ops.altgdmin_node_gradient;
               compress_topk and dequant against theirs BIT FOR BIT at
               (20, 600, 4), (100, 100, 10) and (3, 97, 3), tied rows
               included; times as in phase 3, with torch.mul(q, scale) as
               dequant's library call;
  7. path A — the same preset sample-split into two folds (n_folds=2),
               T_GD=500, cuda: launches node_task_gram 501,
               node_task_grad_tiles 500, mix_rows 500, node_fused_iter 0;
               sd_max against torch-ref on the card (rtol 1e-4, atol
               1e-5); convergence; a profile of 20 iterations;
  8. path B — dif_topk (compression_k=150, and =d), dif_quantized
               (int8) and dif_event (event_threshold=0.02) on the same
               preset, T_GD=500, T_con=10, cuda: compress_topk / dequant
               / mix_rows at 10·T_GD launches; finite outputs; sd_max
               below 0.65 / 0.5 / 0.6 of its first value (the
               reference's bounds); against torch-ref on the card over
               the whole trajectory (top-k at k=d, int8, event), or, for
               top-k at k=150, whose row selection round-off can flip
               (see PATH_B), reported over the first 50 iterations with
               the first parting iteration and held at the final sd_max
               (within 10 %); a profile of 20 iterations each;
  9. gossip kernels — gossip_combine against ref_gossip_combine at the
               mesh round's shape (n = d·r = 2400, K = 2 and K = 19), the
               roll form's (n = 20·600·4, K = 2), a ragged n and bf16,
               with the weights as Python floats and as a device tensor;
               f32 rtol = atol = 1e-6 (the reference's kernel tolerance),
               bf16 5e-2; times as in phase 3, with torch.addmv as the
               library call;
 10. roll   — roll_gossip at Experiment 1 width (Z (20, 600, 4), ring
               (−1, 1), T_con = 10) through the kernel, against torch-ref
               on the card and against stacked_product with the circulant
               W;
 11. mesh   — L = 20 ranks on the one card, spawned once over gloo
               (staged through host memory), each running the EXPERIMENT1
               preset through run_experiment(substrate="mesh") for the six
               stateless programs (T_GD = MESH_T_GD); every sd_max trace
               and rank 0's final U_nodes and B_nodes against the port's
               simulator on the card (rtol 1e-4, atol 1e-5),
               dif_altgdmin's geometric decay, each rank's launch
               counts against the program's DispatchBudget, and ms per
               iteration labelled with the transport.

Then the kernels line (each kernel's launches from its own path's run),
the card line, and the result line.  Exits non-
zero, printing no result, without a CUDA device or outside the repo.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit): HBM
# bandwidth, and float32 outside the tensor cores — the kernels' f32 FMAs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2),
       "float64": dict(rtol=1e-4, atol=1e-4)}     # the kernels compute in f32

# (L, tpn, n, d, r): Experiment 1 (the main path's shape), Experiment 2,
# and a ragged shape (d not a multiple of 32, r odd).
SHAPES = {"exp1": (20, 30, 30, 600, 4), "exp2": (100, 1, 50, 100, 10),
          "ragged": (3, 5, 20, 97, 3)}

SOURCES = {"node_fused_iter": "src/repro_torch/kernels/csrc/altgdmin_ls.cu",
           "node_task_gram": "src/repro_torch/kernels/csrc/altgdmin_ls.cu",
           "mix_rows": "src/repro_torch/kernels/csrc/gossip_axpy.cu",
           "node_task_grad_tiles":
               "src/repro_torch/kernels/csrc/altgdmin_ls.cu",
           "compress_topk": "src/repro_torch/kernels/csrc/compress.cu",
           "dequant": "src/repro_torch/kernels/csrc/compress.cu",
           "gossip_combine": "src/repro_torch/kernels/csrc/gossip_axpy.cu"}
REPLACES = {"node_fused_iter": "src/repro/kernels/altgdmin_ls.py:244",
            "node_task_gram": "src/repro/kernels/altgdmin_ls.py:306",
            "mix_rows": "src/repro/kernels/gossip_axpy.py:45",
            "node_task_grad_tiles": "src/repro/kernels/altgdmin_ls.py:375",
            "compress_topk": "src/repro/kernels/compress.py:64",
            "dequant": "src/repro/kernels/compress.py:89",
            "gossip_combine": "src/repro/kernels/gossip_axpy.py:73"}

# The sample-split fold of Experiment 1 (n = 30 split in two), and the
# (N, d, r, k) blocks of compress_topk: the dif_topk path's (k = d/4),
# Experiment 2's, and a ragged one at the two ends of k.
GRAD_SHAPES = {"exp1_fold": (20, 30, 15, 600, 4), "exp2": SHAPES["exp2"],
               "ragged": SHAPES["ragged"]}
TOPK_SHAPES = {"exp1": (20, 600, 4, 150), "exp2": (100, 100, 10, 25),
               "ragged_k1": (3, 97, 3, 1), "ragged_kd": (3, 97, 3, 97)}


# gossip_combine's (name, n, K, dtype, weights): the mesh round at
# Experiment 1 (n = d·r; K = 2 on a ring, 19 at ER p = 0.5), the roll
# form's operand (n = L·d·r, a ring), a ragged n, bf16.
COMBINE_CASES = (("mesh_K2", 2400, 2, "float32", "floats"),
                 ("mesh_K19", 2400, 19, "float32", "tensor"),
                 ("mesh_K19_floats", 2400, 19, "float32", "floats"),
                 ("roll_K2", 48000, 2, "float32", "floats"),
                 ("ragged_K19", 2401, 19, "float32", "tensor"),
                 ("mesh_K19_bf16", 2400, 19, "bfloat16", "tensor"),
                 ("ragged_K2_bf16", 2401, 2, "bfloat16", "floats"))
COMBINE_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
               "bfloat16": TOL["bfloat16"]}

# The mesh phase: every stateless program, its outer iterations, and
# the seconds the 20 ranks get to report.  T_GD is cut from the preset's
# 500 to 120 (≥ 101, for dif_altgdmin's decay check at iteration 100):
# 20 ranks time-sharing one card take 0.15-0.41 s an iteration, so 500
# iterations of the six programs would not fit the script's time limit
# (PERF.md).
MESH_SOLVERS = ("dif_altgdmin", "dec_altgdmin", "dgd_altgdmin",
                "exact_diffusion", "beyond_central", "centralized_altgdmin")
MESH_T_GD = 120
MESH_TIMEOUT = 600
# rank 0's final U_nodes and B_nodes against the simulator's on the card:
# the trajectory tolerance the sd_max traces are held to
MESH_TOL = dict(rtol=1e-4, atol=1e-5)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, *, reps: int = 15, batch: int = 20) -> float:
    """Median device time of one call of ``fn``.  Each batch of calls is
    queued behind a device-side sleep, so the events time the calls back
    to back on the card rather than the host's pace of launching them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)           # cycles: outlasts the queueing
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def nbytes(*ts) -> int:
    """Bytes of the tensors: each input read once, each output written
    once."""
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, got, want, tol: dict, what: str) -> float:
    torch.cuda.synchronize()                    # a fault shows up here
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
    worst = float(err.max())
    require(ok and bool(torch.isfinite(got).all()),
            f"{what}: kernel disagrees with its plain version "
            f"(max abs err {worst:.3e}, tolerance {tol})")
    return worst


def pair_err(torch, got, want, tol: dict, what: str) -> float:
    """max_err over the two outputs of a kernel."""
    return max(max_err(torch, g, w, tol, what) for g, w in zip(got, want))


def instance(torch, shape, dtype, seed):
    L, tpn, n, d, r = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((L, tpn, n, d), generator=g, device="cuda")
    U = torch.linalg.qr(torch.randn((L, d, r), generator=g,
                                    device="cuda"))[0]
    y = torch.randn((L, tpn, n), generator=g, device="cuda")
    return X.to(dtype), U.to(dtype), y.to(dtype)


def check_kernels(torch):
    from repro_torch.distributed import graphs, mixing
    from repro_torch.kernels import altgdmin_ls, gossip_axpy, ops, ref

    rows = {}
    for sname, shape in SHAPES.items():
        L, tpn, n, d, r = shape
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            X, U, y = instance(torch, shape, dtype, seed=len(rows))
            tol = TOL[dname]
            what = f"{sname} {dname}"
            B, tiles = altgdmin_ls.node_fused_iter(X, U, y)
            e_fused = pair_err(torch, (B, tiles), ref.ref_fused_iter(X, U, y),
                               tol, f"node_fused_iter {what}")
            G, c = altgdmin_ls.node_task_gram(X, U, y)
            e_gram = pair_err(torch, (G, c), ref.ref_task_gram(X, U, y), tol,
                              f"node_task_gram {what}")
            # mix_rows at this shape's AGREE operand: W^{T_con} of an ER
            # graph's Metropolis weights, Z = the (L, d*r) iterate
            W = mixing.metropolis_weights(graphs.erdos_renyi(L, 0.5, seed=0))
            Wp = torch.linalg.matrix_power(
                torch.as_tensor(W, dtype=torch.float32, device="cuda"), 10)
            Z = U.reshape(L, d * r)
            out = gossip_axpy.mix_rows(Wp, Z)
            require(out.dtype == Z.dtype, "mix_rows must return Z's dtype")
            e_mix = max_err(torch, out, ref.ref_mix_rows(Wp, Z), tol,
                            f"mix_rows {what}")
            check = {"shape": sname, "dtype": dname,
                     "max_abs_err": {"node_fused_iter": e_fused,
                                     "node_task_gram": e_gram,
                                     "mix_rows": e_mix}}
            if dname == "float32":
                check["timing"] = timings(torch, X, U, y, Wp, Z, B, tiles,
                                          G, c, out)
            rows[(sname, dname)] = check
            emit("kernels", **check)
        # float64 through the engine op: converted to f32 for the kernel,
        # as the TPU kernel's body does
        X, U, y = instance(torch, shape, torch.float64, seed=99)
        e64 = pair_err(
            torch, ops.altgdmin_fused_step(X, U, y, backend="cuda"),
            ops.altgdmin_fused_step(X, U, y, backend="torch-ref"),
            TOL["float64"], f"altgdmin_fused_step {sname} float64")
        emit("kernels", shape=sname, dtype="float64",
             max_abs_err={"altgdmin_fused_step": e64})
    return rows


def timing(torch, kernel, plain, args, n_bytes, flops, library=None):
    """Kernel, plain and library ms of one call on ``args``, and the
    card's bound for its bytes and operations."""
    b, by = bound(n_bytes, flops)
    return dict(ms=device_ms(torch, lambda: kernel(*args)),
                plain_ms=device_ms(torch, lambda: plain(*args)),
                library_ms=(device_ms(torch, lambda: library(*args))
                            if library else None),
                bound_ms=b, bound_by=by)


def timings(torch, X, U, y, Wp, Z, B, tiles, G, c, out):
    """Kernel, plain and library ms, and the bound, at one f32 shape.
    Bytes count each input read once and each output written once."""
    from repro_torch.kernels import altgdmin_ls, gossip_axpy, ref
    L, tpn, n, d = X.shape
    r = U.shape[2]
    tasks = L * tpn
    flops_gram = tasks * (2 * n * d * r + 2 * n * r * r + 2 * n * r)
    flops_fused = flops_gram + tasks * (r ** 3 / 3 + 2 * r * r + 2 * n * r
                                        + 2 * n * d + d * r)
    return {
        "node_fused_iter": timing(
            torch, altgdmin_ls.node_fused_iter, ref.ref_fused_iter,
            (X, U, y), nbytes(X, U, y, B, tiles), flops_fused),
        "node_task_gram": timing(
            torch, altgdmin_ls.node_task_gram, ref.ref_task_gram, (X, U, y),
            nbytes(X, U, y, G, c), flops_gram),
        "mix_rows": timing(
            torch, gossip_axpy.mix_rows, ref.ref_mix_rows, (Wp, Z),
            nbytes(Wp, Z, out), 2 * Z.shape[0] ** 2 * Z.shape[1],
            library=torch.matmul)}


def main_path(torch):
    from repro_torch.api import EngineSpec, materialize, run_experiment
    from repro_torch.configs.paper import EXPERIMENT1, to_spec
    from repro_torch.kernels import _build

    cfg = EXPERIMENT1[0]
    require(cfg.T_con == 10, "EXPERIMENT1[0] is the T_con=10 preset")
    spec = to_spec(cfg, dtype="float32", backend="cuda")
    T_GD, (L, tpn, n, d, r) = cfg.T_GD, SHAPES["exp1"]

    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    mat = materialize(spec, key=0, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trace = run_experiment(spec, key=0, materialized=mat)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(_build.LAUNCHES)

    want = {"node_fused_iter": T_GD, "mix_rows": T_GD, "node_task_gram": 1}
    require(all(launches.get(k, 0) == v for k, v in want.items()),
            f"main path launch counts {launches}, want {want}")
    for name, arr, shape in (
            ("sd_max", trace.sd_max, (T_GD,)),
            ("sd_mean", trace.sd_mean, (T_GD,)),
            ("spread", trace.spread, (T_GD,)),
            ("time_axis", trace.time_axis, (T_GD,)),
            ("U_nodes", trace.U_nodes.cpu().numpy(), (L, d, r)),
            ("B_nodes", trace.B_nodes.cpu().numpy(), (L, tpn, r))):
        require(tuple(arr.shape) == shape and bool(np.isfinite(arr).all()),
            f"{name}: shape {tuple(arr.shape)} (want {shape}) or not finite")
    require(trace.final_sd_max < 1e-3 * trace.sd_max[0],
            f"dif_altgdmin did not converge: sd_max {trace.sd_max[0]:.3e} "
            f"→ {trace.final_sd_max:.3e}")

    spec_ref = dataclasses.replace(spec, engine=EngineSpec(backend="torch-ref"))
    t3 = time.perf_counter()
    trace_ref = run_experiment(spec_ref, key=0, materialized=mat)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    diff = np.abs(trace.sd_max - trace_ref.sd_max)
    require(bool(np.all(diff <= 1e-5 + 1e-4 * np.abs(trace_ref.sd_max))),
            f"sd_max of the cuda run disagrees with torch-ref "
            f"(max abs diff {diff.max():.3e})")
    emit("main", preset=cfg.name, dtype="float32", T_GD=T_GD,
         launches=launches, final_sd_max=trace.final_sd_max,
         first_sd_max=float(trace.sd_max[0]),
         final_spread=float(trace.spread[-1]),
         sd_max_vs_torch_ref_max_abs_diff=float(diff.max()),
         materialize_s=t1 - t0, run_s=t2 - t1,
         ms_per_iter=(t2 - t1) / T_GD * 1e3,
         torch_ref_run_s=t4 - t3,
         torch_ref_ms_per_iter=(t4 - t3) / T_GD * 1e3,
         total_s=t2 - t0)
    return spec, mat, launches


def profile(torch, spec, mat, *, label="profile"):
    from repro_torch.api import run_experiment
    from torch.profiler import ProfilerActivity, profile as tprofile

    iters = 20
    short = dataclasses.replace(
        spec, solver=dataclasses.replace(spec.solver, T_GD=iters))
    run_experiment(short, key=0, materialized=mat)        # warm
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_experiment(short, key=0, materialized=mat)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    emit("profile", path=label, iterations=iters, wall_ms=wall_ms,
         device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms if wall_ms else None,
         top_kernels_ms=[[name[:90], ms] for name, ms in top])


def check_slice_kernels(torch):
    """Phase 6: this slice's three kernels against their plain versions,
    with the times of each at the shape its path gives it."""
    from repro_torch.kernels import altgdmin_ls, compress, ops, ref

    errs = {"node_task_grad_tiles": 0.0, "compress_topk": 0.0,
            "dequant": 0.0}
    times = {}
    for sname, shape in GRAD_SHAPES.items():
        L, tpn, n, d, r = shape
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            X, U, y = instance(torch, shape, dtype, seed=7)
            B = torch.randn((L, tpn, r), device="cuda")
            tiles = altgdmin_ls.node_task_grad_tiles(X, U, B, y)
            want = ref.ref_node_grad_tiles(X, U, B, y)
            e = max_err(torch, tiles, want, TOL[dname],
                        f"node_task_grad_tiles {sname} {dname}")
            if dname == "float32":
                errs["node_task_grad_tiles"] = max(
                    errs["node_task_grad_tiles"], e)
            emit("slice_kernels", kernel="node_task_grad_tiles",
                 shape=sname, dtype=dname, max_abs_err=e)
            if sname == "exp1_fold" and dname == "float32":
                times["node_task_grad_tiles"] = timing(
                    torch, altgdmin_ls.node_task_grad_tiles,
                    ref.ref_node_grad_tiles, (X, U, B, y),
                    nbytes(X, U, B, y, tiles),
                    L * tpn * (2 * n * d * r + 2 * n * r + 2 * n * d
                               + d * r))
        X, U, y = instance(torch, shape, torch.float64, seed=8)
        B = torch.randn((L, tpn, r), device="cuda", dtype=torch.float64)
        e64 = max_err(
            torch, ops.altgdmin_node_gradient(X, U, B, y, backend="cuda"),
            ops.altgdmin_node_gradient(X, U, B, y, backend="torch-ref"),
            TOL["float64"], f"altgdmin_node_gradient {sname} float64")
        emit("slice_kernels", kernel="altgdmin_node_gradient", shape=sname,
             dtype="float64", max_abs_err=e64)

    for sname, (N, d, r, k) in TOPK_SHAPES.items():
        for dname in ("float32", "bfloat16"):
            g = torch.Generator(device="cuda").manual_seed(d + k)
            M = torch.randn((N, d, r), generator=g, device="cuda").to(
                getattr(torch, dname))
            M[:, d // 2] = M[:, 0]           # exact ties: index order
            M[:, d - 1] = M[:, 0]
            vals, idx = compress.compress_topk(M, k)
            v_ref, i_ref = ref.ref_compress_topk(M, k)
            torch.cuda.synchronize()
            require(torch.equal(idx, i_ref) and torch.equal(vals, v_ref),
                    f"compress_topk {sname} {dname} differs from its plain "
                    f"version")
            emit("slice_kernels", kernel="compress_topk", shape=sname,
                 dtype=dname, bitwise_equal=True)
            if sname == "exp1" and dname == "float32":
                times["compress_topk"] = timing(
                    torch, compress.compress_topk, ref.ref_compress_topk,
                    (M, k), nbytes(M, vals, idx), 2 * N * d * r + N * d)
        for dname in ("float32", "bfloat16"):
            g = torch.Generator(device="cuda").manual_seed(N)
            q = torch.randint(-127, 128, (N, d, r), generator=g,
                              device="cuda", dtype=torch.int8)
            scale = (torch.rand((N, 1, 1), generator=g, device="cuda")
                     + 1e-3).to(getattr(torch, dname))
            out = compress.dequant(q, scale)
            want = ref.ref_dequant(q, scale)
            torch.cuda.synchronize()
            require(out.dtype == want.dtype and torch.equal(out, want),
                    f"dequant {sname} {dname} differs from its plain "
                    f"version")
            emit("slice_kernels", kernel="dequant", shape=sname,
                 dtype=dname, bitwise_equal=True)
            if sname == "exp1" and dname == "float32":
                times["dequant"] = timing(
                    torch, compress.dequant, ref.ref_dequant, (q, scale),
                    nbytes(q, scale, out), q.numel(), library=torch.mul)
    emit("slice_kernels", timing=times)
    return errs, times


def run_path(torch, spec, mat, want, *, name):
    """Drive ``run_experiment`` on the cuda backend with the launch
    counts set to 0 just before and read just after; check the counts
    against ``want``, the outputs' shapes and finiteness; then the same
    spec and materialization on torch-ref.  → (trace, torch-ref trace,
    launches, seconds per run of each)."""
    from repro_torch.api import EngineSpec, run_experiment
    from repro_torch.kernels import _build

    T_GD, p = spec.solver.T_GD, spec.problem
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    trace = run_experiment(spec, key=0, materialized=mat)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    require(all(launches.get(k, 0) == v for k, v in want.items()),
            f"{name}: launch counts {launches}, want {want}")
    for field, arr, shape in (
            ("sd_max", trace.sd_max, (T_GD,)),
            ("spread", trace.spread, (T_GD,)),
            ("time_axis", trace.time_axis, (T_GD,)),
            ("U_nodes", trace.U_nodes.cpu().numpy(), (p.L, p.d, p.r)),
            ("B_nodes", trace.B_nodes.cpu().numpy(),
             (p.L, p.T // p.L, p.r))):
        require(tuple(arr.shape) == shape and bool(np.isfinite(arr).all()),
                f"{name} {field}: shape {tuple(arr.shape)} (want {shape}) "
                f"or not finite")
    spec_ref = dataclasses.replace(spec,
                                   engine=EngineSpec(backend="torch-ref"))
    t2 = time.perf_counter()
    trace_ref = run_experiment(spec_ref, key=0, materialized=mat)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return trace, trace_ref, launches, t1 - t0, t3 - t2


def agree_upto(a, b, upto=None) -> tuple[bool, float, int | None]:
    """Whether two sd_max traces agree (rtol 1e-4, atol 1e-5) over their
    first ``upto`` iterations, the max abs difference there, and the
    first iteration where they part (None if they never do)."""
    ok = np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)
    parts = np.flatnonzero(~ok)
    first = int(parts[0]) if parts.size else None
    return bool(ok[:upto].all()), float(np.abs(a - b)[:upto].max()), first


def path_a(torch):
    """Phase 7: sample-split Dif-AltGDmin at Experiment 1."""
    from repro_torch.api import materialize
    from repro_torch.configs.paper import EXPERIMENT1, to_spec

    cfg = EXPERIMENT1[0]
    spec = to_spec(cfg, dtype="float32", backend="cuda")
    spec = dataclasses.replace(spec, problem=dataclasses.replace(
        spec.problem, n_folds=2))
    T_GD = cfg.T_GD
    mat = materialize(spec, key=0, device="cuda")
    want = {"node_task_gram": T_GD + 1, "node_task_grad_tiles": T_GD,
            "mix_rows": T_GD, "node_fused_iter": 0}
    trace, trace_ref, launches, run_s, ref_s = run_path(
        torch, spec, mat, want, name="path A")
    ok, diff, first = agree_upto(trace.sd_max, trace_ref.sd_max)
    emit("path_a", preset=cfg.name, n_folds=2, dtype="float32", T_GD=T_GD,
         launches=launches, first_sd_max=float(trace.sd_max[0]),
         final_sd_max=trace.final_sd_max,
         final_spread=float(trace.spread[-1]),
         sd_max_vs_torch_ref_max_abs_diff=diff, run_s=run_s,
         ms_per_iter=run_s / T_GD * 1e3, torch_ref_run_s=ref_s,
         torch_ref_ms_per_iter=ref_s / T_GD * 1e3,
         first_parting_iteration=first)
    require(ok, f"path A: sd_max disagrees with torch-ref (max abs diff "
                f"{diff:.3e}, first at iteration {first})")
    require(trace.final_sd_max < 1e-2 * trace.sd_max[0],
            f"path A did not converge: sd_max {trace.sd_max[0]:.3e} → "
            f"{trace.final_sd_max:.3e}")
    profile(torch, spec, mat, label="path_a")
    return launches


# (solver, knobs, kernel counted per round, the reference's convergence
# bound, whether the whole sd_max trajectory is held to torch-ref).  Row
# selection at k < d is discontinuous: once the f32 round-off of
# mix_rows (against the plain product's) reorders two nearly equal row
# norms of Z − x̂ — a difference of nearly equal numbers — the two runs
# select different rows and part.  At k = 150 that happens within the
# first 50 iterations, so that run reports its agreement over them and
# its first parting iteration and is held to its final value (within
# 10 %); the same path at k = d, whose selection cannot flip, is held
# over the whole trajectory.
PATH_B = (("dif_topk", {"compression_k": 150}, "compress_topk", 0.65, False),
          ("dif_topk", {"compression_k": 600}, "compress_topk", 0.65, True),
          ("dif_quantized", {"compression": "int8"}, "dequant", 0.5, True),
          ("dif_event", {"event_threshold": 0.02}, None, 0.6, True))


def path_b(torch, spec, mat):
    """Phase 8: the compressed trio at Experiment 1, on the dense path's
    materialization."""
    T_GD, T_con = spec.solver.T_GD, spec.solver.T_con
    p_d = spec.problem.d
    launches_by_kernel, failures = {}, []
    for name, kw, kernel, shrink, held in PATH_B:
        upto = None if held else 50
        s = dataclasses.replace(spec, solver=dataclasses.replace(
            spec.solver, name=name, **kw))
        want = {"mix_rows": T_con * T_GD, "node_fused_iter": T_GD,
                "node_task_gram": 1, "node_task_grad_tiles": 0,
                "compress_topk": 0, "dequant": 0}
        if kernel:
            want[kernel] = T_con * T_GD
        trace, trace_ref, launches, run_s, ref_s = run_path(
            torch, s, mat, want, name=name)
        if kernel:
            launches_by_kernel.setdefault(kernel, launches.get(kernel, 0))
        ok, diff, first = agree_upto(trace.sd_max, trace_ref.sd_max, upto)
        final_rel = (abs(trace.final_sd_max - trace_ref.final_sd_max)
                     / trace_ref.final_sd_max)
        emit("path_b", solver=name, knobs=kw, dtype="float32", T_GD=T_GD,
             T_con=T_con, launches=launches,
             first_sd_max=float(trace.sd_max[0]),
             final_sd_max=trace.final_sd_max,
             torch_ref_final_sd_max=trace_ref.final_sd_max,
             final_rel_diff_vs_torch_ref=final_rel,
             compared_iterations=upto or T_GD, trajectory_held=held,
             agrees_over_compared=ok,
             sd_max_vs_torch_ref_max_abs_diff=diff,
             first_parting_iteration=first,
             mean_send_frac=(float(np.mean(trace.send_frac))
                             if trace.send_frac is not None else None),
             run_s=run_s, ms_per_iter=run_s / T_GD * 1e3,
             torch_ref_run_s=ref_s,
             torch_ref_ms_per_iter=ref_s / T_GD * 1e3)
        # every solver runs before a failed check raises, so one run
        # reports all three
        if held and not ok:
            failures.append(
                f"{name} {kw}: sd_max disagrees with torch-ref (max abs "
                f"diff {diff:.3e}, first at iteration {first})")
        if not held and final_rel > 0.1:
            failures.append(f"{name}: final sd_max {trace.final_sd_max:.3e}"
                            f" vs torch-ref {trace_ref.final_sd_max:.3e}")
        if not trace.final_sd_max < shrink * trace.sd_max[0]:
            failures.append(
                f"{name} did not converge: sd_max {trace.sd_max[0]:.3e} → "
                f"{trace.final_sd_max:.3e} (bound {shrink})")
        if kw.get("compression_k") != p_d:       # k = d: no own profile
            profile(torch, s, mat, label=f"path_b_{name}")
    require(not failures, "; ".join(failures))
    return launches_by_kernel



def check_gossip_kernel(torch):
    """Phase 9: gossip_combine against its plain version at the mesh and
    roll shapes; the time of each f32 case (the kernel row's numbers are
    the mesh round's at K = 19, the Experiment 1 graph's shift count)."""
    from repro_torch.kernels import gossip_axpy, ops, ref

    errs, times = [], {}
    for name, n, K, dname, wkind in COMBINE_CASES:
        g = torch.Generator(device="cuda").manual_seed(n + K)
        dtype = getattr(torch, dname)
        z = torch.randn(n, generator=g, device="cuda").to(dtype)
        nbrs = torch.randn((K, n), generator=g, device="cuda").to(dtype)
        wt = torch.rand(K + 1, generator=g, device="cuda")
        wt = wt / wt.sum()
        w_floats = tuple(wt.tolist())
        # the op takes the case's own weights: a float tuple it uploads,
        # or the device tensor as it is
        weights = wt if wkind == "tensor" else w_floats
        out = ops.gossip_combine(z, nbrs, weights, backend="cuda")
        want = ref.ref_gossip_combine(z, nbrs, weights)
        require(out.dtype == dtype, "gossip_combine must return z's dtype")
        e = max_err(torch, out, want, COMBINE_TOL[dname],
                    f"gossip_combine {name}")
        bitwise = bool(torch.equal(out, want))
        if dname == "float32":
            errs.append(e)
            w0, wk = float(w_floats[0]), wt[1:]
            times[name] = timing(
                torch, gossip_axpy.gossip_combine, ref.ref_gossip_combine,
                (z, nbrs, wt), nbytes(z, nbrs, wt, out), 2 * (K + 1) * n,
                library=lambda z_, nb, _w: torch.addmv(z_, nb.T, wk,
                                                       beta=w0))
        emit("gossip_kernels", case=name, n=n, K=K, dtype=dname,
             weights=wkind, max_abs_err=e, bitwise_equal=bitwise,
             timing=times.get(name))
    return max(errs), times["mesh_K19"]


def roll_form(torch):
    """Phase 10: roll_gossip at Experiment 1 width through the kernel."""
    from repro_torch.distributed import mixing
    from repro_torch.distributed.consensus import stacked_product
    from repro_torch.distributed.gossip import roll_gossip
    from repro_torch.kernels import _build

    L, d, r, T_con = 20, 600, 4, 10
    g = torch.Generator(device="cuda").manual_seed(20)
    Z = torch.randn((L, d, r), generator=g, device="cuda")
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = roll_gossip(Z, T_con, (-1, 1), backend="cuda")
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    require(launches == {"gossip_combine": T_con},
            f"roll form launches {launches}, want {T_con} gossip_combine")
    plain = roll_gossip(Z, T_con, (-1, 1), backend="torch-ref")
    W = torch.as_tensor(mixing.circulant_weights(L, (-1, 1)),
                        dtype=torch.float32, device="cuda")
    dense = stacked_product(Z, W, T_con)
    e_plain = max_err(torch, out, plain, COMBINE_TOL["float32"],
                      "roll_gossip vs torch-ref")
    # against cuBLAS's products the sums run in another order: f32
    # round-off over ten rounds
    e_dense = max_err(torch, out, dense, dict(rtol=1e-5, atol=1e-5),
                      "roll_gossip vs stacked_product")
    emit("roll", shape=[L, d, r], shifts=[-1, 1], T_con=T_con,
         launches=launches, max_abs_err_vs_torch_ref=e_plain,
         bitwise_equal_torch_ref=bool(torch.equal(out, plain)),
         max_abs_err_vs_stacked_product=e_dense, first_call_ms=run_ms)
    return launches["gossip_combine"]


def mesh_phase(torch, spec, mat, *, T_GD=MESH_T_GD, L=20,
               timeout=MESH_TIMEOUT):
    """Phase 11: the six stateless programs on an L-rank gloo mesh on the
    one card, each rank running its node through run_experiment(
    substrate="mesh"); held against the port's simulator on the card.
    The kernels are built already (phase 2), so ranks only load them."""
    from repro_torch.api import run_experiment
    from repro_torch.api.runner import run_on_mesh
    from repro_torch.core.program import get_program
    from repro_torch.distributed.consensus import (get_rule,
                                                   mesh_weights_from_matrix)
    from repro_torch.distributed.mesh import spawn

    require(spec.problem.L == L, f"the preset has L={spec.problem.L}")
    device = mat.Xg.device.type
    specs = [dataclasses.replace(spec, substrate="mesh",
                                 solver=dataclasses.replace(
                                     spec.solver, name=name, T_GD=T_GD))
             for name in MESH_SOLVERS]
    t0 = time.perf_counter()
    ranks = spawn(run_on_mesh, L, args=(device, [s.to_dict() for s in specs],
                                        0),
                  backend="gloo", device=device, timeout=timeout)
    spawn_s = time.perf_counter() - t0
    K = {"W": len(mesh_weights_from_matrix(mat.W)[0]),
         "adj": len(mesh_weights_from_matrix(mat.adj)[0]), "none": 0}
    failures, launches_combine = [], 0
    for i, s in enumerate(specs):
        name = s.solver.name
        hw = ranks[0][i]
        for g in range(1, L):
            require(np.array_equal(ranks[g][i]["U_nodes"], hw["U_nodes"])
                    and np.array_equal(ranks[g][i]["sd_max"], hw["sd_max"]),
                    f"mesh {name}: rank {g}'s result differs from rank 0's")
        prog = get_program(name)
        rounds = get_rule(prog.combine).signature(s.solver.T_con).rounds_per_iter
        per_iter = prog.dispatch_budget.per_iter("mesh", rounds,
                                                 K[prog.topology], 1)
        n_combine = T_GD * rounds if prog.mixer != "central" else 0
        want = {"node_fused_iter": T_GD, "node_task_gram": 1,
                "gossip_combine": n_combine}
        for g in range(L):
            got = ranks[g][i]["launches"]
            require(all(got.get(k, 0) == v for k, v in want.items())
                    and got.get("node_fused_iter", 0)
                    + got.get("gossip_combine", 0) == per_iter * T_GD,
                    f"mesh {name} rank {g}: launches {got}, want {want} "
                    f"({per_iter} a iteration by the DispatchBudget)")
        if name == "dif_altgdmin":
            launches_combine = hw["launches"].get("gossip_combine", 0)
        sim = run_experiment(dataclasses.replace(s, substrate="simulator"),
                             key=0, materialized=mat)
        sd, sd_sim = hw["sd_max"], sim.sd_max
        ok, diff, first = agree_upto(sd, sd_sim)
        # the iterates themselves, not only their worst subspace distance
        mats = {}
        for field in ("U_nodes", "B_nodes"):
            got_f = hw[field]
            want_f = getattr(sim, field).cpu().numpy()
            if field == "U_nodes" and not prog.stacked:
                # the fusion center's simulator carries one (d, r) iterate
                want_f = np.broadcast_to(want_f, got_f.shape)
            mats[field] = (
                got_f.shape == want_f.shape
                and bool(np.allclose(got_f, want_f, **MESH_TOL)),
                float(np.abs(got_f - want_f).max())
                if got_f.shape == want_f.shape else float("inf"))
        require(sd.shape == (T_GD,) and bool(np.isfinite(sd).all())
                and hw["U_nodes"].shape == tuple(mat.init.U0.shape)
                and bool(np.isfinite(hw["U_nodes"]).all()),
                f"mesh {name}: outputs of the wrong shape or not finite")
        emit("mesh", solver=name, L=L, T_GD=T_GD, T_con=s.solver.T_con,
             preset_T_GD=spec.solver.T_GD,
             T_GD_cut=(f"from the preset's {spec.solver.T_GD} to fit the "
                       f"script's time limit" if T_GD != spec.solver.T_GD
                       else None),
             transport=hw["transport"],
             ms_per_iter=hw["seconds"] / T_GD * 1e3,
             ms_per_iter_label=f"rank 0, {hw['transport']}",
             stage_ms_per_iter=hw["transport_s"].get("stage_s", 0.0)
             / T_GD * 1e3,
             wire_ms_per_iter=hw["transport_s"].get("wire_s", 0.0)
             / T_GD * 1e3,
             launches_rank0=hw["launches"],
             first_sd_max=float(sd[0]), final_sd_max=float(sd[-1]),
             sim_final_sd_max=float(sd_sim[-1]),
             sd_max_vs_simulator_max_abs_diff=diff,
             first_parting_iteration=first,
             U_nodes_vs_simulator_max_abs_diff=mats["U_nodes"][1],
             B_nodes_vs_simulator_max_abs_diff=mats["B_nodes"][1],
             spawn_s=spawn_s)
        if not ok:
            failures.append(f"{name}: sd_max disagrees with the simulator "
                            f"(max abs diff {diff:.3e}, first at {first})")
        for field, (close, err) in mats.items():
            if not close:
                failures.append(f"{name}: {field} disagrees with the "
                                f"simulator (max abs diff {err:.3e})")
        if name == "dif_altgdmin":
            if not (T_GD > 100 and sd[50] < 0.5 * sd[0]
                    and sd[100] < 0.5 * sd[50]):
                failures.append(f"dif_altgdmin: no geometric decay, sd_max "
                                f"{sd[0]:.3e} / {sd[min(50, T_GD - 1)]:.3e} "
                                f"/ {sd[min(100, T_GD - 1)]:.3e}")
            if T_GD == 500 and not sd[-1] < 1e-3 * sd[0]:
                failures.append(f"dif_altgdmin did not converge: {sd[0]:.3e}"
                                f" → {sd[-1]:.3e}")
    require(not failures, "; ".join(failures))
    return launches_combine


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the repository root (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # plain float32 products in full precision on the card (no TF32), so
    # the plain versions are a fair yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    emit("card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    ptxas = [line.strip() for name in _build.SOURCES
             for line in _build.build_log(name).splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    rows = check_kernels(torch)
    spec, mat, launches = main_path(torch)
    profile(torch, spec, mat, label="main")
    slice_errs, slice_timing = check_slice_kernels(torch)
    launches_a = path_a(torch)
    launches_b = path_b(torch, spec, mat)
    combine_err, combine_timing = check_gossip_kernel(torch)
    roll_form(torch)
    launches_mesh = mesh_phase(torch, spec, mat)

    main_row = rows[("exp1", "float32")]
    kernels = []
    for name in ("node_fused_iter", "mix_rows", "node_task_gram"):
        errs = [row["max_abs_err"][name] for key, row in rows.items()
                if key[1] == "float32"]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": max(errs),
                        **main_row["timing"][name]})
    slice_launches = {"node_task_grad_tiles":
                      launches_a["node_task_grad_tiles"], **launches_b}
    for name in ("node_task_grad_tiles", "compress_topk", "dequant"):
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": slice_launches[name],
                        "max_abs_err": slice_errs[name],
                        **slice_timing[name]})
    kernels.append({"name": "gossip_combine", "route": "cuda",
                    "source": SOURCES["gossip_combine"],
                    "replaces": REPLACES["gossip_combine"],
                    "launches": launches_mesh, "max_abs_err": combine_err,
                    **combine_timing})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
