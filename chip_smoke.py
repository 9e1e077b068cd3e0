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
               kernel and the device's busy share.

Then the kernels line, the card line, and the result line.  Exits non-
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
           "mix_rows": "src/repro_torch/kernels/csrc/gossip_axpy.cu"}
REPLACES = {"node_fused_iter": "src/repro/kernels/altgdmin_ls.py:244",
            "node_task_gram": "src/repro/kernels/altgdmin_ls.py:306",
            "mix_rows": "src/repro/kernels/gossip_axpy.py:45"}


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


def bound(nbytes: int, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
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


def timings(torch, X, U, y, Wp, Z, B, tiles, G, c, out):
    """Kernel, plain and library ms, and the bound, at one f32 shape.
    Bytes count each input read once and each output written once."""
    from repro_torch.kernels import altgdmin_ls, gossip_axpy, ref
    L, tpn, n, d = X.shape
    r = U.shape[2]
    tasks = L * tpn

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    flops_gram = tasks * (2 * n * d * r + 2 * n * r * r + 2 * n * r)
    flops_fused = flops_gram + tasks * (r ** 3 / 3 + 2 * r * r + 2 * n * r
                                        + 2 * n * d + d * r)
    res = {}
    b, by = bound(nb(X, U, y, B, tiles), flops_fused)
    res["node_fused_iter"] = dict(
        ms=device_ms(torch, lambda: altgdmin_ls.node_fused_iter(X, U, y)),
        plain_ms=device_ms(torch, lambda: ref.ref_fused_iter(X, U, y)),
        library_ms=None, bound_ms=b, bound_by=by)
    b, by = bound(nb(X, U, y, G, c), flops_gram)
    res["node_task_gram"] = dict(
        ms=device_ms(torch, lambda: altgdmin_ls.node_task_gram(X, U, y)),
        plain_ms=device_ms(torch, lambda: ref.ref_task_gram(X, U, y)),
        library_ms=None, bound_ms=b, bound_by=by)
    b, by = bound(nb(Wp, Z, out), 2 * Z.shape[0] ** 2 * Z.shape[1])
    res["mix_rows"] = dict(
        ms=device_ms(torch, lambda: gossip_axpy.mix_rows(Wp, Z)),
        plain_ms=device_ms(torch, lambda: ref.ref_mix_rows(Wp, Z)),
        library_ms=device_ms(torch, lambda: torch.matmul(Wp, Z)),
        bound_ms=b, bound_by=by)
    return res


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


def profile(torch, spec, mat):
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
    emit("profile", iterations=iters, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms if wall_ms else None,
         top_kernels_ms=[[name[:90], ms] for name, ms in top])


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
    profile(torch, spec, mat)

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
