"""Few-shot personalization serving on the PyTorch/CUDA port — the
paper's product story, end to end (the port's counterpart of
``serve_personalize.py``).

1. Train Dif-AltGDmin while PUBLISHING the representation: the runner's
   ``checkpoint_every`` hook writes crash-safe U snapshots (the spectral
   init at step 0, then every k outer iterations).
2. Serve a fixed cohort of new users (each with few-shot data (X_new,
   y_new)) from every published checkpoint in order — the drifting-U
   mode, where the batched min-B engine hot-swaps to fresher U's and the
   personalized-regressor error θ̂ = U b_new against θ* = U* b* falls
   checkpoint over checkpoint.  Beside it, the cohort's heads and the
   gradient of its least-squares loss at the served U through the
   single-basis ops (``ops.altgdmin_minimize_B``,
   ``ops.altgdmin_gradient``): the gradient shrinks as U converges.
3. Run the closed-loop deadline batcher on the final U for the serving
   telemetry (batch sizes, p50/p99 latency, shed count).

Runs on the card unless asked for the CPU:

  PYTHONPATH=src python examples/serve_personalize_torch.py [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.api import (
    ExperimentSpec, InitSpec, ProblemSpec, SolverSpec, TopologySpec,
    run_experiment,
)
from repro_torch.api.runner import resolve_device
from repro_torch.kernels import ops
from repro_torch.serving import (
    RequestGenerator, ServingEngine, load_representation, run_closed_loop,
)

EVERY = 25


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--T-GD", type=int, default=100)
    ap.add_argument("--requests", type=int, default=200,
                    help="requests of the closed loop")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    spec = ExperimentSpec(
        name="serve_personalize",
        problem=ProblemSpec(d=80, T=64, r=4, n=24, L=8, kappa=2.0),
        topology=TopologySpec(family="erdos_renyi", p=0.5, seed=1),
        init=InitSpec(T_pm=25, T_con=10),
        solver=SolverSpec(name="dif_altgdmin", T_GD=args.T_GD, T_con=3))
    p = spec.problem
    print(f"training Dif-AltGDmin (d={p.d}, T={p.T}, r={p.r}, L={p.L}) on "
          f"{device.type}, publishing U every {EVERY} iters...")
    errs, grads = [], []
    with tempfile.TemporaryDirectory() as ckdir:
        trace = run_experiment(spec, key=0, device=device,
                               checkpoint_every=EVERY, checkpoint_dir=ckdir)
        steps = sorted(int(s.split("_")[1]) for s in os.listdir(ckdir))
        print(f"published checkpoints: {steps}  "
              f"(final sd_max {trace.final_sd_max:.2e})\n")

        # a fixed cohort of new users: few-shot data from the true model
        U_star = trace.materialized.problem.U_star
        cohort = RequestGenerator(U_star, t_new=16, seed=5).generate(48)
        X_list = [q.X for q in cohort]
        y_list = [q.y for q in cohort]
        theta_star = np.stack([q.theta_star for q in cohort])
        X = torch.as_tensor(np.stack(X_list), device=device)
        y = torch.as_tensor(np.stack(y_list), device=device)

        # drifting-U mode: hot-swap to each checkpoint in publish order
        # (a live server would HotSwapSource.poll() between batches; here
        # every step already exists on disk, so they are replayed)
        engine = None
        print(f"{'checkpoint':>10} {'train sd_max':>14} "
              f"{'cohort mean err':>16} {'cohort |grad|':>14}")
        for step in steps:
            U = load_representation(ckdir, step, d=p.d, r=p.r,
                                    dtype=torch.float64, device=device)
            if engine is None:
                engine = ServingEngine(U, max_batch=48, version=step)
            else:
                engine.update_representation(U, version=step)
            _, theta, _ = engine.solve(X_list, y_list)
            err = float(np.mean(np.linalg.norm(theta.cpu().numpy()
                                               - theta_star, axis=1)
                                / np.linalg.norm(theta_star, axis=1)))
            B = ops.altgdmin_minimize_B(X, U, y)
            grad = float(torch.linalg.norm(ops.altgdmin_gradient(X, U, B, y)))
            sd = float(trace.sd_max[step - 1]) if step else float("nan")
            trend = "" if not errs else ("  ↓" if err < errs[-1] else "  ↑")
            print(f"{step:>10} {sd:>14.2e} {err:>16.2e} {grad:>14.2e}"
                  f"{trend}")
            errs.append(err)
            grads.append(grad)

        # closed-loop telemetry on the final representation
        load = RequestGenerator(U_star, t_new=(8, 16, 24), rate_hz=150,
                                seed=9).generate(args.requests)
        server = ServingEngine(engine.U, max_batch=16,
                               version=engine.version)
        warm_rng = np.random.default_rng(0)
        for t in (8, 16, 24):      # warm each sample bucket once
            server.solve([warm_rng.standard_normal((t, p.d))],
                         [np.zeros(t)])
        report = run_closed_loop(server, load, max_wait_s=5e-3,
                                 queue_capacity=64)
    pct = report.latency_percentiles((50, 99))
    print(f"\nclosed loop (final U, ragged T_new, Poisson 150 req/s): "
          f"{len(report.records)} served in "
          f"{len(report.batch_sizes)} batches "
          f"(mean size {np.mean(report.batch_sizes):.1f}), "
          f"{report.n_shed} shed")
    print(f"latency p50 {1e3 * pct['p50']:.2f} ms, "
          f"p99 {1e3 * pct['p99']:.2f} ms; "
          f"cohort-level mean err {report.mean_err:.2e}")
    return {"steps": steps, "errs": errs, "grads": grads,
            "served": len(report.records), "shed": report.n_shed}


if __name__ == "__main__":
    main()
