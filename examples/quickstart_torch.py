"""Quickstart on the PyTorch/CUDA port — the paper in a minute, through
the declarative API (the port's counterpart of ``quickstart.py``).

Reproduces, at reduced scale, the paper's Experiment 1 comparison: the
proposed Dif-AltGDmin against centralized AltGDmin, Dec-AltGDmin and the
DGD-variant, on synthetic multi-task linear regression over an
Erdős–Rényi network.  One :class:`ExperimentSpec` describes the cell;
``dataclasses.replace`` swaps the solver; ``run_experiment`` does the
rest (problem → topology → spectral init → η → algorithm → metrics).
Runs on the card unless asked for the CPU:

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.api import (
    ExperimentSpec, InitSpec, ProblemSpec, SolverSpec, TopologySpec,
    materialize, run_experiment,
)
from repro_torch.distributed import gamma

SOLVERS = (("Dif-AltGDmin (paper, T_con=3)", "dif_altgdmin"),
           ("Dec-AltGDmin [9]  (T_con=3)", "dec_altgdmin"),
           ("AltGDmin [10] (centralized)", "centralized_altgdmin"),
           ("DGD-variant (baseline)", "dgd_altgdmin"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--d", type=int, default=150,
                    help="feature dimension = number of tasks")
    ap.add_argument("--L", type=int, default=10, help="nodes")
    ap.add_argument("--T-GD", type=int, default=250)
    args = ap.parse_args(argv)

    # scaled-down Experiment 1: L=10 nodes, d=T=150, r=4, n=30, p=0.5
    spec = ExperimentSpec(
        name="quickstart_exp1",
        problem=ProblemSpec(d=args.d, T=args.d, r=4, n=30, L=args.L,
                            kappa=2.0),
        topology=TopologySpec(family="erdos_renyi", p=0.5, seed=1,
                              weights="metropolis"),
        init=InitSpec(T_pm=30, T_con=10),
        solver=SolverSpec(name="dif_altgdmin", T_GD=args.T_GD, T_con=3),
    )
    p = spec.problem
    print(f"Dec-MTRL: L={p.L} nodes, d={p.d}, T={p.T} tasks, r={p.r}, "
          f"n={p.n} samples/task (data-scarce: n < d)")

    mat = materialize(spec, key=0, device=args.device)   # shared by all four
    print(f"network: Erdős–Rényi p={spec.topology.p}, "
          f"γ(W)={gamma(mat.W.cpu().numpy()):.3f}, device {mat.Xg.device}")

    runs = {}
    for label, solver in SOLVERS:
        sp = dataclasses.replace(
            spec, solver=dataclasses.replace(spec.solver, name=solver))
        runs[solver] = (label, run_experiment(sp, key=0, materialized=mat))

    ticks = np.unique(np.linspace(0, args.T_GD - 1, 6).astype(int))
    print(f"\n{'algorithm':<32}" + "".join(f"τ={t:<9}" for t in ticks))
    for label, trace in runs.values():
        row = "".join(f"{trace.sd_max[t]:<10.2e}" for t in ticks)
        print(f"{label:<32}{row}")

    print("\nTakeaways (= the paper's Fig. 1):")
    print(" * Dif-AltGDmin converges linearly, at the same order as the")
    print("   centralized algorithm, with only 3 gossip rounds/iteration;")
    print(" * Dec-AltGDmin plateaus at a T_con-dependent error floor;")
    print(" * the DGD-variant fails to converge for this non-convex "
          "problem.")
    return {"final_sd_max": {solver: trace.final_sd_max
                             for solver, (_, trace) in runs.items()}}


if __name__ == "__main__":
    main()
