"""The readings the check's limits are set from, on the card, at a cell's
own sizes; never part of a benchmark run.

  python3 gpubench/calibrate.py --workload <cell> --what program \
      --seeds 11 12 13 ...
  python3 gpubench/calibrate.py --workload <cell> --what control --seeds ...
  python3 gpubench/calibrate.py --workload <cell> --what faults --seeds ...

``program``: for each seed, a run of the cell (``harness.run_cell``)
whose window is as many units as the check samples answers from, and
its check's numbers (the lower readings).  ``control``: the reference in
the nearest precision below the configuration's (FP8 products,
:mod:`gpubench.reference.common`) in the program's place, against the
float32 reference (the upper readings).  ``faults``: such a run with
each fault of the cell's entry (``gpubench/entries/<entry>.py``)
planted.  One JSON line a reading on standard output, all in one
process so the card's set-up is paid once.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name, seed, what, fault=None, *, device="cuda:0",
             config=None, traffic=None):
    """The check's numbers of one seed; ``config`` / ``traffic`` stand in
    for the cell's files (a test's small sizes).  The program's and the
    faults' are those of a run of the cell (:func:`harness.run_cell`),
    its window as many units as the check samples answers from."""
    import torch
    from gpubench import generator, harness
    bench = harness.benchmark(ROOT)
    _, f_config, f_traffic, cellfile = harness.resolve(bench, name, ROOT)
    config, traffic = config or f_config, traffic or f_traffic
    entry = generator.entry(traffic["entry"])
    if what == "control":
        shapes = entry.Driver(config, traffic, cellfile, seed,
                              device).shapes
        return entry.control(config, traffic, cellfile, shapes, seed,
                             torch.device(device))
    units = -(-cellfile.get("check_rows", 1) // entry.prompts(traffic))
    return harness.run_cell(name, seed, 0.0, False, device=device,
                            bench=bench, config=config, traffic=traffic,
                            fault=fault, min_units=units)[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", choices=("program", "control", "faults"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpubench import generator, harness
    traffic = harness.resolve(harness.benchmark(ROOT), args.workload,
                              ROOT)[2]
    todo = [None]
    if args.what == "faults":
        # a state left unchanged reads 1 by the check's measure: no run
        todo = [f for f in generator.entry(traffic["entry"]).faults(traffic)
                if f != "state_unchanged"]
    for fault in todo:
        for seed in args.seeds:
            t = time.perf_counter()
            numbers = readings(args.workload, seed, args.what, fault)
            print(json.dumps({"workload": args.workload, "what": args.what,
                              "fault": fault, "seed": seed,
                              "numbers": numbers,
                              "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
