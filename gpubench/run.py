"""Run one cell of the port's benchmark once and print its result.

  python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout: ``BENCHMARK.json`` names the cells, the
program is the PyTorch and CUDA port under ``src/repro_torch``.  The last
line of standard output is the result, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the last lines of standard error are the same numbers.  Without
a card, or with fewer than the cell asks for, it prints no result and
exits 2; if the run loaded JAX or the JAX package, 3.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(BUILD / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from gpubench import harness
    bench = harness.benchmark(ROOT)
    cell = harness.resolve(bench, args.workload, ROOT)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result, lines, _ = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            device="cuda:0", t0=T0, bench=bench)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
