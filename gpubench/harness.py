"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell; the cell names a configuration (its
file: the model, the weights' init rules, its plain reference) and a
traffic mix (``traffic/<mix>.json``, read by :mod:`gpubench.generator`),
which names the port's entry it drives (``entries/<entry>.py``: the
driver, the faults, the check); ``workloads/<cell>.json`` holds the
limits of the check and how many answers it samples;
``metrics/<metric>.py`` reads one metric.  Adding a cell, an entry or a
metric adds files and entries; nothing here changes.

A run: set-up (the driver builds the kernels, makes the weights from the
seed, builds the program's object and warms every shape), the window
(whole units, untraced, until ``seconds`` have passed; it ends at the
last unit's end), with ``trace`` a further ``trace_units`` units under
the profiler, then the program's state is freed, the check runs the
reference and the readers read the metrics.  Last, the run looks in
``sys.modules`` for JAX and the JAX package.  :func:`run_cell` returns
the result line's object.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from gpubench import check, generator, trace as tr

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# no run may load these (whole top-level module names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: str
    model: dict
    traffic: dict
    setup_s: float
    units: list                      # [(start_s, end_s)] of the window
    unit_tokens: int
    unit_prompts: int
    unit_flops: int                  # model FLOPs of a unit
    call_rows: int                   # sequences one kernel call sees
    trace: tr.Trace | None = None
    traced_units: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0

    @property
    def window_s(self) -> float:
        return self.units[-1][1] - self.units[0][0]


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve(bench: dict, name: str, root: Path = ROOT):
    """(workload entry, configuration file, traffic mix, cell file)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, load_json(root / conf["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            load_json(HERE / "workloads" / f"{name}.json"))


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t0: float | None = None, bench=None,
             config=None, traffic=None, cellfile=None, fault=None,
             min_units: int = 1):
    """One run of cell ``name``; → (the result's object, the check's
    lines, every number the check read).  ``config`` / ``traffic`` /
    ``cellfile`` stand in for the files (a test's small sizes);
    ``fault`` plants one of the entry's faults under the timed path; the
    window runs ``min_units`` units at least."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = {"start": time.perf_counter() - t0}
    bench = benchmark() if bench is None else bench
    cell, f_config, f_traffic, f_cell = resolve(bench, name)
    config, traffic = config or f_config, traffic or f_traffic
    cellfile = cellfile or f_cell
    device = torch.device(device)
    entry = generator.entry(traffic["entry"])
    driver = entry.Driver(config, traffic, cellfile, seed, device)
    marks["driver"] = time.perf_counter() - t0
    if fault is not None:
        entry.plant(driver, fault)
    driver.setup()
    _sync(device)
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    units = []
    start = time.perf_counter()
    while len(units) < min_units or units[-1][1] - start < seconds:
        inputs = driver.prepare()
        a = time.perf_counter()
        driver.call(inputs)
        units.append((a, time.perf_counter()))
    run = Run(name, config["model"], traffic, setup_s, units,
              entry.tokens(traffic), entry.prompts(traffic),
              entry.flops(config["model"], traffic), entry.rows(traffic))
    if trace:
        from repro_torch.kernels import _build
        before = dict(_build.LAUNCHES)
        run.traced_units = traffic["trace_units"]
        run.trace = tr.traced(lambda i: driver.call(driver.prepare()),
                              run.traced_units, device)
        run.counters = {k: v - before.get(k, 0)
                        for k, v in _build.LAUNCHES.items()}
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    got = driver.finish()
    shapes = driver.shapes
    del driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = entry.check_numbers(got, config, traffic, cellfile, shapes,
                                  seed, device)
    del got
    correct, table = check.judge(numbers, cellfile["limits"])

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, name, kind):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct,
              "attempted": len(units) * run.unit_prompts, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = table
    lines = [f"seconds: set-up {setup_s:.3f} (imports to {marks['start']:.3f}"
             f", the program's skeleton to {marks['driver']:.3f}), window "
             f"{run.window_s:.3f} ({len(units)} units), check "
             f"{time.perf_counter() - t_check:.3f}"]
    lines += [f"not compared {k}: {v!r}" for k, v in numbers.items()
              if k not in table]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in table.items()]
    # last: whatever the program, the check or a reader loaded
    loaded = forbidden_loaded()
    if loaded:
        raise SystemExit(f"the run loaded {loaded}: the port and the harness "
                         f"import none of {list(FORBIDDEN)}")
    return result, lines, numbers
