"""Small stand-ins for the benchmark's configurations and traffic mixes,
for the tests on the CPU: each file with its ``small`` sizes put in (every
width cut down, short sequences), so the same code runs in seconds."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def config(name: str, dtype: str | None = None) -> dict:
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c["model"].update(c["small"])
    if dtype is not None:
        c["model"]["dtype"] = dtype
    return c


def traffic(name: str) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t.update(t["small"])
    return t


def cell(workload: str, dtype: str | None = None):
    """(config, traffic) of a cell of BENCHMARK.json, small."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    return config(entry["config"], dtype), traffic(entry["traffic"])
