"""Whole runs of the harness on the CPU at small sizes, each in a fresh
interpreter as the benchmark runs (the look for a card skipped, the rest
of a run driven): a sound run comes out correct; a run with a fault
planted under the timed path comes out not correct, once for each fault
a cell can have; a new cell, entry and metric need new files and entries
only; a run that loaded JAX by its end prints no result, and so does
``run.py`` without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
ENV.pop("JAX_PLATFORMS", None)

RUN = """
import json, sys
root = sys.argv[1]
sys.path[:0] = [root, {src!r}]
from gpubench import harness, tiny
for name, dtype, fault, trace in json.loads(sys.argv[2]):
    config = traffic = None
    if dtype is not None:
        config, traffic = tiny.cell(name, dtype)
    result, lines, _ = harness.run_cell(
        name, 2 ** 31 + 12345, 0.2, trace, device="cpu", config=config,
        traffic=traffic, fault=fault,
        bench=harness.benchmark(harness.ROOT))
    print(json.dumps({{"case": [name, dtype, fault, trace],
                      "result": result}}), flush=True)
""".format(src=str(ROOT / "src"))

TRAIN = "mamba2-2.7b.train.diffusion"
LONG, SHORT = "phi4-mini-3.8b.prefill.32k", "phi4-mini-3.8b.prefill.2k"
SOUND = [(TRAIN, True), (LONG, False), (SHORT, True)]
FAULTS = ([(TRAIN, f) for f in ("state_unchanged", "half_batch",
                                "no_exchange", "altered_answer")]
          + [(SHORT, f) for f in ("stale_answer", "half_batch",
                                  "altered_answer")]
          + [(LONG, f) for f in ("stale_answer", "altered_answer")])


def _runs(root: Path, cases) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, str(root),
                          json.dumps(cases)], capture_output=True, text=True,
                         env=ENV, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    return {tuple(x["case"]): x["result"] for x in lines}


@pytest.fixture(scope="module")
def results():
    cases = [[n, "float32", None, t] for n, t in SOUND]
    cases += [[n, "float32", f, False] for n, f in FAULTS]
    return _runs(ROOT, cases)


@pytest.mark.parametrize("name,trace", SOUND)
def test_a_sound_run_is_correct(results, name, trace):
    r = results[(name, "float32", None, trace)]
    assert r["correct"] is True
    assert list(r)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    assert r["attempted"] >= 1 and r["failed"] == 0
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in r["device"] and r["device"]["window_s"] > 0
    else:
        assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_planted_fault_is_not_correct(results, name, fault):
    r = results[(name, "float32", fault, False)]
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


def test_a_new_cell_entry_and_metric_are_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    g = tmp_path / "gpubench"
    conf = json.loads((g / "configs" / "phi4-mini-3.8b.json").read_text())
    conf["name"] = "tiny-dense"
    conf["model"].update(name="tiny-dense", n_layers=1, d_model=32,
                         n_heads=2, n_kv_heads=1, d_head=16, d_ff=64,
                         vocab_size=53, dtype="float32")
    (g / "configs" / "tiny-dense.json").write_text(json.dumps(conf))
    # a new entry: a module of its own under entries/, found by its name
    (g / "entries" / "prefill_again.py").write_text(
        (g / "entries" / "prefill.py").read_text())
    (g / "traffic" / "prefill.tiny.json").write_text(json.dumps(
        {"entry": "prefill_again", "loop": "closed", "batch": 2, "seq": 24,
         "tokens": "uniform", "warm_units": 1, "trace_units": 2}))
    (g / "workloads" / "tiny-dense.prefill.tiny.json").write_text(json.dumps(
        {"check_rows": 3, "limits": {"greedy_gap": 1e-4,
                                     "logit_rel_l2": 1e-4}}))
    (g / "metrics" / "calls.prefill.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = "tiny-dense.prefill.tiny"
    bench["configs"].append({"name": "tiny-dense", "source": "a test",
                             "file": "gpubench/configs/tiny-dense.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": "tiny-dense",
                               "traffic": "prefill.tiny", "chips": 1,
                               "why": "a test"})
    [m for m in bench["end_to_end"] if m["name"] == "prefill_tokens_per_s"
     ][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "calls.prefill", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "step",
                               "moves": "prefill_tokens_per_s",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == [tmp_path / "BENCHMARK.json"]

    got = _runs(tmp_path, [[cell, None, None, False], [cell, None, None,
                                                      True]])
    plain, traced = got[(cell, None, None, False)], got[(cell, None, None,
                                                        True)]
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    assert traced["metrics"]["calls.prefill"]["value"] >= 1


def test_jax_loaded_after_the_window_refuses_the_run(tmp_path):
    """A metric reader runs after the check: what it loads is looked for
    too, and the run prints no result."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    reader = tmp_path / "gpubench" / "metrics" / "prefill_tokens_per_s.py"
    reader.write_text(reader.read_text() + (
        "\nimport sys, types\n"
        "sys.modules.setdefault('flax', types.ModuleType('flax'))\n"))
    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path),
                          json.dumps([[SHORT, "float32", None, False]])],
                         capture_output=True, text=True, env=ENV,
                         timeout=600)
    assert out.returncode != 0
    assert "flax" in out.stderr and '"result"' not in out.stdout


@pytest.mark.parametrize("holds_program", [True, False])
def test_no_result_without_a_card_or_a_program(tmp_path, holds_program):
    root = ROOT
    if not holds_program:
        root = tmp_path
        shutil.copytree(ROOT / "gpubench", root / "gpubench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", root)
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", SHORT, "--seed",
         "4294967297", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, env=dict(ENV, PYTHONPATH=""),
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
