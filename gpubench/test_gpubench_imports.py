"""What the benchmark loads, each in a fresh interpreter: the harness,
every metric reader, the traffic generator and the references load no
module whose top-level name (before the first dot, compared whole) is
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` — the port,
``repro_torch``, begins with that name and is another — and the
references load nothing of the port."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

LOAD = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
if "metrics" in sys.argv[2:]:
    from gpubench import harness
    for m in harness.benchmark()["end_to_end"] + \\
            harness.benchmark()["per_layer"]:
        harness.reader(m["name"])
    for path in (harness.HERE / "traffic").glob("*.json"):
        importlib.import_module(
            "gpubench.entries." + harness.load_json(path)["entry"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""".format(root=str(ROOT), src=str(ROOT / "src"))

HARNESS = ["gpubench.harness", "gpubench.drivers", "gpubench.check",
           "gpubench.generator", "gpubench.trace", "gpubench.readers",
           "gpubench.roofline", "gpubench.weights", "gpubench.calibrate",
           "repro_torch.launch.steps",
           "repro_torch.launch.train", "repro_torch.models.transformer",
           "repro_torch.kernels._build"]
REFERENCE = ["gpubench.reference." + p.stem for p in
             sorted((ROOT / "gpubench" / "reference").glob("*.py"))
             if p.stem != "__init__"]


def _loaded(modules, *extra) -> set:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", LOAD, json.dumps(modules),
                          *extra], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


@pytest.mark.parametrize("modules,extra", [(HARNESS, ("metrics",)),
                                           (REFERENCE, ())],
                         ids=["harness", "reference"])
def test_nothing_of_jax_is_loaded(modules, extra):
    loaded = _loaded(modules, *extra)
    assert not loaded & FORBIDDEN
    assert "torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(REFERENCE)
    assert "repro_torch" not in loaded
    # and names nothing of it in its source
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro_torch" not in text and "import repro" not in text


def test_the_harness_check_finds_a_forbidden_module():
    from gpubench import harness
    sys.modules.setdefault("repro_placeholder_test", sys)
    assert "repro_placeholder_test" not in harness.forbidden_loaded()
    saved = sys.modules.get("jaxlib.fake_for_test")
    sys.modules["jaxlib.fake_for_test"] = sys
    try:
        assert "jaxlib" in harness.forbidden_loaded()
    finally:
        if saved is None:
            del sys.modules["jaxlib.fake_for_test"]
        del sys.modules["repro_placeholder_test"]
