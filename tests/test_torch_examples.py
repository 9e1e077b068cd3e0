"""The six port examples (``examples/*_torch.py``), each run small on
the CPU (``--device cpu``) in a fresh interpreter that imports it by
path and calls its ``main(argv)``: each ends with its result, and no
``jax`` module was loaded (they import ``repro_torch``, torch and numpy
only).  The results are held to what each example shows: the solvers'
order, mesh ≡ simulator, the federated strategies' spread, tokens
decoded, the falling θ error and gradient, the falling loss and the
checkpoint round trip bit for bit.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

DRIVER = """
import importlib.util, json, sys
path, argv = sys.argv[1], sys.argv[2:]
spec = importlib.util.spec_from_file_location("example", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
out = mod.main(argv)
print("RESULT " + json.dumps({
    "out": out,
    "jax": sorted(m for m in sys.modules
                  if m in ("jax", "repro")
                  or m.startswith(("jax.", "jaxlib", "repro.")))
}, default=float))
"""

# example → its small CPU arguments
SMALL = {
    "quickstart_torch": ["--d", "40", "--L", "4", "--T-GD", "60"],
    "distributed_mtrl_torch": ["--T-GD", "20", "--timeout", "180"],
    "federated_multitask_torch": ["--steps", "6", "--T-GD", "20"],
    "serve_decode_torch": ["--gen", "3"],
    "serve_personalize_torch": ["--T-GD", "50", "--requests", "40"],
    "train_lm_torch": ["--steps", "12"],
}


def _run(name):
    path = os.path.join(REPO_ROOT, "examples", f"{name}.py")
    env = {"PYTHONPATH": os.path.join(REPO_ROOT, "src"),
           "PATH": os.environ.get("PATH", ""), "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable, "-c", DRIVER, path,
                        *SMALL[name], "--device", "cpu"],
                       capture_output=True, text=True, cwd=REPO_ROOT,
                       env=env, timeout=TIMEOUT_S)
    assert r.returncode == 0, f"stdout={r.stdout[-3000:]}\n" \
                              f"stderr={r.stderr[-3000:]}"
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["jax"] == [], f"{name} loaded {res['jax']}"
    return res["out"], r.stdout


def test_quickstart():
    out, text = _run("quickstart_torch")
    sd = out["final_sd_max"]
    assert sd["dif_altgdmin"] < sd["dgd_altgdmin"]
    assert sd["centralized_altgdmin"] < sd["dgd_altgdmin"]
    assert "Dif-AltGDmin (paper, T_con=3)" in text


def test_distributed_mtrl():
    out, text = _run("distributed_mtrl_torch")
    assert out["max_abs_diff"] <= 1e-8
    assert out["sd_mesh"] == pytest.approx(out["sd_sim"], rel=1e-8)
    assert out["sends_rank0"] > 0 and "max |U_hw − U_sim|" in text


def test_federated_multitask():
    out, _ = _run("federated_multitask_torch")
    assert out["allreduce"]["spread"] == 0.0
    assert out["local"]["spread"] > out["diffusion"]["spread"] > 0.0
    assert out["linear"]["sd"] < out["linear"]["sd0"]


def test_serve_decode():
    out, _ = _run("serve_decode_torch")
    assert set(out) == {"qwen3-1.7b", "mamba2-130m", "zamba2-7b",
                        "llava-next-mistral-7b"}
    assert all(len(v["tokens"]) == 3 for v in out.values())
    # one prefill step against the teacher-forced decode, at f32
    assert all(v["prefill_vs_decode"] <= 2e-3 for v in out.values())


def test_serve_personalize():
    out, _ = _run("serve_personalize_torch")
    assert out["steps"] == [0, 25, 50]
    assert out["errs"][-1] < out["errs"][0]
    assert out["grads"][-1] < out["grads"][0]
    assert out["served"] + out["shed"] == 40


def test_train_lm():
    out, _ = _run("train_lm_torch")
    assert out["loss"] < out["loss0"] and out["roundtrip_equal"]
