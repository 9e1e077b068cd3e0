"""The port's dry run on the meta device (``repro_torch.launch.dryrun``):
the CLI end to end in a subprocess on one combination (the assertions
of ``tests/test_dryrun_smoke.py`` less its calibration one: the port
does not calibrate); ``model_flops`` against the reference's formula for
every preset and shape; the collectives hand-counted on a smoke
configuration at a (data 2, model 2) mesh; and the recording scope
(``_build.recording()``) on meta tensors, where the kernels' wrappers
stand in for their launches with empty outputs, against the same scope
on CPU tensors, where they run their plain versions: the same launches
and the same output shapes and dtypes.  Plain
equality; the reference's formula is recomputed here, since importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for every subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as rget  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import dryrun, specs, steps  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_LIMIT_S = 60


def test_dryrun_cli_one_combo(tmp_path):
    arch, shape = "mamba2-130m", "decode_32k"
    out = tmp_path / "dryrun"
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(out)],
        capture_output=True, text=True, cwd=REPO_ROOT,
        env={"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "")},
        timeout=CLI_LIMIT_S)
    assert time.monotonic() - t0 < CLI_LIMIT_S
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr[-2000:]}"
    assert "done" in r.stdout and "0 failures" in r.stdout
    rec = json.loads((out / f"{arch}_{shape}_16x16.json").read_text())
    assert rec["status"] == "ok"
    assert rec["chips"] == 256
    rf = rec["roofline"]
    assert rf["compute_s"] > 0 and rf["memory_s"] > 0
    assert rf["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["peak_bytes"] > 0
    assert rec["cost"] == {k: v for k, v in rec["cost_raw"].items()
                           if k != "caveat"}
    assert "jax" not in r.stdout + r.stderr


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference_formula(arch):
    """The reference's ``model_flops`` (``src/repro/launch/dryrun.py``),
    recomputed from its configuration: 6·N_active·tokens for a train
    step, 2·N_active·tokens for prefill and per decoded token."""
    cfg, rcfg = get_config(arch), rget(arch)
    assert cfg.n_active_params() == rcfg.n_active_params()
    for shape in SHAPES.values():
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        mult = 6.0 if shape.kind == "train" else 2.0
        want = mult * rcfg.n_active_params() * tokens
        assert dryrun.model_flops(cfg, shape) == want
        spec = specs.input_specs(cfg, shape.name,
                                 MeshShape(("data", "model"), (16, 16)))
        assert dryrun.model_flops(spec.cfg, shape) == want


# ------------------------------------------------ collectives by hand

MESH22 = MeshShape(("data", "model"), (2, 2))
SMOKE = get_config("qwen3-1.7b").smoke()      # 2 layers, d 256, ff 512,
#   vocab 512, 4 heads of 64, tied embeddings, f32, no remat


def test_smoke_config_is_the_hand_counted_one():
    assert (SMOKE.n_layers, SMOKE.d_model, SMOKE.d_ff, SMOKE.vocab_size,
            SMOKE.n_heads, SMOKE.n_kv_heads, SMOKE.d_head) == \
        (2, 256, 512, 512, 4, 4, 64)
    assert SMOKE.tie_embeddings and not SMOKE.remat
    assert SMOKE.dtype == "float32"


def test_train_collectives_hand_counted():
    """2 nodes (data 2) of 2 × 64 tokens, each replica over model 2.

    Node axis (diffusion, t_con 1, shifts ±1): 12 communicated leaves
    (all but the node-local embedding), 2 permutes each; a node's
    1 312 256 communicated entries × 4 B × 2 shifts = 10 498 048 B, over
    the 2 devices of its replica: 5 249 024 B a device.

    Model axis, one node's step (128 tokens of d 256, f32: 131 072 B an
    all-reduce): forward, wo and down (row-parallel, contracted d_in on
    'model') in 2 layers = 4; backward, the input gradient of wq, wk,
    wv, gate, up (column-parallel, contracted d_out on 'model') in 2
    layers = 10, and of the tied unembedding (x @ tableᵀ, the table
    vocab-sharded: its input gradient contracts the vocab) = 1; 15 in
    all, 1 966 080 B."""
    rec = dryrun.run_one("qwen3-1.7b", InputShape("t", 64, 4, "train"),
                         mesh=MESH22, cfg=SMOKE)
    per_op = rec["collectives"]["per_op"]
    assert per_op["collective-permute"] == {"count": 24, "bytes": 5249024}
    assert per_op["all-reduce"] == {"count": 15, "bytes": 15 * 131072}
    assert set(per_op) == {"collective-permute", "all-reduce"}
    assert rec["collectives"]["total_bytes"] == 5249024 + 15 * 131072
    assert rec["dominant_collective"] == "collective-permute"
    # 2 nodes × 2 layers of flash, one gossip_combine a communicated leaf
    assert rec["kernel_launches"] == {"flash_attention": 4,
                                      "gossip_combine": 12}


def test_prefill_collectives_hand_counted():
    """A B 2 × S 64 prefill, the batch over data 2.

    Model axis: wo and down in 2 layers, each output (128, 256) f32 =
    131 072 B, its 64-token half a device: 4 all-reduces, 262 144 B.
    FSDP: the 8 weights of ≥ 2**16 entries (the table, gate, up, down,
    wq, wk, wv, wo) gathered over data 2 once, each to its 'model' block:
    table 256·128·4·2, gate / up / down 2·128·256·4·2 each, wq / wk / wv
    / wo 2·128·128·4·2 each = 2 883 584 B."""
    rec = dryrun.run_one("qwen3-1.7b", InputShape("p", 64, 2, "prefill"),
                         mesh=MESH22, cfg=SMOKE)
    per_op = rec["collectives"]["per_op"]
    assert per_op["all-reduce"] == {"count": 4, "bytes": 262144}
    table = 256 * 128 * 4 * 2
    ffn = 2 * 128 * 256 * 4 * 2
    attn = 2 * 128 * 128 * 4 * 2
    assert per_op["all-gather"] == {"count": 8,
                                    "bytes": table + 3 * ffn + 4 * attn}
    assert rec["kernel_launches"] == {"flash_attention": 2}


def test_single_device_counts_whole_step():
    """On a (1, 1) mesh nothing crosses a wire, and the argument bytes
    are every tensor's bytes."""
    mesh = MeshShape(("data", "model"), (1, 1))
    rec = dryrun.run_one("qwen3-1.7b", InputShape("t", 64, 4, "train"),
                         mesh=mesh, cfg=SMOKE, n_nodes=2)
    assert rec["collectives"]["per_op"] == {}
    assert rec["memory"]["argument_bytes"] == rec["argument_bytes_global"]
    n = tfm.count_params(tfm.init_params(SMOKE, device="meta"))
    # params + two moments (f32) of 2 nodes, two int32 steps, the batch
    assert rec["argument_bytes_global"] == 2 * n * 4 * 3 + 2 * 4 \
        + 2 * (2 * 2 * 64 * 8)
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]


# ------------------------------------ meta recording ≡ CPU recording

CASES = (("qwen3-1.7b", "prefill"), ("mamba2-130m", "prefill"),
         ("zamba2-7b", "prefill"), ("qwen3-1.7b", "train"),
         ("mamba2-130m", "train"))


def _case(arch, kind, device):
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    if kind == "prefill":
        params = tfm.serving_params(
            tfm.init_params(cfg, generator=g if device == "cpu" else None,
                            device=device), cfg)
        batch = {"tokens": torch.zeros((2, 32), dtype=torch.int64,
                                       device=device)}
        return steps.make_prefill_step(cfg), (params, batch)
    n = 2
    params = steps.replicate_for_nodes(
        tfm.init_params(cfg, generator=g if device == "cpu" else None,
                        device=device), n)
    opt = specs.make_optimizer(cfg)
    state = steps.TrainState(params, opt.init(params),
                             torch.zeros((), dtype=torch.int32,
                                         device=device))
    tok = torch.zeros((n, 2, 32), dtype=torch.int64, device=device)
    step = steps.make_train_step_fused(cfg, opt, specs.make_aggregation(), n)
    return step, (state, {"tokens": tok, "labels": tok})


def _shapes(tree):
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(tree)]


@pytest.mark.parametrize("arch,kind", CASES)
def test_meta_recording_equals_cpu_recording(arch, kind):
    step, args = _case(arch, kind, "cpu")
    _build.LAUNCHES.clear()
    with _build.recording(), ops.backend_scope("cuda"):
        want = step(*args)
    want_launches = dict(_build.LAUNCHES)
    step, args = _case(arch, kind, "meta")
    _build.LAUNCHES.clear()
    with _build.recording(), ops.backend_scope("cuda"):
        got = step(*args)
    assert dict(_build.LAUNCHES) == want_launches
    assert want_launches            # the kernels' route was taken
    assert _shapes(got) == _shapes(want)
    assert all(t.is_meta for t in tree_leaves(got))


def test_meta_recording_hands_kernel_work_to_the_dry_run():
    """Inside the scope a wrapper given meta tensors hands its operands
    to ``on_meta``, where the dry run's meter counts the kernel's work
    by the wrapper's ``cost`` (the counts of chip_smoke.py's bounds);
    outside it a meta tensor takes the plain route and counts nothing,
    and the ``cuda`` route refuses it."""
    from repro_torch.kernels import flash_attention, ssd_scan
    q = torch.empty((2, 64, 4, 32), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 64, 2, 32), dtype=torch.bfloat16, device="meta")
    _build.LAUNCHES.clear()
    meter = dryrun._Meter({})
    with _build.recording(meter.kernel), ops.backend_scope("cuda"):
        o = ops.flash_attention(q, k, k)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
    pairs = 64 * 65 // 2
    assert meter.kernel_flops == 4 * 32 * 2 * 4 * pairs
    assert meter.kernel_bytes == 2 * (2 * q.numel() + 2 * k.numel())
    assert flash_attention.visible_pairs(64, 64, 16) == \
        sum(min(i + 1, 16) for i in range(64))
    x = torch.empty((1, 8, 2, 4), device="meta")
    dt = torch.empty((1, 8, 2), device="meta")
    A = torch.empty((2,), device="meta")
    Bm = torch.empty((1, 8, 3), device="meta")
    meter = dryrun._Meter({})
    with _build.recording(meter.kernel), ops.backend_scope("cuda"):
        y, h = ops.ssd_scan(x, dt, A, Bm, Bm, A)
    assert y.shape == x.shape and h.shape == (1, 2, 4, 3)
    assert meter.kernel_flops == 5 * 8 * 2 * 4 * 3
    assert meter.kernel_bytes == ssd_scan.cost(x, dt, A, Bm, Bm, A)[1]
    assert dict(_build.LAUNCHES) == {"flash_attention": 1, "ssd_scan": 1}
    _build.LAUNCHES.clear()
    assert ops.resolve_backend(None, q.device) == "torch-ref"
    ops.flash_attention(q, k, k)
    assert not _build.LAUNCHES
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q, k, k, backend="cuda")
