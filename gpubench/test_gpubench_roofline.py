"""The yardstick on the CPU: the frozen roofline arithmetic against the
port's own ``cost`` functions, the model FLOPs against a hand count, and
the trace reader's busy time as the union of overlapping operations."""
from __future__ import annotations

import pytest
import torch

from gpubench import readers, roofline as rf, trace as tr
from gpubench.harness import Run

FLASH_SHAPES = [  # B, Sq, Skv, H, Hkv, D, window
    (4, 2048, 2048, 24, 8, 128, None),
    (1, 512, 512, 32, 32, 112, 128),
    (2, 100, 300, 8, 2, 64, None),
    (2, 100, 300, 8, 2, 64, 37),
    (1, 64, 64, 4, 1, 16, 1),
]
SSD_SHAPES = [  # B, S, H, P, N
    (2, 1024, 112, 64, 64),
    (4, 2048, 24, 64, 128),
    (1, 77, 3, 16, 8),
]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_cost_is_the_ports(shape, dtype):
    from repro_torch.kernels import flash_attention
    B, Sq, Skv, H, Hkv, D, window = shape
    dt = getattr(torch, dtype)
    q = torch.empty((B, Sq, H, D), dtype=dt, device="meta")
    k = torch.empty((B, Skv, Hkv, D), dtype=dt, device="meta")
    assert rf.flash_cost(B, Sq, Skv, H, Hkv, D, dtype=dtype, window=window) \
        == flash_attention.cost(q, k, k, window=window)
    assert rf.visible_pairs(Sq, Skv, window) == \
        flash_attention.visible_pairs(Sq, Skv, window)


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_cost_is_the_ports(shape, dtype):
    from repro_torch.kernels import ssd_scan
    B, S, H, P, N = shape
    dt = getattr(torch, dtype)

    def meta(*s, d=dt):
        return torch.empty(s, dtype=d, device="meta")
    got = rf.ssd_cost(B, S, H, P, N, dtype=dtype)
    assert got == ssd_scan.cost(meta(B, S, H, P), meta(B, S, H, d=torch.float32),
                                meta(H, d=torch.float32), meta(B, S, N),
                                meta(B, S, N), meta(H, d=torch.float32))


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert rf.bound_s(989e12, 0) == (1.0, "operations")
    assert rf.bound_s(0, 3.35e12) == (1.0, "bytes")
    t, by = rf.bound_s(*rf.flash_cost(4, 2048, 2048, 24, 8, 128))
    assert by == "operations" and t == pytest.approx(1.0428e-4, rel=1e-3)


def _config(name):
    from gpubench import harness
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def test_mamba2_train_flops_by_hand():
    m = _config("mamba2-2.7b")["model"]
    d, di, N, H, V = 2560, 5120, 128, 80, 50288
    mamba = d * (2 * di + 2 * N + H) + di * d          # in_proj, out_proj
    assert rf.block_matmul_params(m) == {"mixer": 8 * mamba, "ffn": 0,
                                         "head": d * V}
    tokens = 4 * 4 * 2048                              # every node's
    ssd = 5 * tokens * H * 64 * N * 8
    assert rf.train_step_flops(m, 16, 2048) == \
        6 * (8 * mamba + d * V) * tokens + 3 * ssd
    assert rf.train_step_flops(m, 16, 2048) == pytest.approx(9.109e13,
                                                             rel=1e-3)


@pytest.mark.parametrize("B,S,expect", [(4, 2048, 5.608e13),
                                        (1, 32768, 4.222e14)])
def test_phi4_prefill_flops_by_hand(B, S, expect):
    m = _config("phi4-mini-3.8b")["model"]
    d, ff, V = 3072, 8192, 200064
    layer = 2 * d * d + 2 * d * 1024 + 3 * d * ff      # q, o; k, v; SwiGLU
    attn = 4 * 128 * 24 * B * (S * (S + 1) // 2) * 32
    got = rf.prefill_flops(m, B, S)
    assert got == 2 * 32 * layer * B * S + attn + 2 * d * V * B
    assert got == pytest.approx(expect, rel=1e-3)


def _trace():
    dev = [("a", 10, 30), ("b", 20, 40), ("c", 50, 60), ("a", 95, 120)]
    host = [("gpubench.window", 0, 100), ("gpubench.unit", 1, 49),
            ("aten::mm", 5, 12), ("gpubench.unit", 49, 99),
            ("cudaDeviceSynchronize", 60, 98)]
    return tr.Trace((0, 100), dev, host)


def test_busy_is_the_union_not_the_sum():
    t = _trace()
    # [10, 40] ∪ [50, 60] ∪ [95, 100]: 45 ns; the sum would be 75
    assert t.intervals() == [(10, 40), (50, 60), (95, 100)]
    assert t.busy_s == pytest.approx(45e-9)
    assert t.gaps() == [(0, 10), (40, 50), (60, 95)]
    assert t.device_seconds(lambda n: n == "a") == pytest.approx(45e-9)
    assert t.top_ops(2) == [["a", pytest.approx(45e-9)],
                            ["b", pytest.approx(20e-9)]]


def test_idle_gaps_name_what_the_host_did():
    gaps = _trace().idle_gaps()
    assert gaps[0] == ["gpubench.unit > cudaDeviceSynchronize",
                       pytest.approx(35e-9)]
    assert ["gpubench.unit", pytest.approx(10e-9)] in gaps
    assert ["gpubench.window", pytest.approx(10e-9)] in gaps


def _run(entry="prefill", trace=None, counters=None):
    traffic = ({"entry": "prefill", "batch": 2, "seq": 8} if entry == "prefill"
               else {"entry": "train", "nodes": 2, "per_node_batch": 1,
                     "seq": 8})
    return Run("cell", {}, traffic, 1.5, [(0.0, 1.0), (1.0, 3.0)], 16,
               2 if entry == "prefill" else 1, 10 ** 12, 2, trace, 2,
               counters or {}, 3 * 2 ** 30)


def test_readers_of_a_run():
    run = _run(trace=_trace())
    assert readers.tokens_per_s(run) == pytest.approx(32 / 3)
    assert readers.latency_quantile_ms(run, 50) == \
        pytest.approx(1500.0)
    assert readers.idle_pct(run) == pytest.approx(55.0)
    assert readers.device_ops(run) == 2.0
    assert readers.peak_gib(run) == 3.0
    assert readers.launches(run, "flash_attention") == 0.0


def test_a_roofline_with_nothing_to_read_is_left_out():
    run = _run(trace=_trace())
    assert readers.roofline_pct(run, "flash_attention",
                                readers.FLASH, lambda r: (1, 1)) is None
    assert readers.idle_pct(_run(trace=tr.Trace((0, 10), [], []))) is None


def test_kernel_names_match_the_trace():
    assert readers.FLASH.search(
        "void (anonymous namespace)::tc::flash_mma_kernel<128>(bf16*)")
    assert readers.FLASH.search("void flash_kernel<float>(float*)")
    assert not readers.FLASH.search("void my_flash_kernel_x()")
    for k in ("ssd_kernel", "chunk_state_kernel", "state_pass_kernel",
              "chunk_out_kernel"):
        assert readers.SSD.search(f"void {k}<64, 64>(float const*)")
    assert not readers.SSD.search("void ssd_kernel_ref()")
