"""What the metric readers under ``metrics/`` share: each reads one
number from a run (:class:`gpubench.harness.Run`), or None where the run
holds nothing for it (no trace, no launch of its kernel); a share of a
roofline or a peak is never made up as 0.  Which cells a metric reads is
``BENCHMARK.json``'s ``workloads`` of it."""
from __future__ import annotations

import re
import statistics

from gpubench import roofline as rf

# the port's kernels as the device trace names them (csrc/*.cu)
FLASH = re.compile(r"\bflash_(mma_)?kernel\b")
SSD = re.compile(r"\b(ssd_kernel|chunk_state_kernel|state_pass_kernel|"
                 r"chunk_out_kernel)\b")


def tokens_per_s(run):
    """Every token of every unit of the window over its length."""
    return run.unit_tokens * len(run.units) / run.window_s


def latency_quantile_ms(run, q: int):
    """The q-th percentile of every request's time, dispatch to
    synchronize: a unit's time for each of its requests."""
    times = [e - s for s, e in run.units for _ in range(run.unit_prompts)]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100)[q - 1] * 1e3


def device_ops(run):
    """Device operations (kernels, copies, sets) a traced unit."""
    if run.trace is None:
        return None
    return len(run.trace.ops_in_window()) / run.traced_units or None


def launches(run, kernel: str):
    """The port's launches of ``kernel`` a traced unit
    (``_build.LAUNCHES``)."""
    if run.trace is None:
        return None
    return run.counters.get(kernel, 0) / run.traced_units


def idle_pct(run):
    """The traced window's share in which no device operation ran."""
    if run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def peak_gib(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2 ** 30


def mfu_pct(run):
    """Model FLOPs of the window's units over its length and the card's
    bf16 peak."""
    return 100.0 * run.unit_flops * len(run.units) / (run.window_s
                                                      * rf.PEAK_FLOPS_BF16)


def roofline_pct(run, kernel: str, pattern, cost):
    """The least time of the traced calls of ``kernel`` (``cost(run)``:
    one call's (operations, bytes)) over the device time of the kernels
    whose names ``pattern`` finds in the trace."""
    if run.trace is None:
        return None
    calls = run.counters.get(kernel, 0)
    busy = run.trace.device_seconds(lambda n: pattern.search(n) is not None)
    if not calls or busy <= 0:
        return None
    flops, n_bytes = cost(run)
    return 100.0 * calls * rf.bound_s(flops, n_bytes)[0] / busy


def ssd_call_cost(run):
    m, t = run.model, run.traffic
    di = m["ssm_expand"] * m["d_model"]
    return rf.ssd_cost(run.call_rows, t["seq"], di // m["ssm_headdim"],
                       m["ssm_headdim"], m["ssm_state"], dtype=m["dtype"])


def flash_call_cost(run):
    m, t = run.model, run.traffic
    return rf.flash_cost(run.call_rows, t["seq"], t["seq"], m["n_heads"],
                         m["n_kv_heads"],
                         m.get("d_head") or m["d_model"] // m["n_heads"],
                         dtype=m["dtype"], window=m.get("sliding_window"))
