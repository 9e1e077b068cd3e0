"""The device trace of a traced stretch of units, read raw.

:func:`traced` runs units under ``torch.profiler`` (host and device
activity), each inside a ``gpubench.unit`` annotation and all inside
``gpubench.window``, and reads the profiler's raw events
(``kineto_results``: building its per-event Python objects costs tens
of µs an event).  :class:`Trace` holds what the readers need:

  * the window, from the ``gpubench.window`` annotation;
  * every device operation (kernel, copy, set) in it, with its times;
  * the busy time: the UNION of the device operations' intervals, so
    operations that overlap count once (a sum would count them twice);
  * the idle gaps between them, each named by what the host was doing
    when it began: the innermost host event open at that moment.
"""
from __future__ import annotations

import bisect
import dataclasses

WINDOW, UNIT = "gpubench.window", "gpubench.unit"


@dataclasses.dataclass
class Trace:
    window: tuple                # (start_ns, end_ns)
    device: list                 # [(name, start_ns, end_ns)], by start
    host: list                   # [(name, start_ns, end_ns)], by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def intervals(self):
        """The device operations' intervals clipped to the window, merged:
        [(start_ns, end_ns)] in order, none overlapping."""
        lo, hi = self.window
        merged: list = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def gaps(self):
        """[(start_ns, end_ns)] of the window in which no device operation
        ran."""
        out, at = [], self.window[0]
        for s, e in self.intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    def ops_in_window(self):
        lo, hi = self.window
        return [d for d in self.device if d[1] < hi and d[2] > lo]

    def device_seconds(self, match) -> float:
        """Summed device seconds of the operations whose name ``match``
        (a predicate) accepts, in the window."""
        return sum(e - s for n, s, e in self.ops_in_window()
                   if match(n)) / 1e9

    def top_ops(self, k: int = 10):
        """The k device operations that took most time, summed by name."""
        by: dict = {}
        for n, s, e in self.ops_in_window():
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[short(n), ns / 1e9] for n, ns in top]

    def host_at(self, t: int) -> str:
        """The innermost host event open at ``t`` (the one that began
        last), with the harness annotation open around it."""
        starts = [h[1] for h in self.host]
        i = bisect.bisect_right(starts, t)
        inner, span = None, None
        for name, s, e in reversed(self.host[:i]):
            if e >= t:
                if inner is None:
                    inner = name
                if name.startswith("gpubench."):
                    span = name
                    break
        if span is not None and inner != span:
            return f"{span} > {inner}"
        return inner or "nothing"

    def idle_gaps(self, k: int = 10):
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:k]
        return [[self.host_at(s), (e - s) / 1e9] for s, e in gaps]


def short(name: str, n: int = 160) -> str:
    """A kernel's name without its ``void`` and cut to ``n`` letters."""
    name = name.removeprefix("void ")
    return name if len(name) <= n else name[:n - 3] + "..."


def read(prof) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        if ev.device_type() != cpu:
            # the harness's annotations appear on the device's timeline
            # too: they are spans, not operations
            if not name.startswith("gpubench."):
                device.append((name, s, e))
            continue
        if name == WINDOW:
            window = (s, e)
        host.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    device.sort(key=lambda d: d[1])
    host.sort(key=lambda h: h[1])
    return Trace(window, device, host)


def traced(units, n: int, device):
    """Run ``units(i)`` for i < n under the profiler, the card's activity
    with the host's where ``device`` is a card; → the Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            for i in range(n):
                with record_function(UNIT):
                    units(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return read(prof)
