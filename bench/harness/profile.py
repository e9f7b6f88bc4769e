"""The traced run's reading of the device: ``torch.profiler`` with CUDA
activity only (so the host's own ops add no events), read straight from
the profiler's raw results.

Host spans are the benchmark's own: per call, ``call`` (the entry point
running), ``sync_copy`` (waiting for the result: the copy to the host
or the synchronise) and ``between_calls``.  Their ``perf_counter``
stamps are put on the profiler's clock (nanoseconds since the epoch) by
an offset read at the window's start.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Trace:
    names: list                # device operation of each event
    start_ns: np.ndarray       # (E,) on the profiler's clock
    end_ns: np.ndarray
    host_spans: list           # (kind, start_ns, end_ns), profiler clock

    def busy_intervals(self) -> np.ndarray:
        """The union of the events' intervals -> (K, 2), sorted."""
        if not len(self.start_ns):
            return np.zeros((0, 2), np.int64)
        order = np.argsort(self.start_ns, kind="stable")
        s, e = self.start_ns[order], self.end_ns[order]
        reach = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > reach[:-1]
        first = np.flatnonzero(new)
        last = np.append(first[1:], len(s)) - 1
        return np.stack([s[first], reach[last]], axis=1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9


def clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, the tightest of a few
    bracketed reads."""
    best = None
    for _ in range(7):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


class Profiler:
    """Records the device's operations between ``start`` and ``stop``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def events(self):
        """(names, start_ns, end_ns) of every device operation."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        names, starts, ends = [], [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            names.append(e.name())
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
        return (names, np.asarray(starts, np.int64),
                np.asarray(ends, np.int64))


def warm_profiler() -> None:
    """One short session, so that the profiler's first start (CUPTI's set
    up) is paid in set-up and not at the window's start."""
    import torch
    p = Profiler()
    p.start()
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    p.stop()
    p.events()


def host_spans(calls, offset_ns: int) -> list:
    """The window's host spans on the profiler's clock."""
    spans = []
    for i, c in enumerate(calls):
        spans.append(("call", c.t0 + offset_ns, c.t_ret + offset_ns))
        spans.append(("sync_copy", c.t_ret + offset_ns,
                      c.t_ready + offset_ns))
        if i + 1 < len(calls):
            spans.append(("between_calls", c.t_ready + offset_ns,
                          calls[i + 1].t0 + offset_ns))
    return spans


def top_ops(trace: Trace, k: int = 10) -> list:
    """The ``k`` device operations that took most time, summed by name
    -> [[name, seconds]]."""
    total: dict = {}
    for name, s, e in zip(trace.names, trace.start_ns, trace.end_ns):
        total[name] = total.get(name, 0) + int(e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:160], ns / 1e9] for name, ns in ranked]


def idle_gaps(trace: Trace, window: tuple, k: int = 10) -> list:
    """The ``k`` longest stretches inside ``window`` (profiler clock) in
    which no device operation ran, each named by the host span it
    started in -> [[name, seconds]]."""
    iv = trace.busy_intervals()
    lo, hi = window
    edges = [lo] + [x for pair in iv for x in pair] + [hi]
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            gaps.append((int(s), int(e)))
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = trace.host_spans
    starts = np.asarray([sp[1] for sp in spans], np.int64)
    out = []
    for s, e in gaps[:k]:
        j = int(np.searchsorted(starts, s, side="right")) - 1
        name = spans[j][0] if 0 <= j and s < spans[j][2] else "outside"
        out.append([name, (e - s) / 1e9])
    return out
