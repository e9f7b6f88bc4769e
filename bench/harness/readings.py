"""The metric readers' arithmetic.  Each ``metrics/<name>.py`` names one
of these as its ``read``.  A reader returns None where it finds nothing
to read."""
from __future__ import annotations

import math
import re

from harness import counts

#: the port's own kernels on the estimation path, by the name the
#: profiler gives them (csrc/features.cu, csrc/charge.cuh)
FEATURES = re.compile(r"\bfeatures_kernel\b")
CHARGE = re.compile(r"\bcharge_kernel<")


def call_ms(c) -> float:
    return (c.t_ready - c.t0) / 1e6


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def device_ns(trace, pattern=None, exclude=()) -> tuple[int, int]:
    """(summed duration ns, count) of the traced device operations whose
    name matches ``pattern`` (all when None) and none of ``exclude``."""
    total = n = 0
    for name, s, e in zip(trace.names, trace.start_ns, trace.end_ns):
        if pattern is not None and not pattern.search(name):
            continue
        if any(x.search(name) for x in exclude):
            continue
        total += int(e - s)
        n += 1
    return total, n


def _least(run, need) -> tuple[float, str]:
    nbytes = nops = 0
    for c in run.ok_calls:
        b, o = need(run.works[c.batch])
        nbytes += b
        nops += o
    return counts.bound_s(nbytes, nops, run.peaks)


def _roofline(run, need, pattern):
    if run.trace is None or run.peaks is None or not run.ok_calls:
        return None
    ns, n = device_ns(run.trace, pattern)
    if n == 0 or ns == 0:
        return None
    least, by = _least(run, need)
    return {"value": least / (ns / 1e9) * 100.0, "bound_by": by,
            "power_limit": run.power_limit}


# ---- end to end (host clock) ------------------------------------------------
def setup_s(run):
    """Seconds from the process's start to the window's start: imports,
    trace generation, the model and batches on the card, the kernels
    built or loaded, every shape warmed."""
    return run.setup_s


def scored_cmds_per_s(run):
    """(command, parameter set) scores the window delivered, over the
    window: real commands only (padding is not counted), times the
    vendors or modules each was scored against, summed over every call
    that completed; the window runs from the first call's start to the
    last call's result."""
    if run.window_s <= 0 or not run.ok_calls:
        return None
    return sum(run.works[c.batch].scored for c in run.ok_calls) \
        / run.window_s


def call_p95_ms(run):
    """The nearest-rank 95th percentile over every call of the window,
    from the call's start on the host until its results were ready
    (copied to the host, or synchronised)."""
    if not run.calls:
        return None
    return percentile([call_ms(c) for c in run.calls], 95)


# ---- per layer (the traced window) ------------------------------------------
def host_enqueue_ms(run):
    """Entry: the mean time a call spends in the entry point on the host,
    from its start until it returns (before the copy or synchronise)."""
    if run.trace is None or not run.calls:
        return None
    return sum(c.t_ret - c.t0 for c in run.calls) / len(run.calls) / 1e6


def device_ops_per_call(run):
    """Entry: device operations (kernels, copies, fills) the profiler
    recorded, over the calls."""
    if run.trace is None or not run.calls or not run.trace.names:
        return None
    return len(run.trace.names) / len(run.calls)


def eager_device_ms(run):
    """Bookkeeping and report: the device time a call of every operation
    that is not one of the port's own kernels (``features_kernel``,
    ``charge_kernel<...>``): the eager torch ops of ``structural_state``,
    ``pack_state``, the report, and the copies."""
    if run.trace is None or not run.calls:
        return None
    ns, n = device_ns(run.trace, None, (FEATURES, CHARGE))
    return ns / len(run.calls) / 1e6 if n else None


def features_roofline(run):
    """Feature kernel: its share of its roofline (``counts.features_need``
    at 3.35 TB/s over the kernel's device time), in percent."""
    return _roofline(run, counts.features_need, FEATURES)


def charge_roofline(run):
    """Charge kernels: their share of their roofline, the larger of the
    needed bytes at 3.35 TB/s and the charge operations at 67 TFLOP/s
    float32 (``counts.charge_need``) over their device time, in percent;
    ``bound_by`` says which bounds it."""
    return _roofline(run, counts.charge_need, CHARGE)


def device_idle_share(run):
    """Device: the share of the window in which no device operation ran
    (1 minus the union of the operations' intervals over the window), in
    percent."""
    if run.trace is None or run.window_s <= 0:
        return None
    busy = run.trace.busy_s()
    return max(0.0, 1.0 - busy / run.window_s) * 100.0 if busy > 0 else None


def call_mfu(run):
    """Device, the whole call: the calls' least time (each input read once
    and each output written once at 3.35 TB/s, or their charge
    operations at 67 TFLOP/s float32, whichever is larger;
    ``counts.call_need``) over their measured time, in percent: the whole
    call's share of the card's peak, which bounds any kernel's gain."""
    if run.trace is None or run.peaks is None or not run.ok_calls:
        return None
    least, by = _least(run, counts.call_need)
    spent = sum(call_ms(c) for c in run.ok_calls) / 1e3
    return {"value": least / spent * 100.0, "bound_by": by,
            "power_limit": run.power_limit}
