"""The readers of the program's own spans (``repro_torch.spans``).

The program records its spans while a ``torch.profiler`` session runs,
so a traced run's window leaves every call's spans in the program's
buffer, and no other harness file takes part.  A reader takes them with
``repro_torch.spans.drain()``, once a run (:func:`program_spans` keeps
them on the run, since every reader is called after the window), and
puts their ``perf_counter_ns`` stamps on the profiler's clock with the
harness's own offset: the first host span's start less the first call's
start.  Each metric is a total over the window divided by the calls, as
``harness/readings.py`` divides.  Each returns None without a device
trace or without spans (a program that records none), or where the
program's buffer was full (spans may be missing).

A span's own host time is its time less its children's outer intervals
(the recorder's work at a child's edges lies in the child's outer
interval and in no span; ``recorder_ms`` reports it).

A span's device time is the summed time of the device operations it
launched itself (:func:`device_own_ns`).  The trace does not say which
host code launched an operation, so the program syncs its first calls
(``repro_torch.spans``): there each operation runs inside the stretch
of host time in which it was launched, with the device idle for half a
gap (``SYNC_GAP_NS``) or more on either side of each edge, which gives
each stretch its count of operations once the call is put on the
trace's clock (:func:`shifts`).  A later call with the same spans and
the same device batch launches the same operations in the same order
(one stream), so its operations, in order of their start, are cut by
those counts, walking the calls in order.
"""
from __future__ import annotations

import numpy as np

#: the spans of the bookkeeping and report layer
BOOKKEEPING = ("state", "pack", "report")


def program_spans(run):
    """The program's spans of the traced window, or None."""
    if run.trace is None or not run.calls:
        return None
    kept = vars(run)
    if "program_spans" not in kept:
        try:
            from repro_torch import spans
        except ImportError:
            kept["program_spans"] = None
        else:
            got = spans.drain()
            full = len(got) >= spans.KEEP
            kept["program_spans"] = None if full or not got else got
    return kept["program_spans"]


def offset_ns(run) -> int:
    """``perf_counter_ns`` to the profiler's clock."""
    return run.trace.host_spans[0][1] - run.calls[0].t0


def children(spans) -> dict:
    """Each span's id -> its child spans."""
    kids: dict = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    return kids


def own(spans, inner: dict, outer: dict) -> dict:
    """Each span's id -> ``inner[id]`` less its children's ``outer``."""
    kids = children(spans)
    return {s.id: inner[s.id] - sum(outer[c.id] for c in kids.get(s.id, ()))
            for s in spans}


def host_ns(spans) -> tuple[dict, dict]:
    """(inner, outer) host time of each span's id."""
    return ({s.id: s.end_ns - s.start_ns for s in spans},
            {s.id: s.outer_end_ns - s.outer_start_ns for s in spans})


def per_call_ms(run, ns) -> float:
    return ns / len(run.calls) / 1e6


class Idle:
    """The device's idle time inside intervals of the profiler's clock,
    counted within the window ``[lo, hi]``."""

    def __init__(self, trace, lo: int, hi: int):
        iv = trace.busy_intervals()
        s, e = np.clip(iv[:, 0], lo, hi), np.clip(iv[:, 1], lo, hi)
        keep = e > s
        self.s, self.e = s[keep], e[keep]
        self.cum = np.concatenate([[0], np.cumsum(self.e - self.s)])
        self.lo, self.hi = lo, hi

    def _busy_to(self, t: np.ndarray) -> np.ndarray:
        """Busy time in ``[lo, t]``."""
        k = np.searchsorted(self.s, t, side="right")
        if not len(self.s):
            return np.zeros_like(t)
        last_end = self.e[np.maximum(k - 1, 0)]
        return self.cum[k] - np.where(k > 0, np.maximum(last_end - t, 0), 0)

    def within(self, a, b) -> np.ndarray:
        """Idle ns inside each ``[a, b]`` (arrays of the profiler's
        clock)."""
        a = np.clip(np.asarray(a, np.int64), self.lo, self.hi)
        b = np.clip(np.asarray(b, np.int64), self.lo, self.hi)
        return (b - a) - (self._busy_to(b) - self._busy_to(a))


def idle_ns(run):
    """(the window's :class:`Idle`, each span's id -> (idle ns inside its
    host time, inside its outer interval)), kept on the run."""
    kept = vars(run)
    if "program_idle" not in kept:
        spans = program_spans(run)
        off = offset_ns(run)
        idle = Idle(run.trace, run.calls[0].t0 + off,
                    run.calls[-1].t_ready + off)
        inner = idle.within([s.start_ns + off for s in spans],
                            [s.end_ns + off for s in spans])
        outer = idle.within([s.outer_start_ns + off for s in spans],
                            [s.outer_end_ns + off for s in spans])
        kept["program_idle"] = (idle, {s.id: (int(i), int(o)) for s, i, o
                                       in zip(spans, inner, outer)})
    return kept["program_idle"]


def stretches(spans, gap: int = 0) -> tuple[list, list]:
    """One call's host time cut at its spans' edges -> (times, owners):
    from ``times[k - 1]`` to ``times[k]`` an operation launched is
    ``owners[k]``'s own (None: no span's; ``owners[0]`` before the
    first edge, ``owners[-1]`` after the last).  A span's stretch runs
    from its ``start_ns`` to its ``outer_end_ns``, each less half of
    ``gap``: a synced span stamps each after waiting for every earlier
    operation and then ``gap`` more, so in a synced call an operation
    runs inside the stretch that launched it, at least half a gap from
    either end."""
    edges = sorted([(s.start_ns - gap // 2, 1, s.id, s) for s in spans]
                   + [(s.outer_end_ns - gap // 2, 0, s.id, s)
                      for s in spans], key=lambda e: e[:3])
    times, owners, stack = [], [None], []
    for t, opens, _, s in edges:
        if opens:
            stack.append(s)
        else:
            stack.remove(s)
        times.append(t)
        owners.append(stack[-1] if stack else None)
    return times, owners


def shifts(times, busy: np.ndarray, gap: int, reach: int = 3_000_000,
           most: int = 8) -> list:
    """The shifts, within ``reach``, that put every edge of a synced call
    (``times``, host clock) where the device was idle (``busy``: the
    trace's busy intervals on the host clock): the middle of each run of
    such shifts, tried in steps of an eighth of ``gap``, the ``most``
    nearest 0 first.  Each edge sits in the middle of an idle gap of
    ``gap`` or more, so the right shift leaves a run that wide; the
    gaps' pattern can leave others (an edge in the next gap over)."""
    step = max(1, gap // 8)
    tried = np.arange(-reach, reach + 1, step)
    at = np.asarray(times, np.int64)[None, :] + tried[:, None]
    k = np.searchsorted(busy[:, 0], at, side="right") - 1
    inside = (k >= 0) & (at < busy[np.maximum(k, 0), 1])
    fits = np.flatnonzero(~inside.any(axis=1))
    if not len(fits):
        return []
    runs = np.split(fits, np.flatnonzero(np.diff(fits) > 1) + 1)
    mid = sorted(int(tried[r[0]] + tried[r[-1]]) // 2 for r in runs)
    return sorted(mid, key=abs)[:most]


def call_starts(starts, ends, t0, t_ready, first: int,
                reach: int = 2_000_000, near: int = 100_000,
                settle: int = 64) -> list:
    """The index of the first operation of each call from ``first`` on
    (host clock; ``starts`` sorted, ``ends`` in the same order).  Every
    operation of call ``i - 1`` ended by its ``t_ready`` and every one of
    call ``i`` started after its ``t0``, on the trace's clock, which is
    the host's plus an error ``e``: so where call ``i`` begins at
    operation ``j``, ``e`` lies in ``[last end before j - t_ready[i-1],
    starts[j] - t0[i]]``.  The error drifts slowly: it is taken where the
    first ``settle`` calls' candidate intervals meet, each weighed by the
    device's idle before its operation (the nearest 0 of equal peaks),
    then followed call by call.  Candidates lie within ``reach``, at most
    half the calls' spacing.  Of a call's candidates within ``near`` of
    it, the one after the longest idle of the device is taken (the host
    went from one call's result to the next call's first launch there),
    else the nearest, and the error is kept inside its interval."""
    done = np.maximum.accumulate(ends)
    if len(t0) > 1:                    # no call mistaken for the next
        reach = min(reach, int(np.median(np.diff(t0))) // 2)

    def candidates(i, e):
        lo, hi = np.searchsorted(starts, [t0[i] + e - reach,
                                          t0[i] + e + reach])
        j = np.arange(max(lo, 1), hi)
        a = done[j - 1] - t_ready[i - 1]
        b = starts[j] - t0[i]
        keep = a <= b
        return j[keep], a[keep], b[keep]

    edges = []
    for i in range(first, min(first + settle, len(t0))):
        j, a, b = candidates(i, 0)
        idle = starts[j] - done[j - 1]
        edges += list(zip(a, idle)) + list(zip(b, -idle))
    edges.sort(key=lambda x: (x[0], -x[1]))
    best, e, depth = (-1, 0), 0, 0
    for k, (x, step) in enumerate(edges):
        depth += step
        mid = (x + edges[k + 1][0]) // 2 if k + 1 < len(edges) else x
        if step > 0 and (depth, -abs(mid)) > best:
            best, e = (depth, -abs(mid)), mid
    found = []
    for i in range(first, len(t0)):
        j, a, b = candidates(i, e)
        if not len(j):
            found.append(None)
            continue
        far = np.maximum(a - e, 0) + np.maximum(e - b, 0)
        idle = starts[j] - done[j - 1]
        k = (int(np.argmax(np.where(far <= near, idle, -1)))
             if (far <= near).any() else int(np.argmin(far)))
        e = int(min(max(e, a[k]), b[k]))
        found.append(int(j[k]))
    return found


def device_own_ns(run):
    """(each span's id -> the device ns of the operations it launched
    itself, each read call's time from its start to its first
    operation's start, the calls read), kept on the run; None where no
    call could be read, with the reason kept as
    ``vars(run)["program_device_unread"]``.

    The synced calls give the counts.  Each is put on the trace's clock
    at each of its :func:`shifts`, and its operations counted by the
    stretch their midpoint falls in.  The counts that most synced calls
    with the same spans can give are taken (a wrong shift's agree only
    by chance), then those of the shifts nearest 0; a device batch whose
    synced calls can all give another set of counts takes that one.  The
    later calls are cut at :func:`call_starts`, and a call whose
    operations add up to its counts is read, its operations in order of
    their start cut by them (one stream).  The synced calls themselves
    are not read."""
    kept = vars(run)
    if "program_device" in kept:
        return kept["program_device"]
    spans = program_spans(run)
    kept["program_device"] = None
    if spans is None:
        return None
    from repro_torch.spans import SYNC_GAP_NS

    def unread(why):
        kept["program_device_unread"] = why
        return None

    tr = run.trace
    off = offset_ns(run)
    order = np.argsort(tr.start_ns, kind="stable")
    starts = tr.start_ns[order] - off                 # perf_counter_ns
    ends = tr.end_ns[order] - off
    took = ends - starts
    mids = starts + took // 2
    busy = tr.busy_intervals() - off
    t0 = np.asarray([c.t0 for c in run.calls], np.int64)
    t_ready = np.asarray([c.t_ready for c in run.calls], np.int64)
    roots = {s.id: s for s in spans if s.parent is None}
    by_call: dict = {}
    for s in spans:
        if s.root in roots:
            at = np.searchsorted(t0, roots[s.root].outer_start_ns, "right")
            by_call.setdefault(int(at) - 1, []).append(s)
    # (batch, spans' names) -> for each synced call, the counts it can
    # give, each with the shift nearest 0 that gives them
    offers: dict = {}
    calls, synced_calls = [], set()
    for i in range(len(run.calls)):
        mine = by_call.get(i)
        if not mine:
            calls.append(None)
            continue
        times, owners = stretches(mine, SYNC_GAP_NS)
        kind = (run.calls[i].batch, tuple(o and o.name for o in owners))
        calls.append((kind, owners))
        if all(s.synced for s in mine):
            synced_calls.add(i)
            nxt = t0[i + 1] if i + 1 < len(t0) else np.iinfo(np.int64).max
            got = {}
            for shift in reversed(shifts(times, busy, SYNC_GAP_NS)):
                ops = slice(*np.searchsorted(mids - shift, [t0[i], nxt]))
                which = np.searchsorted(times, mids[ops] - shift, "right")
                got[tuple(int(x) for x in np.bincount(
                    which, minlength=len(owners)))] = shift
            offers.setdefault(kind, []).append(got)
    if not offers:
        return unread("no synced call")
    votes: dict = {}       # (spans' names, counts) -> [calls, |shifts|]
    synced: dict = {}      # spans' names -> synced calls
    for (_, names), offered in offers.items():
        synced[names] = synced.get(names, 0) + len(offered)
        for got in offered:
            for n, shift in got.items():
                v = votes.setdefault((names, n), [0, 0])
                v[0] += 1
                v[1] += abs(shift)
    counts: dict = {}
    for kind, offered in offers.items():
        mine = set.intersection(*(set(got) for got in offered))
        pool = mine or {n for (names, n) in votes if names == kind[1]}
        n = min(pool, key=lambda n: (-votes[kind[1], n][0],
                                     votes[kind[1], n][1]))
        if mine or 2 * votes[kind[1], n][0] >= synced[kind[1]]:
            counts[kind] = n
    first = next((i for i in range(len(run.calls))
                  if i not in synced_calls), len(run.calls))
    if first == 0 or first == len(run.calls):
        return unread("no call after the synced ones")
    begins = call_starts(starts, ends, t0, t_ready, first)
    begins.append(len(starts))
    own: dict = {}
    lag, read = [], 0
    for i, (j, nxt) in enumerate(zip(begins, begins[1:]), start=first):
        if calls[i] is None or j is None or nxt is None:
            continue
        kind, owners = calls[i]
        n = counts.get(kind)
        if n is None or sum(n) != nxt - j:
            continue
        spent = np.bincount(np.repeat(np.arange(len(owners)), n),
                            weights=took[j:nxt], minlength=len(owners))
        for o, x in zip(owners, spent):
            if o is not None:
                own[o.id] = own.get(o.id, 0) + int(x)
        lag.append(int(starts[j] - t0[i]))
        read += 1
    if not read:
        return unread("no call's operations add up to its counts")
    kept["program_device"] = (own, lag, read)
    return kept["program_device"]


# ---- the readers -----------------------------------------------------------
def entry_self_host_ms(run):
    """Entry: the host time a call of the root span outside its children
    (argument checks, impl and vendor resolution, caches, glue).  Further
    keys: ``root_ms`` (the root's whole host time a call),
    ``recorder_ms`` (the recorder's own host time a call, in no span),
    ``root_device_ms`` and ``children_device_ms`` (the device time a
    call read of the operations the root and its descendants launched,
    and of those its children and theirs launched), ``calls_read`` (the
    share of the window's calls read), ``first_op_lag_us`` (the median
    time from a call's start to its first device operation's start, put
    on the trace's clock with the window's one offset, over the first
    and the last 100 calls read: the two differ by the drift between the
    clocks over the window), or ``device_unread`` (why no device time was
    read), ``counts`` (each span's counts a call, as
    ``<span>.<count>``)."""
    spans = program_spans(run)
    if spans is None:
        return None
    inner, outer = host_ns(spans)
    mine = own(spans, inner, outer)
    roots = [s for s in spans if s.parent is None]
    out = {"value": per_call_ms(run, sum(mine[s.id] for s in roots)),
           "root_ms": per_call_ms(run, sum(inner[s.id] for s in roots)),
           "recorder_ms": per_call_ms(run, sum(outer[s.id] - inner[s.id]
                                               for s in spans))}
    device = device_own_ns(run)
    if device is None:
        out["device_unread"] = vars(run).get("program_device_unread")
    else:
        own_dev, lag, read = device
        every = sum(own_dev.values())
        of_roots = sum(own_dev.get(s.id, 0) for s in roots)
        out["root_device_ms"] = every / read / 1e6
        out["children_device_ms"] = (every - of_roots) / read / 1e6
        out["calls_read"] = read / len(run.calls)
        out["first_op_lag_us"] = [float(np.median(lag[:100])) / 1e3,
                                  float(np.median(lag[-100:])) / 1e3]
    counts: dict = {}
    for s in spans:
        for k, v in s.counts.items():
            key = f"{s.name}.{k}"
            counts[key] = counts.get(key, 0) + v
    out["counts"] = {k: v / len(run.calls) for k, v in sorted(counts.items())}
    return out


def bookkeeping_host_ms(run):
    """Bookkeeping and report: the host time a call of ``state``, ``pack``
    and ``report`` outside their children, what enqueueing their eager
    operations costs; ``by_span`` splits it."""
    spans = program_spans(run)
    if spans is None:
        return None
    mine = own(spans, *host_ns(spans))
    by = {name: per_call_ms(run, sum(mine[s.id] for s in spans
                                     if s.name == name))
          for name in BOOKKEEPING}
    return {"value": sum(by.values()), "by_span": by}


def device_ms(run, name: str):
    """The device time a call read of the operations that the spans
    named ``name`` launched themselves, with the share of the window's
    calls read as ``calls_read``, or None where there are none or no
    call was read."""
    spans = program_spans(run)
    device = device_own_ns(run)
    if device is None or not any(s.name == name for s in spans):
        return None
    own_dev, _, read = device
    ns = sum(own_dev.get(s.id, 0) for s in spans if s.name == name)
    return {"value": ns / read / 1e6, "calls_read": read / len(run.calls)}


def state_device_ms(run):
    """Bookkeeping and report: the device time a call of the operations
    ``state`` launched (``structural_state``'s scans, cats, compares and
    copies)."""
    return device_ms(run, "state")


def pack_device_ms(run):
    """Bookkeeping and report: the device time a call of the operations
    ``pack`` launched (the planes, the parameter blocks, a map's padding
    and accumulator)."""
    return device_ms(run, "pack")


def report_device_ms(run):
    """Bookkeeping and report: the device time a call of the operations
    ``report`` launched (the cycles and the report's leaves)."""
    return device_ms(run, "report")


def program_idle_ms(run):
    """Device: the device idle time a call that falls inside a program
    span's own host time, the host code the card waited on.  Further
    keys: ``by_span`` (ms a call for each span name), ``outside`` (ms a
    call of idle time outside every program span) and ``outside_by``
    (that time by the benchmark's host span: ``call`` outside the
    program, ``sync_copy``, ``between_calls``; ``recorder``, the
    recorder's own work).  The value and ``outside`` add up to the idle
    time of the window from the first call's start to the last call's
    result."""
    spans = program_spans(run)
    if spans is None:
        return None
    window, idle = idle_ns(run)
    mine = own(spans, {k: v[0] for k, v in idle.items()},
               {k: v[1] for k, v in idle.items()})
    by: dict = {}
    for s in spans:
        by[s.name] = by.get(s.name, 0) + mine[s.id]
    in_program = sum(by.values())
    recorder = sum(o - i for i, o in idle.values())
    host = window.within([h[1] for h in run.trace.host_spans],
                         [h[2] for h in run.trace.host_spans])
    outside_by = {k: 0 for k in ("call", "sync_copy", "between_calls")}
    for h, x in zip(run.trace.host_spans, host):
        outside_by[h[0]] = outside_by.get(h[0], 0) + int(x)
    outside_by["call"] -= in_program + recorder
    outside_by["recorder"] = recorder
    total = int(window.within([window.lo], [window.hi])[0])
    return {"value": per_call_ms(run, in_program),
            "by_span": {k: per_call_ms(run, v)
                        for k, v in sorted(by.items())},
            "outside": per_call_ms(run, total - in_program),
            "outside_by": {k: per_call_ms(run, v)
                           for k, v in outside_by.items()}}
