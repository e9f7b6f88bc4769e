"""Spans of the estimation path, kept in memory while a profiler runs.

``with span(name, **counts):`` marks one layer's share of a call and
records its name, the span it runs inside (``parent``), the outermost
span of the call (``root``: every span of one call shares it), and its
start and end on ``time.perf_counter_ns()``.  A count is a function of
no arguments, read at both edges and kept as the change between them (a
launch counter's ``.launches``).

Spans record only while a ``torch.profiler`` session runs on the calling
thread (``torch.autograd._profiler_enabled()``).  Otherwise ``span``
costs one profiler check and keeps nothing.  :func:`drain` returns the
finished spans, oldest first, and empties the buffer; where nothing
drains it, the buffer keeps the newest ``KEEP`` spans.

The recorder takes nothing from the device.  A reader finds each span's
device operations in the profiler's trace: on one stream they run in
the order they were launched, and a call repeats the operations of an
earlier call of the same shapes.  So the first ``SYNCED_ROOTS`` roots
after each drain (with CUDA initialised) are *synced*: at both edges of
each of their spans the recorder synchronises the device and then waits
``SYNC_GAP_NS`` more before its stamp (``start_ns``, ``outer_end_ns``),
so the device idles for that long around each edge, and a reader counts
a span's operations between the middles of those gaps even where the
trace's clock and the host's disagree by less than half a gap; later
calls are cut by those counts.

The recorder's own work at a span's edges (the counts, a synced span's
waits) lies outside the span: in ``[outer_start_ns, start_ns]`` and
``[end_ns, outer_end_ns]``, which belong to no span, so a parent's time
less its children's outer intervals is the parent's own work.

The spans of the estimation path (``impl='cuda'``):

* ``estimate``, ``fleet_map``: the roots, ``Vampire.estimate`` and
  ``fleet.fleet_surface_energy``;
* ``state``: ``structural_state``;
* ``features``: the feature kernel;
* ``pack``: the planes; the parameter blocks (inside ``charge``); a
  chunked map's padding and accumulator;
* ``charge``: the charge kernel's call, count ``launches``; a chunked
  map's, one a module chunk, takes in the scatter into the map;
* ``report``: the cycles and the report.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

KEEP = 1 << 20                     # spans kept where nothing drains (a
                                   # traced 50 s window: ~500,000)
SYNCED_ROOTS = 8                   # synced roots after each drain
SYNC_GAP_NS = 400_000              # the device's idle around a synced edge
_profiling = torch.autograd._profiler_enabled
_finished = collections.deque(maxlen=KEEP)    # finished spans, oldest first
_open = threading.local()          # each thread's open spans
_ids = itertools.count(1)
_roots = itertools.count()         # roots begun since the last drain


class Span:
    """One recorded span (see the module docstring)."""

    __slots__ = ("name", "id", "parent", "root", "synced", "outer_start_ns",
                 "start_ns", "end_ns", "outer_end_ns", "counts")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts
        self.end_ns = self.outer_end_ns = None

    def __enter__(self) -> "Span":
        t = time.perf_counter_ns()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        if stack:
            up = stack[-1]
            self.parent, self.root, self.synced = up.id, up.root, up.synced
        else:
            self.parent = None
            self.root = self.id
            self.synced = (next(_roots) < SYNCED_ROOTS
                           and torch.cuda.is_initialized())
        stack.append(self)
        for k, read in self.counts.items():
            self.counts[k] = (read, read())
        if self.synced:
            _wait()
        self.outer_start_ns = t
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.synced:
            _wait()
        for k, (read, first) in self.counts.items():
            self.counts[k] = read() - first
        _open.stack.pop()
        self.outer_end_ns = time.perf_counter_ns()
        _finished.append(self)


def _wait() -> None:
    """A synced edge: every operation launched so far ends, and the
    device then idles for ``SYNC_GAP_NS``."""
    torch.cuda.synchronize()
    time.sleep(SYNC_GAP_NS / 1e9)


_OFF = contextlib.nullcontext()


def span(name: str, **counts):
    """A span of the layer ``name`` with its ``counts``, or a context that
    does nothing where no profiler runs."""
    if not _profiling():
        return _OFF
    return Span(name, counts)


def drain() -> list:
    """The spans finished since the last drain, oldest first; empties the
    buffer, and the next ``SYNCED_ROOTS`` roots are synced."""
    global _roots
    done = []
    while _finished:
        done.append(_finished.popleft())
    _roots = itertools.count()
    return done
