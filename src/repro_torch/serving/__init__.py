"""Continuously batched estimation-as-a-service, in three layers:

* :mod:`repro_torch.serving.ring` — the persistent :class:`TraceRing`:
  continuous ragged admission, re-padded in place into a small fixed
  vocabulary of bucketed pad shapes, dispatched on a cadence;
* :mod:`repro_torch.serving.engine` — the :class:`ServingEngine`: the
  model kept resident on its device, one batched ``estimate`` per window;
* :mod:`repro_torch.serving.service` — the :class:`EstimationService`:
  ``trace_lint``-gated admission with structured :class:`Rejection`\\ s,
  per-ticket results, and per-dispatch metrics (queue depth, batch fill,
  traces/s, p50/p99 latency, rejection counts).

A port of ``repro.serving``; with ``mesh=`` the engine shards each
window's traces over a ``(data, model)`` mesh of processes.  Quick
loop::

    svc = EstimationService(model, ServiceConfig())
    tickets, rejections = svc.submit_many(traces)
    svc.drain()
    rows = [svc.result(t) for t in tickets if t is not None]
    print(svc.metrics())
"""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.ring import (RingBatch, RingConfig, TraceRing,
                                      TraceTooLongError)
from repro_torch.serving.service import (EstimationService, MetricsSnapshot,
                                         Rejection, ServiceConfig)

__all__ = [
    "EstimationService", "MetricsSnapshot", "Rejection", "RingBatch",
    "RingConfig", "ServiceConfig", "ServingEngine", "TraceRing",
    "TraceTooLongError",
]
