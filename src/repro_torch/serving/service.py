"""Admission + metrics layer: the estimation service itself.

A port of ``repro.serving.service``.  :class:`EstimationService` glues the
serving stack together —

    submit / submit_many           (lint gate -> ring admission)
        -> TraceRing               (bucketed re-padding, FIFO windows)
        -> ServingEngine.dispatch  (resident model, batched estimate)
        -> per-ticket result rows  (+ latency / throughput counters)

Admission routes every ingested trace through the ``trace_lint`` batched
gate: a protocol-illegal trace is returned as a structured
:class:`Rejection` (rule id, command index, bank — the linter's
diagnostics verbatim), never silently priced, and never blocks the legal
traces admitted alongside it.  A trace longer than the ring's largest
length bucket rejects the same way (reason ``'too-long'``).

Dispatch happens on :meth:`step` (one ring window, synchronised with the
device before the clock stops), :meth:`maybe_step` (cadence-gated) or
:meth:`drain` (flush everything).  Results are keyed by ticket: each
admitted trace's row of the batched report, on the host.

With a streaming fitter attached (``fitter=``, a
:class:`~repro_torch.core.recalibrate.StreamingFitter`),
:meth:`observe_telemetry` feeds it fleet telemetry; when its drift
detector fires, the service refits and hot-swaps the refreshed model into
the engine (``ServingEngine.update_model``: the same batch shapes, no
kernel rebuilt).  The drift fields of :class:`MetricsSnapshot` report
the last tick's score, the peak, the per-key scores and the number of
refits pushed; without a fitter they stay zero.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.dram import CommandTrace
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.ring import RingConfig, TraceRing, TraceTooLongError


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of one service instance (one estimation configuration).

    ``data`` is the typed :class:`~repro_torch.core.model_api.DataProfile`
    spelling of the data-dependence fractions; the loose
    ``ones_frac``/``toggle_frac`` fields remain accepted and both
    spellings meet in the engine's ``normalize_data_profile`` call."""
    ring: RingConfig = RingConfig()
    mode: str = "mean"
    impl: str = "vectorized"
    lint: bool = True            # the ingestion gate; off only for trusted
    cadence_s: float = 0.0       # maybe_step dispatch period (0 = every call)
    max_batch: int | None = None   # per-window cap (<= ring max_batch)
    data: object | None = None     # model_api.DataProfile
    ones_frac: float | None = None
    toggle_frac: float | None = None


@dataclasses.dataclass(frozen=True)
class Rejection:
    """One refused submission, with the evidence."""
    ticket: int
    reason: str                  # 'protocol' | 'too-long'
    diagnostics: tuple           # linter Diagnostics ('protocol' only)

    @property
    def rules(self) -> tuple[str, ...]:
        if self.reason != "protocol":
            return (self.reason,)
        return tuple(sorted({d.rule for d in self.diagnostics}))


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """Counters since service construction (one dispatch granularity)."""
    admitted: int
    rejected: int
    rejected_by_rule: dict[str, int]
    dispatches: int
    dispatched_traces: int
    completed: int
    queue_depth: int
    batch_fill: float            # mean real-slots / padded-slots
    traces_per_s: float          # admitted traces through dispatch time
    latency_p50_ms: float        # submit -> result available
    latency_p99_ms: float
    dispatch_p50_ms: float       # one engine dispatch, device synchronised
    dispatch_p99_ms: float
    engine_programs: int         # distinct batch shapes (bounded by ring)
    # online-recalibration telemetry (zeros unless a fitter is attached)
    drift_score: float = 0.0     # last observe_telemetry's detector score
    drift_peak: float = 0.0      # max score seen since construction
    drift_by_key: dict[str, float] = dataclasses.field(default_factory=dict)
    recalibrations: int = 0      # refits pushed through update_model


def _pct(samples: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(samples), q) * 1e3) \
        if samples else 0.0


def _map_leaves(fn, rep):
    """``fn`` over every tensor of a report (a NamedTuple of tensors, or
    ``mode='range'``'s tuple of them)."""
    if isinstance(rep, torch.Tensor):
        return fn(rep)
    leaves = [_map_leaves(fn, x) for x in rep]
    return type(rep)(*leaves) if hasattr(rep, "_fields") else tuple(leaves)


class EstimationService:
    """The continuously batched estimation front end (one process a
    rank: the concurrency is in the batched dispatch, not in threads).
    With a ``mesh`` every rank runs the service on the same requests and
    the engine shards each window's traces over the mesh's devices."""

    def __init__(self, model=None, config: ServiceConfig | None = None, *,
                 mesh=None, engine: ServingEngine | None = None,
                 fitter=None):
        self.config = config or ServiceConfig()
        # a prebuilt engine carries its resident model into the new service
        self.engine = engine if engine is not None else ServingEngine(
            model, mesh=mesh, impl=self.config.impl, mode=self.config.mode,
            data=self.config.data,
            ones_frac=self.config.ones_frac,
            toggle_frac=self.config.toggle_frac)
        self.ring = TraceRing(self.config.ring, device=self.engine.device)
        # optional streaming fitter: telemetry flows in through
        # observe_telemetry, refreshed fits flow out through
        # engine.update_model — fit-while-serving
        self.fitter = fitter
        self._drift_last = None
        self._drift_peak = 0.0
        self._recalibrations = 0
        self._results: dict[int, object] = {}
        self._submit_t: dict[int, float] = {}
        self._next_ticket = 0
        self._closed = False
        self._last_dispatch_t = 0.0
        # counters
        self._admitted = 0
        self._rejected_by_rule: dict[str, int] = {}
        self._rejections: list[Rejection] = []
        self._dispatches = 0
        self._dispatched = 0
        self._completed = 0
        self._fills: list[float] = []
        self._dispatch_s: list[float] = []
        self._latency_s: list[float] = []

    # ----------------------------------------------------------- admission
    def submit(self, trace: CommandTrace,
               vendors: Sequence[int] | None = None) -> int | Rejection:
        """Admit one trace.  Returns its ticket, or a :class:`Rejection`
        when the lint gate (or the ring's length cap) refuses it."""
        tickets, rejections = self.submit_many([trace], vendors)
        return rejections[0] if rejections else tickets[0]

    def submit_many(self, traces: Sequence[CommandTrace],
                    vendors: Sequence[int] | None = None
                    ) -> tuple[list[int | None], list[Rejection]]:
        """Admit a burst: ONE batched lint over the whole burst, then
        per-trace admission.  Illegal traces become :class:`Rejection`\\ s
        (their slot in ``tickets`` is ``None``); the legal ones are
        admitted regardless — a mixed burst never blocks its clean
        members.  ``vendors`` scopes the whole burst (the ring groups
        windows by vendor subset)."""
        if self._closed:
            raise RuntimeError("service is closed")
        from repro_torch.analysis import trace_lint
        traces = list(traces)
        errors_by_trace: dict[int, list] = {}
        if self.config.lint and traces:
            for d in trace_lint.errors_of(trace_lint.lint_traces(traces)):
                errors_by_trace.setdefault(d.trace_index, []).append(d)
        group = (tuple(int(v) for v in vendors)
                 if vendors is not None else None)
        tickets: list[int | None] = []
        rejections: list[Rejection] = []
        now = time.perf_counter()
        for i, tr in enumerate(traces):
            ticket = self._next_ticket
            self._next_ticket += 1
            diags = errors_by_trace.get(i)
            if diags:
                rejections.append(self._reject(
                    Rejection(ticket, "protocol", tuple(diags))))
                tickets.append(None)
                continue
            try:
                self.ring.admit(tr, ticket=ticket, group=group)
            except TraceTooLongError:
                rejections.append(self._reject(
                    Rejection(ticket, "too-long", ())))
                tickets.append(None)
                continue
            self._submit_t[ticket] = now
            self._admitted += 1
            tickets.append(ticket)
        return tickets, rejections

    def _reject(self, r: Rejection) -> Rejection:
        self._rejections.append(r)
        for rule in r.rules:
            self._rejected_by_rule[rule] = \
                self._rejected_by_rule.get(rule, 0) + 1
        return r

    # ------------------------------------------------------------ dispatch
    def step(self) -> int:
        """Dispatch ONE ring window; returns how many real traces it
        scored (0 on an empty ring — the empty flush is a no-op)."""
        rb = self.ring.take(self.config.max_batch)
        if rb is None:
            return 0
        t0 = time.perf_counter()
        rep = self.engine.dispatch(rb.batch, rb.group)
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        t1 = time.perf_counter()
        self._last_dispatch_t = t1
        self._dispatches += 1
        self._dispatched += rb.n_real
        self._fills.append(rb.fill)
        self._dispatch_s.append(t1 - t0)
        host = _map_leaves(torch.Tensor.cpu, rep)
        for i, ticket in enumerate(rb.tickets):
            self._results[ticket] = _map_leaves(lambda x: x[i], host)
            self._latency_s.append(t1 - self._submit_t.pop(ticket, t0))
            self._completed += 1
        return rb.n_real

    def maybe_step(self) -> int:
        """The ingestion loop's hot-path tick: dispatch only when the
        cadence period has elapsed (and the ring is non-empty)."""
        if not len(self.ring):
            return 0
        if time.perf_counter() - self._last_dispatch_t < self.config.cadence_s:
            return 0
        return self.step()

    def drain(self) -> int:
        """Flush every pending window (shutdown / end-of-burst); returns
        the total real traces dispatched."""
        total = 0
        while True:
            n = self.step()
            if n == 0:
                return total
            total += n

    def close(self) -> int:
        """Drain, then refuse further submissions."""
        n = self.drain()
        self._closed = True
        return n

    # ----------------------------------------------------------- telemetry
    def observe_telemetry(self, currents, cell_idx, tick: int):
        """Feed one tick of fleet telemetry to the attached streaming
        fitter; when its drift detector fires, refit from the accumulated
        sufficient statistics and hot-swap the refreshed parameters into
        the engine.  Returns the fitter's
        :class:`~repro_torch.core.recalibrate.DriftReport`."""
        if self.fitter is None:
            raise RuntimeError(
                "no streaming fitter attached; construct the service with "
                "fitter=model_api.fit(fitter='streaming', ...)")
        report = self.fitter.observe(currents, cell_idx, tick)
        self._drift_last = report
        self._drift_peak = max(self._drift_peak, report.score)
        if report.triggered:
            self.engine.update_model(self.fitter.refit())
            self._recalibrations += 1
        return report

    # ------------------------------------------------------------- results
    def result(self, ticket: int):
        """Pop one completed ticket's report row (leaves vendor-shaped;
        ``mode='range'`` a (lo, mean, hi) triple of rows).  Raises
        ``KeyError`` while the ticket is still queued."""
        if ticket not in self._results and ticket in self._submit_t:
            raise KeyError(f"ticket {ticket} not yet dispatched "
                           f"(queue depth {len(self.ring)}; call step/drain)")
        return self._results.pop(ticket)

    @property
    def rejections(self) -> tuple[Rejection, ...]:
        return tuple(self._rejections)

    # ------------------------------------------------------------- metrics
    def metrics(self) -> MetricsSnapshot:
        dispatch_time = sum(self._dispatch_s)
        return MetricsSnapshot(
            admitted=self._admitted,
            rejected=len(self._rejections),
            rejected_by_rule=dict(self._rejected_by_rule),
            dispatches=self._dispatches,
            dispatched_traces=self._dispatched,
            completed=self._completed,
            queue_depth=len(self.ring),
            batch_fill=float(np.mean(self._fills)) if self._fills else 0.0,
            traces_per_s=(self._dispatched / dispatch_time
                          if dispatch_time > 0 else 0.0),
            latency_p50_ms=_pct(self._latency_s, 50),
            latency_p99_ms=_pct(self._latency_s, 99),
            dispatch_p50_ms=_pct(self._dispatch_s, 50),
            dispatch_p99_ms=_pct(self._dispatch_s, 99),
            engine_programs=self.engine.cache_size(),
            drift_score=(self._drift_last.score
                         if self._drift_last is not None else 0.0),
            drift_peak=self._drift_peak,
            drift_by_key=(dict(self._drift_last.by_key)
                          if self._drift_last is not None else {}),
            recalibrations=self._recalibrations)
