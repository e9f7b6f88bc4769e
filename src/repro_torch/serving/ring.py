"""Persistent TraceBatch ring: continuous admission + bucketed re-padding.

A port of ``repro.serving.ring``.  Ragged traces arrive continuously; on
each dispatch tick the ring re-pads the pending window *in place*
(persistent host-side buffers, one set per bucket shape) into a small
FIXED set of pad shapes:

* the command axis rounds up to the next **length bucket**
  (:attr:`RingConfig.length_buckets`);
* the trace axis rounds up to the next **count bucket**
  (:attr:`RingConfig.count_buckets`) with all-NOP/dt=0 rows of zero
  weight.

Both paddings are exact by the repo-wide padding contract (a zero-cycle
NOP draws no charge and moves no integrator state; a zero-weight row
contributes neither charge nor cycles), so bucketed results equal the
exact-shape pad bit for bit — and the set of batch shapes a service ever
dispatches is bounded by ``len(count_buckets) * len(length_buckets)`` per
vendor subset, whatever traffic arrives.

The ring is dispatch-cadence infrastructure only: it never lints, never
estimates, and keeps no results — that is :mod:`repro_torch.serving.service`.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import torch

from repro_torch.core.dram import LINE_WORDS, CommandTrace
from repro_torch.core.estimate_batch import TraceBatch


@dataclasses.dataclass(frozen=True)
class RingConfig:
    """The fixed pad-shape vocabulary (ascending, final entries = caps)."""
    length_buckets: tuple[int, ...] = (256, 1024, 4096, 16384)
    count_buckets: tuple[int, ...] = (8, 16, 32, 64)

    def __post_init__(self):
        for name in ("length_buckets", "count_buckets"):
            buckets = getattr(self, name)
            if not buckets or list(buckets) != sorted(set(buckets)):
                raise ValueError(f"{name} must be non-empty, ascending, "
                                 f"unique; got {buckets}")

    @property
    def max_batch(self) -> int:
        return self.count_buckets[-1]

    @property
    def max_length(self) -> int:
        return self.length_buckets[-1]


class TraceTooLongError(ValueError):
    """An admitted trace exceeds the largest length bucket — it can never
    be padded into a ring shape, so admission rejects it up front."""

    def __init__(self, n: int, limit: int):
        self.n = int(n)
        self.limit = int(limit)
        super().__init__(
            f"trace of {self.n} commands exceeds the ring's largest length "
            f"bucket ({self.limit}); chunk it (traces.py evaluates long "
            f"applications in chunks) or configure larger buckets")


def bucket_for(value: int, buckets: Sequence[int]) -> int | None:
    """Smallest bucket >= ``value``, or None when the largest is exceeded."""
    for b in buckets:
        if value <= b:
            return int(b)
    return None


@dataclasses.dataclass(frozen=True)
class RingBatch:
    """One dispatch window: a bucket-shaped TraceBatch whose first
    ``len(tickets)`` rows are the real admitted traces, in order."""
    batch: TraceBatch
    tickets: tuple[int, ...]
    group: tuple[int, ...] | None   # the vendor-subset key the entries share

    @property
    def n_real(self) -> int:
        return len(self.tickets)

    @property
    def slots(self) -> int:
        return self.batch.n_traces

    @property
    def fill(self) -> float:
        return self.n_real / self.slots


class TraceRing:
    """FIFO admission buffer over persistent per-bucket pad buffers.  Each
    window is copied from the host buffers to ``device`` (a fresh copy, so
    a window stays valid after the buffers are refilled)."""

    def __init__(self, config: RingConfig | None = None, device="cpu"):
        self.config = config or RingConfig()
        self.device = torch.device(device)
        self._pending: collections.deque = collections.deque()
        self._next_ticket = 0
        # (count_bucket, length_bucket) -> dict of reused host tensors; the
        # "re-pad in place" half of the contract: admission churn never
        # allocates fresh pad storage once a bucket shape has been seen
        self._buffers: dict[tuple[int, int], dict[str, torch.Tensor]] = {}

    def __len__(self) -> int:
        return len(self._pending)

    # ----------------------------------------------------------- admission
    def admit(self, trace: CommandTrace, ticket: int | None = None,
              group: tuple[int, ...] | None = None) -> int:
        """Queue one ragged trace; returns its ticket.  Raises
        :class:`TraceTooLongError` when no length bucket can hold it."""
        n = int(trace.n)
        if bucket_for(n, self.config.length_buckets) is None:
            raise TraceTooLongError(n, self.config.max_length)
        if ticket is None:
            ticket = self._next_ticket
        self._next_ticket = max(self._next_ticket, ticket) + 1
        self._pending.append((int(ticket), trace, group))
        return int(ticket)

    # ------------------------------------------------------------ dispatch
    def take(self, max_batch: int | None = None) -> RingBatch | None:
        """Pop the oldest dispatch window and re-pad it into its bucket
        shape.  Entries sharing the head entry's ``group`` (vendor-subset
        key) are collected FIFO up to ``max_batch``; other groups keep
        their order for later ticks.  Returns None when the ring is empty
        (the empty flush is a no-op, not an error)."""
        if not self._pending:
            return None
        limit = min(max_batch or self.config.max_batch,
                    self.config.max_batch)
        group = self._pending[0][2]
        picked, kept = [], []
        for entry in self._pending:
            if entry[2] == group and len(picked) < limit:
                picked.append(entry)
            else:
                kept.append(entry)
        self._pending = collections.deque(kept)

        tickets = tuple(t for t, _, _ in picked)
        trs = [tr for _, tr, _ in picked]
        cbucket = bucket_for(len(trs), self.config.count_buckets)
        lbucket = bucket_for(max(int(tr.n) for tr in trs),
                             self.config.length_buckets)
        buf = self._buffers_for(cbucket, lbucket)
        for arr in buf.values():
            arr.zero_()                      # NOP == 0, dt == 0, weight == 0
        for i, tr in enumerate(trs):
            n = int(tr.n)
            for name in CommandTrace._fields:
                buf[name][i, :n] = getattr(tr, name)
            buf["weight"][i, :n] = 1.0
        on_dev = {name: x.to(self.device, copy=True)
                  for name, x in buf.items()}
        batch = CommandTrace(*(on_dev[name] for name in CommandTrace._fields))
        return RingBatch(TraceBatch(batch, on_dev["weight"]), tickets, group)

    def _buffers_for(self, count: int, length: int) -> dict[str, torch.Tensor]:
        buf = self._buffers.get((count, length))
        if buf is None:
            buf = {name: torch.zeros((count, length), dtype=torch.int32)
                   for name in ("cmd", "bank", "row", "col", "dt")}
            buf["data"] = torch.zeros((count, length, LINE_WORDS),
                                      dtype=torch.int32)
            buf["weight"] = torch.zeros((count, length), dtype=torch.float32)
            self._buffers[(count, length)] = buf
        return buf
