"""Fault tolerance: failure injection, retry-with-restore, stragglers.

A port of ``repro.runtime.fault``.  The trainer treats "a step crashed" as
a normal event:

  while step < total:
      try:  step_fn()
      except Fault:  restore_from_checkpoint(); continue

:class:`FaultInjector` raises :class:`SimulatedFault` at configured steps
(once each); :class:`StragglerMonitor` flags steps slower than a multiple
of the running median; :class:`StepTimer` times a step on the host clock,
synchronising the device first so that the reading covers the device's
work.  Resharding onto another mesh is ``runtime.elastic``.
"""
from __future__ import annotations

import dataclasses
import time

import torch


class SimulatedFault(RuntimeError):
    """Stands in for a node loss, an interconnect timeout or a
    preemption."""


@dataclasses.dataclass
class FaultInjector:
    fail_at_steps: tuple[int, ...] = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFault(f"injected fault at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0        # x median
    window: int = 50
    times: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        if len(self.times) >= 5 and seconds > self.threshold * med:
            self.flagged.append((step, seconds, med))
            return True
        return False


class StepTimer:
    """``with StepTimer(device) as t: ...`` -> ``t.seconds``; a CUDA
    device is synchronised on entry and on exit."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.seconds = time.perf_counter() - self.t0
        return False
