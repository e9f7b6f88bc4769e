"""The batched fleet engine: the characterization campaign's
``(modules, probes)`` current matrix, the fleet-wide structural surfaces,
and the stacked-parameter core the estimation dispatch shares.

* :func:`stack_params` stacks per-module ``PowerParams`` along a leading
  module axis; :class:`FleetStackCache` keeps a fleet's stacked params on
  a device, keyed on the module objects' identity;
* probe points of unequal length are NOP/dt=0-padded into one
  ``(probes, commands)`` :class:`ProbeBatch` with a skip/validity mask;
* :func:`fleet_measure_current` (plain PyTorch) and
  :func:`fleet_measure_current_cuda` (the feature and VAMPIRE charge
  kernels, the probe axis on the kernels' trace axis and the module axis
  on their vendor axis) give the noise-free matrix;
* :func:`run_probes` adds the counter-based measurement noise of
  ``device_sim``, the same factor the serial oracle draws per call.

The reference's ``mesh=`` sharding is not ported: the port runs the
campaign on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import model_api
from repro_torch.core.dram import CommandTrace, batch_traces
from repro_torch.core.energy_model import (PowerParams, StructuralFeatures,
                                           charge_from_features,
                                           extract_structural_features,
                                           finalize_features, masked_cycles)

MESH_NOT_PORTED = ("mesh= sharding of the campaign and the fleet surface "
                   "is not ported; the port runs on one card (ROADMAP, "
                   "queue 1: mesh sharding for a multi-GPU slice)")


def stack_params(params: Sequence[PowerParams]) -> PowerParams:
    """Stack per-module parameter sets along a leading module axis (one
    ``torch.stack`` per leaf)."""
    return PowerParams(*(torch.stack(leaves) for leaves in zip(*params)))


class FleetStackCache:
    """Stacked fleet params kept on a device: built once per (fleet,
    device), keyed on the module objects' identity, least recently used
    entries dropped past ``maxsize``.  An entry holds its modules, so an
    id cannot be recycled while it is cached."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._entries: dict = {}     # key -> (modules, stacked)
        self.hits = 0
        self.misses = 0

    def stacked(self, modules, device) -> PowerParams:
        key = (tuple(id(m) for m in modules), torch.device(device))
        hit = self._entries.pop(key, None)
        if hit is not None:
            self.hits += 1
            self._entries[key] = hit
            return hit[1]
        self.misses += 1
        stacked = stack_params([m.params for m in modules]).to(device)
        self._entries[key] = (tuple(modules), stacked)
        while len(self._entries) > self.maxsize:
            self._entries.pop(next(iter(self._entries)))
        return stacked

    def clear(self):
        self._entries.clear()


#: the process-wide fleet-stack cache both campaign engines go through
FLEET_STACK_CACHE = FleetStackCache()


def fleet_stacked(modules, device=None) -> PowerParams:
    """The stacked params of a fleet on ``device``: a module sequence is
    stacked once (:data:`FLEET_STACK_CACHE`); an already stacked
    ``PowerParams`` (a synthetic fleet) is moved there, and stays where it
    is when ``device`` is None."""
    if isinstance(modules, PowerParams):
        return modules if device is None else modules.to(device)
    return FLEET_STACK_CACHE.stacked(tuple(modules),
                                     model_api.resolve_device(device))


@dataclasses.dataclass(frozen=True)
class ProbePoint:
    """One measurement of the campaign: a looped microbenchmark trace, the
    number of setup commands to skip, and a stable noise key."""
    label: tuple
    trace: CommandTrace
    skip: int
    key: int


@dataclasses.dataclass
class ProbeBatch:
    """A padded, fixed-shape batch of probe points."""
    trace: CommandTrace    # (P, N) leading probe axis on every field
    weight: torch.Tensor   # (P, N) float32 measurement mask
    keys: np.ndarray       # (P,) noise keys

    @classmethod
    def from_points(cls, points: Sequence[ProbePoint]) -> "ProbeBatch":
        trace, weight = batch_traces([(p.trace, p.skip) for p in points])
        return cls(trace, weight, np.asarray([p.key for p in points]))

    def select(self, idx) -> "ProbeBatch":
        """The padded rows at ``idx`` and their noise keys."""
        idx = np.asarray(idx)
        rows = torch.as_tensor(idx, dtype=torch.long,
                               device=self.weight.device)
        return ProbeBatch(CommandTrace(*(x[rows] for x in self.trace)),
                          self.weight[rows], self.keys[idx])

    def with_keys(self, keys: np.ndarray) -> "ProbeBatch":
        """The same padded batch under different noise keys."""
        return ProbeBatch(self.trace, self.weight, np.asarray(keys))

    def to(self, device) -> "ProbeBatch":
        if self.weight.device == torch.device(device):
            return self
        return ProbeBatch(self.trace.to(device), self.weight.to(device),
                          self.keys)


def batched_pair_totals(tr: CommandTrace, w: torch.Tensor,
                        sf: StructuralFeatures, stacked: PowerParams):
    """Masked charge of every (trace, paramset) pair and the masked cycles
    of every trace -> ``((..., V), (...,))``.  The structural pass ``sf``
    ran once for the batch; only the open-bank finalize and the charge
    integration run per parameter set."""
    charges = []
    for v in range(stacked.i2n.shape[0]):
        pp = stacked.select(v)
        c = charge_from_features(tr, finalize_features(sf, pp), pp)
        charges.append((c * w).sum(dim=-1))
    return torch.stack(charges, dim=-1), masked_cycles(tr, w)


def _currents(charge: torch.Tensor, cycles: torch.Tensor) -> torch.Tensor:
    """(P, M) masked charge and (P,) cycles -> the (M, P) current matrix."""
    return (charge / torch.clamp(cycles.to(torch.float32),
                                 min=1.0)[:, None]).T


def fleet_measure_current(trace: CommandTrace, weight: torch.Tensor,
                          stacked: PowerParams,
                          sf: StructuralFeatures | None = None
                          ) -> torch.Tensor:
    """Noise-free average current of every (module, probe) pair in plain
    PyTorch: ``trace``/``weight`` are a ProbeBatch's padded fields,
    ``stacked`` the fleet's stacked params -> float32 (modules, probes).
    ``sf`` is the batch's structural pass when the caller already has it
    (it depends on the traces only)."""
    if sf is None:
        sf = extract_structural_features(trace)
    return _currents(*batched_pair_totals(trace, weight, sf, stacked))


def fleet_measure_current_cuda(trace: CommandTrace, weight: torch.Tensor,
                               stacked: PowerParams) -> torch.Tensor:
    """The ``impl='cuda'`` twin of :func:`fleet_measure_current`: the
    feature kernel once over the probe batch, then the VAMPIRE charge
    kernel with the probe axis as its trace axis and the module axis as
    its vendor axis (the true params' ``ones_quad`` curvature is part of
    the kernel)."""
    from repro_torch.kernels.vampire_energy import ops as vops
    return _currents(*vops.batched_charge_matrix(trace, weight, stacked))


def fleet_surface_energy(modules, trace: CommandTrace, weight: torch.Tensor,
                         impl: str = "vectorized", *, device=None, mesh=None,
                         module_chunk: int | None = None,
                         trace_chunk: int | None = None):
    """Ground-truth structural-variation surfaces of a whole fleet (paper
    Figs 19-22 as fleet-wide maps): an ``EnergyReport`` whose leaves are
    ``(traces, modules, banks, row_bands)`` — the estimation engine's
    surface dispatch with the stacked per-module true params on the vendor
    axis.  ``impl`` is ``'vectorized'`` or ``'cuda'``; ``modules`` is a
    module sequence (stacked once) or a stacked ``PowerParams`` (a
    synthetic fleet).  ``module_chunk`` (and ``trace_chunk``) switch to
    the memory-bounded chunked dispatch
    (``estimate_batch.chunked_surface_reports``), exact against the
    one-shot one."""
    from repro_torch.core import estimate_batch as eb
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    impl = model_api.resolve_impl(impl, mode="surface").name
    if impl == "reference":
        raise ValueError("impl='reference' for the fleet surface is the "
                         "per-command oracle; score modules one at a time")
    stacked = fleet_stacked(modules, device)
    trace, weight = trace.to(stacked.i2n.device), weight.to(
        stacked.i2n.device)
    if module_chunk is not None or trace_chunk is not None:
        return eb.chunked_surface_reports(
            trace, weight, stacked,
            module_chunk=(stacked.i2n.shape[0] if module_chunk is None
                          else module_chunk),
            trace_chunk=trace_chunk, impl=impl)
    dispatch = (eb.cuda_batched_surface_reports if impl == "cuda"
                else eb.batched_surface_reports)
    return dispatch(trace, weight, stacked)


def run_probes(modules, points: Sequence[ProbePoint], *,
               engine: str = "batched", noisy: bool = True,
               batch: ProbeBatch | None = None, impl: str = "vectorized",
               device=None, mesh=None) -> np.ndarray:
    """Measure every probe point on every module -> (modules, probes) mA
    as float64 numpy, on ``device`` (``cuda`` unless the caller names
    another).

    ``engine='batched'`` evaluates a padded batch in one dispatch through
    ``impl`` (``'vectorized'``: plain PyTorch; ``'cuda'``: the kernels);
    ``engine='serial'`` replays the campaign one ``measure_current`` call
    at a time and is the correctness oracle.  Both draw the same
    per-(module, probe) noise.  Contradictions are errors:
    ``impl='reference'`` with the batched engine (the oracle is
    ``engine='serial'``), ``impl='cuda'`` with the serial one.  A prebuilt
    ``batch`` of the same points skips the re-padding.  ``modules`` may be
    a stacked ``PowerParams`` (a synthetic fleet) when ``noisy=False``."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    impl = model_api.resolve_impl(impl).name
    if engine == "serial":
        if impl == "cuda":
            raise ValueError("engine='serial' is the per-command oracle; "
                             "impl='cuda' requires engine='batched'")
        dev = model_api.resolve_device(device)
        traces = [p.trace.to(dev) for p in points]
        return np.asarray(
            [[m.measure_current(tr, noisy=noisy, skip=p.skip,
                                probe_key=p.key)
              for p, tr in zip(points, traces)] for m in modules])
    if engine != "batched":
        raise ValueError(f"unknown engine {engine!r}")
    if impl == "reference":
        raise ValueError("impl='reference' for the campaign is "
                         "engine='serial' (the per-command oracle)")
    if isinstance(modules, PowerParams) and noisy:
        raise ValueError("noisy measurements need module identities; pass "
                         "the modules, or noisy=False for stacked params")
    stacked = fleet_stacked(modules, device)
    if batch is None:
        batch = ProbeBatch.from_points(points)
    batch = batch.to(stacked.i2n.device)
    measure = (fleet_measure_current_cuda if impl == "cuda"
               else fleet_measure_current)
    currents = measure(batch.trace, batch.weight, stacked).cpu().numpy()
    currents = currents.astype(np.float64)
    if noisy:
        from repro_torch.core import device_sim
        currents = currents * device_sim.measurement_noise_factors(
            [m.spec for m in modules], batch.keys)
    return currents
