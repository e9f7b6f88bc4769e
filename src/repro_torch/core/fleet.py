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

With a ``(data, model)`` mesh (``launch.mesh.make_local_mesh``) both the
surface and the probe matrix are sharded as the reference's
``shard_map`` calls are: traces (probes) over ``data``, modules over
``model``.  Every rank runs the call; each computes the charge of its own
box through the same ``'vectorized'`` or ``'cuda'`` dispatch, the boxes
are gathered on every rank, and the finalisation runs once outside, as
in the one-process dispatch.  Every (trace, module) pair is independent,
and ``'cuda'`` launches a box's kernels at the whole batch's geometry
(the tiles a pair's commands are summed in follow it), so its result is
the one-process result bit for bit.  So is ``'vectorized'``: each
pair's sums are kept in the whole batch's order whatever the box's shape
(``kernels.common.row_sums``, given the box's place in the batch by the
same ``config``).  A mesh of one device, or axes that do not divide the
batch, take the plain dispatch.
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
from repro_torch.kernels.common import batch_rows, row_sums
from repro_torch.spans import span


def stack_params(params: Sequence[PowerParams]) -> PowerParams:
    """Stack per-module parameter sets along a leading module axis (one
    ``torch.stack`` per leaf)."""
    return PowerParams(*(torch.stack(leaves) for leaves in zip(*params)))


class FleetStackCache:
    """Stacked fleet params kept on a device: built once per (fleet,
    device, mesh), keyed on the module objects' identity, least recently
    used entries dropped past ``maxsize``.  An entry holds its modules, so
    an id cannot be recycled while it is cached.  On a mesh the params
    are DTensors (``model_api.device_resident``): the module axis
    ``Shard(0)`` over ``model`` when that axis has more than one device
    and divides the fleet, else replicated."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._entries: dict = {}     # key -> (modules, stacked)
        self.hits = 0
        self.misses = 0

    def stacked(self, modules, device, mesh=None) -> PowerParams:
        key = (tuple(id(m) for m in modules), torch.device(device), mesh)
        hit = self._entries.pop(key, None)
        if hit is not None:
            self.hits += 1
            self._entries[key] = hit
            return hit[1]
        self.misses += 1
        stacked = stack_params([m.params for m in modules]).to(device)
        if mesh is not None:
            n_model = model_api.mesh_axis(mesh, "model")
            stacked = model_api.device_resident(
                stacked, mesh, axis="model" if n_model > 1
                and len(modules) % n_model == 0 else None)
        self._entries[key] = (tuple(modules), stacked)
        while len(self._entries) > self.maxsize:
            self._entries.pop(next(iter(self._entries)))
        return stacked

    def clear(self):
        self._entries.clear()


#: the process-wide fleet-stack cache both campaign engines go through
FLEET_STACK_CACHE = FleetStackCache()

#: the shape of the box this rank computed in its last sharded dispatch
LAST_BOX: tuple | None = None


def fleet_stacked(modules, device=None, mesh=None) -> PowerParams:
    """The stacked params of a fleet on ``device``: a module sequence is
    stacked once (:data:`FLEET_STACK_CACHE`), placed on ``mesh`` when one
    is given; an already stacked ``PowerParams`` (a synthetic fleet) is
    moved there, and stays where it is when ``device`` is None."""
    if isinstance(modules, PowerParams):
        return modules if device is None else modules.to(device)
    return FLEET_STACK_CACHE.stacked(tuple(modules),
                                     model_api.resolve_device(device), mesh)


def _sharded(t) -> bool:
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(t, DTensor) and any(isinstance(p, Shard)
                                          for p in t.placements)


def _whole(stacked: PowerParams, mesh) -> PowerParams:
    """Stacked params as plain tensors holding every module (a module
    axis sharded over ``model`` is gathered)."""
    return model_api.map_tensors(stacked, lambda t: model_api.gather_boxes(
        t.to_local(), mesh, {"model": 0}) if _sharded(t)
        else model_api.local_view(t))


def _rows(n: int, mesh, axis: str) -> slice:
    """This rank's block of ``n`` rows split evenly over ``axis``."""
    k = n // model_api.mesh_axis(mesh, axis)
    i = model_api.mesh_index(mesh, (axis,))
    return slice(i * k, (i + 1) * k)


def _module_block(stacked: PowerParams, mesh) -> PowerParams:
    """This rank's modules: its shard of a module axis sharded over
    ``model``, else its block of the rows."""
    if _sharded(stacked.i2n):
        return model_api.local_view(stacked)
    rows = _rows(stacked.i2n.shape[0], mesh, "model")
    return PowerParams(*(x[rows] for x in model_api.local_view(stacked)))


def _note(box: torch.Tensor) -> None:
    global LAST_BOX
    LAST_BOX = tuple(box.shape)


def _shards(mesh, n_rows: int, n_modules: int) -> bool:
    """The reference's rule: shard when the mesh has more than one
    (data x model) device and both axes divide their batch axes."""
    if mesh is None:
        return False
    n_data = model_api.mesh_axis(mesh, "data")
    n_model = model_api.mesh_axis(mesh, "model")
    return (n_data * n_model > 1 and n_rows % n_data == 0
            and n_modules % n_model == 0)


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
                        sf: StructuralFeatures, stacked: PowerParams,
                        config: dict | None = None):
    """Masked charge of every (trace, paramset) pair and the masked cycles
    of every trace -> ``((..., V), (...,))``.  The structural pass ``sf``
    ran once for the batch; only the open-bank finalize and the charge
    integration run per parameter set.  ``config`` places a sharded box
    of traces in its batch (``kernels.common.batch_rows``)."""
    rows = batch_rows(config)
    charges = []
    for v in range(stacked.i2n.shape[0]):
        pp = stacked.select(v)
        c = charge_from_features(tr, finalize_features(sf, pp), pp)
        charges.append(row_sums(c * w, rows))
    return torch.stack(charges, dim=-1), masked_cycles(tr, w)


def _currents(charge: torch.Tensor, cycles: torch.Tensor) -> torch.Tensor:
    """(P, M) masked charge and (P,) cycles -> the (M, P) current matrix."""
    return (charge / torch.clamp(cycles.to(torch.float32),
                                 min=1.0)[:, None]).T


def fleet_measure_current(trace: CommandTrace, weight: torch.Tensor,
                          stacked: PowerParams,
                          sf: StructuralFeatures | None = None,
                          config: dict | None = None) -> torch.Tensor:
    """Noise-free average current of every (module, probe) pair in plain
    PyTorch: ``trace``/``weight`` are a ProbeBatch's padded fields,
    ``stacked`` the fleet's stacked params -> float32 (modules, probes).
    ``sf`` is the batch's structural pass when the caller already has it
    (it depends on the traces only); ``config`` places a sharded box in
    its batch, as the kernels' twin takes it."""
    if sf is None:
        sf = extract_structural_features(trace)
    return _currents(*batched_pair_totals(trace, weight, sf, stacked,
                                          config))


def fleet_measure_current_cuda(trace: CommandTrace, weight: torch.Tensor,
                               stacked: PowerParams,
                               config: dict | None = None) -> torch.Tensor:
    """The ``impl='cuda'`` twin of :func:`fleet_measure_current`: the
    feature kernel once over the probe batch, then the VAMPIRE charge
    kernel (launched at ``config``) with the probe axis as its trace axis
    and the module axis as its vendor axis (the true params' ``ones_quad``
    curvature is part of the kernel)."""
    from repro_torch.kernels.vampire_energy import ops as vops
    return _currents(*vops.batched_charge_matrix(trace, weight, stacked,
                                                 config=config))


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
    one-shot one.  With a ``mesh`` every rank makes the call; traces
    shard over ``data`` and modules over ``model`` (the module docstring)
    and every rank returns the whole report.  Chunking and a mesh are
    exclusive strategies.  A call is the root span ``fleet_map``
    (``repro_torch.spans``)."""
    with span("fleet_map"):
        from repro_torch.core import estimate_batch as eb
        impl = model_api.resolve_impl(impl, mode="surface").name
        if impl == "reference":
            raise ValueError("impl='reference' for the fleet surface is the "
                             "per-command oracle; score modules one at a time")
        chunked = module_chunk is not None or trace_chunk is not None
        if chunked and mesh is not None:
            raise ValueError("module_chunk/trace_chunk and mesh are "
                             "mutually exclusive surface strategies")
        stacked = fleet_stacked(modules, device, mesh)
        dev = stacked.i2n.device
        trace, weight = trace.to(dev), weight.to(dev)
        if chunked:
            return eb.chunked_surface_reports(
                trace, weight, stacked,
                module_chunk=(stacked.i2n.shape[0] if module_chunk is None
                              else module_chunk),
                trace_chunk=trace_chunk, impl=impl)
        if _shards(mesh, trace.cmd.shape[0], stacked.i2n.shape[0]):
            rows = _rows(trace.cmd.shape[0], mesh, "data")
            # a box's kernels launch at the whole batch's geometry, and its
            # 'vectorized' row sums are taken at the batch's shape
            box = eb.surface_chunk_charge(
                CommandTrace(*(x[rows] for x in trace)), weight[rows],
                _module_block(stacked, mesh), impl,
                config={"batch": (trace.cmd.shape[0], stacked.i2n.shape[0]),
                        "first_trace": rows.start})
            _note(box)
            charge = model_api.gather_boxes(box, mesh, {"data": 0, "model": 1})
            return eb.surface_report(charge, trace, weight)
        if mesh is not None:
            stacked = _whole(stacked, mesh)
        return eb.surface_report(
            eb.surface_chunk_charge(trace, weight, stacked, impl), trace,
            weight)


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
    a stacked ``PowerParams`` (a synthetic fleet) when ``noisy=False``.
    With a ``mesh`` the batched engine shards probes over ``data`` and
    modules over ``model`` and every rank returns the whole matrix."""
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
    stacked = fleet_stacked(modules, device, mesh)
    if batch is None:
        batch = ProbeBatch.from_points(points)
    batch = batch.to(stacked.i2n.device)
    measure = (fleet_measure_current_cuda if impl == "cuda"
               else fleet_measure_current)
    if _shards(mesh, batch.weight.shape[0], stacked.i2n.shape[0]):
        rows = _rows(batch.weight.shape[0], mesh, "data")
        box = measure(CommandTrace(*(x[rows] for x in batch.trace)),
                      batch.weight[rows], _module_block(stacked, mesh),
                      config={"batch": (batch.weight.shape[0],
                                        stacked.i2n.shape[0]),
                              "first_trace": rows.start})
        _note(box)
        currents = model_api.gather_boxes(box, mesh, {"model": 0, "data": 1})
    else:
        if mesh is not None:
            stacked = _whole(stacked, mesh)
        currents = measure(batch.trace, batch.weight, stacked)
    currents = currents.cpu().numpy().astype(np.float64)
    if noisy:
        from repro_torch.core import device_sim
        currents = currents * device_sim.measurement_noise_factors(
            [m.spec for m in modules], batch.keys)
    return currents
