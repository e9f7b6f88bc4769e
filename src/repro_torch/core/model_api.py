"""The unified estimator protocol, the impl registry and schema-v2 model
files, in PyTorch.

Every power model — the fitted VAMPIRE model and the datasheet baselines
(Micron calculator, DRAMPower) — implements ONE entry point:

    model.estimate(traces, vendors=None, *, mode='mean'|'range'|
                   'distribution'|'surface', impl='vectorized',
                   data=DataProfile(...) | None, ones_frac=None,
                   toggle_frac=None, config=None)

* ``traces`` is one :class:`~repro_torch.core.dram.CommandTrace`, a
  sequence of ragged traces, or a
  :class:`~repro_torch.core.estimate_batch.TraceBatch`; they are moved to
  the model's device;
* report leaves are ``(traces, vendors)``; ``'range'`` returns
  ``(lo, mean, hi)``; ``'surface'`` leaves are ``(traces, vendors, banks,
  row_bands)`` and sum over the cells to ``'mean'``;
* ``impl`` resolves through the registry: ``'vectorized'`` (plain
  PyTorch over the whole batch), ``'cuda'`` (the hand-written kernels of
  ``repro_torch.kernels``; on CPU tensors their plain versions) and
  ``'reference'`` (alias ``'scan'``: the pair-at-a-time per-command
  oracle);
* ``config`` is the charge kernels' launch configuration under
  ``impl='cuda'`` (``kernels.common.resolve_geometry``: the autotuner's
  choice when None).  A sharded dispatch estimates its box with the
  whole batch's ``{"batch": (traces, vendors), "first_trace": t0}``:
  ``'cuda'`` sizes the launch for the batch, ``'vectorized'`` sums the
  box's rows at the batch's shape (``kernels.common.row_sums``), so both
  give the batch's bits; ``'reference'`` ignores it.

A model lives on one device.  The entry points that make one
(:func:`load_estimator`, :func:`make_estimator`, the estimator classes)
put it on ``cuda`` unless the caller passes ``device="cpu"``; without a
card and without that request they raise rather than run on the CPU.
On a mesh of processes, :func:`device_resident` places a model's tensors
as DTensors and :func:`gather_boxes` assembles what the ranks computed
(the sharded serving engine and fleet dispatches).

Models are saved as schema v2: a ``.npz`` of plain arrays plus a
``__manifest__`` JSON entry, the format ``repro.core.model_api`` writes;
it is read with ``allow_pickle=False``.  The v1 pickle format is not
read here.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import zipfile
from typing import Literal, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

SCHEMA_VERSION = 2
MANIFEST_KEY = "__manifest__"

EstimateMode = Literal["mean", "range", "distribution", "surface"]


@runtime_checkable
class Estimator(Protocol):
    """What every power model exposes (see the module docstring)."""

    kind: str                        # 'vampire' | 'micron' | 'drampower'
    device: torch.device

    @property
    def vendors(self) -> tuple[int, ...]:
        """Vendor ids the model covers, in the stacked-leaf order."""
        ...

    def estimate(self, traces, vendors=None, *, mode: EstimateMode = "mean",
                 impl: str = "vectorized", data: "DataProfile | None" = None,
                 ones_frac=None, toggle_frac=None, config=None):
        ...

    def save(self, path: str) -> None:
        ...


def resolve_device(device=None) -> torch.device:
    """The device a model is put on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and no card
    is present — the port never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "estimators on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Impl registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EstimateImpl:
    """One way of evaluating the (traces, vendors) report matrix."""
    name: str
    description: str
    modes: tuple[str, ...] = ("mean", "range", "distribution", "surface")
    aliases: tuple[str, ...] = ()


_IMPLS: dict[str, EstimateImpl] = {}
_IMPL_ALIASES: dict[str, str] = {}


def register_impl(impl: EstimateImpl) -> EstimateImpl:
    """Register an impl (or re-register to override)."""
    _IMPLS[impl.name] = impl
    for alias in impl.aliases:
        _IMPL_ALIASES[alias] = impl.name
    return impl


def registered_impls() -> tuple[str, ...]:
    return tuple(sorted(_IMPLS))


def resolve_impl(name: str, *, mode: str | None = None) -> EstimateImpl:
    """Resolve an ``impl=`` argument (name or alias), checking that it
    supports ``mode``."""
    impl = _IMPLS.get(_IMPL_ALIASES.get(name, name))
    if impl is None:
        raise ValueError(f"unknown impl {name!r}; registered impls: "
                         f"{list(registered_impls())}")
    if mode is not None and mode not in impl.modes:
        raise ValueError(f"impl {impl.name!r} does not support mode "
                         f"{mode!r} (supports {list(impl.modes)})")
    return impl


def impl_execution_mode(name: str, device) -> str:
    """How an impl runs on ``device``: ``'kernel'`` for ``'cuda'`` on a
    CUDA device, ``'plain'`` for ``'cuda'`` on the CPU (the kernels'
    plain versions), ``'torch'`` for the other impls.  There is no
    fallback from a kernel to its plain version on a CUDA device."""
    impl = resolve_impl(name)
    if impl.name != "cuda":
        return "torch"
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def require_impl_path(kind: str, impl: str,
                      supported: tuple[str, ...]) -> None:
    """Raise when an estimator has no branch for a registered impl."""
    if impl not in supported:
        raise ValueError(
            f"estimator kind {kind!r} has no evaluation path for impl "
            f"{impl!r} (it implements {list(supported)}); registering an "
            f"impl does not give existing estimators a dispatch for it")


VECTORIZED_IMPL = register_impl(EstimateImpl(
    "vectorized",
    "plain PyTorch over the padded (traces, commands) batch: one "
    "structural pass, one charge pass per vendor",
    modes=("mean", "range", "distribution", "surface")))
CUDA_IMPL = register_impl(EstimateImpl(
    "cuda",
    "hand-written Hopper kernels: one feature kernel per batch and a "
    "per-vendor charge kernel over (chunks, traces, vendors); their plain "
    "versions on CPU tensors",
    modes=("mean", "range", "distribution", "surface")))
REFERENCE_IMPL = register_impl(EstimateImpl(
    "reference",
    "pair-at-a-time per-command oracle (a host-side walk of the state "
    "machine for measured-data modes), kept for cross-checking",
    modes=("mean", "range", "distribution", "surface"),
    aliases=("scan",)))


# ---------------------------------------------------------------------------
# Argument contract
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DataProfile:
    """Fraction of ones on the bus and of toggling bit lanes (scalar, or
    one value per trace) for ``mode='distribution'``."""
    ones_frac: object = None
    toggle_frac: object = None

    @property
    def empty(self) -> bool:
        return self.ones_frac is None and self.toggle_frac is None


def normalize_data_profile(data: "DataProfile | None" = None,
                           ones_frac=None,
                           toggle_frac=None) -> DataProfile:
    """Map the typed ``data=`` argument or the loose kwargs onto one
    :class:`DataProfile`; exactly one spelling per call."""
    if data is not None:
        if not isinstance(data, DataProfile):
            raise TypeError(f"data= must be a DataProfile, got "
                            f"{type(data).__name__}")
        if ones_frac is not None or toggle_frac is not None:
            raise ValueError("pass data=DataProfile(...) OR the loose "
                             "ones_frac=/toggle_frac= kwargs, not both")
        return data
    return DataProfile(ones_frac=ones_frac, toggle_frac=toggle_frac)


def validate_estimate_args(mode: str, ones_frac, toggle_frac) -> None:
    """Fractions are required with ``mode='distribution'`` and rejected
    with any other mode."""
    if mode not in ("mean", "range", "distribution", "surface"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "distribution":
        if ones_frac is None or toggle_frac is None:
            raise ValueError("mode='distribution' requires ones_frac "
                             "and toggle_frac")
    elif ones_frac is not None or toggle_frac is not None:
        raise ValueError("ones_frac/toggle_frac are only meaningful "
                         "with mode='distribution'")


def validate_data_profile(mode: str, profile: DataProfile) -> None:
    validate_estimate_args(mode, profile.ones_frac, profile.toggle_frac)


# ---------------------------------------------------------------------------
# Fitter registry: HOW a model's parameters are obtained.  The registry
# stores no fit callable; :func:`fit` owns the name-keyed dispatch and
# raises on a registered fitter it has no branch for.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FitterSpec:
    """One way of producing fitted model parameters: ``streaming=False``
    fitters are one-shot (``fit()`` returns a fitted estimator);
    ``streaming=True`` ones return a stateful fitter."""
    name: str
    description: str
    streaming: bool
    aliases: tuple[str, ...] = ()


_FITTERS: dict[str, FitterSpec] = {}
_FITTER_ALIASES: dict[str, str] = {}


def register_fitter(spec: FitterSpec) -> FitterSpec:
    """Register a fitter (or re-register to override)."""
    _FITTERS[spec.name] = spec
    for alias in spec.aliases:
        _FITTER_ALIASES[alias] = spec.name
    return spec


def registered_fitters() -> tuple[str, ...]:
    return tuple(sorted(_FITTERS))


def resolve_fitter(name: str, *,
                   streaming: bool | None = None) -> FitterSpec:
    """Resolve a ``fitter=`` argument (name or alias), checking it against
    the requested execution style."""
    spec = _FITTERS.get(_FITTER_ALIASES.get(name, name))
    if spec is None:
        raise ValueError(f"unknown fitter {name!r}; registered fitters: "
                         f"{list(registered_fitters())}")
    if streaming is not None and streaming != spec.streaming:
        style = "streaming" if spec.streaming else "one-shot"
        want = "streaming" if streaming else "one-shot"
        raise ValueError(f"fitter {spec.name!r} is {style}, not {want}")
    return spec


CAMPAIGN_FITTER = register_fitter(FitterSpec(
    "campaign",
    "one-shot offline characterization campaign "
    "(repro_torch.core.characterize): measure every probe cell on the "
    "simulated rig, invert the slot accounting once",
    streaming=False,
    aliases=("offline",)))
STREAMING_FITTER = register_fitter(FitterSpec(
    "streaming",
    "incremental fitter (repro_torch.core.recalibrate): decayed "
    "per-probe-cell sufficient statistics updated from telemetry ticks, "
    "re-inverted into model refreshes of the same shape for "
    "ServingEngine.update_model",
    streaming=True,
    aliases=("online",)))


def fit(kind: str = "vampire", fleet=None, *, fitter: str = "campaign",
        device=None, **kw):
    """The unified fit entry point, on ``device`` (``cuda`` unless the
    caller names another).

    ``fitter='campaign'`` runs the offline campaign over ``fleet``
    (``device_sim.make_fleet()`` modules; the paper's 50 when None) and
    returns a fitted estimator of ``kind``; extra kwargs go to
    ``characterize.characterize_fleet`` (``probe_modules``,
    ``probe_reps``, ``n_rows``, ``rng_seed``, ``engine``, ``impl``).
    ``fitter='streaming'`` returns a
    :class:`repro_torch.core.recalibrate.StreamingFitter` primed on an
    initial model (``init_model=``, or a fresh campaign fit when omitted;
    ``config=``, ``impl=``)."""
    spec = resolve_fitter(fitter)
    if spec.name == "campaign":
        from repro_torch.core import characterize
        from repro_torch.core.vampire import Vampire
        device = resolve_device(device)
        model = Vampire.from_characterization(
            characterize.characterize_fleet(fleet, device=device, **kw),
            device)
        return model if kind == "vampire" else make_estimator(kind, model)
    if spec.name == "streaming":
        if kind != "vampire":
            raise ValueError("fitter='streaming' recalibrates the fitted "
                             "VAMPIRE model; derive baselines from it via "
                             "make_estimator")
        from repro_torch.core import recalibrate
        return recalibrate.streaming_fitter(fleet, device=device, **kw)
    raise ValueError(
        f"fitter {spec.name!r} is registered but fit() has no dispatch "
        f"branch for it; registering a fitter does not give fit() an "
        f"execution path")


def resolve_vendor_indices(order: Sequence[int],
                           vendors) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Normalize a ``vendors`` argument against a model's stacked vendor
    order -> (vendor ids, row indices into the stacked leaves)."""
    order = list(order)
    if vendors is None:
        vs = tuple(order)
    elif isinstance(vendors, (int, np.integer)):
        vs = (int(vendors),)
    else:
        vs = tuple(int(v) for v in vendors)
    try:
        idx = tuple(order.index(v) for v in vs)
    except ValueError:
        missing = [v for v in vs if v not in order]
        raise KeyError(f"vendor(s) {missing} not fitted; model covers "
                       f"{order}") from None
    return vs, idx


def stack_reports(reports):
    """Stack a list of EnergyReports leaf by leaf along a new axis 0."""
    from repro_torch.core.energy_model import EnergyReport
    return EnergyReport(*(torch.stack(leaves) for leaves in zip(*reports)))


# ---------------------------------------------------------------------------
# Per-model caches
# ---------------------------------------------------------------------------
class TraceBatchCache:
    """Remembers the padded, device-resident TraceBatch of the last few
    trace sets scored through a model, keyed by trace identity (entries
    hold the traces, so an id cannot be recycled while cached)."""

    def __init__(self, device, maxsize: int = 4):
        self.device = device
        self.maxsize = maxsize
        self._entries: list[tuple[tuple, object]] = []

    def get(self, traces):
        from repro_torch.core.dram import CommandTrace
        from repro_torch.core.estimate_batch import TraceBatch, as_trace_batch
        if isinstance(traces, TraceBatch):
            return traces.to(self.device)
        key = ((traces,) if isinstance(traces, CommandTrace)
               else tuple(traces))
        for held, tb in self._entries:
            if len(held) == len(key) and all(a is b
                                             for a, b in zip(held, key)):
                return tb
        tb = as_trace_batch(list(key)).to(self.device)
        self._entries.append((key, tb))
        del self._entries[:-self.maxsize]
        return tb


class StackedEstimatorMixin:
    """Caches every stacked estimator shares: the padded-batch memo and
    vendor-subset slices of the stacked leaves."""

    @property
    def _batch_cache(self) -> TraceBatchCache:
        cache = self.__dict__.get("_batches")
        if cache is None:
            cache = self.__dict__["_batches"] = TraceBatchCache(self.device)
        return cache

    def _memo_subset(self, idx: tuple[int, ...], build):
        cache = self.__dict__.setdefault("_subsets", {})
        hit = cache.get(idx)
        if hit is None:
            hit = cache[idx] = build()
        return hit


# ---------------------------------------------------------------------------
# Models on a mesh
# ---------------------------------------------------------------------------
_MODEL_CACHES = ("_batches", "_subsets")


def map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor it holds, through named
    tuples, tuples, lists, dicts and the attributes of a dataclass
    instance (a copy, without its per-model caches); any other object is
    kept as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(x, fn) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(x, fn) for x in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        new = copy.copy(obj)
        object.__setattr__(new, "__dict__", {
            k: map_tensors(v, fn) for k, v in vars(obj).items()
            if k not in _MODEL_CACHES})
        return new
    return obj


def device_resident(model, mesh=None, *, axis: str | None = None):
    """The model with every tensor a DTensor on ``mesh``: ``Replicate()``
    on every mesh dimension, or with ``axis`` (``'model'``) its leading
    dimension ``Shard(0)`` over that mesh dimension and ``Replicate()``
    on the others (the stacked fleet's module axis).  Each rank keeps its
    own box of the tensor it holds (every rank holds the same model, as
    SPMD callers do), so no collective runs.  The model's structure is
    kept; without a mesh the model is returned as it is."""
    if mesh is None:
        return model
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    pl = tuple(Shard(0) if name == axis else Replicate()
               for name in mesh.mesh_dim_names)

    def one(t):
        if isinstance(t, DTensor):
            return t
        return distribute_tensor(t.to(mesh.device_type), mesh, pl,
                                 src_data_rank=None)
    return map_tensors(model, one)


def local_view(model):
    """The model with each DTensor replaced by this rank's shard of it
    (``to_local()``), which the kernels and the plain dispatches take."""
    from torch.distributed.tensor import DTensor
    return map_tensors(model, lambda t: t.to_local()
                       if isinstance(t, DTensor) else t)


def mesh_axis(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (1 when absent)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def mesh_index(mesh, names: Sequence[str]) -> int:
    """This rank's position among the devices of ``names``' axes, in
    row-major order of the mesh's axes."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for name in mesh.mesh_dim_names:
        if name in names:
            index = index * mesh_axis(mesh, name) + coord[name]
    return index


def gather_boxes(box: torch.Tensor, mesh, dims: dict) -> torch.Tensor:
    """The whole tensor of which this rank holds ``box``, assembled on
    every rank: ``dims`` maps a mesh axis to the dimension of ``box`` it
    splits (axes splitting one dimension do so in the mesh's order, row
    major); the ranks along an axis that splits nothing hold the same box.
    Every rank's box has one shape.  One blocking
    ``all_gather_into_tensor`` over the whole process group (``gloo``
    takes CUDA tensors for it too), so the mesh must span the world; a
    mesh over some of the ranks raises a ``ValueError``."""
    import torch.distributed as dist
    src = box.contiguous()
    world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(f"a mesh of {mesh.size()} devices over a world "
                         f"of {world} ranks: the sharded dispatches "
                         f"gather over the whole world, so the mesh must "
                         f"span it (launch.mesh.make_local_mesh)")
    out = src.new_empty((world * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src)
    out = out.view((world,) + tuple(src.shape))
    ranks = mesh.mesh.flatten().to(device=out.device, dtype=torch.long)
    g = out[ranks].reshape(tuple(mesh.shape) + tuple(src.shape))
    names = list(mesh.mesh_dim_names)
    for i in reversed(range(len(names))):
        if names[i] not in dims:
            g = g.select(i, 0)
            del names[i]
    order, shape = [], []
    for k in range(src.dim()):
        split = [i for i, n in enumerate(names) if dims[n] == k]
        order += split + [len(names) + k]
        shape.append(src.shape[k] * math.prod(g.shape[i] for i in split))
    return g.permute(order).reshape(shape)


# ---------------------------------------------------------------------------
# Schema-v2 serialization
# ---------------------------------------------------------------------------
def save_estimator(model, path: str, *, meta: dict | None = None) -> None:
    """Write an estimator as a schema-v2 ``.npz`` + JSON manifest, the
    file ``repro.core.model_api.load_estimator`` reads."""
    kind = getattr(model, "kind", None)
    if kind == "vampire":
        arrays, manifest = _vampire_payload(model)
    elif kind in ("micron", "drampower"):
        arrays, manifest = _baseline_payload(model)
    else:
        raise TypeError(f"cannot serialize estimator kind {kind!r}")
    manifest["schema"] = SCHEMA_VERSION
    manifest["kind"] = kind
    if meta is not None:
        manifest["meta"] = meta
    payload = {MANIFEST_KEY: np.array(json.dumps(manifest))}
    payload.update(arrays)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def read_manifest(path: str) -> dict | None:
    """The v2 manifest of a saved estimator, or ``None`` for v1 pickles."""
    if not zipfile.is_zipfile(path):
        return None
    with np.load(path, allow_pickle=False) as npz:
        return json.loads(npz[MANIFEST_KEY].item())


def load_estimator(path: str, device=None):
    """Load a schema-v2 estimator onto ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not a schema-v2 model file (a v1 "
                         "pickle must be re-saved as v2 by the reference "
                         "package first)")
    with np.load(path, allow_pickle=False) as npz:
        manifest = json.loads(npz[MANIFEST_KEY].item())
        schema = manifest.get("schema")
        if schema != SCHEMA_VERSION:
            raise ValueError(f"unsupported model schema {schema!r} in {path}")
        kind = manifest.get("kind")
        if kind == "vampire":
            return _vampire_from_payload(npz, manifest, device)
        if kind in ("micron", "drampower"):
            return _baseline_from_payload(npz, manifest, device)
        raise ValueError(f"unknown estimator kind {kind!r} in {path}")


# ---- VAMPIRE payload ------------------------------------------------------
# fitted quantities stored per vendor (the reference's ``_FITTED_FIELDS``)
_FITTED_FIELDS = ("datadep", "datadep_r2", "i2n", "bank_open_delta",
                  "bank_read_factor", "bank_write_factor", "q_actpre",
                  "row_ones_slope", "q_ref", "i_pd", "act_surface",
                  "i_pd_slow", "i_actpd", "i_sr")


@dataclasses.dataclass(frozen=True)
class SavedFit:
    """What a VAMPIRE model file held besides the fleet's float32 leaves:
    every array but the manifest (the float64 fitted arrays, ``band``,
    ``idd_datasheet``, ``datadep_r2`` and the ``raw/<vendor>/...``
    campaign arrays) and the manifest's ``idd_r2``, ``row_r2`` and
    ``raw``."""
    arrays: dict
    idd_r2: dict
    row_r2: dict
    raw: bool


_SWEEP_FIELDS = ("ones", "toggles", "current", "corrected")


def saved_fit_from_campaign(by_vendor: dict, bands: dict) -> SavedFit:
    """The arrays and manifest maps of a fresh campaign fit, named and
    typed as the reference's ``_vampire_payload`` writes them: the float64
    fitted quantities, ``band``, ``idd_datasheet`` and the
    ``raw/<vendor>/...`` campaign arrays."""
    vs = sorted(by_vendor)
    arrays: dict[str, np.ndarray] = {
        "vendor_ids": np.asarray(vs, np.int64),
        "band": np.asarray([bands[v] for v in vs], np.float64)}
    for field in _FITTED_FIELDS:
        arrays[field] = np.stack([np.asarray(getattr(by_vendor[v], field),
                                             np.float64) for v in vs])
    idd_keys = sorted(by_vendor[vs[0]].idd_datasheet)
    arrays["idd_datasheet"] = np.asarray(
        [[by_vendor[v].idd_datasheet[k] for k in idd_keys] for v in vs],
        np.float64)
    idd_r2, row_r2, raw = {}, {}, False
    for v in vs:
        vc = by_vendor[v]
        idd_r2[str(v)] = dict(vc.idd_extrapolation_r2)
        if vc.row_sweep:
            row_r2[str(v)] = float(vc.row_sweep.get("r2", 0.0))
        if not (vc.idd_measured or vc.ones_sweep or vc.row_sweep):
            continue
        raw = True
        for key, arr in vc.idd_measured.items():
            arrays[f"raw/{v}/idd_measured/{key}"] = np.asarray(arr,
                                                               np.float64)
        for (mode, op), sweep in vc.ones_sweep.items():
            for field in _SWEEP_FIELDS:
                arrays[f"raw/{v}/ones_sweep/{mode}/{op}/{field}"] = \
                    np.asarray(sweep[field], np.float64)
        for field in ("row_ones", "current"):
            if vc.row_sweep:
                arrays[f"raw/{v}/row_sweep/{field}"] = \
                    np.asarray(vc.row_sweep[field], np.float64)
    return SavedFit(arrays=arrays, idd_r2=idd_r2, row_r2=row_r2, raw=raw)


def _vampire_payload(model) -> tuple[dict, dict]:
    saved = model.saved
    manifest = {"vendors": list(model.vendors),
                "idd_keys": list(model.idd_keys),
                "idd_r2": {}, "row_r2": {}, "raw": False}
    if saved is not None:
        manifest.update(idd_r2=saved.idd_r2, row_r2=saved.row_r2,
                        raw=saved.raw)
        return dict(saved.arrays), manifest
    # a model built in the port: its float32 leaves
    fm = model.fleet
    arrays: dict[str, np.ndarray] = {
        "vendor_ids": fm.vendor_ids.cpu().numpy().astype(np.int64),
        "band": fm.band.cpu().numpy().astype(np.float64),
        "idd_datasheet": fm.idd_datasheet.cpu().numpy().astype(np.float64),
        "datadep_r2": np.zeros((fm.band.shape[0], 4, 2)),
    }
    for field in _FITTED_FIELDS:
        if field != "datadep_r2":
            arrays[field] = getattr(fm.params, field).cpu().numpy().astype(
                np.float64)
    return arrays, manifest


def _vampire_from_payload(npz, manifest, device):
    from repro_torch.convert import fleet_model_from_numpy, params_from_fitted
    from repro_torch.core.vampire import Vampire
    arrays = {name: np.asarray(npz[name]) for name in npz.files
              if name != MANIFEST_KEY}
    fitted = {f: arrays[f] for f in _FITTED_FIELDS
              if f != "datadep_r2" and f in arrays}
    fleet = fleet_model_from_numpy(
        params_from_fitted(fitted), band=arrays["band"],
        idd_datasheet=arrays["idd_datasheet"],
        vendor_ids=arrays["vendor_ids"], device=device)
    saved = SavedFit(arrays=arrays, idd_r2=manifest.get("idd_r2", {}),
                     row_r2=manifest.get("row_r2", {}),
                     raw=bool(manifest.get("raw", False)))
    return Vampire(fleet=fleet, idd_keys=tuple(manifest["idd_keys"]),
                   saved=saved, vendor_order=tuple(
                       int(v) for v in arrays["vendor_ids"]))


# ---- baseline payload -----------------------------------------------------
def _baseline_payload(model) -> tuple[dict, dict]:
    vs = list(model.vendors)
    idd_keys = sorted(model.datasheets[vs[0]])
    arrays = {
        "vendor_ids": np.asarray(vs, np.int64),
        "idd_table": np.asarray(
            [[model.datasheets[v][k] for k in idd_keys] for v in vs],
            np.float64),
    }
    return arrays, {"vendors": vs, "idd_keys": idd_keys}


def _baseline_from_payload(npz, manifest, device):
    from repro_torch.core.baselines_power import BASELINE_MODELS
    cls = BASELINE_MODELS[manifest["kind"]]
    vs = [int(v) for v in np.asarray(npz["vendor_ids"])]
    idd_keys = list(manifest["idd_keys"])
    table = np.asarray(npz["idd_table"], np.float64)
    return cls.from_datasheets(
        {v: {k: float(table[i, j]) for j, k in enumerate(idd_keys)}
         for i, v in enumerate(vs)}, device=device)


# ---------------------------------------------------------------------------
# Estimator kinds
# ---------------------------------------------------------------------------
def make_estimator(kind: str, vampire) -> "Estimator":
    """Build the requested estimator kind from a fitted VAMPIRE model, on
    the model's device (the baselines share its per-vendor datasheets)."""
    if kind == "vampire":
        return vampire
    from repro_torch.core.baselines_power import BASELINE_MODELS
    if kind in BASELINE_MODELS:
        return BASELINE_MODELS[kind].from_vampire(vampire)
    raise ValueError(f"unknown estimator kind {kind!r}; expected 'vampire', "
                     f"'micron', or 'drampower'")


ESTIMATOR_KINDS = ("vampire", "micron", "drampower")
