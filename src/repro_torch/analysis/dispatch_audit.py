"""Dispatch auditor: prove every registered (estimator kind x impl x mode)
combination keeps the estimation contracts, by running it once under a
recorder.

A port of ``repro.analysis.dispatch_audit``.  The reference traces each
dispatch to a jaxpr and lowers it to StableHLO; PyTorch runs eagerly and
compiles no programs, so each check is given a torch meaning here:

* **float64** (every impl) — the production ``estimate`` runs once under a
  ``TorchDispatchMode`` (:class:`OpRecorder`) that records every aten op
  whose output is ``float64`` or ``complex128``: the energy pipeline is a
  float32 contract end to end.  A CUDA kernel's own arithmetic is
  invisible to the mode; its output is allocated float32 by
  ``kernels.common.launch_charge``.
* **host_callback** (``'vectorized'`` and ``'cuda'``) — any synchronisation
  of the host with the device inside the dispatch.  The recorder lists
  ``aten._local_scalar_dense`` (``.item()``, ``bool(t)``, ``int(t)``),
  ``aten.nonzero``, ``aten.masked_select`` and indexing by a boolean
  mask (on the card each needs the count of its true elements on the
  host), a copy onto the CPU of a device tensor, and
  ``aten.lift_fresh`` (host data made into a tensor, on the card a blocking
  copy to the device).  On a CUDA device the dispatch also runs under
  ``torch.cuda.set_sync_debug_mode("error")``, and an error it raises is a
  finding carrying the error's text.  ``'reference'`` is exempt from this
  check alone: the port's oracle is a command-by-command walk on the host
  by design (``core/energy_model.trace_charges_scan``), where the
  reference's is a traced ``lax.scan``.
* **pad_masking** (``'vectorized'`` and ``'cuda'``) — the reference proves
  by dead-code elimination that the batch's ``weight`` is live; torch has
  no jaxpr, so it is tested by perturbation: zeroing the weight of one
  real command that carries charge must change the report, and filling
  the pad slots (weight 0) with live commands copied from another trace
  must leave every leaf equal bit for bit.
* **recompile** — the port has no ``torch.compile``; the only per-shape
  or per-call build state is the kernel libraries (``kernels.build._LIBS``
  and the ``nvcc`` starts), the charge kernels' launch geometry
  (``kernels.common.charge_geometry``'s cache) and the autotuner's lookups
  (``kernels.autotune``), counted by :func:`build_state`; and in serving
  ``ServingEngine.cache_size()``.  On the CPU the kernel counts stay 0 by
  construction, so those probes bite on the card.

Findings are structured (:class:`AuditFinding`); ``python -m
repro_torch.analysis`` fails on any ERROR severity.  Every function takes
``device=`` (``cuda`` unless the caller names another).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ERROR = "error"
WARNING = "warning"

#: impls whose batched dispatch consumes the padded batch directly and
#: must therefore consume the validity mask, and must not wait on the
#: device (the oracle walks each ragged trace on the host by design)
_MASKED_IMPLS = ("vectorized", "cuda")
_SYNC_IMPLS = ("vectorized", "cuda")

_MODES = ("mean", "range", "distribution", "surface")
_MODE_KW = {"distribution": dict(ones_frac=0.5, toggle_frac=0.25)}
_WIDE = (torch.float64, torch.complex128)


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    """One dispatch-audit diagnostic."""
    kind: str       # estimator kind ('vampire' | 'micron' | 'drampower')
    impl: str       # registry impl name
    mode: str       # estimate mode
    check: str      # 'float64' | 'host_callback' | 'pad_masking' |
                    # 'recompile' | 'audit_trace'
    severity: str   # 'error' | 'warning'
    detail: str

    def __str__(self):  # pragma: no cover - formatting
        return (f"[{self.severity.upper()}] {self.check}: "
                f"kind={self.kind} impl={self.impl} mode={self.mode} — "
                f"{self.detail}")


def errors_of(findings: Iterable[AuditFinding]) -> list[AuditFinding]:
    return [f for f in findings if f.severity == ERROR]


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------
class OpRecorder(TorchDispatchMode):
    """Records, for every aten op run under it, the ``float64`` /
    ``complex128`` outputs (``wide``: (op, shape) pairs) and the ops that
    make the host wait on the device or bring host data in (``host``)."""

    _SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select",
                 "lift_fresh")
    _INDEX_OPS = ("index", "index_put", "index_put_")

    def __init__(self):
        super().__init__()
        self.wide: list[tuple[str, tuple[int, ...]]] = []
        self.host: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.dtype in _WIDE:
                self.wide.append((str(func), tuple(t.shape)))
        if name in self._SYNC_OPS:
            self.host.append(str(func))
        elif name in self._INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            self.host.append(f"{func} (boolean mask: a nonzero count)")
        elif name in ("_to_copy", "copy_") and _onto_cpu(name, args, out):
            self.host.append(f"{func} (device to host)")
        return out


def _onto_cpu(name: str, args, out) -> bool:
    """Whether a copy op moves a device tensor onto the CPU."""
    src, dst = (args[0], out) if name == "_to_copy" else (args[1], args[0])
    return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
            and src.device.type != "cpu" and dst.device.type == "cpu")


@contextlib.contextmanager
def _sync_errors(device: torch.device, on: bool):
    """``torch.cuda.set_sync_debug_mode("error")`` for the block on a CUDA
    device (nothing on the CPU); the mode is restored before any wait."""
    if not on or device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def record(fn, device, sync_errors: bool = False):
    """Run ``fn()`` under an :class:`OpRecorder` (and, when
    ``sync_errors`` on a CUDA device, the sync debug mode "error") ->
    ``(result, recorder, sync error text or None)``."""
    device = torch.device(device)
    rec = OpRecorder()
    out, sync = None, None
    try:
        with _sync_errors(device, sync_errors), rec:
            out = fn()
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        sync = str(exc).splitlines()[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, rec, sync


def build_state() -> dict[str, int]:
    """The port's per-shape and per-call build state: loaded kernel
    libraries, ``nvcc`` starts, charge-kernel geometries and autotuner
    lookups (all 0 on a machine that launched no kernel)."""
    from repro_torch.kernels import autotune, build, common
    return {"libraries": len(build._LIBS), "nvcc": build.nvcc_starts,
            "geometries": common.charge_geometry.cache_info().currsize,
            "autotune": autotune.lookups()}


def _growth(before: dict, after: dict) -> int:
    return sum(after[k] - before[k] for k in before)


# ---------------------------------------------------------------------------
# Shared probe inputs
# ---------------------------------------------------------------------------
def default_audit_batch(device="cuda"):
    """A small heterogeneous TraceBatch on ``device`` (real padding rows
    present, so the pad-masking check is not vacuous)."""
    from repro_torch.core import idd_loops, model_api, traces
    from repro_torch.core.estimate_batch import TraceBatch
    device = model_api.resolve_device(device)
    trs = [idd_loops.idd0(reps=4), idd_loops.idd4r(reps=2),
           traces.app_trace(traces.SPEC_APPS[0], n_requests=24)]
    return TraceBatch.from_traces(trs).to(device)


def _estimate(model, tb, impl: str, mode: str, vendors=None):
    return model.estimate(tb, vendors, mode=mode, impl=impl,
                          **_MODE_KW.get(mode, {}))


def _leaves(rep) -> list[torch.Tensor]:
    return [x for x in tree_flatten(rep)[0] if isinstance(x, torch.Tensor)]


def _perturbed(tb):
    """``(dropped, filled)``: ``tb`` with the weight of one real command
    that lasts at least a cycle (an ACT, else a RD/WR, else any) set to 0,
    and ``tb`` with every pad slot holding a live command of the longest
    trace (weight still 0)."""
    from repro_torch.core.dram import ACT, RD, WR, CommandTrace
    from repro_torch.core.estimate_batch import TraceBatch
    w = tb.weight.cpu().numpy()
    cmd = tb.trace.cmd.cpu().numpy()
    live = w > 0
    lasting = live & (tb.trace.dt.cpu().numpy() > 0)
    t0 = int(np.argmax(lasting.any(axis=1)))
    hits = np.flatnonzero(lasting[t0])
    for codes in ((ACT,), (RD, WR)):
        kind = np.flatnonzero(lasting[t0] & np.isin(cmd[t0], codes))
        if kind.size:
            hits = kind
            break
    dropped_w = w.copy()
    dropped_w[t0, hits[0]] = 0.0
    dropped = TraceBatch(tb.trace, torch.from_numpy(dropped_w).to(tb.device))

    src = int(np.argmax(live.sum(axis=1)))
    n_src = max(int(live[src].sum()), 1)
    take = np.arange(w.shape[1]) % n_src
    pad = ~live

    def fill(x):
        a = x.cpu().numpy().copy()
        a[pad] = a[src][take][np.nonzero(pad)[1]]
        return torch.from_numpy(a).to(tb.device)

    filled = TraceBatch(CommandTrace(*(fill(x) for x in tb.trace)),
                        tb.weight)
    return dropped, filled


# ---------------------------------------------------------------------------
# The per-combination audit
# ---------------------------------------------------------------------------
def audit_combination(model, impl: str, mode: str, tb=None,
                      device="cuda") -> list[AuditFinding]:
    """Run one (kind, impl, mode) dispatch under the recorder and the
    perturbations.  Returns findings (empty when clean)."""
    if tb is None:
        tb = default_audit_batch(device)
    device = torch.device(device)
    kind = model.kind
    findings: list[AuditFinding] = []
    syncs = impl in _SYNC_IMPLS
    _estimate(model, tb, impl, mode)              # warm: builds, memos
    try:
        rep, rec, sync = record(lambda: _estimate(model, tb, impl, mode),
                                device, sync_errors=syncs)
    except Exception as exc:  # infra failure, not a verified dispatch bug
        return [AuditFinding(kind, impl, mode, "audit_trace", ERROR,
                             f"dispatch failed: {exc!r}")]
    if rec.wide:
        ops = sorted(set(rec.wide))
        findings.append(AuditFinding(
            kind, impl, mode, "float64", ERROR,
            f"{len(rec.wide)} float64 op outputs (float32 contract "
            f"violated): {ops[:6]}"))
    if syncs and (rec.host or sync):
        detail = sync if sync else f"host round trips: {sorted(set(rec.host))}"
        findings.append(AuditFinding(kind, impl, mode, "host_callback",
                                     ERROR, detail))
    if rep is None or impl not in _MASKED_IMPLS:
        return findings

    dropped, filled = _perturbed(tb)
    base = _leaves(rep)
    if all(torch.equal(a, b) for a, b in
           zip(base, _leaves(_estimate(model, dropped, impl, mode)))):
        findings.append(AuditFinding(
            kind, impl, mode, "pad_masking", ERROR,
            "zeroing the weight of a real command left the report "
            "unchanged: the TraceBatch validity weight is ignored"))
    if not all(torch.equal(a, b) for a, b in
               zip(base, _leaves(_estimate(model, filled, impl, mode)))):
        findings.append(AuditFinding(
            kind, impl, mode, "pad_masking", ERROR,
            "live commands in zero-weight pad slots changed the report: "
            "padding rows would be billed as real commands"))
    return findings


# ---------------------------------------------------------------------------
# Recompilation-hazard probes
# ---------------------------------------------------------------------------
def audit_recompilation(model, modes: Sequence[str] = _MODES, tb=None,
                        tb_same_shape=None, device="cuda",
                        impls: Sequence[str] = _SYNC_IMPLS
                        ) -> list[AuditFinding]:
    """Drive the production ``estimate`` path and assert the build state
    (:func:`build_state`) stops growing once warm: repeated calls and a
    same-shape re-pad of DIFFERENT content add nothing, the first subset
    of two vendors adds at most one entry, and an equal-size subset adds
    nothing."""
    from repro_torch.core.dram import CommandTrace
    from repro_torch.core.estimate_batch import TraceBatch
    if tb is None:
        tb = default_audit_batch(device)
    if tb_same_shape is None:
        perm = torch.arange(tb.n_traces - 1, -1, -1, device=tb.device)
        tb_same_shape = TraceBatch(CommandTrace(*(x[perm] for x in tb.trace)),
                                   tb.weight[perm])
    kind = model.kind
    vendors = list(model.vendors)
    findings: list[AuditFinding] = []

    for impl in impls:
        for mode in modes:
            def call(batch, vs, mode=mode, impl=impl):
                _estimate(model, batch, impl, mode, vs)

            def grew(before, what, limit=0):
                if _growth(before, build_state()) > limit:
                    findings.append(AuditFinding(
                        kind, impl, mode, "recompile", ERROR,
                        f"{what} (build state {before} -> "
                        f"{build_state()})"))

            call(tb, vendors)                       # warm
            base = build_state()
            call(tb, vendors)                       # repeat: adds nothing
            grew(base, "a repeated estimate over an identical TraceBatch "
                 "added build state")
            call(tb_same_shape, vendors)            # same shape, new content
            grew(base, "a same-shape re-pad of a different ragged trace set "
                 "added build state")
            if len(vendors) >= 3:
                call(tb, vendors[:2])               # first subset of size 2
                grew(base, "a vendor subset added more than one build "
                     "entry", limit=1)
                grown = build_state()
                call(tb, vendors[1:])               # same-size subset
                grew(grown, "an equal-size vendor subset added build state "
                     "(subset slicing is shape-unstable)")
    return findings


# ---------------------------------------------------------------------------
# Serving-path probe (the ring's bucketing contract)
# ---------------------------------------------------------------------------
def audit_serving(model, impl: str = "vectorized",
                  device="cuda") -> list[AuditFinding]:
    """Drive the serving stack and assert the ring's pad-shape bucketing
    bounds the engine's dispatched shapes (``ServingEngine.cache_size()``):
    arrival mixes WITHIN one (count, length) bucket add none, and crossing
    into a new bucket adds exactly one."""
    from repro_torch.core import idd_loops
    from repro_torch.serving import (EstimationService, RingConfig,
                                     ServiceConfig)
    model = model.to(device)
    kind = model.kind
    findings: list[AuditFinding] = []
    short = [idd_loops.idd0(reps=2), idd_loops.idd0(reps=3),
             idd_loops.idd4r(reps=2)]
    long = idd_loops.validation_sweep(64)
    b1 = 1 << (max(int(tr.n) for tr in short) - 1).bit_length()
    b2 = max(1 << (int(long.n) - 1).bit_length(), b1 * 2)
    svc = EstimationService(model, ServiceConfig(
        ring=RingConfig(length_buckets=(b1, b2), count_buckets=(4, 8)),
        impl=impl, lint=False))

    def run(traces):
        svc.submit_many(traces)
        svc.drain()
        return svc.engine.cache_size()

    base = run(short)                          # warm: one (4, b1) shape
    if run(short[:2]) != base or run(short + short[:1]) != base:
        findings.append(AuditFinding(
            kind, impl, "mean", "recompile", ERROR,
            "varying arrival mixes within one (count, length) bucket "
            "added a dispatch shape (ring bucketing broken)"))
    crossed = run([long])                      # new length bucket: (4, b2)
    if crossed > base + 1:
        findings.append(AuditFinding(
            kind, impl, "mean", "recompile", ERROR,
            "crossing one length bucket added more than one dispatch "
            "shape"))
    if run([long] + short[:1]) != crossed:     # mixed window, known bucket
        findings.append(AuditFinding(
            kind, impl, "mean", "recompile", ERROR,
            "a mixed-length window landing in a known bucket added a "
            "dispatch shape"))
    return findings


# ---------------------------------------------------------------------------
# Fleet-scale chunked-dispatch probe
# ---------------------------------------------------------------------------
def audit_fleet_chunked(tb=None, module_chunk: int = 4,
                        device="cuda") -> list[AuditFinding]:
    """Drive ``estimate_batch.chunked_surface_reports`` and assert its
    scaling contract: at a fixed ``module_chunk``, growing the fleet 2x
    and revisiting a size add no build state (the chunk count never
    reaches the kernels' geometry), and the whole chunked dispatch, carry
    included, records no float64 op: through ``'vectorized'``, and
    ``'cuda'`` too on a CUDA device."""
    from repro_torch.core import device_sim
    from repro_torch.core import estimate_batch as EB
    if tb is None:
        tb = default_audit_batch(device)
    device = torch.device(device)
    impls = ("vectorized",) + (("cuda",) if device.type == "cuda" else ())
    _, small = device_sim.synth_fleet_params(2 * module_chunk, device=device)
    _, big = device_sim.synth_fleet_params(4 * module_chunk, device=device)
    findings: list[AuditFinding] = []

    for impl in impls:
        def run(stacked, impl=impl):
            return EB.chunked_surface_reports(
                tb.trace, tb.weight, stacked, module_chunk=module_chunk,
                impl=impl)

        run(small)                                       # warm
        base = build_state()
        run(big)                                         # 2x chunks
        if build_state() != base:
            findings.append(AuditFinding(
                "fleet", impl, "surface", "recompile", ERROR,
                "growing the fleet at a fixed module_chunk added build "
                f"state ({base} -> {build_state()})"))
        _, rec, _ = record(lambda: run(small), device)   # revisit
        if build_state() != base:
            findings.append(AuditFinding(
                "fleet", impl, "surface", "recompile", ERROR,
                "revisiting an already-seen fleet size added build state"))
        if rec.wide:
            findings.append(AuditFinding(
                "fleet", impl, "surface", "float64", ERROR,
                f"the chunked surface dispatch makes float64 buffers "
                f"(float32 contract violated): {sorted(set(rec.wide))[:6]}"))
    return findings


# ---------------------------------------------------------------------------
# Online-recalibration probe (the fit-while-serving contract)
# ---------------------------------------------------------------------------
def audit_recalibration(model=None, device="cuda") -> list[AuditFinding]:
    """Audit the streaming-fit path (``repro_torch.core.recalibrate``):

    * the ONE incremental update step (``_update_stats``) records no
      float64 op (the sufficient statistics are float32 end to end);
    * a round-robin telemetry stream of fixed-width slices adds no build
      state;
    * a streaming refit pushed through ``ServingEngine.update_model``
      leaves the engine's dispatch shapes and the loaded kernel libraries
      unchanged.

    The fitter and the engine run ``impl='cuda'`` (the kernels on a card,
    their plain versions on the CPU).
    """
    from repro_torch.core import params as P
    from repro_torch.core import recalibrate
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine

    if model is None:
        from repro_torch.core.vampire import reference_vampire
        model = reference_vampire(device)
    model = model.to(device)
    device = torch.device(device)
    cfg = recalibrate.RecalConfig(probe_reps=64, n_rows=8,
                                  probe_modules=2, slice_size=32)
    specs = [P.ModuleSpec(v, i, 2015)
             for v in model.vendors for i in range(2)]
    fitter = recalibrate.StreamingFitter(model, specs, cfg, impl="cuda")
    findings: list[AuditFinding] = []

    # ---- float64 in the update step (on copies of the statistics) --------
    stats = recalibrate.RunningStats(*(x.clone() for x in fitter.stats))
    cur = torch.zeros((len(specs), cfg.slice_size), dtype=torch.float32,
                      device=device)
    idx = torch.arange(cfg.slice_size, device=device)
    _, rec, _ = record(lambda: recalibrate._update_stats(
        stats, cur, idx, fitter._decay, fitter._predicted, fitter._floor),
        device)
    if rec.wide:
        findings.append(AuditFinding(
            "recalibrate", "streaming", "fit", "float64", ERROR,
            f"the incremental update step makes float64 buffers (the "
            f"sufficient statistics must stay float32): "
            f"{sorted(set(rec.wide))[:6]}"))

    # ---- no build state across the telemetry stream ----------------------
    predicted = fitter._predicted.cpu().numpy()
    fitter.observe(predicted[:, :cfg.slice_size],
                   np.arange(cfg.slice_size), tick=1)        # warm
    base = build_state()
    shifted = (np.arange(cfg.slice_size) + cfg.slice_size) % fitter.n_cells
    fitter.observe(predicted[:, shifted], shifted, tick=2)
    if build_state() != base:
        findings.append(AuditFinding(
            "recalibrate", "streaming", "fit", "recompile", ERROR,
            "the round-robin telemetry stream added build state (a "
            "fixed-width slice at a new tick must reuse it)"))

    # ---- streaming refit -> update_model: nothing new --------------------
    engine = ServingEngine(model, impl="cuda")
    tb = default_audit_batch(device)
    engine.dispatch(tb)                                      # warm
    warm, libs = engine.cache_size(), dict(build._LIBS)
    engine.update_model(fitter.refit())
    engine.dispatch(tb)
    if engine.cache_size() != warm or build._LIBS != libs:
        findings.append(AuditFinding(
            "recalibrate", "streaming", "fit", "recompile", ERROR,
            "a streaming refit pushed through ServingEngine.update_model "
            "added a dispatch shape or a kernel library"))
    return findings


# ---------------------------------------------------------------------------
# Whole-registry sweep
# ---------------------------------------------------------------------------
def audit_model(model, impls: Sequence[str] | None = None,
                modes: Sequence[str] | None = None, tb=None,
                recompile: bool = True, device="cuda") -> list[AuditFinding]:
    """Audit every (impl x mode) dispatch of one estimator."""
    from repro_torch.core import model_api
    if tb is None:
        tb = default_audit_batch(device)
    findings: list[AuditFinding] = []
    for impl in (impls if impls is not None else model_api.registered_impls()):
        for mode in (modes if modes is not None else
                     model_api.resolve_impl(impl).modes):
            findings.extend(audit_combination(model, impl, mode, tb, device))
    if recompile:
        findings.extend(audit_recompilation(
            model, modes if modes is not None else _MODES, tb,
            device=device))
    return findings


def audit_all(vampire, kinds: Sequence[str] | None = None,
              **kwargs) -> list[AuditFinding]:
    """Audit every registered estimator kind built from one fitted
    model."""
    from repro_torch.core import model_api
    findings: list[AuditFinding] = []
    for kind in (kinds if kinds is not None else model_api.ESTIMATOR_KINDS):
        model = model_api.make_estimator(kind, vampire)
        findings.extend(audit_model(model, **kwargs))
    return findings
