"""Whether the boxes a sharded estimation dispatch computes give the
whole batch's bits, one process, one card: every box the ranks of a
(1, 2), (2, 1) or (2, 2) ``(data, model)`` mesh would compute for
``chip_smoke.py``'s ``[mesh]`` calls (the fleet surface, the probe
matrix, the estimation service's windows) is computed here in turn and
held against the same slice of the whole batch's result.

* ``impl='cuda'``: each box at its own launch geometry and at the whole
  batch's (``config={"batch": ...}``, ``kernels.common.resolve_geometry``),
  with the device time of the service's boxes at each;
* ``impl='vectorized'``: each box as the plain dispatch computes it (the
  module axis is a Python loop there, so the fleet is cut to
  ``--vec-modules``; the row count is what a reduction's order can
  follow).

    python3 tools/mesh_box_probe.py                      # on the card
    PYTHONPATH=src python tools/mesh_box_probe.py --device cpu --small

Prints one line a (call, impl, mesh, geometry) and a JSON object of them
all last.  It reports; it checks nothing.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

MESHES = ((1, 2), (2, 1), (2, 2))


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _leaves(y)]


def _compare(box, whole) -> tuple[bool, float]:
    """(bit-equal, largest relative difference) of two results."""
    eq, rel = True, 0.0
    for a, b in zip(_leaves(box), _leaves(whole)):
        a, b = a.float().cpu(), b.float().cpu()
        eq = eq and bool(torch.equal(a, b))
        rel = max(rel, float(((a - b).abs() / b.abs().clamp(min=1e-30))
                             .max()) if a.numel() else 0.0)
    return eq, rel


def _slice(x, rows, mods, row_dim: int, mod_dim: int):
    """The (rows, mods) box of a result (``mods`` None: every module)."""
    if isinstance(x, torch.Tensor):
        x = x.narrow(row_dim, rows.start, rows.stop - rows.start)
        if mods is not None:
            x = x.narrow(mod_dim, mods.start, mods.stop - mods.start)
        return x
    return type(x)(*(_slice(y, rows, mods, row_dim, mod_dim) for y in x))


def boxes(n_rows: int, n_mods: int, shape):
    """Every rank's (rows, modules) of an ``(n_rows, n_mods)`` batch on a
    ``(data, model)`` mesh, traces over data and modules over model."""
    d, m = shape
    kr, km = n_rows // d, n_mods // m
    return [(slice(i * kr, (i + 1) * kr), slice(j * km, (j + 1) * km))
            for i in range(d) for j in range(m)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes, for a rehearsal on the CPU")
    ap.add_argument("--vec-modules", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import chip_smoke as cs
    from repro_torch.core import characterize, device_sim, dram, fleet
    from repro_torch.core import idd_loops, model_api
    from repro_torch.core import estimate_batch as eb
    from repro_torch.core.dram import CommandTrace
    from repro_torch.core.energy_model import PowerParams
    from repro_torch.core.estimate_batch import TraceBatch
    from repro_torch.serving import EstimationService, ServiceConfig

    dev = args.device
    cuda = dev == "cuda"
    if cuda:
        from repro_torch.kernels import build
        build.build_all()
        print(cs.card_line(), flush=True)
    n_modules = 40 if args.small else cs.FLEET_MODULES[-1]
    n_vec = 8 if args.small else args.vec_modules
    _, stacked = device_sim.synth_fleet_params(n_modules, device=dev)
    trace, weight = dram.batch_traces(
        [(idd_loops.validation_sweep(8, reps=12), 2),
         (idd_loops.validation_sweep(16, reps=8), 2)])
    trace, weight = trace.to(dev), weight.to(dev)
    plan = dict(probe_reps=16, n_rows=4) if args.small \
        else {}
    probe = characterize.campaign_plan(**plan).batch_on("probe_batch", dev)
    n_tr, n_req, length = (8, 40, 512) if args.small else (64, 6000, 16384)
    trs, _ = cs.build_workload(args.seed, n_tr, n_req, length, "cpu")
    model = model_api.load_estimator(str(cs.MODEL_FILE), device=dev)
    windows = []
    svc = EstimationService(model, ServiceConfig(lint=False))
    plain = svc.engine.dispatch
    svc.engine.dispatch = lambda tb, v: windows.append((tb, v)) or plain(
        tb, v)
    svc.submit_many(trs)
    svc.drain()
    svc.close()

    def sub(p: PowerParams, mods) -> PowerParams:
        return PowerParams(*(x[mods] for x in p))

    def rows_of(tr: CommandTrace, w, rows):
        return CommandTrace(*(x[rows] for x in tr)), w[rows]

    def time_ms(fn) -> float | None:
        return cs.event_ms(fn, 5) if cuda else None

    results = []

    def report(call, impl, tag, geo, per_box):
        eq = all(e for e, _ in per_box)
        rel = max(r for _, r in per_box)
        results.append(dict(call=call, impl=impl, mesh=tag, geometry=geo,
                            bit_equal=eq, max_rel=rel,
                            boxes=len(per_box)))
        print(f"[box] {call} {impl} {tag} geometry={geo}: "
              f"every box bit-equal={eq} max_rel={rel:.3e} "
              f"({len(per_box)} boxes)", flush=True)

    for impl in ("cuda", "vectorized"):
        st = stacked if impl == "cuda" else sub(stacked, slice(0, n_vec))
        n_mod = st.i2n.shape[0]
        geos = ("own", "whole") if impl == "cuda" else ("own",)
        measure = (fleet.fleet_measure_current_cuda if impl == "cuda"
                   else fleet.fleet_measure_current)
        def surface(tr, w, p, **kw):
            return eb.surface_chunk_charge(tr, w, p, impl, **kw)
        # the surface: (T, V, 8, R); the probe matrix: (V, P)
        calls = {"surface": (trace, weight, surface, 0, 1),
                 "probes": (probe.trace, probe.weight, measure, 1, 0)}
        for call, (tr, w, fn, row_dim, mod_dim) in calls.items():
            whole = fn(tr, w, st)
            n_rows = w.shape[0]
            for shape in MESHES:
                tag = f"{shape[0]}x{shape[1]}"
                for geo in geos:
                    per_box = []
                    for rows, mods in boxes(n_rows, n_mod, shape):
                        kw = ({"config": {"batch": (n_rows, n_mod)}}
                              if geo == "whole" else {})
                        got = fn(*rows_of(tr, w, rows), sub(st, mods), **kw)
                        per_box.append(_compare(
                            got, _slice(whole, rows, mods, row_dim,
                                        mod_dim)))
                    report(call, impl, tag, geo, per_box)
        # the service's windows, and their first 8 and 16 traces as
        # windows of their own: rows over every mesh device
        cuts = [(f"{tag} window of {size}", size)
                for tag in ("2 devices", "4 devices") for size in (8, 16)]
        for label, cut in [("2 devices", None), ("4 devices", None)] + cuts:
            n_shards, tag = int(label[0]), label
            for geo in geos:
                per_box, ms = [], []
                for tb, vendors in windows:
                    if cut is not None:
                        if tb.n_traces <= cut:
                            continue
                        tb = TraceBatch(*rows_of(tb.trace, tb.weight,
                                                 slice(0, cut)))
                    n = tb.n_traces
                    if n % n_shards:
                        continue
                    whole = model.estimate(tb, vendors, impl=impl)
                    k = n // n_shards
                    nv = len(vendors or model.vendors)
                    for i in range(n_shards):
                        rows = slice(i * k, (i + 1) * k)
                        box = TraceBatch(*rows_of(tb.trace, tb.weight, rows))

                        def run(box=box):
                            return model.estimate(
                                box, vendors, impl=impl,
                                config={"batch": (n, nv)}
                                if geo == "whole" else None)
                        per_box.append(_compare(
                            run(), _slice(whole, rows, None, 0, 1)))
                        if impl == "cuda" and i == 0:
                            ms.append(time_ms(run))
                if not per_box:
                    continue
                report("service", impl, tag, geo, per_box)
                if ms and ms[0] is not None:
                    results[-1]["box0_ms"] = ms
                    print(f"[box] service cuda {tag} geometry={geo}: "
                          f"first box's device ms per window {ms}",
                          flush=True)
    print(json.dumps({"boxes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
