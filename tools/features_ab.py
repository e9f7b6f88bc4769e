#!/usr/bin/env python3
"""Time an earlier feature stage against the checkout's, in turns, on one
card.

    mkdir -p build/features_ab/old
    for f in features.cu common.cuh; do
        git show 87b8724:src/repro_torch/csrc/$f > build/features_ab/old/$f
    done
    python3 tools/features_ab.py build/features_ab/old [--rounds 4]

The directory holds an earlier ``features.cu`` beside the header it
includes, whose kernel reads a materialised previous line and a float
toggle mask (``repro_features(data, prev, tmask, ones, togg, m,
stream)``); it is compiled with the port's ``nvcc`` flags into
``build/features_ab/`` (its ``-Xptxas -v`` report printed).  Three sides
of the feature stage of ``ops.charge_planes``, each given the batch's
``structural_state``:

* ``old``: that source's whole stage as its ``charge_planes`` ran it:
  ``prev_lines`` (clamp, widen, expand, gather, select), the toggle mask
  cast to float32, then the earlier kernel;
* ``old_kernel``: the earlier kernel alone, on a previous line and mask
  made beforehand;
* ``new``: the checkout's ``batched_features(data, cmd, prev_rw)``.

At the estimation batch (64 traces of 6000 requests at 16,384 commands)
and the validation (23 sweeps), recalibration slice (120 probe cells)
and IDD (12 cells) batches, every side is first checked bit-exact
against the plain version and then timed in turns (old, old_kernel, new,
new, old_kernel, old per round): device ms with ``chip_smoke.event_ms``
(L2 flushed, mean of 20) and host-clock ms with ``chip_smoke.wall_ms``
(to a synchronize, median of 20), which counts the launches the host
makes.  Each line gives every sample, the median and the mean, the
median's share of the bound (80 B a line at 3.35 TB/s) and the old
median over the new, with the card's ``name, power.limit``.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

ORDER = ("old", "old_kernel", "new", "new", "old_kernel", "old")


def batches(seed: int, device) -> dict:
    """The four batches the feature stage runs at on the main paths."""
    import chip_smoke
    from repro_torch.core import characterize, idd_loops, validate
    from repro_torch.core.estimate_batch import TraceBatch
    _, est = chip_smoke.build_workload(seed, 64, 6000, 16384, device)
    plan = characterize.campaign_plan()
    probes = plan.batch_on("probe_batch", device)
    return {
        "est": est.trace,
        "val": TraceBatch.from_traces(
            [idd_loops.validation_sweep(n) for n in validate.N_READS]
        ).to(device).trace,
        "slice": probes.select(list(range(120))).trace,
        "idd": plan.batch_on("idd_batch", device).trace}


def sides(lib: ctypes.CDLL, trace) -> tuple[dict, tuple]:
    """The three sides on ``trace`` and the plain version's result."""
    import torch

    from repro_torch.core.energy_model import prev_lines, structural_state
    from repro_torch.kernels import build
    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    fn = lib.repro_features
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    t, n = trace.cmd.shape
    m = t * n
    dev = trace.cmd.device
    st = structural_state(trace)
    data = trace.data.reshape(m, -1)

    def old_kernel(prev, tmask):
        ones = torch.empty(m, dtype=torch.float32, device=dev)
        togg = torch.empty(m, dtype=torch.float32, device=dev)
        build.check(fn(build.ptr(data), build.ptr(prev), build.ptr(tmask),
                       build.ptr(ones), build.ptr(togg), m,
                       build.stream(dev)), "earlier features kernel")
        return ones.reshape(t, n), togg.reshape(t, n)

    def old():
        tmask = (st.has_prev & st.is_rw).to(torch.float32)
        return old_kernel(prev_lines(trace.data, st).reshape(m, -1),
                          tmask.reshape(m))

    made = (prev_lines(trace.data, st).reshape(m, -1).contiguous(),
            (st.has_prev & st.is_rw).to(torch.float32).reshape(m))
    args = (trace.data, trace.cmd, st.prev_rw)
    return ({"old": old, "old_kernel": lambda: old_kernel(*made),
             "new": lambda: ve.batched_features(*args)},
            ve.batched_features_plain(*args))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("features_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from charge_ab import build_source
    card = chip_smoke.card_line()
    old_lib = build_source(args.old / "features.cu",
                           ROOT / "build" / "features_ab" / args.old.name,
                           args.old.name)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    for shape, trace in batches(args.seed, "cuda").items():
        fns, want = sides(old_lib, trace)
        for tag, fn in fns.items():
            got = fn()
            chip_smoke.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                             f"{tag} on {shape} differs from the plain "
                             f"version")
        t, n = trace.cmd.shape
        m = t * n
        b_ms, b_by = chip_smoke.bound(m * chip_smoke.FEATURE_LINE_BYTES,
                                      m * 64)
        dev_ms = {tag: [] for tag in fns}
        host_ms = {tag: [] for tag in fns}
        for _ in range(args.rounds):
            for tag in ORDER:
                dev_ms[tag].append(chip_smoke.event_ms(fns[tag], 20, flush))
                host_ms[tag].append(chip_smoke.wall_ms(fns[tag], 20))
        for what, times in (("device", dev_ms), ("host", host_ms)):
            meds = {tag: statistics.median(ts) for tag, ts in times.items()}
            for tag, ts in times.items():
                print(f"[ab] features {shape} {what} {tag}: ms="
                      f"{' '.join(f'{x:.4f}' for x in ts)} mean="
                      f"{statistics.mean(ts):.4f} median={meds[tag]:.4f} "
                      f"share_of_bound={b_ms / meds[tag]:.3f} "
                      f"old_over_new={meds['old'] / meds['new']:.3f} "
                      f"bound_ms={b_ms:.4f} ({b_by}) shape=(T={t}, N={n}) "
                      f"lines={m} card=\"{card}\"", flush=True)
        del fns, want
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
