#!/usr/bin/env python3
"""Time a benchmark cell's calls with the program's spans recording and
not, in turns, inside the benchmark's own profiler session on one card:
what ``repro_torch.spans`` adds to a traced run.

    python3 tools/span_cost.py --workload vampire-ddr3l.batch-long \
        [--seed 7] [--blocks 8] [--calls 40]

Builds the cell's inputs and program as ``bench/run.py`` does, warms
every shape, then checks that ``torch.autograd._profiler_enabled()``
reads true inside the benchmark's CUDA-only profiler session and that
the program's spans record there and stop after it.  Then, inside one
such session, ``--blocks`` rounds, each of ``--calls`` calls with the
spans recording and as many with them switched off (the tool makes the
recorder's profiler check read false), the side that goes first
alternating.  For each side it prints the host time a call (from its
start to the entry's return) and the call time (to the result on the
host, or the synchronise): median, p95 and mean over the side's calls.
An "on" block's first calls are synced (``repro_torch.spans``: they wait
for the device at each span's edge): they are timed apart, as
``synced``.  It prints the spans a call with their counts, the
recorder's own host time a call after the synced ones (each span's
outer interval less its own), what a span costs with no profiler
running (the ``with`` block included), and whether a library was built
or loaded while recording (``build.nvcc_starts``, ``build._LIBS``); the
card's name and power limit lead the output.
"""
from __future__ import annotations

import argparse
import contextlib
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def summary(ns: list) -> str:
    ms = sorted(x / 1e6 for x in ns)
    p95 = ms[max(0, -(-95 * len(ms) // 100) - 1)]
    return (f"median {statistics.median(ms):.4f} p95 {p95:.4f} "
            f"mean {statistics.fmean(ms):.4f} ms ({len(ms)} calls)")


@contextlib.contextmanager
def spans_off(spans):
    """The recorder's profiler check reads false inside the block."""
    check = spans._profiling
    spans._profiling = lambda: False
    try:
        yield
    finally:
        spans._profiling = check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--calls", type=int, default=40)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    from harness import core, profile
    from harness import traffic as tf
    core.set_cache_dirs(ROOT)
    import torch

    from repro_torch import spans
    from repro_torch.kernels import build

    print(f"[card] {torch.cuda.get_device_name(0)}, power limit "
          f"{core.power_limit()}")
    manifest = core.load_json(ROOT / "BENCHMARK.json")
    files = core.cell_files(ROOT, manifest, args.workload)
    cfg, mix = core.load_json(files["config"]), core.load_json(
        files["traffic"])
    inputs = tf.make_inputs(cfg, mix, args.seed)
    prog = core.load_entry(ROOT, cfg, mix)(ROOT, cfg, mix, inputs, "cuda")
    nb = len(prog.batches)
    for _ in range(2):
        for b in range(nb):
            prog.call(b)

    profile.warm_profiler()
    prof = profile.Profiler()
    prof.start()
    inside = torch.autograd._profiler_enabled()
    prog.call(0)
    prof.stop()
    got = spans.drain()
    prog.call(0)
    print(f"[profiler] _profiler_enabled() in the CUDA-only session: "
          f"{inside}; spans of one call recorded there: {len(got)}; "
          f"after it: {len(spans.drain())}; enabled after it: "
          f"{torch.autograd._profiler_enabled()}")

    n = 200_000
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with spans.span("charge", launches=len):
            pass
    print(f"[off] a span with no profiler running: "
          f"{(time.perf_counter_ns() - t0) / n:.1f} ns")

    libs = (build.nvcc_starts, len(build._LIBS))
    times = {"off": ([], []), "on": ([], []), "synced": ([], [])}
    last = []
    i = 0
    prof = profile.Profiler()
    prof.start()
    for r in range(args.blocks):
        for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
            block = ([], [])
            with (spans_off(spans) if side == "off"
                  else contextlib.nullcontext()):
                for _ in range(args.calls):
                    t0 = time.perf_counter_ns()
                    _, t_ret = prog.call(i % nb)
                    t1 = time.perf_counter_ns()
                    block[0].append(t_ret - t0)
                    block[1].append(t1 - t0)
                    i += 1
            synced = 0
            if side == "on":
                last = spans.drain()        # outside the timed calls
                synced = sum(s.synced for s in last if s.parent is None)
            for k in (0, 1):                # a block's synced calls lead it
                times["synced"][k].extend(block[k][:synced])
                times[side][k].extend(block[k][synced:])
    prof.stop()
    for side, (host, call) in times.items():
        if host:
            print(f"[{side}] host {summary(host)}; call {summary(call)}")
    roots = [s for s in last if s.parent is None]
    per_call: dict = {}
    for s in last:
        row = per_call.setdefault(s.name, {"spans": 0})
        row["spans"] += 1
        for k, v in s.counts.items():
            row[k] = row.get(k, 0) + v
    for name, row in per_call.items():
        print(f"[spans] {name}: " + ", ".join(
            f"{k} {v / len(roots):g}" for k, v in row.items()) + " a call")
    later = [s for s in last if not s.synced]
    recorder = sum((s.outer_end_ns - s.outer_start_ns)
                   - (s.end_ns - s.start_ns) for s in later)
    n_later = max(1, sum(s.parent is None for s in later))
    print(f"[spans] the recorder's own host ms a call after the synced "
          f"ones: {recorder / n_later / 1e6:.4f}")
    print(f"[build] nvcc starts and libraries before / after the rounds: "
          f"{libs} / {(build.nvcc_starts, len(build._LIBS))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
