#!/usr/bin/env python3
"""Time earlier sources of the charge kernels against the checkout's, in
turns, on one card.

    mkdir -p build/charge_ab/old
    for f in vampire_energy.cu baseline_energy.cu common.cuh; do
        git show 17aa892:src/repro_torch/csrc/$f > build/charge_ab/old/$f
    done
    python3 tools/charge_ab.py build/charge_ab/old [more dirs ...] \\
        [--rounds 4]

Each directory holds an earlier ``vampire_energy.cu`` and
``baseline_energy.cu`` beside the headers they include, with the C
interface those sources had before the kernels reduced their own tiles:
the planes, the output ``(V, T, chunks)`` or ``(V, T, chunks, 64)`` of
1024-command partials, ``n_traces, n_cmds, n_vendors`` and the stream;
their partials are summed over the chunks by torch afterwards, as their
wrappers did.  Every source, the checkout's too, is compiled with the
port's ``nvcc`` flags into ``build/charge_ab/`` and its ``-Xptxas -v``
report printed.

On ``chip_smoke.py``'s estimation batch (64 traces of 6000 requests
padded to 16384 commands, 3 vendors) each of the six charge rows is
checked against its plain version (rtol 1e-5) for every source and then
timed with ``chip_smoke.event_ms`` (L2 flushed, mean of 20) in turns:
each old source, then the checkout's wrapper ("new") twice, then each old
source again, per round.  Each line gives every sample, their mean and
their median, and from the median (which a sample that a stalled host
call lengthened does not move) the speedup, the share of the row's bound
and the GB/s, with the card's ``name, power.limit``.  ``line_ones`` on 32 MiB
and a one-float fill are timed first under the same flush, as yardsticks
for a plain streaming read and for an empty launch.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OLD_CHUNK = 1024
SOURCES = ("vampire_energy", "baseline_energy")


def build_source(source: pathlib.Path, out_dir: pathlib.Path,
                 tag: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"{source.stem}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                           str(target), str(source)],
                          capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"[build] {tag}/{source.name}   {line.strip()}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}")
    return ctypes.CDLL(str(target))


def old_launcher(libs: dict, row: dict):
    """A call of an earlier source's kernel for ``row``, through its own C
    interface, its partials summed as its wrapper did."""
    import torch

    from repro_torch.kernels import build
    kind, surface, args = row["kind"], row["surface"], row["args"]
    lib = libs["vampire_energy" if kind == "vampire" else "baseline_energy"]
    fn = getattr(lib, f"repro_{kind}_charge" + ("_surface" if surface
                                                 else ""))
    n_ptrs = len(args) + 1
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    t, n = args[2 if kind == "vampire" else 0].shape
    v = args[-1].shape[0]
    dev = args[0].device
    shape = (v, t, -(-n // OLD_CHUNK)) + ((64,) if surface else ())

    def run():
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        build.check(fn(*(build.ptr(a) for a in args), build.ptr(out), t, n,
                       v, build.stream(dev)), row["name"])
        return out.sum(dim=2).transpose(0, 1)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", type=pathlib.Path, nargs="+")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("charge_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core import model_api
    from repro_torch.kernels import build

    card = chip_smoke.card_line()
    out_root = ROOT / "build" / "charge_ab"
    for name in SOURCES:
        build_source(build.CSRC / f"{name}.cu", out_root / "new", "new")
    olds = {d.name: {name: build_source(d / f"{name}.cu", out_root / d.name,
                                        d.name)
                     for name in SOURCES} for d in args.dirs}
    build.build_all()

    _, tb = chip_smoke.build_workload(args.seed, 64, 6000, 16384, "cuda")
    vampire = model_api.load_estimator(str(chip_smoke.MODEL_FILE),
                                       device="cuda")
    models = {k: model_api.make_estimator(k, vampire)
              for k in chip_smoke.KINDS}
    rows = chip_smoke.charge_rows(tb, models)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    t, n = tb.trace.cmd.shape
    # yardstick: a streaming read of 32 MiB (the popcount kernel, which
    # reads each byte once and writes 2 MiB)
    from repro_torch.kernels.popcount import popcount
    lines = torch.randint(-2**31, 2**31 - 1, (1 << 19, 16), device="cuda",
                          dtype=torch.int32)
    ref_ms = chip_smoke.event_ms(lambda: popcount.line_ones(lines), 20, flush)
    tiny = torch.empty(1, device="cuda")
    fill_ms = chip_smoke.event_ms(tiny.zero_, 20, flush)
    print(f"[ab] reference line_ones (32 MiB read) ms={ref_ms:.4f} fill "
          f"(one float) ms={fill_ms:.4f} card=\"{card}\"", flush=True)
    del lines
    for row in rows:
        want = row["plain"]()
        fns = {tag: old_launcher(libs, row) for tag, libs in olds.items()}
        fns["new"] = row["fn"]
        for tag, fn in fns.items():
            err = chip_smoke.assert_close(fn(), want, chip_smoke.RTOL,
                                          f"{tag} {row['name']}")
            print(f"[ab] {row['name']} {tag} max_abs_err={err:.3e}",
                  flush=True)
        b_ms, b_by = chip_smoke.bound(row["nbytes"], row["nops"])
        times = {tag: [] for tag in fns}
        for _ in range(args.rounds):
            for tag in [*olds, "new", "new", *reversed(list(olds))]:
                times[tag].append(chip_smoke.event_ms(fns[tag], 20, flush))
        meds = {tag: statistics.median(ts) for tag, ts in times.items()}
        for tag, ts in times.items():
            print(f"[ab] {row['name']} {tag}: ms="
                  f"{' '.join(f'{x:.4f}' for x in ts)} mean="
                  f"{statistics.mean(ts):.4f} median={meds[tag]:.4f} "
                  f"share_of_bound={b_ms / meds[tag]:.3f} gb_per_s="
                  f"{row['nbytes'] / meds[tag] / 1e6:.1f} speedup_of_new="
                  f"{meds[tag] / meds['new']:.2f} bound_ms={b_ms:.4f} "
                  f"({b_by}) shape=(T={t}, N={n}, V=3) "
                  f"card=\"{card}\"",
                  flush=True)

    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
