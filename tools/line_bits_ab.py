#!/usr/bin/env python3
"""Time an earlier source of the line kernels against the checkout's, in
turns, on one card.

    mkdir -p build/line_bits_ab/old
    for f in line_bits.cu common.cuh; do
        git show 51c8527:src/repro_torch/csrc/$f > build/line_bits_ab/old/$f
    done
    python3 tools/line_bits_ab.py build/line_bits_ab/old [--rounds 4]

The directory holds an earlier ``line_bits.cu`` beside the header it
includes, compiled with the port's ``nvcc`` flags into
``build/line_bits_ab/`` (its ``-Xptxas -v`` report printed).  Each side
of ``line_toggles_seq`` is timed as the whole call its wrapper makes:
the earlier side is a fill of ``out[0]`` and then ``repro_line_toggles``
over the two views ``lines[1:]`` and ``lines[:-1]``, as that source's
wrapper did; the new side is the checkout's
``kernels/toggle/ops.line_toggles_seq``.  ``line_ones`` (popcount) is
the control row, the earlier source's ``repro_line_ones`` against the
checkout's wrapper.

On 32 MiB (524,288 lines) and 1 GiB (16,777,216 lines) of seeded random
lines, every side is first checked bit-exact against the plain version
and then timed with ``chip_smoke.event_ms`` (L2 flushed, mean of 20) in
turns: old, new, new, old per round.  Each line gives every sample, the
median and the mean, the median's share of the bound (bytes at 3.35
TB/s) and the old median over the new, with the card's ``name,
power.limit``.
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

SIZES = {"32MiB": 1 << 19, "1GiB": 1 << 24}     # lines of 64 bytes


def old_calls(lib: ctypes.CDLL, lines) -> dict:
    """The earlier source's two calls on ``lines``, as its wrappers made
    them."""
    import torch

    from repro_torch.kernels import build
    for name, nargs in (("repro_line_ones", 2), ("repro_line_toggles", 3)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * nargs
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    n, dev = lines.shape[0], lines.device

    def ones():
        out = torch.empty(n, dtype=torch.int32, device=dev)
        build.check(lib.repro_line_ones(build.ptr(lines), build.ptr(out), n,
                                        build.stream(dev)), "old line_ones")
        return out

    def toggles_seq():
        out = torch.empty(n, dtype=torch.int32, device=dev)
        out[:1] = 0
        build.check(lib.repro_line_toggles(
            build.ptr(lines[1:]), build.ptr(lines[:-1]), build.ptr(out[1:]),
            n - 1, build.stream(dev)), "old line_toggles")
        return out
    return {"line_ones": ones, "line_toggles_seq": toggles_seq}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("line_bits_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from charge_ab import build_source
    from repro_torch.kernels.popcount import popcount, ref as pc_ref
    from repro_torch.kernels.toggle import ops as tops, ref as tg_ref

    card = chip_smoke.card_line()
    old_lib = build_source(args.old / "line_bits.cu",
                           ROOT / "build" / "line_bits_ab" / args.old.name,
                           args.old.name)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for size, n in SIZES.items():
        lines = torch.randint(-2**31, 2**31 - 1, (n, 16), generator=gen,
                              device="cuda", dtype=torch.int32)
        old = old_calls(old_lib, lines)
        rows = {"line_toggles_seq": (tops.line_toggles_seq,
                                     tg_ref.line_toggles_seq),
                "line_ones": (popcount.line_ones, pc_ref.line_ones)}
        for name, (new_fn, plain) in rows.items():
            fns = {"old": old[name], "new": lambda f=new_fn: f(lines)}
            want = plain(lines)
            for tag, fn in fns.items():
                chip_smoke.check(torch.equal(fn(), want),
                                 f"{tag} {name} on {size} differs from its "
                                 f"plain version")
            del want
            b_ms, b_by = chip_smoke.bound(n * (64 + 4), n * 47)
            times = {tag: [] for tag in fns}
            for _ in range(args.rounds):
                for tag in ("old", "new", "new", "old"):
                    times[tag].append(chip_smoke.event_ms(fns[tag], 20,
                                                          flush))
            meds = {tag: statistics.median(ts) for tag, ts in times.items()}
            for tag, ts in times.items():
                print(f"[ab] {name} {size} {tag}: ms="
                      f"{' '.join(f'{x:.4f}' for x in ts)} mean="
                      f"{statistics.mean(ts):.4f} median={meds[tag]:.4f} "
                      f"share_of_bound={b_ms / meds[tag]:.3f} "
                      f"old_over_new={meds['old'] / meds['new']:.3f} "
                      f"bound_ms={b_ms:.4f} ({b_by}) lines={n} "
                      f"card=\"{card}\"", flush=True)
        del lines, old
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
