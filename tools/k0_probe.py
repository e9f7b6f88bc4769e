#!/usr/bin/env python3
"""Time the flash backward's K0 (the delta pass) built with 1 to 16 rows a
thread, under three states of the L2 cache, beside PyTorch calls that read
the same bytes, on one card.

    python3 tools/k0_probe.py

Builds the checkout's ``csrc/flash_attention_bwd.cu`` once for each value
of ``PREP_ROWS`` (a copy with that constant changed, under
``build/k0_probe/``), checks that every build gives the same bits at one
qwen2.5-3b train layer (out and dout (64, 2048, 128), bf16), then times
each with ``chip_smoke.event_ms`` (20 launches a reading; per round the
builds in order and then in reverse, two rounds, the median printed)
after three kinds of window: the 96 MiB ``zero_`` fill that
``chip_smoke.py`` uses to flush L2 (it leaves the cache full of dirty
lines), a 96 MiB read (a clean cache), and nothing (out and dout partly
warm).  Beside them: ``torch.sum`` of the same 67.1 MB in float32 and
``torch.linalg.vecdot`` (K0's ``library_ms``).  Each line carries the
card's ``name, power.limit``.
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ROWS = (1, 2, 4, 8, 16)
BH, S, DV = 64, 2048, 128


def build_variants(out_dir: pathlib.Path) -> dict[int, ctypes.CDLL]:
    """One library a value of ``PREP_ROWS``, compiled together."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for rows in ROWS:
        text = re.sub(r"constexpr int PREP_ROWS = \d+;",
                      f"constexpr int PREP_ROWS = {rows};", src)
        source = out_dir / f"k0_{rows}.cu"
        source.write_text(text)
        procs[rows] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out_dir / f"k0_{rows}.so"), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for rows, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on PREP_ROWS = {rows}:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"k0_{rows}.so"))
        lib.repro_flash_bwd_prep.argtypes = build.SIGNATURES[
            "flash_attention_bwd"]["repro_flash_bwd_prep"]
        lib.repro_flash_bwd_prep.restype = ctypes.c_int
        libs[rows] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k0_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    card = cs.card_line()
    libs = build_variants(ROOT / "build" / "k0_probe")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out, do = (torch.randn(BH, S, DV, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(2))
    both = torch.cat([out.view(-1), do.view(-1)])
    stream = build.stream(out.device)
    deltas = {rows: torch.empty((BH, S), device="cuda") for rows in libs}

    def k0(rows):
        return lambda: build.check(libs[rows].repro_flash_bwd_prep(
            build.ptr(out), build.ptr(do), build.ptr(deltas[rows]), BH, S,
            DV, 1, stream), "K0")
    fns = {rows: k0(rows) for rows in libs}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    first = deltas[ROWS[0]]
    same = all(torch.equal(first, d) for d in deltas.values())
    cs.check(same, "K0 builds by rows a thread disagree")
    print(f"[probe] bit-equal across rows a thread: {same}", flush=True)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    bound = cs.bound(*cs.bwd_work(BH, 8, S, DV, DV, 2)[
        "flash_attention_bwd_prep"])[0]
    for label, flush in (("flushed", flush_buf.zero_),
                         ("flush by a read", lambda: flush_buf.sum()),
                         ("warm", None)):
        times = {rows: [] for rows in fns}
        for _ in range(2):
            for rows in list(fns) + list(fns)[::-1]:
                times[rows].append(cs.event_ms(fns[rows], 20, flush))
        total = cs.event_ms(lambda: both.sum(dtype=torch.float32), 20, flush)
        vecdot = cs.event_ms(lambda: torch.linalg.vecdot(do, out, dim=-1),
                             20, flush)
        print(f"[probe] {label}: " + " ".join(
            f"rows{rows}={statistics.median(t):.4f}"
            for rows, t in times.items())
            + f" | sum of the same 67.1 MB {total:.4f} | vecdot {vecdot:.4f}"
            f" | bound {bound:.4f} card=\"{card}\"", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
