#!/usr/bin/env python3
"""Time earlier builds of the flash-attention kernel against the
checkout's own, in turns, on one card.

    git show <commit>:src/repro_torch/csrc/flash_attention.cu \\
        > build/flash_ab/old.cu
    python3 tools/flash_ab.py build/flash_ab/old.cu [more.cu ...] [--rounds 2]

Compiles each given source with the port's ``nvcc`` flags into
``build/flash_ab/`` (its ``-Xptxas -v`` report is printed) and loads it
beside the checkout's ``csrc/flash_attention.cu`` ("new"); a source from
before the kernel took a separate value width (no ``dv`` argument) is
called with its own argument list.  At the serving
prefill shape (qwen2.5-3b, batch 4, prompt 2048: q 64 x 2048 x 128, k/v 8
x 2048 x 128, causal bf16) and at qwen2-7b's (q 112, k/v 16), each is
checked against the plain version (atol 2e-2) and then timed with
``chip_smoke.event_ms`` (L2 flushed, mean of 20) in turns: each source,
then "new", twice, then each source again, per round; with
``scaled_dot_product_attention`` on k/v expanded to every q head beside
them.  Each line carries the card's ``name, power.limit``.  With
``--no-check`` the sources are timed without the check: for copies of the
kernel with one part of its work cut out, to see what that part costs.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (name, B, H, Kh, S, D)
SHAPES = (("qwen2.5-3b", 4, 16, 2, 2048, 128),
          ("qwen2-7b", 4, 28, 4, 2048, 128))


def build_source(source: pathlib.Path) -> tuple[ctypes.CDLL, bool]:
    """The library built from ``source`` and whether its entry point takes
    the value width ``dv``."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"{source.stem}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                           str(target), str(source)],
                          capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"[build] {source.stem}   {line.strip()}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}")
    lib = ctypes.CDLL(str(target))
    argtypes = list(build.SIGNATURES["flash_attention"]
                    ["repro_flash_attention"])
    takes_dv = "int dv," in source.read_text()
    if not takes_dv:
        del argtypes[9]
    lib.repro_flash_attention.argtypes = argtypes
    lib.repro_flash_attention.restype = ctypes.c_int
    return lib, takes_dv


def launcher(lib, takes_dv, q, k, v):
    """A call of ``lib``'s kernel on (q, k, v), causal bf16, into a fresh
    output, as the port's wrapper makes it."""
    import torch

    from repro_torch.kernels import build
    bh, sq, d = q.shape
    bh_kv, skv = k.shape[:2]

    widths = (d, d) if takes_dv else (d,)

    def run():
        out = torch.empty_like(q)
        build.check(lib.repro_flash_attention(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), bh,
            bh_kv, sq, skv, *widths, d ** -0.5, 1, 0, 1,
            build.stream(q.device)), "flash_attention")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", type=pathlib.Path, nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-check", action="store_true",
                    help="time the given sources without checking them")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ref

    card = chip_smoke.card_line()
    libs = {src.stem: build_source(src) for src in args.sources}
    libs["new"] = (build.library("flash_attention"), True)
    olds = [tag for tag in libs if tag != "new"]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for name, b, h, kh, s, d in SHAPES:
        q, k, v = (torch.randn(rows, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for rows in (b * h, b * kh, b * kh))
        want = ref.attention_ref(q, k, v, causal=True).float()
        fns = {tag: launcher(*lib, q, k, v) for tag, lib in libs.items()}
        for tag, fn in fns.items():
            err = float((fn().float() - want).abs().max())
            print(f"[ab] {name} {tag} max_abs_err={err:.3e}", flush=True)
            if tag == "new" or not args.no_check:
                chip_smoke.check(err <= 2e-2, f"{tag} kernel at {name}: max "
                                              f"abs err {err:.3e}")
        del want
        q4 = q.view(b, h, s, d)
        k4 = k.view(b, kh, s, d).repeat_interleave(h // kh, dim=1)
        v4 = v.view(b, kh, s, d).repeat_interleave(h // kh, dim=1)
        flops = chip_smoke.attention_flops(b * h, s, s, d, True)
        times = {tag: [] for tag in libs}
        for _ in range(args.rounds):
            for tag in olds + ["new", "new"] + olds[::-1]:
                times[tag].append(chip_smoke.event_ms(fns[tag], 20,
                                                      flush_buf.zero_))
        sdpa = chip_smoke.event_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=True),
            20, flush_buf.zero_)
        bound = flops / chip_smoke.BF16_OPS_PER_S * 1e3
        for tag, ts in times.items():
            mean = sum(ts) / len(ts)
            print(f"[ab] {name} {tag}: ms={' '.join(f'{t:.4f}' for t in ts)} "
                  f"mean={mean:.4f} tflops={flops / mean / 1e9:.1f} "
                  f"share_of_bound={bound / mean:.3f} card=\"{card}\"",
                  flush=True)
        print(f"[ab] {name} sdpa: ms={sdpa:.4f} bound_ms={bound:.4f} "
              f"(B={b}, H={h}, Kh={kh}, S={s}, D={d}, causal, bf16) "
              f"card=\"{card}\"", flush=True)
        del q, k, v, q4, k4, v4
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
