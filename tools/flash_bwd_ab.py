#!/usr/bin/env python3
"""Time earlier builds of the flash backward's K1 (dK, dV) and K2 (dQ)
against the checkout's own, in turns, on one card.

    git show <commit>:src/repro_torch/csrc/flash_attention_bwd.cu \\
        > build/flash_bwd_ab/old.cu
    python3 tools/flash_bwd_ab.py build/flash_bwd_ab/old.cu [more.cu ...] \\
        [--rounds 2]

Compiles each given source with the port's ``nvcc`` flags into
``build/flash_bwd_ab/`` (its ``-Xptxas -v`` report is printed) and loads
it beside the checkout's ``csrc/flash_attention_bwd.cu`` ("new").  At one
qwen2.5-3b train layer (q 64 x 2048 x 128, k/v 8 x 2048 x 128, causal
bf16), every build's K1 and K2 read the lse and delta of one run of the
checkout's K0; each build's dq, dk and dv are first checked against the
plain backward (``attention_bwd_ref``, within 2e-2 of each gradient's
largest value), then K1 and K2 are timed with ``chip_smoke.event_ms``
(L2 flushed, mean of 10) in turns: each source, then "new", twice, then
each source again, per round.  Beside them: each kernel's bound
(``chip_smoke.bwd_work``) and SDPA's backward on k/v expanded to every q
head, which computes dq, dk and dv at once.  Each line carries the card's
``name, power.limit``.
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

# (name, B, H, Kh, S, D): one qwen2.5-3b train layer at batch 4 x 2048
SHAPE = ("qwen2.5-3b", 4, 16, 2, 2048, 128)
KERNELS = {"dkdv": "flash_attention_bwd_dkdv", "dq": "flash_attention_bwd_dq"}
BAR = 2e-2


def build_source(source: pathlib.Path) -> ctypes.CDLL:
    """The library built from ``source`` with the backward's signatures."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "flash_bwd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"{source.stem}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                           "-I", str(build.CSRC), "-o", str(target),
                           str(source)], capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"[build] {source.stem}   {line.strip()}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}")
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in build.SIGNATURES["flash_attention_bwd"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launchers(lib, q, k, v, do, lse, delta):
    """K1 and K2 of ``lib`` on the given inputs, each into outputs of its
    own, as the port's wrapper launches them; and a run of both."""
    import torch

    from repro_torch.kernels import build
    bh, s, d = q.shape
    bh_kv = k.shape[0]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    args = (bh, bh_kv, s, s, d, d, d ** -0.5, 1, 1, build.stream(q.device))
    p = build.ptr

    def dkdv():
        build.check(lib.repro_flash_bwd_dkdv(p(q), p(k), p(v), p(do), p(lse),
                                             p(delta), p(dk), p(dv), *args),
                    "K1")

    def dq_fn():
        build.check(lib.repro_flash_bwd_dq(p(q), p(k), p(v), p(do), p(lse),
                                           p(delta), p(dq), *args), "K2")

    def both():
        dkdv()
        dq_fn()
        return dq, dk, dv
    return {"dkdv": dkdv, "dq": dq_fn}, both


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", type=pathlib.Path, nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref

    card = chip_smoke.card_line()
    libs = {src.stem: build_source(src) for src in args.sources}
    libs["new"] = build.library("flash_attention_bwd")
    olds = [tag for tag in libs if tag != "new"]
    name, b, h, kh, s, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v, do = (torch.randn(rows, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for rows in (b * h, b * kh, b * kh, b * h))
    out = fa.flash_attention(q, k, v)
    # one K0 run's lse and delta, read by every build's K1 and K2
    lse = torch.empty((b * h, s), dtype=torch.float32, device="cuda")
    delta = torch.empty_like(lse)
    build.check(libs["new"].repro_flash_bwd_prep(
        *(build.ptr(t) for t in (q, k, out, do, lse, delta)), b * h, b * kh,
        s, s, d, d, d ** -0.5, 1, 1, build.stream(q.device)), "K0")
    want = ref.attention_bwd_ref(q, k, v, out, do, causal=True)
    fns = {}
    for tag, lib in libs.items():
        fns[tag], both = launchers(lib, q, k, v, do, lse, delta)
        got = both()
        torch.cuda.synchronize()
        errs = []
        for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = float((g.float() - w.float()).abs().max()) / float(
                w.float().abs().max())
            chip_smoke.check(bool(torch.isfinite(g).all()) and err <= BAR,
                             f"{tag} {g_name} at {name}: {err:.3e} of the "
                             f"largest beyond {BAR}")
            errs.append(f"{g_name}={err:.3e}")
        print(f"[ab] {name} {tag} err of the largest: {' '.join(errs)}",
              flush=True)
    del want
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    times = {(tag, kern): [] for tag in libs for kern in KERNELS}
    for _ in range(args.rounds):
        for tag in olds + ["new", "new"] + olds[::-1]:
            for kern in KERNELS:
                times[tag, kern].append(chip_smoke.event_ms(
                    fns[tag][kern], 10, flush_buf.zero_))
    q4 = q.view(b, h, s, d).detach().requires_grad_(True)
    k4, v4 = (x.view(b, kh, s, d).repeat_interleave(h // kh, dim=1)
              .detach().requires_grad_(True) for x in (k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    sdpa = chip_smoke.event_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), do.view(b, h, s, d),
                                    retain_graph=True), 10, flush_buf.zero_)
    work = chip_smoke.bwd_work(b * h, b * kh, s, d, d, 2)
    means = {}
    for (tag, kern), ts in times.items():
        bound = chip_smoke.bound(*work[KERNELS[kern]],
                                 chip_smoke.BF16_OPS_PER_S)[0]
        means[tag, kern] = mean = sum(ts) / len(ts)
        readings = " ".join(f"{t:.4f}" for t in ts)
        print(f"[ab] {name} {kern} {tag}: ms={readings}"
              f" mean={mean:.4f} bound_ms={bound:.4f} share_of_bound="
              f"{bound / mean:.4f} card=\"{card}\"", flush=True)
    for tag in olds:
        print(f"[ab] {name} speedup of new over {tag}: " + " ".join(
            f"{kern}={means[tag, kern] / means['new', kern]:.2f}x"
            for kern in KERNELS) + f" card=\"{card}\"", flush=True)
    print(f"[ab] {name} sdpa backward: ms={sdpa:.4f} (B={b}, H={h}, Kh={kh}, "
          f"S={s}, D={d}, causal, bf16, k/v expanded) card=\"{card}\"",
          flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
