#!/usr/bin/env python3
"""Time an earlier build of the flash forward and backward against the
checkout's own, in turns, on one card: the forward with K0 (the
backward's statistics) and K1 (dK, dV) and K2 (dQ).

    mkdir -p build/flash_bwd_ab/old
    for f in flash_attention.cu flash_attention_bwd.cu hopper.cuh; do
        git show <commit>:src/repro_torch/csrc/$f > build/flash_bwd_ab/old/$f
    done
    python3 tools/flash_bwd_ab.py build/flash_bwd_ab/old [--rounds 2]

The directory holds an earlier ``flash_attention.cu`` and
``flash_attention_bwd.cu`` (and the headers they include, else the
checkout's are used) from before the forward wrote lse: its forward
takes no lse pointer and its K0 computes lse and delta from q, k, out and
dout.  Each is compiled with the port's ``nvcc`` flags into
``build/flash_bwd_ab/`` (its ``-Xptxas -v`` report is printed) and
loaded beside the checkout's sources ("new"), whose forward writes lse
and whose K0 is the delta pass alone.  At one qwen2.5-3b train layer (q
64 x 2048 x 128, k/v 8 x 2048 x 128, causal bf16) each build runs its own
forward and K0, and its K1 and K2 on that lse and delta; the two
forwards' outputs and lse, the deltas, and each build's dq, dk and dv
against the plain backward (``attention_bwd_ref``, within 2e-2 of each
gradient's largest value) are checked first.  Then, with
``chip_smoke.event_ms`` (L2 flushed, mean of 10 a reading), per round the
old build, "new" twice and the old build again: the forward, K0, the
forward and K0 together (what the train step pays for its statistics),
K1 and K2.  Each line gives the readings, their median, the bound
(``chip_smoke.bwd_work``; the forward's from its operations) and the
card's ``name, power.limit``.
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

# (name, B, H, Kh, S, D): one qwen2.5-3b train layer at batch 4 x 2048
SHAPE = ("qwen2.5-3b", 4, 16, 2, 2048, 128)
PARTS = ("fwd", "k0", "fwd+k0", "dkdv", "dq")
BAR = 2e-2
_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the sources from before the forward wrote lse (commit 463b841)
OLD_SIGNATURES = {
    "flash_attention": {
        "repro_flash_attention": [_P] * 4 + [_I32] * 6 + [_F32]
        + [_I32] * 3 + [_P]},
    "flash_attention_bwd": {
        f"repro_flash_bwd_{name}": [_P] * n + [_I32] * 6 + [_F32]
        + [_I32] * 2 + [_P]
        for name, n in (("prep", 6), ("dkdv", 8), ("dq", 7))},
}


def build_source(source: pathlib.Path, signatures: dict) -> ctypes.CDLL:
    """The library built from ``source`` (its own directory's headers
    first), with ``signatures``."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "flash_bwd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"old_{source.stem}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                           "-I", str(source.parent), "-I", str(build.CSRC),
                           "-o", str(target), str(source)],
                          capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"[build] old/{source.name}   {line.strip()}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}")
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def closures(fwd_lib, bwd_lib, new: bool, q, k, v, do):
    """One build's launches at the shape of ``q``, each into outputs of
    its own: the forward (writing lse when ``new``), K0 (the old one also
    writes lse), both, K1 and K2; and their outputs."""
    import torch

    from repro_torch.kernels import build
    bh, s, d = q.shape
    bh_kv = k.shape[0]
    p, stream = build.ptr, build.stream(q.device)
    scale = d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    shape = (bh, bh_kv, s, s, d, d, scale, 1, 1, stream)

    def fwd():
        lse_arg = (p(lse),) if new else ()
        build.check(fwd_lib.repro_flash_attention(
            p(q), p(k), p(v), p(out), *lse_arg, bh, bh_kv, s, s, d, d, scale,
            1, 0, 1, stream), "forward")

    def k0():
        if new:
            rc = bwd_lib.repro_flash_bwd_prep(p(out), p(do), p(delta), bh, s,
                                              d, 1, stream)
        else:
            rc = bwd_lib.repro_flash_bwd_prep(p(q), p(k), p(out), p(do),
                                              p(lse), p(delta), *shape)
        build.check(rc, "K0")

    def both():
        fwd()
        k0()

    def dkdv():
        build.check(bwd_lib.repro_flash_bwd_dkdv(
            *map(p, (q, k, v, do, lse, delta, dk, dv)), *shape), "K1")

    def dq_fn():
        build.check(bwd_lib.repro_flash_bwd_dq(
            *map(p, (q, k, v, do, lse, delta, dq)), *shape), "K2")
    fns = {"fwd": fwd, "k0": k0, "fwd+k0": both, "dkdv": dkdv, "dq": dq_fn}
    return fns, {"out": out, "lse": lse, "delta": delta, "dq": dq, "dk": dk,
                 "dv": dv}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=pathlib.Path,
                    help="directory of the earlier flash_attention.cu and "
                         "flash_attention_bwd.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ref

    card = chip_smoke.card_line()
    libs = {"old": tuple(build_source(args.old / f"{name}.cu", sig)
                         for name, sig in OLD_SIGNATURES.items()),
            "new": (build.library("flash_attention"),
                    build.library("flash_attention_bwd"))}
    name, b, h, kh, s, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v, do = (torch.randn(rows, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for rows in (b * h, b * kh, b * kh, b * h))
    fns, outs = {}, {}
    for tag, (fwd_lib, bwd_lib) in libs.items():
        fns[tag], outs[tag] = closures(fwd_lib, bwd_lib, tag == "new",
                                       q, k, v, do)
        for part in ("fwd+k0", "dkdv", "dq"):
            fns[tag][part]()
    torch.cuda.synchronize()
    old, new = outs["old"], outs["new"]
    out_err = float((old["out"].float() - new["out"].float()).abs().max())
    lse_err = float((old["lse"] - new["lse"]).abs().max())
    delta_err = float((old["delta"] - new["delta"]).abs().max())
    delta_top = float(old["delta"].abs().max())
    chip_smoke.check(out_err <= 2e-2 and lse_err <= 1e-3
                     and delta_err <= 1e-5 * delta_top,
                     f"old against new: out {out_err:.3e}, lse {lse_err:.3e}, "
                     f"delta {delta_err:.3e} of largest {delta_top:.3e}")
    print(f"[ab] {name} old against new: out max abs err {out_err:.3e} "
          f"(bit-equal: {torch.equal(old['out'], new['out'])}), the old "
          f"K0's lse against the new forward's {lse_err:.3e}, delta "
          f"{delta_err:.3e} (largest {delta_top:.3e})", flush=True)
    for tag in libs:
        o = outs[tag]
        want = ref.attention_bwd_ref(q, k, v, o["out"], do, causal=True)
        errs = []
        for g_name, w in zip(("dq", "dk", "dv"), want):
            g = o[g_name]
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
    times = {(tag, part): [] for tag in libs for part in PARTS}
    for _ in range(args.rounds):
        for tag in ("old", "new", "new", "old"):
            for part in PARTS:
                times[tag, part].append(chip_smoke.event_ms(
                    fns[tag][part], 10, flush_buf.zero_))
    work = chip_smoke.bwd_work(b * h, b * kh, s, d, d, 2)
    fwd_bound = chip_smoke.bound(
        2 * (2 * q.numel() + 2 * k.numel()),
        chip_smoke.attention_flops(b * h, s, s, d, True),
        chip_smoke.BF16_OPS_PER_S)[0]
    k0_bound = chip_smoke.bound(*work["flash_attention_bwd_prep"])[0]
    bounds = {"fwd": fwd_bound, "k0": k0_bound,
              "fwd+k0": fwd_bound + k0_bound,
              "dkdv": chip_smoke.bound(*work["flash_attention_bwd_dkdv"])[0],
              "dq": chip_smoke.bound(*work["flash_attention_bwd_dq"])[0]}
    medians = {}
    for (tag, part), ts in times.items():
        medians[tag, part] = med = statistics.median(ts)
        readings = " ".join(f"{t:.4f}" for t in ts)
        print(f"[ab] {name} {part} {tag}: ms={readings} median={med:.4f} "
              f"bound_ms={bounds[part]:.4f} share_of_bound="
              f"{bounds[part] / med:.4f} card=\"{card}\"", flush=True)
    print(f"[ab] {name} old over new (medians): " + " ".join(
        f"{part}={medians['old', part] / medians['new', part]:.2f}x"
        for part in PARTS) + f" (new's K0 bound is the delta pass's) "
        f"card=\"{card}\"", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
