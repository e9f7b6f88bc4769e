#!/usr/bin/env python3
"""Time the serving entry point of an earlier checkout against this one,
in turns, on one card.

    mkdir -p build/serve_ab/parent
    git archive <commit> | tar -x -C build/serve_ab/parent
    python3 tools/serve_ab.py build/serve_ab/parent [--arch qwen2.5-3b]

Each turn is a process of its own that puts one checkout's ``src/`` first
on ``sys.path``, builds its kernels (outside the timing), and runs its
``repro_torch.launch.serve.run`` at full width (batch 4, prompt 2048, 32
greedy decode tokens, no power report), then times 10 more decode steps
with ``torch.cuda.synchronize`` after each.  The turns go earlier, this,
this, earlier per round; each prints prefill s, decode p50/p99 ms and the
extra steps' median ms, with the card's ``name, power.limit``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def child(root: pathlib.Path, arch: str, seed: int) -> None:
    """One turn: serve ``arch`` from ``root``'s package, print one JSON
    line."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    build.library("flash_attention")
    job = serve.ServeJob(arch=arch, smoke=False, batch=4, prompt_len=2048,
                         decode_tokens=32, seed=seed, device="cuda")
    res = serve.run(job)
    cfg = registry.get_config(arch)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device="cuda").manual_seed(seed))
    tok = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    _, caches = lm.prefill(params, tok.repeat(1, 2047), max_len=2060)
    steps = []
    for _ in range(10):
        caches["pos"] = 2047
        t0 = time.perf_counter()
        lm.decode_step(params, caches, tok)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"root": str(root), "prefill_s": res["prefill_s"],
                      "decode_p50_ms": res["decode_p50_ms"],
                      "decode_p99_ms": res["decode_p99_ms"],
                      "step_ms": float(np.median(steps))}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("earlier", type=pathlib.Path)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", type=pathlib.Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child, args.arch, args.seed)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    card = chip_smoke.card_line()
    turns = {"earlier": args.earlier.resolve(), "this": ROOT}
    results = {tag: [] for tag in turns}
    for _ in range(args.rounds):
        for tag in ("earlier", "this", "this", "earlier"):
            out = subprocess.run(
                [sys.executable, __file__, str(args.earlier), "--arch",
                 args.arch, "--seed", str(args.seed), "--child",
                 str(turns[tag])], capture_output=True, text=True,
                check=True).stdout
            row = json.loads(out.strip().splitlines()[-1])
            results[tag].append(row)
            print(f"[serve_ab] {args.arch} {tag}: "
                  f"prefill_s={row['prefill_s']:.4f} "
                  f"decode_p50_ms={row['decode_p50_ms']:.3f} "
                  f"decode_p99_ms={row['decode_p99_ms']:.3f} "
                  f"step_ms={row['step_ms']:.3f} card=\"{card}\"",
                  flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
