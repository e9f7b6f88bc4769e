#!/usr/bin/env python3
"""Teacher-forcing drift of mamba2-780m at its published widths, by depth
and dtype, in the port and in the reference, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/tf_drift.py \\
        [--layers 4 12] [--prompt 300] [--no-reference]

A measurement that holds the port against the reference, so it sits with
the tests (pytest does not collect it: its name has no ``test_``).

For each depth (the config's first ``L`` layers, random weights from
seed 0) and dtype: two decode steps after a prefill of all but the last
two prompt tokens, each against the forward pass's logits at its token,
as ``tests/test_models.py``'s test_decode_matches_teacher_forcing
compares them; prints the larger difference beside the reference's bar
(0.15 std + 0.05).  The port's float32 model takes the bf16 draws cast to
float32.  The reference runs in bf16 only, as its test does.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def port_drift(n_layers: int, prompt: int) -> dict[str, tuple]:
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.lm import LM

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [f32(v) for v in tree]
        return tree.float()
    cfg = dataclasses.replace(registry.get_config("mamba2-780m"),
                              n_layers=n_layers)
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, prompt)))
    out = {}
    for dtype, p in (("float32", f32(params)), ("bfloat16", params)):
        lm = LM(dataclasses.replace(cfg, dtype=dtype))
        full, _ = lm.forward(p, tok)
        _, caches = lm.prefill(p, tok[:, :prompt - 2], max_len=prompt)
        worst = (0.0, 1.0)
        for t in (prompt - 2, prompt - 1):
            step, caches = lm.decode_step(p, caches, tok[:, t:t + 1])
            want = full[:, t, :cfg.vocab].double()
            err = float((step[:, :cfg.vocab].double() - want).abs().max())
            bar = 0.15 * (float(want.std()) + 1e-6) + 0.05
            worst = max(worst, (err, bar), key=lambda e: e[0] / e[1])
        out[dtype] = worst
    return out


def reference_drift(n_layers: int, prompt: int) -> tuple[float, float]:
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.models.lm import LM
    cfg = dataclasses.replace(registry.get_config("mamba2-780m"),
                              n_layers=n_layers)
    lm = LM(cfg)
    params = lm.init(jax.random.key(0))
    tok = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, prompt)))
    full, _ = jax.jit(lm.forward)(params, tok)
    _, caches = jax.jit(lambda p, t: lm.prefill(p, t, max_len=prompt))(
        params, tok[:, :prompt - 2])
    step = jax.jit(lm.decode_step)
    worst = (0.0, 1.0)
    for t in (prompt - 2, prompt - 1):
        logits, caches = step(params, caches, tok[:, t:t + 1])
        want = full[:, t, :cfg.vocab]
        err = float(jnp.max(jnp.abs(logits[:, :cfg.vocab] - want)))
        bar = 0.15 * (float(jnp.std(want)) + 1e-6) + 0.05
        worst = max(worst, (err, bar), key=lambda e: e[0] / e[1])
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 12])
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--no-reference", action="store_true")
    args = ap.parse_args()
    for n in args.layers:
        for dtype, (err, bar) in port_drift(n, args.prompt).items():
            print(f"port      layers={n} {dtype}: err={err:.5f} "
                  f"bar={bar:.4f}", flush=True)
        if not args.no_reference:
            err, bar = reference_drift(n, args.prompt)
            print(f"reference layers={n} bfloat16: err={err:.5f} "
                  f"bar={bar:.4f}", flush=True)


if __name__ == "__main__":
    main()
