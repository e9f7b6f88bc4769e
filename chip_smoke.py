#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout (it puts ``src/`` on ``sys.path``
itself).  Phases, each printing its numbers:

1. environment: torch, the device, and the card's name and power limit;
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once; timed, with the compiler's register /
   shared-memory / spill report);
3. workload from ``--seed``: 64 synthetic application traces of 6000
   requests, padded to the serving ring's largest bucket (64 x 16384
   commands), and the committed fitted model with its two baselines
   (3 vendors);
4. every kernel against its plain PyTorch version, timed with CUDA events
   beside its bound: the charge-path kernels on the estimation inputs
   (features bit-exact; charge at rtol 1e-5, the same bits on a second
   call, and GB/s beside the time; the state kernel bit-exact there and
   at the benchmark's batch-long and batch-short shapes), the line kernels (popcount,
   toggle, byte LUT, BDI) bit-exact on a seeded 32 MiB bf16 tensor, with
   ``torch.take`` timed beside the byte LUT (run after phase 5); the
   flash-attention kernel at the qwen2.5-3b prefill shape, at the MLA
   prefill shape of deepseek-v2-lite-16b (q and k 192 wide, v 128) and at
   the cross-attention and encoder shapes (below);
5. ``estimate`` end to end for 3 kinds x 4 modes through ``impl='cuda'``
   against ``impl='vectorized'`` (rtol 1e-5), surface summing to mean, pad
   rows and pad commands adding zero, every kernel of the path launched;
   the device time of one estimate by kernel (``torch.profiler``), one
   device operation per call of each charge wrapper; then the line
   kernels of phase 4 (the sequential toggles also on 1 GiB, and one
   device operation a call); a small input against the command-by-command
   oracle on the CPU; and the refusal of out-of-range banks and rows and
   the zeros of a batch of empty traces, in every kind, impl and mode;
   ``[analysis]``: the port's analysis gate (``python -m
   repro_torch.analysis`` in process: the corpus lint, the dispatch audit
   with the serving, fleet and recalibration probes, the repo lint), then
   the dispatch audit over the estimation batch (3 kinds x 3 impls x 4
   modes, ``set_sync_debug_mode("error")`` on ``'vectorized'`` and
   ``'cuda'``), 0 errors; ``[autotune]``: the committed launch geometry
   against the default one at every main-path shape of the charge kernels
   (the same bits twice, rtol 1e-5, both timed) and one sweep;
6. ``[study]``: the paper's Section 10 encoding study at full size — all
   23 synthetic SPEC apps x 4 encodings (92 traces of 6000 requests),
   scored by ``encoding_energy_study`` on the card, the same encoded
   batch again through ``impl='cuda'`` (rtol 1e-5), per-app ratios and
   the mean OWI saving beside the paper's 12.2%;
7. ``[hbm]``: ``tensor_stats``, BDI ``compression_ratio`` and the OWI
   energy ratio of four seeded 32 MiB tensor corpora made on the card,
   and ``tensor_stats`` of a 1 GiB all-ones tensor (exactly 1.0);
8. ``[campaign]``: the paper's characterization campaign at full size —
   ``model_api.fit('vampire', make_fleet(paper_fleet()), impl='cuda')``
   on the 50-module fleet at the default plan (348 probes of 1030
   commands), against the same fit through ``'vectorized'`` (currents at
   rtol 1e-5, fitted leaves at the reference's rtol 1e-4 / atol 1e-6),
   Table 5 and the structural surface beside their planted values, the
   quick fit against the committed ``vampire_quickfit_v2.npz`` (the
   card's check against the reference's fit), save and load;
9. ``[fleet]``: a synthetic fleet of 10,000 modules, its chunked surface
   map (256 modules a chunk, bit for bit the one-shot map at 1,000) and
   every campaign probe on every module (a 10,000 x 348 current matrix),
   through ``'cuda'`` against ``'vectorized'`` on the first chunk; the
   feature, charge and surface kernels also timed at these shapes;
9b. ``[mesh]``: ``mesh=`` sharding of the estimation side on (1, 2),
   (2, 1) and (2, 2) meshes of processes that share card 0 on the
   ``gloo`` backend (the script needs only one card; NCCL refuses two
   ranks on one device): 9's surface and probe matrix and estimation
   services over 3's 64 traces and over their first 8 and 16 (boxes of
   2-8 rows), through ``impl='cuda'`` and then ``'vectorized'``, each
   rank's result bit for bit the one process's, each rank's box and
   launches printed, wall times
   labelled as processes sharing one card.  The LM paths on a mesh
   (``launch.serve`` and ``launch.train`` with ``--data``/``--model``)
   are not run here: DTensor's collectives on gloo with CUDA tensors
   crashed ranks with SIGSEGV (``tools/gloo_cuda_probe.py``), so they wait
   for a machine with two cards; their gloo runs on the CPU are
   ``tests/torch_gloo_mesh.py``;
10. ``[validation]``: paper Section 9.1 on the port's own fit of the
   50-module fleet (``impl='cuda'``): the paper's 22 held-out modules (8
   A, 7 B, 7 C) and the 23 sweeps of ``N_READS`` scored by all three
   estimators through ``run_validation(impl='cuda')`` against
   ``'vectorized'`` (rtol 1e-5), each MAPE beside the paper's 6.8 / 32.4
   / 160.6 %, the ordering VAMPIRE < DRAMPower < Micron; the Fig 14 table;
   the structural surface maps (Figs 19-22) of the three kinds through
   both impls, each summing to 1, the baselines' flat; the charge kernels
   at these shapes (V = 3, and V = 22 for the measurement);
11. ``[apps]``: paper Section 9.3 on that fit, all 23 apps at 2000
   requests: page allocation on vendor C and power-down scheduling on
   vendor A through ``'cuda'`` against ``'vectorized'`` (rtol 1e-5), the
   power-down rewrites lint clean, a remap keeps commands and data; host
   and estimate seconds apart;
12. ``[recal]``: online recalibration of the 50-module fleet (360 probe
   cells, slices of 120, decay 0.7) over 120 ticks of
   ``bench_recalibrate.py``'s drift through ``'cuda'``: the frozen error
   rising at every checkpoint, the recalibrated one below it, an oracle
   campaign fit of the drifted fleet, telemetry ``'cuda'`` against
   ``'vectorized'``; the estimation service's hot swap over a planted step
   (one refit, the same batch shapes, ring buckets and kernel libraries,
   new answers equal to the refreshed model's);
13. ``[serve]``: the LM serving entry point (``repro_torch.launch.serve.run``)
   on qwen2.5-3b at full width (36 layers, random bf16 weights from
   ``--seed``): batch 4, prompt 2048, 32 greedy decode tokens, the power
   report through the estimation service with ``impl='cuda'``; then
   teacher forcing (decode after a prefill of 2047 tokens against a
   prefill of 2048), a prefill with the plain attention against the
   kernel's, and the power report's ``'cuda'`` energies against
   ``'vectorized'``.  The flash-attention kernel (its ``[kernel]`` row
   at the prefill shape, with a ragged and a float32 case) must be
   launched once per layer of the prefill;
14. ``[serve-mla]``: the same entry point on deepseek-v2-lite-16b at full
   width and depth (MLA + MoE: 27 layers, 64 routed experts top-6 + 2
   shared, random bf16 weights): batch 4, prompt 2048, 32 greedy decode
   tokens, the power report through ``impl='cuda'``; then the same bits
   from the same prompt twice, each layer's flash-attention output against
   the plain attention, teacher forcing at the reference's MLA bar with
   ``capacity_factor`` 16 layer by layer on the prefill's own inputs (the
   whole decode step's difference reported beside it), the report's
   ``'cuda'`` against ``'vectorized'``; flash must launch 27 times in the
   prefill;
15. ``[serve-ssm]``: the entry point on mamba2-780m at full width and
   depth (48 Mamba2 blocks, d_model 1536): batch 4, prompt 2048, 32 decode
   tokens, the power report through ``'cuda'``; no flash launch; the same
   bits twice, teacher forcing for two decode steps, layer 0's chunked
   scan against its recurrence in float32 (the reference's bars);
16. ``[serve-xattn]``: llama-3.2-vision-11b at full width and depth (40
   layers, 8 cross-attention layers over 1601 patch embeddings): batch 4,
   prompt 2048, 32 decode tokens; flash 40 times in the prefill (8 at Sq
   2048 against 1601 keys) and 8 times a decode step (Sq = 1); on seeded
   N(0, 1) embeddings every flash call against the plain attention and
   teacher forcing;
17. ``[serve-enc]``: whisper-small at its published widths and depth (12
   encoder + 12 decoder layers, 1500 frames): batch 4, prompt 416, 32
   decode tokens; flash 36 times in the prefill and 12 a decode step; the
   checks of 16;
18. ``[serve-hybrid]``: jamba's hybrid pattern at its smoke widths through
   ``LM.prefill`` and ``decode_step``: one flash launch per period,
   teacher forcing at ``capacity_factor`` 16;
19. ``[train]``: the train entry point (``repro_torch.launch.train.run``)
   on qwen2.5-3b at full width and depth (36 layers, random bf16 weights,
   float32 AdamW moments): batch 4 x 2048 tokens, one warm step under
   ``torch.profiler`` and four timed steps, no checkpoints; step s,
   tokens/s, every loss finite, peak memory against its prediction, the
   bound, the power report, the warm step's busy ms by kernel and the
   flash kernels' share of it; the flash forward launched 72 times a step
   (forward and recompute) and K0-K2 36 times each;
20. ``[train-grad]``: each of the ten configs at smoke widths, every
   leaf's gradient through the kernels against the plain attention with
   the plain backward (float32 at the CPU tests' bar, bf16 at 3e-2 of
   each leaf's largest, those above 2e-2 listed), and one train step;
21. ``[train-ckpt]``: the smoke qwen2.5-3b through ``train.run``, 12 steps
   with a fault at step 7 and a checkpoint every 4, its final state
   against an uninterrupted run's (R12);
22. ``[dryrun]``: the dry run (``repro_torch.launch.steps.dryrun_cell``)
   of 19's step on fake tensors on a 1 x 1 fake mesh: its counted
   operations equal ``train_work``, its predicted peak is within 5 % of
   19's measured one (``train_memory``'s beside both), its roofline bound
   and the measured step's model FLOP utilisation; then ``python -m
   repro_torch.launch.dryrun --all --mesh pod`` in a subprocess: an
   ``[ok]`` for each of the 32 cells of the reference's list (the dense,
   MLA, MoE, cross-attention, encoder-decoder, Mamba2 and hybrid models,
   ``long_500k`` for the last two) on the 16 x 16 fake mesh, no
   ``[not-ported]``, no ``[FAIL]``, and the roofline table of the 32.

Phase 4 also times the flash kernel at the shapes of 16 and 17 (the cross
prefill, the encoder, a cross decode step at Sq = 1) and checks Sq = 1
against 1500 and 1601 keys, times the forward at the serving prefill
without lse and with lse written (a train layer's forward), in turns, and
holds the backward's K0 (delta) to K2 against ``attention_bwd_ref`` on the
forward kernel's lse at one qwen2.5-3b train layer (bf16) and in float32,
timing K0 beside ``torch.linalg.vecdot`` and K1 and K2 beside SDPA's
backward; ``[faults] F7`` shows that q, k and v get gradients through the
card's flash attention.

Each main path (5 to 21) runs with the kernels' launch counts set to 0
just before it and read just after; every kernel must have been launched.
Any failed check exits non-zero.  The last lines are one JSON object of
per-kernel numbers, the card's ``name, power.limit`` line, and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MODEL_FILE = ROOT / "src" / "repro_torch" / "data" / "vampire_quickfit_v2.npz"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
RTOL = 1e-5                   # the reference's energy bar (test_impl_registry)
SPIN_CYCLES = 200_000         # ~0.1 ms of device clock before a timed window
MODES = ("mean", "range", "distribution", "surface")
MODE_KW = {"distribution": dict(ones_frac=0.35, toggle_frac=0.15)}
KINDS = ("vampire", "micron", "drampower")


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def assert_close(got, want, rtol: float, what: str) -> float:
    """Element-wise |got - want| <= rtol * |want|; returns the max abs
    error."""
    import torch
    got, want = got.double(), want.double()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > rtol * want.abs()
    if bool(bad.any()):
        rel = torch.where(bad, err / want.abs().clamp(min=1e-300), 0.0)
        i = int(rel.argmax())
        idx = tuple(int(k) for k in torch.unravel_index(
            torch.tensor(i), got.shape))
        raise CheckFailed(
            f"{what}: {int(bad.sum())} elements beyond rtol {rtol}; worst "
            f"at {idx}: got {float(got.reshape(-1)[i])!r} want "
            f"{float(want.reshape(-1)[i])!r} (max abs err "
            f"{float(err.max()):.3e})")
    return float(err.max())


def event_ms(fn, iters: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events; ``flush`` (run outside the timed window) evicts
    the L2 cache first, as the estimation path finds it.  A device-side
    spin of ~0.1 ms before the window lets the host enqueue ``fn``'s
    launches ahead of the device, so the host's Python time for a short
    wrapper does not show up as device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def wall_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def bound(nbytes: float, nops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type (float32 by default),
    whichever is larger (ms)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_workload(seed: int, n_traces: int, n_requests: int, length: int,
                   device):
    import dataclasses

    from repro_torch.core import traces
    from repro_torch.core.estimate_batch import bucketed_trace_batch
    apps = [dataclasses.replace(traces.SPEC_APPS[i % len(traces.SPEC_APPS)],
                                seed=seed * 1000 + i + 1)
            for i in range(n_traces)]
    trs = [traces.app_trace(app, n_requests=n_requests) for app in apps]
    return trs, bucketed_trace_batch(trs, n_traces, length).to(device)


#: the feature kernel's compulsory bytes a line: data 64, cmd 4 and
#: prev_rw 4 read, ones and togg (float32) written
FEATURE_LINE_BYTES = 64 + 4 + 4 + 2 * 4
#: the state kernel's a command: cmd, bank and col read, prev_rw and the
#: state word written
STATE_CMD_BYTES = 3 * 4 + 2 * 4
#: the benchmark's shapes at which the state kernel is also timed
STATE_SHAPES = {"batch-long": (512, 16384), "batch-short": (4096, 2048)}


def kernel_inputs(tb, models):
    """The per-command inputs the path hands each kernel, built by the
    same assembler steps as ``impl='cuda'``."""
    import torch

    from repro_torch.core.dram import ACT
    from repro_torch.core.energy_model import structural_state
    from repro_torch.kernels.vampire_energy import ops as vops
    tr, w = tb.trace, tb.weight
    st = structural_state(tr)
    return dict(
        data=tr.data, cmd=tr.cmd, prev_rw=st.prev_rw,
        state=vops.pack_state(st), w=w.contiguous(),
        params=vops.pack_param_blocks(models["vampire"].fleet.params),
        any_act=(tr.cmd == ACT).any(dim=-1).to(torch.float32),
        table=models["micron"].idd_table)


def charge_rows(tb, models, x=None) -> list[dict]:
    """The six charge kernels' rows on the estimation batch: each
    wrapper, its plain version, and the bytes and operations of its
    bound; ``x`` is ``kernel_inputs``'s dict (made here when omitted)."""
    from repro_torch.kernels.baseline_energy import baseline_energy as be
    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    x = kernel_inputs(tb, models) if x is None else x
    tr = tb.trace
    t, n = tr.cmd.shape
    m = t * n
    v = x["params"].shape[0]
    ones, togg = ve.batched_features(x["data"], x["cmd"], x["prev_rw"])
    vargs = (ones, togg, tr.cmd, tr.bank, tr.row, tr.dt, x["state"], x["w"],
             x["params"])
    rows = []
    for surface, fn, line in ((False, ve.vampire_charge, 220),
                              (True, ve.vampire_charge_surface, 179)):
        out_bytes = t * v * (64 if surface else 1) * 4
        rows.append(dict(
            name=fn.__name__, fn=lambda fn=fn: fn(*vargs),
            plain=lambda s=surface: ve.vampire_charge_plain(*vargs,
                                                            surface=s),
            args=vargs, kind="vampire", surface=surface,
            source="src/repro_torch/csrc/vampire_energy.cu",
            replaces=("src/repro/kernels/vampire_energy/vampire_energy.py:"
                      f"{line}"),
            nbytes=m * 8 * 4 + v * 123 * 4 + out_bytes, nops=m * v * 45))

    bargs = (tr.cmd, tr.bank, tr.row, tr.dt, x["state"], x["w"],
             x["any_act"], x["table"])
    for (kind, surface), fn in be.WRAPPERS.items():
        planes = 6 if surface else 4     # + bank, row for the cell index
        out_bytes = t * v * (64 if surface else 1) * 4
        rows.append(dict(
            name=fn.__name__, fn=lambda fn=fn: fn(*bargs),
            plain=lambda k=kind, s=surface:
                be.baseline_charge_plain(k, *bargs, surface=s),
            args=bargs, kind=kind, surface=surface,
            source="src/repro_torch/csrc/baseline_energy.cu",
            replaces=("src/repro/kernels/baseline_energy/baseline_energy.py:"
                      + ("81" if surface else "97")),
            nbytes=m * planes * 4 + t * 4 + v * 40 + out_bytes,
            nops=m * v * 20))
    return rows


def state_rows(tb, shapes: dict) -> list[dict]:
    """The state kernel on the estimation batch and at ``shapes`` (name ->
    ``(T, N)``: the batch's commands end to end, repeated and cut into
    traces of ``N``), each checked for the same bits as its plain
    version; only the first row is the estimation batch's (``shape`` is
    None)."""
    import torch

    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    tr = tb.trace
    planes = (tr.cmd, tr.bank, tr.col)

    def rows_of(p, t, n):
        return p.reshape(-1).repeat(-(-t * n // p.numel()))[:t * n].view(t, n)

    rows = []
    for label, (t, n) in {None: tuple(tr.cmd.shape), **shapes}.items():
        args = tuple(rows_of(p, t, n) for p in planes)
        got, want = ve.batched_state(*args), ve.batched_state_plain(*args)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"state kernel differs from its plain version at "
              f"(T={t}, N={n})")
        rows.append(dict(
            name="batched_state", fn=lambda a=args: ve.batched_state(*a),
            plain=lambda a=args: ve.batched_state_plain(*a),
            source="src/repro_torch/csrc/features.cu",
            replaces="none: port only (the reference's jnp structural_state,"
                     " src/repro/core/energy_model.py:226)",
            err=0.0, nbytes=t * n * STATE_CMD_BYTES,
            bound=bound(t * n * STATE_CMD_BYTES, 0),
            shape=label and f"{label} (T={t}, N={n})"))
    return rows


def kernel_phase(tb, models, card: str,
                 state_shapes: dict = STATE_SHAPES) -> list[dict]:
    """Phase 4: every kernel against its plain version at the path's
    shapes, timed beside its bound; the state kernel also at
    ``state_shapes`` (:func:`state_rows`)."""
    import torch

    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    x = kernel_inputs(tb, models)
    t, n = tb.trace.cmd.shape
    m = t * n
    v = x["params"].shape[0]
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=tb.device)
    flush = flush_buf.zero_

    # features: exact
    fargs = (x["data"], x["cmd"], x["prev_rw"])
    ones, togg = ve.batched_features(*fargs)
    p_ones, p_togg = ve.batched_features_plain(*fargs)
    check(torch.equal(ones, p_ones) and torch.equal(togg, p_togg),
          "features kernel differs from its plain version")
    rows = [dict(
        name="batched_features", fn=lambda: ve.batched_features(*fargs),
        plain=lambda: ve.batched_features_plain(*fargs),
        source="src/repro_torch/csrc/features.cu",
        replaces="src/repro/kernels/vampire_energy/vampire_energy.py:90",
        err=0.0, bound=bound(m * FEATURE_LINE_BYTES, m * 64))]
    rows += charge_rows(tb, models, x)

    for r in rows[1:]:           # the charge kernels
        got = r["fn"]()
        r["err"] = assert_close(got, r["plain"](), RTOL, r["name"])
        check(torch.equal(got, r["fn"]()),
              f"{r['name']}: two calls give different bits")
        r["bound"] = bound(r["nbytes"], r["nops"])
    rows += state_rows(tb, state_shapes)

    for r in rows:
        r["ms"] = event_ms(r["fn"], 20, flush)
        r["plain_ms"] = event_ms(r["plain"], 5, flush)
        rate = (f" bytes_per_line={FEATURE_LINE_BYTES}" if r is rows[0]
                else f" gb_per_s={r['nbytes'] / r['ms'] / 1e6:.1f}")
        shape = r.get("shape") or f"(T={t}, N={n}, V={v})"
        print(f"[kernel] {r['name']}: ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]}) share_of_bound="
              f"{r['bound'][0] / r['ms']:.3f}{rate} "
              f"max_abs_err={r['err']:.3e} "
              f"shape={shape} card=\"{card}\"", flush=True)
    del flush_buf
    return [r for r in rows if not r.get("shape")]


def one_kernel_phase(rows: list[dict]) -> None:
    """Each charge wrapper's call runs one device operation, its kernel:
    no reduction or fill after it (``torch.profiler``; run after the
    timed phases, so the profiler is not attached while they run)."""
    for r in rows:
        if "nbytes" not in r:
            continue
        ops = device_kernels(r["fn"])
        check(len(ops) == 1, f"{r['name']}: one call runs {len(ops)} device "
                             f"operations ({ops}), not one kernel")
        print(f"[profile] {r['name']}: one call runs one device operation, "
              f"{ops[0][:70]}", flush=True)


def device_kernels(fn) -> list[str]:
    """The device operations (kernels, copies, fills) that one call of
    ``fn`` runs, as ``torch.profiler`` records them.  A profiler session
    on the card has once recorded no device activity at all for a call
    that did launch its kernel; such a session is repeated, up to three
    in all, so an empty list means that no session saw a device
    operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    ops: list[str] = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return ops


def line_kernel_phase(seed: int, card: str, device="cuda",
                      shape=(4096, 4096)) -> list[dict]:
    """Phase 4, second half: the line kernels of the study and HBM paths
    on 32 MiB — 524,288 lines of a seeded bf16 (4096, 4096) tensor —
    bit-exact against their plain versions, timed beside their bounds;
    the sequential toggles' call must run one device operation."""
    import torch

    from repro_torch.core import hbm
    from repro_torch.kernels.bdi import bdi, ref as bdi_ref
    from repro_torch.kernels.byte_lut import byte_lut, ref as lut_ref
    from repro_torch.kernels.popcount import popcount, ref as pc_ref
    from repro_torch.kernels.toggle import ops as tops, ref as tg_ref
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(*shape, generator=gen, device=device,
                    dtype=torch.bfloat16)
    lines = hbm._tensor_lines(x)
    n = lines.shape[0]
    lut = torch.randperm(256, generator=gen, device=device).to(torch.int32)
    idx = lut_ref.words_to_bytes(lines).reshape(-1).long()
    # bounds: each line read once, each output written once; integer
    # operations per line (popc + adds, + xor, the BDI compares, per-word
    # byte split + lookup + repack) against the float32 rate — the bytes
    # bound every one of them
    in_bytes = n * 64
    rows = [
        dict(name="line_ones", fn=lambda: popcount.line_ones(lines),
             plain=lambda: pc_ref.line_ones(lines),
             source="src/repro_torch/csrc/line_bits.cu",
             replaces="src/repro/kernels/popcount/popcount.py:31",
             bound=bound(in_bytes + n * 4, n * 31), library=None),
        dict(name="line_toggles", fn=lambda: tops.line_toggles_seq(lines),
             plain=lambda: tg_ref.line_toggles_seq(lines),
             source="src/repro_torch/csrc/line_bits.cu",
             replaces="src/repro/kernels/toggle/toggle.py:27",
             bound=bound(in_bytes + n * 4, n * 47), library=None),
        dict(name="bdi_sizes", fn=lambda: bdi.bdi_sizes(lines),
             plain=lambda: bdi_ref.bdi_sizes(lines),
             source="src/repro_torch/csrc/bdi.cu",
             replaces="src/repro/kernels/bdi/bdi.py:101",
             bound=bound(in_bytes + n * 8, n * 400), library=None),
        dict(name="apply_lut_lines",
             fn=lambda: byte_lut.apply_lut_lines(lines, lut),
             plain=lambda: lut_ref.apply_lut_lines(lines, lut),
             source="src/repro_torch/csrc/byte_lut.cu",
             replaces="src/repro/kernels/byte_lut/byte_lut.py:36",
             bound=bound(2 * in_bytes + 256 * 4, n * 16 * 18),
             library=lambda: torch.take(lut, idx)),
    ]
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    for r in rows:
        got, want = r["fn"](), r["plain"]()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{r['name']} kernel differs from its plain version")
        r["err"] = 0.0
        r["ms"] = event_ms(r["fn"], 20, flush)
        r["plain_ms"] = event_ms(r["plain"], 5, flush)
        r["library_ms"] = (None if r["library"] is None
                           else event_ms(r["library"], 20, flush))
    # the sequential toggles are one device operation a call (profiled
    # after every row is timed)
    ops = device_kernels(rows[1]["fn"])
    check(len(ops) == 1, f"line_toggles: one call runs {len(ops)} device "
                         f"operations ({ops}), not one kernel")
    for r in rows:
        lib = ("" if r["library_ms"] is None
               else f" library_ms={r['library_ms']:.4f} (torch.take)")
        dev_ops = f" device_ops={len(ops)}" if r is rows[1] else ""
        print(f"[kernel] {r['name']}: ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]}) share_of_bound="
              f"{r['bound'][0] / r['ms']:.3f}{lib}{dev_ops} max_abs_err=0 "
              f"shape=(lines={n}, 16) card=\"{card}\"", flush=True)
    del flush_buf, idx
    return rows


def toggles_gib_phase(seed: int, card: str, device="cuda",
                      n_lines: int = 1 << 24) -> None:
    """The sequential toggle kernel on 1 GiB of seeded random lines
    (16,777,216), where the timer's ~5 us floor no longer matters:
    bit-exact against its plain version, timed beside its bound."""
    import torch

    from repro_torch.kernels.toggle import ops as tops, ref as tg_ref
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    lines = torch.randint(-2**31, 2**31 - 1, (n_lines, 16), generator=gen,
                          device=device, dtype=torch.int32)
    check(torch.equal(tops.line_toggles_seq(lines),
                      tg_ref.line_toggles_seq(lines)),
          f"line_toggles on {n_lines} lines differs from its plain version")
    nbytes = n_lines * (64 + 4)
    b_ms, b_by = bound(nbytes, n_lines * 47)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    ms = event_ms(lambda: tops.line_toggles_seq(lines), 20, flush_buf.zero_)
    print(f"[kernel] line_toggles (1 GiB): ms={ms:.4f} bound_ms={b_ms:.4f} "
          f"({b_by}) share_of_bound={b_ms / ms:.3f} gb_per_s="
          f"{nbytes / ms / 1e6:.1f} max_abs_err=0 shape=(lines={n_lines}, "
          f"16) card=\"{card}\"", flush=True)
    del flush_buf, lines


FLASH_ATOL = {"bfloat16": 2e-2, "float32": 2e-5}   # the reference's bars
# the backward kernels' bars, as a share of each gradient's largest value
FLASH_BWD_BAR = {"bfloat16": 2e-2, "float32": 1e-4}


def attention_flops(bh: int, sq: int, skv: int, d: int, causal: bool,
                    dv: int | None = None) -> int:
    """Operations of Q K^T (``d`` wide) and P V (``dv`` wide, ``d`` unless
    given) over the (query, key) pairs the inputs need: every pair, or for
    causal attention the pairs with key <= query (top-left aligned): query
    ``i`` sees ``min(i + 1, skv)`` keys.  Counted here, apart from the flash
    module's own count, which the tests hold against this one."""
    if causal:
        n = min(sq, skv)
        pairs = n * (n + 1) // 2 + (sq - n) * skv
    else:
        pairs = sq * skv
    return 2 * bh * pairs * (d + (d if dv is None else dv))


def flash_kernel_phase(seed: int, card: str, device="cuda",
                       shape=(4, 16, 2, 2048, 128),
                       ragged: int = 2000,
                       wide=(4, 28, 4, 2048, 128)) -> list[dict]:
    """Phase 4, third part: the flash-attention kernel at the serving
    prefill shape ``(B, H, Kh, S, D)`` (qwen2.5-3b, batch 4, prompt 2048:
    q ``(B*H, S, D)``, k and v ``(B*Kh, S, D)``; one train layer's shape
    too), causal bf16, against its plain version at atol 2e-2 and timed
    beside its bound and ``scaled_dot_product_attention``, with its rate in
    TFLOP/s, without lse (serving) and with lse written (training), in
    turns; then, checked only, a ragged length (S = ``ragged``) in bf16,
    the prefill shape in float32 (atol 2e-5) and ``wide``, a group of 7 q
    heads per kv head (qwen2-7b's 28 and 4 heads at batch 4) in bf16.  In
    every case the output with lse written equals the output without, bit
    for bit, and the lse is within 1e-3 of the plain one."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    b, h, kh, sq, d = shape
    bh, bh_kv, skv = b * h, b * kh, sq
    gen = torch.Generator(device=device).manual_seed(seed + 7)

    def inputs(rows, kv_rows, s_q, s_kv, dim, dtype):
        return tuple(torch.randn(*dims, generator=gen, device=device,
                                 dtype=dtype)
                     for dims in ((rows, s_q, dim), (kv_rows, s_kv, dim),
                                  (kv_rows, s_kv, dim)))

    wb, wh, wkh, ws, wd = wide
    cases = {"prefill": (bh, bh_kv, sq, skv, d, torch.bfloat16),
             "ragged": (bh, bh_kv, ragged, ragged, d, torch.bfloat16),
             "float32": (bh, bh_kv, sq, skv, d, torch.float32),
             "group7": (wb * wh, wb * wkh, ws, ws, wd, torch.bfloat16)}
    errs, lse_err = {}, 0.0
    for name, case in cases.items():
        q, k, v = inputs(*case)
        got = fa.flash_attention(q, k, v, causal=True)
        with_lse, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                               want_lse=True)
        want, want_lse = fa_ref.attention_ref(q, k, v, causal=True,
                                              return_lse=True)
        atol = FLASH_ATOL[str(case[-1]).split(".")[-1]]
        err = float((got.float() - want.float()).abs().max())
        what = (f"flash_attention {name} (BH={case[0]}, BH_kv={case[1]}, "
                f"Sq={case[2]}, Skv={case[3]}, D={case[4]}, {case[5]})")
        check(bool(torch.isfinite(got).all()) and err <= atol,
              f"{what}: max abs err {err:.3e} beyond atol {atol}")
        check(torch.equal(got, with_lse), f"{what}: the output with lse "
                                          "written is not the output without")
        lerr = float((lse - want_lse).abs().max())
        check(lerr <= 1e-3, f"{what}: lse max abs err {lerr:.3e} beyond 1e-3")
        errs[name], lse_err = err, max(lse_err, lerr)
        del got, with_lse, lse, want, want_lse
    q, k, v = inputs(*cases["prefill"])
    q4 = q.view(b, h, sq, d)
    k4 = k.view(b, kh, skv, d).repeat_interleave(h // kh, dim=1)
    v4 = v.view(b, kh, skv, d).repeat_interleave(h // kh, dim=1)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    row = dict(
        name="flash_attention", fn=lambda: fa.flash_attention(q, k, v),
        plain=lambda: fa_ref.attention_ref(q, k, v),
        library=lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       is_causal=True),
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:73",
        err=errs["prefill"],
        bound=bound(nbytes, attention_flops(bh, sq, skv, d, True),
                    BF16_OPS_PER_S))
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    # without lse (serving) and with it (training), in turns
    fwd = {False: row["fn"],
           True: lambda: fa.flash_attention_fwd(q, k, v, want_lse=True)}
    times = {False: [], True: []}
    for want_lse in (False, True, True, False):
        times[want_lse].append(event_ms(fwd[want_lse], 10, flush))
    row["ms"] = sum(times[False]) / 2
    ms_lse = sum(times[True]) / 2
    row["plain_ms"] = event_ms(row["plain"], 3, flush)
    row["library_ms"] = event_ms(row["library"], 20, flush)
    tflops = attention_flops(bh, sq, skv, d, True) / row["ms"] / 1e9
    print(f"[kernel] flash_attention: ms={row['ms']:.4f} (readings "
          f"{times[False][0]:.4f} {times[False][1]:.4f}) ms_lse="
          f"{ms_lse:.4f} (lse written; readings {times[True][0]:.4f} "
          f"{times[True][1]:.4f}; in turns) "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound'][0]:.4f} "
          f"({row['bound'][1]}) share_of_bound="
          f"{row['bound'][0] / row['ms']:.3f} tflops={tflops:.1f} "
          f"library_ms={row['library_ms']:.4f} (sdpa, k/v expanded) "
          f"max_abs_err={errs['prefill']:.3e} "
          f"ragged_err={errs['ragged']:.3e} f32_err={errs['float32']:.3e} "
          f"group7_err={errs['group7']:.3e} (BH={wb * wh}, "
          f"BH_kv={wb * wkh}, S={ws}) lse_err={lse_err:.3e} (the four "
          "cases' worst; the output with lse bit-equal to the one without) "
          f"shape=(BH={bh}, S={sq}, "
          f"BH_kv={bh_kv}, D={d}, causal, bf16) card=\"{card}\"",
          flush=True)
    del flush_buf, q4, k4, v4
    return [row]


def flash_mla_kernel_phase(seed: int, card: str, device="cuda",
                           shape=(4, 16, 2048, 192, 128),
                           ragged: int = 2000) -> list[dict]:
    """Phase 4, fourth part: the flash-attention kernel at the MLA prefill
    shape ``(B, H, S, D, Dv)`` (deepseek-v2-lite-16b, batch 4, prompt 2048:
    q and k ``(B*H, S, 192)``, v ``(B*H, S, 128)``, group 1), causal bf16,
    against its plain version at atol 2e-2 and timed beside its bound and
    one ``scaled_dot_product_attention`` call on the same tensors; then,
    checked only, a ragged length (S = ``ragged``) in bf16 and the shape in
    float32 (atol 2e-5).  Its launches are those of ``[serve-mla]``'s
    prefill."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    b, h, sq, d, dv = shape
    bh = b * h
    gen = torch.Generator(device=device).manual_seed(seed + 8)

    def inputs(s_len, dtype):
        return tuple(torch.randn(bh, s_len, width, generator=gen,
                                 device=device, dtype=dtype)
                     for width in (d, d, dv))

    errs = {}
    for name, (s_len, dtype) in {"prefill": (sq, torch.bfloat16),
                                 "ragged": (ragged, torch.bfloat16),
                                 "float32": (sq, torch.float32)}.items():
        q, k, v = inputs(s_len, dtype)
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa_ref.attention_ref(q, k, v, causal=True)
        atol = FLASH_ATOL[str(dtype).split(".")[-1]]
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and got.shape == (bh, s_len, dv)
              and err <= atol,
              f"flash_attention MLA {name} (BH={bh}, S={s_len}, D={d}, "
              f"Dv={dv}, {dtype}): max abs err {err:.3e} beyond atol {atol}")
        errs[name] = err
        del got, want
    q, k, v = inputs(sq, torch.bfloat16)
    q4, k4, v4 = (x.view(b, h, sq, x.shape[-1]) for x in (q, k, v))
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + bh * sq * dv)
    ops = attention_flops(bh, sq, sq, d, True, dv=dv)
    row = dict(
        name="flash_attention_mla",
        fn=lambda: fa.flash_attention(q, k, v),
        plain=lambda: fa_ref.attention_ref(q, k, v),
        library=lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       is_causal=True),
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:73",
        err=errs["prefill"], bound=bound(nbytes, ops, BF16_OPS_PER_S))
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    row["ms"] = event_ms(row["fn"], 20, flush)
    row["plain_ms"] = event_ms(row["plain"], 3, flush)
    row["library_ms"] = event_ms(row["library"], 20, flush)
    print(f"[kernel] flash_attention (MLA {d}/{d}/{dv}): ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound'][0]:.4f} "
          f"({row['bound'][1]}) share_of_bound="
          f"{row['bound'][0] / row['ms']:.3f} "
          f"tflops={ops / row['ms'] / 1e9:.1f} "
          f"library_ms={row['library_ms']:.4f} (sdpa) "
          f"max_abs_err={errs['prefill']:.3e} "
          f"ragged_err={errs['ragged']:.3e} f32_err={errs['float32']:.3e} "
          f"shape=(BH={bh}, S={sq}, D={d}, Dv={dv}, group 1, causal, bf16) "
          f"card=\"{card}\"", flush=True)
    del flush_buf, q4, k4, v4
    return [row]


def flash_cross_kernel_phase(seed: int, card: str, device="cuda",
                             xattn=(4, 32, 8, 2048, 1601, 128),
                             encoder=(4, 12, 1500, 64),
                             decode_keys=(1500, 1601)) -> list[dict]:
    """Phase 4, fifth part: the flash-attention kernel at the call shapes
    of the cross-attention and encoder paths, non-causal bf16, each against
    its plain version at atol 2e-2 and timed beside its bound and one
    ``scaled_dot_product_attention`` call (k/v expanded to every q head):
    llama-3.2-vision's cross prefill ``xattn`` = (B, H, Kh, Sq, Skv, D)
    (q ``(B*H, Sq, D)`` over the 1601 patch embeddings' K/V ``(B*Kh, Skv,
    D)``, group 4), whisper-small's encoder ``encoder`` = (B, H, S, D)
    (group 1, S = 1500) and a cross-attention decode step (that q at
    ``Sq = 1`` over the same K/V).  Checked only: ``Sq = 1`` against each
    of ``decode_keys`` keys at groups 1 and 4, bf16 and float32 (atol
    2e-5).  Their launches are those of ``[serve-xattn]`` and
    ``[serve-enc]``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator(device=device).manual_seed(seed + 9)

    def qkv(rows, kv_rows, s_q, s_kv, dim, dtype=torch.bfloat16):
        return tuple(torch.randn(*dims, generator=gen, device=device,
                                 dtype=dtype)
                     for dims in ((rows, s_q, dim), (kv_rows, s_kv, dim),
                                  (kv_rows, s_kv, dim)))

    decode_errs = {}
    for skv in decode_keys:
        for group in (1, 4):
            for dtype in (torch.bfloat16, torch.float32):
                d = 64 if skv == decode_keys[0] else 128
                q, k, v = qkv(8 * group, 8, 1, skv, d, dtype)
                got = fa.flash_attention(q, k, v, causal=False)
                want = fa_ref.attention_ref(q, k, v, causal=False)
                atol = FLASH_ATOL[str(dtype).split(".")[-1]]
                err = float((got.float() - want.float()).abs().max())
                check(bool(torch.isfinite(got).all()) and err <= atol,
                      f"flash_attention Sq=1 Skv={skv} group {group} D={d} "
                      f"{dtype}: max abs err {err:.3e} beyond atol {atol}")
                decode_errs[skv, group, str(dtype).split(".")[-1]] = err

    b, h, kh, sq, skv, d = xattn
    eb, eh, es, ed = encoder
    cases = {  # name: (B, H, Kh, Sq, Skv, D), what it is
        "flash_attention_xattn": ((b, h, kh, sq, skv, d), "cross prefill"),
        "flash_attention_encoder": ((eb, eh, eh, es, es, ed), "encoder"),
        "flash_attention_xdecode": ((b, h, kh, 1, skv, d),
                                    "cross decode, Sq = 1")}
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    rows = []
    for name, ((cb, ch, ckh, csq, cskv, cd), what) in cases.items():
        q, k, v = qkv(cb * ch, cb * ckh, csq, cskv, cd)
        got = fa.flash_attention(q, k, v, causal=False)
        want = fa_ref.attention_ref(q, k, v, causal=False)
        err = float((got.float() - want.float()).abs().max())
        atol = FLASH_ATOL["bfloat16"]
        check(bool(torch.isfinite(got).all()) and err <= atol,
              f"flash_attention {what} (BH={cb * ch}, Sq={csq}, "
              f"BH_kv={cb * ckh}, Skv={cskv}, D={cd}): max abs err "
              f"{err:.3e} beyond atol {atol}")
        del got, want
        q4 = q.view(cb, ch, csq, cd)
        k4, v4 = (x.view(cb, ckh, cskv, cd).repeat_interleave(ch // ckh,
                                                              dim=1)
                  for x in (k, v))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        ops = attention_flops(cb * ch, csq, cskv, cd, False)
        row = dict(
            name=name,
            fn=lambda q=q, k=k, v=v: fa.flash_attention(q, k, v,
                                                        causal=False),
            plain=lambda q=q, k=k, v=v: fa_ref.attention_ref(q, k, v,
                                                             causal=False),
            library=lambda q4=q4, k4=k4, v4=v4:
                F.scaled_dot_product_attention(q4, k4, v4),
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:73",
            err=err, bound=bound(nbytes, ops, BF16_OPS_PER_S))
        row["ms"] = event_ms(row["fn"], 20, flush)
        row["plain_ms"] = event_ms(row["plain"], 3, flush)
        row["library_ms"] = event_ms(row["library"], 20, flush)
        print(f"[kernel] flash_attention ({what}): ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} "
              f"bound_ms={row['bound'][0]:.4f} ({row['bound'][1]}) "
              f"share_of_bound={row['bound'][0] / row['ms']:.3f} "
              f"tflops={ops / row['ms'] / 1e9:.1f} "
              f"library_ms={row['library_ms']:.4f} (sdpa, k/v expanded) "
              f"max_abs_err={err:.3e} shape=(BH={cb * ch}, Sq={csq}, "
              f"BH_kv={cb * ckh}, Skv={cskv}, D={cd}, group "
              f"{ch // ckh}, non-causal, bf16) card=\"{card}\"", flush=True)
        rows.append(row)
        del q4, k4, v4
    print(f"[kernel] flash_attention Sq=1 checks (BH_kv=8, non-causal): "
          + " ".join(f"Skv={s_kv}/group{g}/{dt}={e:.3e}"
                     for (s_kv, g, dt), e in decode_errs.items())
          + f" card=\"{card}\"", flush=True)
    del flush_buf
    return rows


BWD_REPLACES = "src/repro/models/layers.py:87"   # the jnp twin it trains


def bwd_work(bh: int, bh_kv: int, s: int, d: int, dv: int, itemsize: int,
             causal: bool = True) -> dict[str, tuple[int, int, float]]:
    """(bytes, operations, the peak rate of their type) of each backward
    kernel: K0 reads out and dout, writes float32 delta and does a
    multiply-add an element (float32, on the CUDA cores); K1 reads q, k,
    v, dout, lse and delta, writes dk and dv, and computes S, dP, dV and
    dK; K2 reads the same, writes dq, and computes S, dP and dQ (each
    product over the pairs the mask keeps, on the bf16 tensor cores)."""
    pairs = attention_flops(bh, s, s, 1, causal, dv=0) // 2   # 2 bh pairs
    q = bh * s * d * itemsize
    kv = bh_kv * s * (d + dv) * itemsize
    o = bh * s * dv * itemsize
    stats = 2 * bh * s * 4
    return {"flash_attention_bwd_prep": (2 * o + bh * s * 4, 2 * bh * s * dv,
                                         FP32_OPS_PER_S),
            "flash_attention_bwd_dkdv": (q + kv + o + stats + kv,
                                         pairs * 2 * (2 * d + 2 * dv),
                                         BF16_OPS_PER_S),
            "flash_attention_bwd_dq": (q + kv + o + stats + q,
                                       pairs * 2 * (2 * d + dv),
                                       BF16_OPS_PER_S)}


def bwd_kernel_fns(q, k, v, out, do, lse, causal: bool = True):
    """One closure per backward kernel, each launching it alone (for its
    timing) on scratch of its own, K1 and K2 reading ``lse`` (the forward
    kernel's) and the delta of one K0 run; and that delta.  On CPU tensors
    (a rehearsal) the plain versions stand in: ``delta_ref`` and the plain
    backward."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ref as fa_ref
    if q.device.type == "cpu":
        full = lambda: fa_ref.attention_bwd_ref(q, k, v, out, do,  # noqa: E731
                                                causal=causal, lse=lse)
        return {"flash_attention_bwd_prep": lambda: fa_ref.delta_ref(out, do),
                "flash_attention_bwd_dkdv": full,
                "flash_attention_bwd_dq": full}, fa_ref.delta_ref(out, do)
    bh, s, d = q.shape
    bh_kv, dv = k.shape[0], v.shape[-1]
    lib = build.library("flash_attention_bwd")
    delta = torch.empty_like(lse)
    dq, dk, dvo = (torch.empty_like(t) for t in (q, k, v))
    is_bf16 = int(q.dtype == torch.bfloat16)
    stream = build.stream(q.device)
    args = (bh, bh_kv, s, s, d, dv, d ** -0.5, int(causal), is_bf16, stream)
    p = build.ptr

    def launch(fn, tensors, tail):
        return lambda: build.check(fn(*map(p, tensors), *tail), fn.__name__)
    fns = {"flash_attention_bwd_prep": launch(
        lib.repro_flash_bwd_prep, (out, do, delta),
        (bh, s, dv, is_bf16, stream)),
        "flash_attention_bwd_dkdv": launch(
            lib.repro_flash_bwd_dkdv, (q, k, v, do, lse, delta, dk, dvo),
            args),
        "flash_attention_bwd_dq": launch(
            lib.repro_flash_bwd_dq, (q, k, v, do, lse, delta, dq), args)}
    fns["flash_attention_bwd_prep"]()
    return fns, delta


def prep_plain(q, k, out, do, causal: bool = True):
    """The oracle of the backward's statistics: each row's log-normaliser
    over the masked scores (``torch.logsumexp``, what the forward kernel
    writes) and ``rowsum(dout * out)`` (K0's delta), float32."""
    import torch
    group = q.shape[0] // k.shape[0]
    sc = torch.einsum("bqd,bkd->bqk", q.float(),
                      k.repeat_interleave(group, dim=0).float())
    sc = sc * q.shape[-1] ** -0.5
    if causal:
        sc = sc.masked_fill(torch.ones(sc.shape[1:], dtype=torch.bool,
                                       device=q.device).triu(1),
                            float("-inf"))
    return (torch.logsumexp(sc, dim=-1),
            (do.float() * out.float()).sum(-1))


def flash_bwd_kernel_phase(seed: int, card: str, device="cuda",
                           shape=(4, 16, 2, 2048, 128),
                           small=(2, 4, 2, 200, 64)) -> list[dict]:
    """Phase 4, fifth part: the flash backward's K0-K2 through
    ``flash_attention_bwd``, on the lse that the forward kernel writes
    (``flash_attention_fwd(..., want_lse=True)``), against
    ``attention_bwd_ref`` at one qwen2.5-3b train layer ``(B, H, Kh, S,
    D)`` in bf16 (bar 2e-2 of each gradient's largest value) and at
    ``small`` in float32 (1e-4), each giving the same bits twice; the
    forward's lse (max abs err within 1e-3) and K0's delta (within 1e-5
    of its largest; its row's ``max_abs_err``; the same bits twice)
    against their oracle (``prep_plain``);
    then each kernel timed alone beside its bound (``bwd_work``), its
    plain version (K0's ``delta_ref``; the whole plain backward for K1 and
    K2) and one PyTorch call: ``torch.linalg.vecdot`` for K0 (a bf16
    result), SDPA's backward with k/v expanded for K1 and K2 (dq, dk and
    dv at once)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator(device=device).manual_seed(seed + 12)

    def inputs(b, h, kh, s, d, dtype):
        q, k, v, do = (torch.randn(*dims, generator=gen, device=device,
                                   dtype=dtype)
                       for dims in ((b * h, s, d), (b * kh, s, d),
                                    (b * kh, s, d), (b * h, s, d)))
        return (q, k, v, do, *fa.flash_attention_fwd(q, k, v,
                                                      want_lse=True))

    errs = {}
    for tag, case, dtype in (("bf16", shape, torch.bfloat16),
                             ("f32", small, torch.float32)):
        q, k, v, do, out, lse = inputs(*case, dtype)
        got = fa.flash_attention_bwd(q, k, v, out, do, lse)
        again = fa.flash_attention_bwd(q, k, v, out, do, lse)
        want = fa_ref.attention_bwd_ref(q, k, v, out, do, causal=True)
        bar = FLASH_BWD_BAR[str(dtype).split(".")[-1]]
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            err = float((g.float() - w.float()).abs().max()) / max(
                float(w.float().abs().max()), 1e-30)
            check(bool(torch.isfinite(g).all()) and err <= bar,
                  f"flash backward {tag} {name}: {err:.3e} of the largest "
                  f"beyond {bar}")
            check(torch.equal(g, a), f"flash backward {tag} {name}: not "
                                     "the same bits twice")
            errs[tag, name] = err
        del got, again, want
    b, h, kh, s, d = shape
    q, k, v, do, out, lse = inputs(*shape, torch.bfloat16)
    plain_lse, plain_delta = prep_plain(q, k, out, do)
    fns, delta = bwd_kernel_fns(q, k, v, out, do, lse)
    first = delta.clone()
    fns["flash_attention_bwd_prep"]()
    torch.cuda.synchronize()
    lse_err = float((lse - plain_lse).abs().max())
    check(lse_err <= 1e-3, f"the forward kernel's lse is {lse_err:.3e} "
                           "from the plain one")
    delta_err = float((delta - plain_delta).abs().max())
    delta_top = float(plain_delta.abs().max())
    check(delta_err <= 1e-5 * delta_top, f"K0's delta is {delta_err:.3e} "
          f"from the plain one, beyond 1e-5 of its largest {delta_top:.3e}")
    check(torch.equal(delta, first), "K0: not the same bits twice")
    plain = {"flash_attention_bwd_prep": lambda: fa_ref.delta_ref(out, do)}
    plain["flash_attention_bwd_dkdv"] = plain["flash_attention_bwd_dq"] = (
        lambda: fa_ref.attention_bwd_ref(q, k, v, out, do, causal=True,
                                         lse=lse))
    q4 = q.view(b, h, s, d).detach().requires_grad_(True)
    k4, v4 = (x.view(b, kh, s, d).repeat_interleave(h // kh, dim=1)
              .detach().requires_grad_(True) for x in (k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(b, h, s, d)
    sdpa_bwd = (lambda: torch.autograd.grad(o4, (q4, k4, v4), do4,  # noqa
                                            retain_graph=True))
    work = bwd_work(b * h, b * kh, s, d, d, 2)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    lib_ms = {"flash_attention_bwd_prep": event_ms(
        lambda: torch.linalg.vecdot(do, out, dim=-1), 10, flush)}
    lib_ms["flash_attention_bwd_dkdv"] = lib_ms["flash_attention_bwd_dq"] = (
        event_ms(sdpa_bwd, 10, flush))
    rows = []
    for name, fn in fns.items():
        row = dict(name=name, fn=fn, plain=plain[name],
                   source="src/repro_torch/csrc/flash_attention_bwd.cu",
                   replaces=BWD_REPLACES,
                   err=(delta_err if name == "flash_attention_bwd_prep" else
                        max(errs["bf16", g] for g in ("dq", "dk", "dv"))),
                   bound=bound(*work[name]), library_ms=lib_ms[name])
        row["ms"] = event_ms(fn, 5 if row["bound"][1] == "operations"
                             else 20, flush)
        row["plain_ms"] = event_ms(row["plain"], 2, flush)
        rows.append(row)
    total = sum(r["ms"] for r in rows)
    for r in rows:
        lib = ("(torch.linalg.vecdot, a bf16 result)"
               if r["name"] == "flash_attention_bwd_prep" else
               "(sdpa backward, k/v expanded)")
        print(f"[kernel] {r['name']}: ms={r['ms']:.4f} plain_ms="
              f"{r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]}) share_of_bound="
              f"{r['bound'][0] / r['ms']:.4f} library_ms="
              f"{r['library_ms']:.4f} {lib} shape=(BH={b * h}, "
              f"BH_kv={b * kh}, S={s}, D={d}, causal, bf16) "
              f"card=\"{card}\"", flush=True)
    sdpa_ms = lib_ms["flash_attention_bwd_dq"]
    print(f"[kernel] flash backward K0+K1+K2: ms={total:.4f} against "
          f"sdpa backward {sdpa_ms:.4f}; bf16 dq/dk/dv err "
          f"{errs['bf16', 'dq']:.3e}/{errs['bf16', 'dk']:.3e}/"
          f"{errs['bf16', 'dv']:.3e}, f32 {errs['f32', 'dq']:.3e}/"
          f"{errs['f32', 'dk']:.3e}/{errs['f32', 'dv']:.3e} of the largest "
          f"(bars {FLASH_BWD_BAR}); the same bits twice; the forward's lse "
          f"max abs err {lse_err:.3e}, K0's delta {delta_err:.3e} (largest "
          f"{delta_top:.3e})", flush=True)
    del flush_buf, q4, k4, v4, o4
    return rows


def counters():
    from repro_torch.kernels.baseline_energy import baseline_energy as be
    from repro_torch.kernels.bdi import bdi
    from repro_torch.kernels.byte_lut import byte_lut
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.popcount import popcount
    from repro_torch.kernels.toggle import toggle
    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    wrappers = [ve.batched_state, ve.batched_features, ve.vampire_charge,
                ve.vampire_charge_surface, *be.WRAPPERS.values(),
                popcount.line_ones, toggle.line_toggles,
                byte_lut.apply_lut_lines, bdi.bdi_sizes, fa.flash_attention,
                *(BwdCounter(name) for name in fa.BWD_KERNELS)]
    return {w.__name__: w for w in wrappers}


def reset_counters() -> None:
    for w in counters().values():
        w.launches = 0


def read_counters() -> dict[str, int]:
    return {name: w.launches for name, w in counters().items()}


class BwdCounter:
    """One of K0-K2's counts (``flash_attention.bwd_launches[name]``) as a
    wrapper's ``launches``."""

    def __init__(self, name: str):
        self.__name__ = name

    @property
    def launches(self) -> int:
        from repro_torch.kernels.flash_attention import flash_attention as fa
        return fa.flash_attention.bwd_launches[self.__name__]

    @launches.setter
    def launches(self, n: int) -> None:
        from repro_torch.kernels.flash_attention import flash_attention as fa
        fa.flash_attention.bwd_launches[self.__name__] = n


def path_kernels(kind: str, mode: str) -> set[str]:
    """The kernels ``estimate(..., impl='cuda')`` must launch."""
    if kind == "vampire":
        charge = ("vampire_charge_surface" if mode == "surface"
                  else "vampire_charge")
        return {"batched_state", charge} | (
            {"batched_features"} if mode != "distribution" else set())
    return {"batched_state",
            f"{kind}_charge" + ("_surface" if mode == "surface" else "")}


def leaves(rep, mode):
    return rep if mode == "range" else (rep,)


def e2e_phase(tb, trs, models, kernel_ms: dict[str, float], card: str):
    """Phase 5: the main path, through the entry point a user calls.
    Returns the launches of every kernel over the main-path runs and the
    host-clock ms of every (kind, mode) estimate."""
    import torch

    from repro_torch.core.estimate_batch import bucketed_trace_batch
    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    t, n = tb.trace.cmd.shape
    total = {name: 0 for name in counters()}
    times = {}

    def bookkeeping():
        ve.batched_state(tb.trace.cmd, tb.trace.bank, tb.trace.col)

    book_ms = wall_ms(bookkeeping, 5)
    for kind in KINDS:
        est = models[kind]
        for mode in MODES:
            kw = MODE_KW.get(mode, {})
            reset_counters()
            rep = est.estimate(tb, mode=mode, impl="cuda", **kw)
            torch.cuda.synchronize()
            launched = read_counters()
            for name, c in launched.items():
                total[name] += c
            need = path_kernels(kind, mode)
            check(all(launched[k] > 0 for k in need),
                  f"{kind}/{mode}: kernels {sorted(need)} not all launched "
                  f"({launched})")
            vec = est.estimate(tb, mode=mode, impl="vectorized", **kw)
            for a, b in zip(leaves(rep, mode), leaves(vec, mode)):
                for name, la, lb in zip(a._fields, a, b):
                    if name == "cycles":
                        check(torch.equal(la, lb), f"{kind}/{mode} cycles")
                    else:
                        assert_close(la, lb, RTOL,
                                     f"{kind}/{mode} leaf {name}")
            ms = wall_ms(lambda: est.estimate(tb, mode=mode, impl="cuda",
                                              **kw), 5)
            vec_ms = wall_ms(lambda: est.estimate(tb, mode=mode,
                                                  impl="vectorized", **kw), 3)
            times[kind, mode] = ms
            kern = sum(kernel_ms[k] * c for k, c in launched.items() if c)
            print(f"[e2e] {kind}/{mode}: estimate_ms={ms:.3f} "
                  f"traces_per_s={t / ms * 1e3:.1f} "
                  f"vectorized_ms={vec_ms:.3f} bookkeeping_ms={book_ms:.3f} "
                  f"kernels_ms={kern:.3f} "
                  f"launches={ {k: v for k, v in launched.items() if v} } "
                  f"shape=(T={t}, N={n}, V=3) card=\"{card}\"", flush=True)

        mean = est.estimate(tb, impl="cuda")
        surf = est.estimate(tb, mode="surface", impl="cuda")
        assert_close(surf.charge_ma_cycles.sum(dim=(-2, -1)),
                     mean.charge_ma_cycles, RTOL, f"{kind} surface sum")
        check(torch.equal(surf.cycles.sum(dim=(-2, -1)), mean.cycles),
              f"{kind} surface cycles sum")
        # pad rows: k traces in a 2k-slot bucket; pad commands: a trace
        # scored at its own length vs inside the full-length bucket
        k = min(8, len(trs))
        small = bucketed_trace_batch(trs[:k], 2 * k, n).to(tb.device)
        part = est.estimate(small, impl="cuda")
        check(bool((part.charge_ma_cycles[k:] == 0).all())
              and bool((part.cycles[k:] == 0).all()),
              f"{kind}: pad rows add charge or cycles")
        assert_close(part.charge_ma_cycles[:k], mean.charge_ma_cycles[:k],
                     1e-6, f"{kind}: rows inside a padded bucket")
        solo = est.estimate([trs[0]], impl="cuda")
        assert_close(solo.charge_ma_cycles[0], mean.charge_ma_cycles[0],
                     RTOL, f"{kind}: pad commands")
        print(f"[e2e] {kind}: surface sums to mean, pad rows and pad "
              f"commands add zero", flush=True)
    return total, times


def device_profile(fn, what: str, wall: float, card: str,
                   tag: str = "[profile]", top: int = 8) -> None:
    """Where one call of ``fn`` spends its device time: every kernel the
    profiler records, summed by name, against ``wall``, the host-clock ms
    of the same call measured without the profiler (the rest is the
    device's idle share)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.device_time_total / 1e3
            launches += 1
    busy = sum(by_name.values())
    if not by_name:
        print(f"{tag} {what}: device time not measured (the profiler "
              "recorded no kernel)", flush=True)
        return
    print(f"{tag} {what}: device_busy_ms={busy:.3f} of wall_ms={wall:.3f} "
          f"(idle share {max(0.0, 1 - busy / wall):.3f}) "
          f"device_ops={launches} distinct={len(by_name)} card=\"{card}\"",
          flush=True)
    for name, ms in by_name.most_common(top):
        print(f"{tag}   {ms:8.3f} ms  {name[:90]}", flush=True)


def profile_phase(tb, models, estimate_ms: float, card: str) -> None:
    """The device time of one ``vampire`` mean estimate."""
    est = models["vampire"]
    device_profile(lambda: est.estimate(tb, impl="cuda"), "vampire/mean",
                   estimate_ms, card)


def oracle_phase(models, trs) -> None:
    """A small input on the card against the command-by-command oracle
    run on the CPU (``impl='reference'`` on a CPU copy of the model)."""
    from repro_torch.core import model_api
    from repro_torch.core.dram import CommandTrace
    small = [CommandTrace(*(f[:400] for f in tr)) for tr in trs[:3]]
    cpu_vampire = models["vampire"].to("cpu")
    for kind in KINDS:
        cpu = model_api.make_estimator(kind, cpu_vampire)
        for mode in MODES:
            kw = MODE_KW.get(mode, {})
            got = models[kind].estimate(small, mode=mode, impl="cuda", **kw)
            want = cpu.estimate(small, mode=mode, impl="reference", **kw)
            for a, b in zip(leaves(got, mode), leaves(want, mode)):
                for name, la, lb in zip(a._fields, a, b):
                    assert_close(la.cpu(), lb, RTOL,
                                 f"oracle {kind}/{mode} leaf {name}")
    print("[oracle] 3 kinds x 4 modes on 3 x 400 commands match the CPU "
          "oracle", flush=True)


IMPLS = ("vectorized", "reference", "cuda")
BAD_ADDRESSES = ((9, 5), (-1, 5), (1, 40000), (1, -5))   # (bank, row)


def faults_phase(models, device="cuda") -> None:
    """The port's refusals and edge cases on the card: a bank outside
    [0, 8) or a row outside [0, 2^15) is refused by ``make_trace`` and, in
    a trace built field by field on the card, by ``estimate`` in every
    kind, impl and mode alike, naming the trace and the command; a batch
    of empty traces gives zeros of every mode's shape."""
    import torch

    from repro_torch.core import dram

    def address_trace(bank, row, make):
        return make([dram.ACT, dram.PRE, dram.ACT, dram.RD, dram.PRE],
                    [0, 0, bank, bank, bank], [0, 0, row, row, 0],
                    [0, 0, 0, 1, 0], None, [6, 6, 6, 4, 6])

    def direct(cmds, banks, rows, cols, data, dts):
        i32 = [torch.tensor(x, dtype=torch.int32, device=device)
               for x in (cmds, banks, rows, cols, dts)]
        return dram.CommandTrace(*i32[:4], torch.zeros(
            (len(cmds), 16), dtype=torch.int32, device=device), i32[4])

    def refused(fn, where: str) -> None:
        try:
            fn()
        except ValueError as exc:
            check(str(exc).startswith(where),
                  f"refusal names the wrong place: {exc} (want {where})")
            return
        raise CheckFailed(f"an out-of-range address was not refused "
                          f"({where})")

    good = address_trace(0, 5, dram.make_trace).to(device)
    n = 0
    for bank, row in BAD_ADDRESSES:
        refused(lambda: address_trace(bank, row, dram.make_trace),
                "trace 0, command 2")
        bad = address_trace(bank, row, direct)
        for kind in KINDS:
            for impl in IMPLS:
                for mode in ("mean", "surface"):
                    refused(lambda: models[kind].estimate(
                        [good, bad], mode=mode, impl=impl),
                        "trace 1, command 2")
                    n += 1
    empty = dram.make_trace([], [], [], [], None, [])
    for kind in KINDS:
        for mode in MODES:
            shape = (2, 3) + ((8, 8) if mode == "surface" else ())
            for impl in IMPLS:
                rep = models[kind].estimate([empty, empty], mode=mode,
                                            impl=impl, **MODE_KW.get(mode, {}))
                for leaf in leaves(rep, mode):
                    for name, x in zip(leaf._fields, leaf):
                        check(tuple(x.shape) == shape and not bool(x.any()),
                              f"empty traces {kind}/{mode}/{impl} {name}: "
                              f"shape {tuple(x.shape)}, not zeros of {shape}")
    print(f"[faults] {len(BAD_ADDRESSES)} out-of-range addresses refused by "
          f"make_trace and by estimate in {n} (address, kind, impl, mode) "
          f"cases; a batch of empty traces gives zeros in 3 kinds x 4 modes "
          f"x 3 impls", flush=True)


def f7_phase(card: str, device="cuda") -> None:
    """``[faults] F7`` (repaired): q, k and v that require grad get their
    gradients through the card's flash attention (``FlashAttention``: the
    forward kernel, then K0-K2, one launch each), within the bf16 bar of
    the plain backward's."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator(device=device).manual_seed(21)
    q, k, v, do = (torch.randn(*shape, generator=gen, device=device,
                               dtype=torch.bfloat16)
                   for shape in ((8, 200, 64), (4, 200, 64), (4, 200, 64),
                                 (8, 200, 64)))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    reset_counters()
    out = fa.flash_attention(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    launched = read_counters()
    want = fa_ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                    out.detach(), do, causal=True)
    errs = []
    for name, t, w in zip("qkv", leaves, want):
        check(t.grad is not None and bool(torch.isfinite(t.grad).all()),
              f"F7: {name} has no finite gradient through the card's flash "
              "attention")
        errs.append(float((t.grad.float() - w.float()).abs().max())
                    / max(float(w.float().abs().max()), 1e-30))
    check(max(errs) <= FLASH_BWD_BAR["bfloat16"],
          f"F7: gradients {errs} of the largest beyond "
          f"{FLASH_BWD_BAR['bfloat16']}")
    kernels = ("flash_attention",) + fa.BWD_KERNELS
    check(all(launched[name] == 1 for name in kernels),
          f"F7: launches {[launched[name] for name in kernels]} of the "
          "forward and K0-K2, not one each")
    print(f"[faults] F7 repaired: q, k and v get gradients through the "
          f"card's flash attention (forward kernel, then K0-K2 once each); "
          f"against the plain backward dq/dk/dv err "
          f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} of the largest "
          f"(bar {FLASH_BWD_BAR['bfloat16']}) card=\"{card}\"", flush=True)


PAPER_OWI_SAVING = 0.122      # the paper's average OWI energy reduction


def study_phase(seed: int, model, card: str,
                n_requests: int = 6000) -> dict[str, int]:
    """Phase 6: the Section 10 encoding study at full size through the
    entry point a user calls, then the same encoded batch through
    ``impl='cuda'``.  Returns the launches of the ``encoding_energy_study``
    run."""
    import dataclasses

    import torch

    from repro_torch.analysis import trace_lint
    from repro_torch.core import encodings, traces
    t0 = time.perf_counter()
    apps = [dataclasses.replace(app, seed=seed * 1000 + i + 1)
            for i, app in enumerate(traces.SPEC_APPS)]
    trs = {app.name: traces.app_trace(app, n_requests=n_requests)
           for app in apps}
    gen_s = time.perf_counter() - t0

    reset_counters()
    t0 = time.perf_counter()
    study = encodings.encoding_energy_study(trs, model)
    torch.cuda.synchronize()
    study_s = time.perf_counter() - t0
    launched = read_counters()
    check(launched["apply_lut_lines"] > 0,
          f"study: the byte-LUT kernel was not launched ({launched})")

    # the same batch, step by step: encode (LUT on the card, refresh
    # rescheduling and lint), lint alone, the estimate in both impls
    t0 = time.perf_counter()
    encoded = encodings.encode_all(trs, device=model.device)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    diags = [trace_lint.lint_trace(tr) for tr in encoded]
    lint_s = time.perf_counter() - t0
    # clean: no rule broken, and no refresh later than tREFI plus the
    # linter's scheduling slack
    check(not any(diags), "study: an encoded trace does not lint clean")
    lengths = [tr.n for tr in encoded]
    t0 = time.perf_counter()
    rep = model.estimate(encoded)
    torch.cuda.synchronize()
    est_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep_cuda = model.estimate(encoded, impl="cuda")
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    for name, a, b in zip(rep._fields, rep_cuda, rep):
        if name == "cycles":
            check(torch.equal(a, b), "study: cycles differ between impls")
        else:
            assert_close(a, b, RTOL, f"study impl='cuda' leaf {name}")
    table = encodings.study_table(list(trs), rep)
    for app in trs:
        want = torch.tensor([table[app][e] for e in encodings.ENCODINGS])
        got = torch.tensor([study[app][e] for e in encodings.ENCODINGS])
        assert_close(got, want, RTOL, f"study {app} vs its batch")
        check(bool((got > 0).all()), f"study {app}: energy not positive")

    savings = []
    for app, per in study.items():
        base = per["baseline"]
        savings.append(1 - per["owi"] / base)
        print(f"[study] {app:11s} " + " ".join(
            f"{e}={per[e] / base:.4f}" for e in ("bdi", "optimized", "owi")),
            flush=True)
    mean = sum(savings) / len(savings)
    print(f"[study] traces={len(encoded)} commands min={min(lengths)} "
          f"max={max(lengths)} total={sum(lengths)} vendors="
          f"{len(model.vendors)} owi_mean_saving={mean * 100:.2f}% "
          f"(paper: {PAPER_OWI_SAVING * 100:.1f}%) gen_s={gen_s:.3f} "
          f"study_s={study_s:.3f} encode_s={encode_s:.3f} "
          f"lint_s={lint_s:.3f} estimate_s={est_s:.3f} "
          f"estimate_cuda_s={cuda_s:.3f} "
          f"launches={ {k: v for k, v in launched.items() if v} } "
          f"card=\"{card}\"", flush=True)
    return launched


def hbm_phase(seed: int, model, card: str, mib: int = 32,
              ones_bytes: int = 1 << 30) -> dict[str, int]:
    """Phase 7: the HBM data statistics of four seeded ``mib`` MiB corpora
    made on the card and of a 1 GiB all-ones tensor; returns the
    launches of the run."""
    import torch

    from repro_torch.core import encodings, hbm, traces
    from repro_torch.kernels.bdi import ops as bdi_ops
    from repro_torch.kernels.popcount import ref as pc_ref
    from repro_torch.kernels.toggle import ref as tg_ref
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    bf16 = dict(device=dev, dtype=torch.bfloat16, generator=gen)
    corpora = {
        "bf16_weights": torch.randn(4096, mib * 128, **bf16) * 0.02,
        "bf16_activations": torch.relu(torch.randn(4096, mib * 128, **bf16)),
        "int8_quantized": (torch.randn(4096, mib * 256, device=dev,
                                       generator=gen) * 30).to(torch.int8),
        "token_ids": torch.randint(0, 32000, (mib << 18,), device=dev,
                                   generator=gen, dtype=torch.int32),
    }
    vendor = model.vendors[0]
    reset_counters()
    for name, x in corpora.items():
        t0 = time.perf_counter()
        ones, togg = hbm.tensor_stats(x)
        stats_ms = (time.perf_counter() - t0) * 1e3
        lines = hbm._tensor_lines(x)
        cr = float(bdi_ops.compression_ratio(lines))
        head = x.reshape(-1).view(torch.uint8)[:400 * 64].cpu().numpy()
        app = traces.AppSpec("tensor", 0.5, 0.6, 0.7, "random", 99)
        tr = traces.app_trace(app, n_requests=400,
                              lines=traces.lines_from_bytes(head))
        owi_tr = encodings.encode_trace(tr, "owi", device=dev)
        rep = model.estimate([tr, owi_tr], (vendor,))
        base, owi = rep.energy_pj[:, 0].double().tolist()
        cr_trace = float(bdi_ops.compression_ratio(torch.from_numpy(
            traces.trace_request_lines(tr).view("int32")).to(dev)))
        check(0.0 < ones < 1.0 and 0.0 <= togg <= 1.0 and 0.0 < cr <= 1.0
              and owi > 0 and base > 0, f"hbm {name}: values out of range")
        if name == "bf16_weights":      # the kernels' sums on the CPU side
            want_ones = int(pc_ref.line_ones(lines).sum(dtype=torch.int64))
            want_togg = int(tg_ref.line_toggles_seq(lines).sum(
                dtype=torch.int64))
            n = lines.shape[0]
            check((ones, togg) == (want_ones / (n * 512),
                                   want_togg / ((n - 1) * 512)),
                  "hbm: tensor_stats differs from the plain sums")
        print(f"[hbm] {name:16s} bytes={x.numel() * x.element_size()} "
              f"ones_frac={ones:.6f} toggle_frac={togg:.6f} "
              f"bdi_ratio={cr:.4f} bdi_ratio_trace={cr_trace:.4f} "
              f"owi_energy_ratio={owi / base:.4f} "
              f"tensor_stats_ms={stats_ms:.3f} card=\"{card}\"",
              flush=True)
    del corpora
    ones_gib = torch.full((ones_bytes // 2,), -1, dtype=torch.int16,
                          device=dev).view(torch.bfloat16)
    t0 = time.perf_counter()
    ones, togg = hbm.tensor_stats(ones_gib)
    stats_ms = (time.perf_counter() - t0) * 1e3
    check(ones == 1.0 and togg == 0.0,
          f"hbm: 1 GiB of all-ones bits gives ones_frac={ones!r} "
          f"toggle_frac={togg!r}, not exactly 1.0 and 0.0")
    print(f"[hbm] all_ones          bytes={ones_bytes} ones_frac={ones!r} "
          f"toggle_frac={togg!r} ({ones_bytes * 8} ones, counted in int64) "
          f"tensor_stats_ms={stats_ms:.3f} card=\"{card}\"", flush=True)
    del ones_gib
    return read_counters()


QUICK_FIT = dict(probe_modules=2, probe_reps=64, n_rows=8)
FIT_RTOL, FIT_ATOL = 1e-4, 1e-6   # the reference's batched-vs-serial bar


def fit_close(got, want, what: str) -> float:
    """|got - want| <= FIT_ATOL + FIT_RTOL * |want| element-wise (the
    reference's bar for two fits); returns the largest share of the bar
    used."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{what}: shape {got.shape} vs "
                                   f"{want.shape}")
    check(bool(np.isfinite(got).all()), f"{what}: non-finite values")
    share = np.abs(got - want) / (FIT_ATOL + FIT_RTOL * np.abs(want))
    worst = float(share.max()) if share.size else 0.0
    check(worst <= 1.0, f"{what}: beyond rtol {FIT_RTOL} / atol {FIT_ATOL} "
                        f"(share of the bar {worst:.3f})")
    return worst


def charge_path_bound(t: int, n: int, v: int, surface: bool = False):
    """The bound of the VAMPIRE charge path (feature kernel, then the
    charge kernel) on a (T, N) batch of V parameter sets: each command's
    two lines and mask read and two features written once, the charge
    kernel's eight planes and V parameter rows read and its output
    written once; 64 operations a line and 45 a command and set."""
    m = t * n
    out = t * v * (64 if surface else 1) * 4
    return bound(m * (64 + 64 + 4 + 8) + m * 8 * 4 + v * 123 * 4 + out,
                 m * 64 + m * v * 45)


def shape_rows(tag: str, batch, stacked, plain_v: int, card: str,
               flush) -> None:
    """The feature, VAMPIRE charge and surface kernels at a campaign or
    fleet shape: each against its plain version on the first ``plain_v``
    parameter sets (rtol 1e-5; the features bit-exact), timed beside its
    bound.  Not main-path launches: the counts are read around the
    phase's own runs, before this."""
    import torch

    from repro_torch.core.energy_model import structural_state
    from repro_torch.kernels.vampire_energy import ops as vops
    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    tr, w = batch.trace, batch.weight
    t, n = tr.cmd.shape
    v = stacked.i2n.shape[0]
    m = t * n
    st = structural_state(tr)
    fargs = (tr.data, tr.cmd, st.prev_rw)
    ones, togg = ve.batched_features(*fargs)
    p_ones, p_togg = ve.batched_features_plain(*fargs)
    check(torch.equal(ones, p_ones) and torch.equal(togg, p_togg),
          f"{tag}: features kernel differs from its plain version")
    params = vops.pack_param_blocks(stacked)
    args = [ones, togg, tr.cmd, tr.bank, tr.row, tr.dt, vops.pack_state(st),
            w.contiguous(), params]
    plain_args = args[:-1] + [params[:plain_v].contiguous()]
    masked = int((w[:, :1] == 0).sum())
    rows = [("batched_features", lambda: ve.batched_features(*fargs),
             lambda: ve.batched_features_plain(*fargs), 0.0,
             bound(m * FEATURE_LINE_BYTES, m * 64))]
    for fn, surface in ((ve.vampire_charge, False),
                        (ve.vampire_charge_surface, True)):
        got = fn(*args)[:, :plain_v]
        err = assert_close(got, ve.vampire_charge_plain(*plain_args,
                                                        surface=surface),
                           RTOL, f"{tag}: {fn.__name__}")
        out = t * v * (64 if surface else 1) * 4
        rows.append((fn.__name__, lambda fn=fn: fn(*args),
                     lambda s=surface: ve.vampire_charge_plain(
                         *plain_args, surface=s), err,
                     bound(m * 8 * 4 + v * 123 * 4 + out, m * v * 45)))
    for name, fn, plain, err, (b_ms, b_by) in rows:
        ms = event_ms(fn, 10, flush)
        plain_ms = event_ms(plain, 3, flush)
        print(f"[kernel] {name} ({tag}): ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"(plain on {plain_v} of {v} sets) bound_ms={b_ms:.4f} "
              f"({b_by}) share_of_bound={b_ms / ms:.3f} max_abs_err="
              f"{err:.3e} shape=(T={t}, N={n}, V={v}) "
              f"rows_with_masked_first_command={masked} card=\"{card}\"",
              flush=True)


def campaign_phase(card: str, device="cuda", specs=None,
                   **plan) -> dict[str, int]:
    """Phase 8: the paper's characterization campaign at full size, the
    50-module fleet (14 A, 13 B, 23 C) at the defaults (5 probe modules,
    256 reps, 24 rows), through the entry point a user calls with
    ``impl='cuda'``; the same fit through ``'vectorized'`` on the card;
    Table 5's and the surface's recovery; the quick fit against the
    committed one (the card's yardstick for the reference's fit); save and
    load.  ``specs`` and ``plan`` (``probe_modules``, ``probe_reps``,
    ``n_rows``) cut the campaign for a rehearsal.  Returns the launches of
    the ``'cuda'`` fit."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import (characterize, device_sim, fleet,
                                  idd_loops, model_api, params)
    modules = device_sim.make_fleet(specs or params.paper_fleet())
    plan_kw = {k: v for k, v in plan.items() if k != "probe_modules"}
    reset_counters()
    t0 = time.perf_counter()
    model = model_api.fit("vampire", modules, fitter="campaign",
                          impl="cuda", device=device, **plan)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launched = read_counters()
    check(launched["batched_features"] > 0 and
          launched["vampire_charge"] > 0,
          f"campaign: the feature and charge kernels were not both "
          f"launched ({launched})")
    t0 = time.perf_counter()
    model_api.fit("vampire", modules, impl="cuda", device=device, **plan)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vec = model_api.fit("vampire", modules, impl="vectorized", device=device,
                        **plan)
    torch.cuda.synchronize()
    vec_s = time.perf_counter() - t0

    # the measured currents (the raw campaign arrays) at rtol 1e-5, the
    # fitted leaves at the fit bar
    cur_err = 0.0
    for name, x in model.saved.arrays.items():
        if name.endswith(("/current",)) or "/idd_measured/" in name:
            cur_err = max(cur_err, assert_close(
                torch.from_numpy(x), torch.from_numpy(
                    vec.saved.arrays[name]), RTOL, f"campaign {name}"))
    share = 0.0
    for v in model.vendors:
        for leaf, a, b in zip(model.params(v)._fields, model.params(v),
                              vec.params(v)):
            share = max(share, fit_close(a.cpu(), b.cpu(),
                                         f"campaign vendor {v} {leaf}"))
    cplan = characterize.campaign_plan(**plan_kw)
    probe = cplan.batch_on("probe_batch", device)
    stacked = fleet.fleet_stacked(modules, device)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    t, n = probe.trace.cmd.shape
    kern = fleet.run_probes(modules, cplan.probe_points, batch=probe,
                            impl="cuda", noisy=False, device=device)
    plain = fleet.run_probes(modules, cplan.probe_points, batch=probe,
                             noisy=False, device=device)
    mat_err = assert_close(torch.from_numpy(kern), torch.from_numpy(plain),
                           RTOL, "campaign: every module x the probes")
    ms = event_ms(lambda: fleet.fleet_measure_current_cuda(
        probe.trace, probe.weight, stacked), 10, flush_buf.zero_)
    b_ms, b_by = charge_path_bound(t, n, len(modules))
    counts = [len(device_sim.vendor_modules(modules, v)) for v in range(3)]
    print(f"[campaign] fleet: modules={len(modules)} (A {counts[0]}, B "
          f"{counts[1]}, C {counts[2]}) plan={plan or 'defaults'} "
          f"idd_batch={tuple(cplan.idd_batch.weight.shape)} "
          f"probe_batch=(T={t}, N={n}) fit_s={fit_s:.3f} (plan and "
          f"batches built in it) warm_fit_s={warm_s:.3f} "
          f"vectorized_fit_s={vec_s:.3f} launches="
          f"{ {k: c for k, c in launched.items() if c} } card=\"{card}\"",
          flush=True)
    print(f"[campaign] cuda vs vectorized: currents max_abs_err="
          f"{cur_err:.3e} mA (rtol {RTOL}); fitted leaves within "
          f"{share:.3f} of the bar (rtol {FIT_RTOL}, atol {FIT_ATOL}); the "
          f"({len(modules)} x {t}) noise-free matrix max_abs_err="
          f"{mat_err:.3e} "
          f"measure_ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"share_of_bound={b_ms / ms:.3f} card=\"{card}\"", flush=True)
    shape_rows(f"campaign, {len(modules)} modules x {t} probes", probe,
               stacked, len(modules), card, flush_buf.zero_)

    # Table 5 and the structural surface, recovered beside the planted
    dd = model.saved.arrays["datadep"]
    for v in model.vendors:
        for mi, mode in enumerate(characterize.IL_MODES):
            got = dd[v, mi, 0]
            want = params.TABLE5[v, mi, 0]
            print(f"[campaign] table5 vendor={'ABC'[v]} mode={mode:7s} RD "
                  f"fitted=({got[0]:.2f}, {got[1]:.4f}, {got[2]:.4f}) "
                  f"planted=({want[0]:.2f}, {want[1]:.4f}, {want[2]:.4f})",
                  flush=True)
        surf = model.saved.arrays["act_surface"][v]
        planted = device_sim.structural_surface(v)
        print(f"[campaign] surface vendor={'ABC'[v]} max_abs_err="
              f"{np.abs(surf - planted).max():.4f} planted_range="
              f"({planted.min():.4f}, {planted.max():.4f})", flush=True)

    # the quick fit against the committed one, at the fit bar
    quick = model_api.fit("vampire", device_sim.make_fleet(
        [params.ModuleSpec(v, i, 2015) for v in range(3) for i in range(3)]),
        impl="cuda", device=device, **QUICK_FIT)
    share = 0.0
    with np.load(MODEL_FILE, allow_pickle=False) as z:
        names = sorted(set(z.files) - {model_api.MANIFEST_KEY})
        check(names == sorted(quick.saved.arrays),
              "quick fit: entry names differ from the committed file's")
        for name in names:
            share = max(share, fit_close(quick.saved.arrays[name], z[name],
                                         f"quick fit {name}"))
    print(f"[campaign] quick fit (3 x 3 modules, probe_modules=2, "
          f"probe_reps=64, n_rows=8) through cuda matches the committed "
          f"{MODEL_FILE.name}: {len(names)} arrays within {share:.3f} of "
          f"the bar", flush=True)

    # save and load the fresh fit: the same estimates
    trs = [idd_loops.validation_sweep(24), idd_loops.idd7(),
           idd_loops.idd3p()]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/fit.npz"
        model.save(path)
        loaded = model_api.load_estimator(path, device=device)
    for mode in ("mean", "surface"):
        a = model.estimate(trs, mode=mode, impl="cuda")
        b = loaded.estimate(trs, mode=mode, impl="cuda")
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"campaign: a saved and loaded fit estimates differently "
              f"({mode})")
    print(f"[campaign] save and load: {len(model.saved.arrays)} arrays, "
          f"the same {len(trs)}-trace estimates (mean, surface)", flush=True)
    del flush_buf
    return launched


FLEET_MODULES = (1_000, 10_000)
MODULE_CHUNK = 256


def fleet_phase(card: str, device="cuda", sizes=FLEET_MODULES,
                module_chunk: int = MODULE_CHUNK, **plan) -> dict[str, int]:
    """Phase 9: fleet scale at ``bench_fleetscale.py``'s sizes: a
    synthetic fleet of 10,000 modules, the chunked surface map
    (``module_chunk`` 256) over its two validation-sweep traces through
    ``'cuda'`` (bit for bit the one-shot map at 1,000 modules;
    ``'vectorized'`` on the first chunk), and every probe of the default
    campaign plan (``plan`` cuts it) on all 10,000 modules.  Returns the
    launches of the surface map and the probe run."""
    import torch

    from repro_torch.core import (characterize, device_sim, dram,
                                  estimate_batch as eb, fleet, idd_loops)
    t0 = time.perf_counter()
    _, stacked = device_sim.synth_fleet_params(sizes[-1],
                                               device=device)
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    trace, weight = dram.batch_traces(
        [(idd_loops.validation_sweep(8, reps=12), 2),
         (idd_loops.validation_sweep(16, reps=8), 2)])
    trace, weight = trace.to(device), weight.to(device)
    t, n = trace.cmd.shape
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def head(k):
        return stacked.select(list(range(k)))

    # exactness first: chunked == one-shot at 1,000; cuda == vectorized
    one = fleet.fleet_surface_energy(head(sizes[0]), trace, weight,
                                     impl="cuda")
    chunked = fleet.fleet_surface_energy(head(sizes[0]), trace,
                                         weight, impl="cuda",
                                         module_chunk=module_chunk)
    check(all(torch.equal(a, b) for a, b in zip(one, chunked)),
          f"fleet: the chunked surface differs from the one-shot one at "
          f"{sizes[0]} modules")
    vec = eb.batched_surface_reports(trace, weight, head(module_chunk))
    surf_err = assert_close(one.energy_pj[:, :module_chunk], vec.energy_pj,
                            RTOL, "fleet: surface cuda vs vectorized")

    reset_counters()
    n_mod = sizes[-1]

    def surface_map():
        return fleet.fleet_surface_energy(stacked, trace, weight,
                                          impl="cuda",
                                          module_chunk=module_chunk)
    rep = surface_map()
    torch.cuda.synchronize()
    launched = read_counters()
    check(launched["vampire_charge_surface"] > 0,
          f"fleet: the surface kernel was not launched ({launched})")
    check(tuple(rep.energy_pj.shape) == (t, n_mod, 8, 8)
          and bool(torch.isfinite(rep.energy_pj).all())
          and bool((rep.energy_pj.sum(dim=(-2, -1)) > 0).all()),
          f"fleet: the {n_mod}-module surface map is not finite and "
          f"positive")
    assert_close(rep.energy_pj[:, :sizes[0]], one.energy_pj, 0.0,
                 f"fleet: the first {sizes[0]} modules of the {n_mod} map")
    wall = wall_ms(surface_map, 3)
    ev = event_ms(surface_map, 3, flush_buf.zero_)
    b_ms, b_by = bound(t * n * 8 * 4 + n_mod * 123 * 4 + t * n_mod * 64 * 4
                       + t * 64 * 4, t * n * n_mod * 45)
    print(f"[fleet] surface map: modules={n_mod} traces={t} commands={n} "
          f"module_chunk={module_chunk} synth_s={synth_s:.3f} "
          f"wall_ms={wall:.3f} modules_per_s={n_mod / wall * 1e3:.0f} "
          f"event_ms={ev:.4f} bound_ms={b_ms:.4f} ({b_by}) chunked_equals_"
          f"one_shot_at_{sizes[0]}=True cuda_vs_vectorized_max_abs_err="
          f"{surf_err:.3e} pJ ({module_chunk} modules) launches="
          f"{ {k: c for k, c in launched.items() if c} } card=\"{card}\"",
          flush=True)

    # every campaign probe on every module, noise-free
    cplan = characterize.campaign_plan(**plan)
    probe = cplan.batch_on("probe_batch", device)
    pt, pn = probe.trace.cmd.shape
    reset_counters()

    def probe_all():
        return fleet.run_probes(stacked, cplan.probe_points, batch=probe,
                                noisy=False, impl="cuda", device=device)
    mat = probe_all()
    launched_probe = read_counters()
    check(launched_probe["batched_features"] > 0
          and launched_probe["vampire_charge"] > 0,
          f"fleet: the feature and charge kernels were not both launched "
          f"({launched_probe})")
    check(mat.shape == (n_mod, pt) and bool((mat > 0).all()),
          f"fleet: the probe matrix has shape {mat.shape} or a current "
          f"that is not positive")
    plain = fleet.run_probes(head(module_chunk), cplan.probe_points,
                             batch=probe, noisy=False, device=device)
    probe_err = assert_close(torch.from_numpy(mat[:module_chunk]),
                             torch.from_numpy(plain), RTOL,
                             "fleet: probe matrix cuda vs vectorized")
    wall = wall_ms(probe_all, 3)
    ev = event_ms(lambda: fleet.fleet_measure_current_cuda(
        probe.trace, probe.weight, stacked), 3, flush_buf.zero_)
    b_ms, b_by = charge_path_bound(pt, pn, n_mod)
    print(f"[fleet] probes: modules={n_mod} probes={pt} commands={pn} "
          f"matrix={mat.shape} ({mat.shape[0] * mat.shape[1] * 4} bytes "
          f"float32) wall_ms={wall:.3f} modules_per_s="
          f"{n_mod / wall * 1e3:.0f} measure_event_ms={ev:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ev:.3f} "
          f"cuda_vs_vectorized_max_abs_err={probe_err:.3e} mA "
          f"({module_chunk} modules) launches="
          f"{ {k: c for k, c in launched_probe.items() if c} } "
          f"card=\"{card}\"", flush=True)
    for name, c in launched_probe.items():
        launched[name] += c
    shape_rows(f"fleet surface, {module_chunk}-module chunk",
               fleet.ProbeBatch(trace, weight, None), head(module_chunk),
               module_chunk, card, flush_buf.zero_)
    shape_rows(f"fleet probes, {n_mod} modules", probe, stacked,
               min(64, n_mod), card, flush_buf.zero_)
    del flush_buf
    return launched


#: the [mesh] phase's (data, model) meshes by world size: processes
#: sharing card 0
MESH_WORLDS = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
#: the [mesh] phase's service windows besides the whole workload's: the
#: first 8 and 16 traces, whose boxes on the meshes hold 2-8 rows
MESH_WINDOWS = (8, 16)
#: the kernels each [mesh] call must launch in every rank (impl='cuda')
MESH_KERNELS = {"surface": ("batched_features", "vampire_charge_surface"),
                "probes": ("batched_features", "vampire_charge"),
                "service": ("batched_features", "vampire_charge"),
                **{f"window {w}": ("batched_features", "vampire_charge")
                   for w in MESH_WINDOWS}}
#: the [mesh] calls timed against one process
MESH_TIMED = ("surface", "probes", "service")
#: the [mesh] phase's impls and their fleets: 'vectorized' loops over the
#: modules in Python, so it takes the [fleet] phase's smaller fleet
MESH_IMPLS = {"cuda": "stacked", "vectorized": "stacked_vec"}


def mesh_calls(inp: dict, model, mesh, impl: str = "cuda"):
    """The [mesh] phase's calls on ``inp`` (the fleet, its surface
    traces, the probe batch, the estimation traces), through the entry
    points a user calls with ``impl``: the surface, the probe matrix, a
    service over every trace and one over each of ``MESH_WINDOWS``'
    first traces; ``mesh`` None: one process.  Returns the calls and
    each service by its call's name."""
    from repro_torch.core import fleet
    from repro_torch.serving import EstimationService, ServiceConfig
    stacked = inp[MESH_IMPLS[impl]]
    services = {}

    def service(name, trs):
        svc = services[name] = EstimationService(
            model, ServiceConfig(lint=False, impl=impl), mesh=mesh)

        def run():
            tickets, _ = svc.submit_many(trs)
            svc.drain()
            return [svc.result(t) for t in tickets]
        return run
    return {
        "surface": lambda: fleet.fleet_surface_energy(
            stacked, inp["trace"], inp["weight"], impl=impl, mesh=mesh),
        "probes": lambda: fleet.run_probes(
            stacked, (), batch=inp["probe"], noisy=False, impl=impl,
            mesh=mesh),
        "service": service("service", inp["trs"]),
        **{f"window {w}": service(f"window {w}", inp["trs"][:w])
           for w in MESH_WINDOWS}}, services


def same(a, b) -> bool:
    """Bit-equal reports, report lists or arrays."""
    import numpy as np
    import torch
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool(np.array_equal(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))
    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


def mesh_child(rank: int, world: int, shapes, store: str, work: str,
               device: str = "cuda") -> None:
    """One rank of ``[mesh]``, spawned: every rank shares card 0 on the
    ``gloo`` backend, on a ``cuda`` mesh.  It loads the kernels phase 2
    built, runs :func:`mesh_calls` of each impl on each of ``shapes``,
    holds each result against the one process's, bit for bit, and writes
    what it computed, launched and took (``impl='cuda'``) to
    ``work/rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core import fleet, model_api
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    inp = torch.load(f"{work}/inputs.pt", weights_only=False)
    one = torch.load(f"{work}/one.pt", weights_only=False)
    inp = {k: v if k == "trs" else v.to(device) for k, v in inp.items()}
    model = model_api.load_estimator(str(MODEL_FILE), device=device)
    out = {}
    for shape in shapes:
        mesh = make_local_mesh(*shape, device=device)
        rec = {}
        for impl in MESH_IMPLS:
            calls, services = mesh_calls(inp, model, mesh, impl)
            for name, fn in calls.items():
                reset_counters()
                got = fn()
                if cuda:
                    torch.cuda.synchronize()
                rec[f"{name} {impl}"] = {
                    "equal": same(got, one[f"{name} {impl}"]),
                    "launches": {k: c for k, c in read_counters().items()
                                 if c},
                    "box": list(services[name].engine.last_rows)
                    if name in services else list(fleet.LAST_BOX or ())}
                fleet.LAST_BOX = None
        calls, _ = mesh_calls(inp, model, mesh)
        for name in MESH_TIMED:
            fn = calls[name]
            times = []
            for _ in range(3):
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                if cuda:
                    torch.cuda.synchronize()
                dist.barrier()
                times.append((time.perf_counter() - t0) * 1e3)
            rec[f"{name} cuda"]["wall_ms"] = sorted(times)[1]
        out[f"{shape[0]}x{shape[1]}"] = rec
    with open(f"{work}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def mesh_phase(card: str, seed: int, device="cuda",
               n_modules: int = FLEET_MODULES[-1], n_traces: int = 64,
               n_requests: int = 6000, length: int = 16384,
               **plan) -> dict[str, int]:
    """Phase 9b, ``[mesh]``: the estimation side of ``mesh=`` at full
    size, on (1, 2), (2, 1) and (2, 2) meshes of processes that share
    card 0 (``gloo``; the script needs only one card and NCCL refuses two
    ranks on one device).  The ``[fleet]`` phase's synthetic fleet of
    10,000 modules: its surface over the two validation sweeps and the
    ``[campaign]`` probe matrix (348 probes); the estimation service over
    the ``[e2e]`` workload's 64 traces, and over its first 8 and 16 (boxes
    of 2-8 rows, whose row sums a card's reduce kernel would split by the
    row count without the window's ``config``); all ``impl='cuda'``, then
    the same through ``impl='vectorized'`` on the [fleet] phase's
    1,000-module fleet.  Each rank's result must equal the one process's
    bit for bit, and under ``'cuda'`` each rank must launch the feature
    and charge kernels on its own box.  Wall times are of
    processes sharing one card, not of a multi-GPU mesh.  Returns the
    launches of every rank's first ``'cuda'`` call of each."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from repro_torch.core import characterize, device_sim, dram, idd_loops
    from repro_torch.core import model_api
    n_dev = torch.cuda.device_count()
    print(f"[mesh] device_count={n_dev}: the meshes are processes sharing "
          f"card 0 on the gloo backend (cuda meshes), not cards",
          flush=True)
    _, stacked = device_sim.synth_fleet_params(n_modules, device=device)
    _, stacked_vec = device_sim.synth_fleet_params(FLEET_MODULES[0],
                                                   device=device)
    trace, weight = dram.batch_traces(
        [(idd_loops.validation_sweep(8, reps=12), 2),
         (idd_loops.validation_sweep(16, reps=8), 2)])
    probe = characterize.campaign_plan(**plan).batch_on("probe_batch",
                                                        device)
    trs, _ = build_workload(seed, n_traces, n_requests, length, "cpu")
    inp = {"stacked": stacked, "stacked_vec": stacked_vec,
           "trace": trace.to(device), "weight": weight.to(device),
           "probe": probe, "trs": trs}
    model = model_api.load_estimator(str(MODEL_FILE), device=device)
    one = {}
    for impl in MESH_IMPLS:
        calls, _ = mesh_calls(inp, model, None, impl)
        one.update({f"{name} {impl}": fn() for name, fn in calls.items()})
    calls, _ = mesh_calls(inp, model, None)
    one_ms = {name: wall_ms(calls[name], 3) for name in MESH_TIMED}
    launched = dict.fromkeys(read_counters(), 0)
    with tempfile.TemporaryDirectory() as work:
        torch.save({k: v if k == "trs" else v.to("cpu")
                    for k, v in inp.items()}, f"{work}/inputs.pt")
        torch.save({k: v if isinstance(v, np.ndarray) else
                    v.to("cpu") if hasattr(v, "to") else
                    [r.to("cpu") for r in v] for k, v in one.items()},
                   f"{work}/one.pt")
        del one, calls
        torch.cuda.empty_cache()
        for world, shapes in MESH_WORLDS.items():
            t0 = time.perf_counter()
            mp.spawn(mesh_child, args=(world, shapes, f"{work}/store{world}",
                                       work, device), nprocs=world)
            spawn_s = time.perf_counter() - t0
            ranks = []
            for r in range(world):
                with open(f"{work}/rank{r}.json") as f:
                    ranks.append(json.load(f))
            for shape in shapes:
                tag = f"{shape[0]}x{shape[1]}"
                for name, impl in ((n, i) for i in MESH_IMPLS
                                   for n in MESH_KERNELS):
                    call = f"{name} {impl}"
                    for r, res in enumerate(ranks):
                        got = res[tag][call]
                        what = ("shape" if name in ("surface", "probes")
                                else "rows")
                        print(f"[mesh] {tag} rank {r} {call}: "
                              f"bit_equal_to_one_process={got['equal']} "
                              f"its box {what}={got['box']} "
                              f"launches={got['launches']}", flush=True)
                        check(got["equal"], f"mesh {tag}: rank {r}'s "
                                            f"{call} differs from one "
                                            f"process's")
                        if impl != "cuda":
                            continue
                        for k in MESH_KERNELS[name]:
                            check(got["launches"].get(k, 0) > 0,
                                  f"mesh {tag}: rank {r} launched no {k} "
                                  f"in {name}")
                        for k, c in got["launches"].items():
                            launched[k] += c
                    if impl != "cuda" or name not in MESH_TIMED:
                        continue
                    print(f"[mesh] {tag} {name}: wall_ms="
                          f"{ranks[0][tag][call]['wall_ms']:.3f} with "
                          f"{world} processes sharing one card (not a "
                          f"multi-GPU time) against one process "
                          f"{one_ms[name]:.3f} card=\"{card}\"",
                          flush=True)
            print(f"[mesh] world {world}: spawn and run {spawn_s:.1f} s",
                  flush=True)
    return launched


PAPER_MAPE = {"vampire": 6.8, "drampower": 32.4, "micron": 160.6}
CHARGE_WRAPPERS = ("batched_features", "vampire_charge",
                   "vampire_charge_surface", "micron_charge",
                   "micron_charge_surface", "drampower_charge",
                   "drampower_charge_surface")


def validation_kernel_rows(tag: str, tb, models, card: str, flush) -> None:
    """The six charge kernels on a batch of another shape: each against
    its plain version (rtol 1e-5), timed beside its bound.  Not main-path
    launches."""
    from repro_torch.kernels.vampire_energy import ops as vops
    t, n = tb.trace.cmd.shape
    v = len(models["vampire"].vendors)
    for r in charge_rows(tb, models):
        err = assert_close(r["fn"](), r["plain"](), RTOL,
                           f"{tag}: {r['name']}")
        b_ms, b_by = bound(r["nbytes"], r["nops"])
        ms = event_ms(r["fn"], 10, flush)
        plain_ms = event_ms(r["plain"], 3, flush)
        print(f"[kernel] {r['name']} ({tag}): ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.3f} max_abs_err={err:.3e} "
              f"shape=(T={t}, N={n}, V={v}) card=\"{card}\"", flush=True)


def validation_rows(res, names) -> "np.ndarray":
    """(modules x sweeps, 1 + estimators) array of a ValidationResult:
    the measured current, then each estimator's, row by row."""
    import numpy as np
    return np.asarray([[row["measured"]] + [row[k] for k in names]
                       for row in res.raw.values()], np.float64)


def validation_phase(card: str, device="cuda", specs=None, n_values=None,
                     **plan):
    """Phase 10, ``[validation]``: paper Section 9.1, Fig 14 and Figs
    19-22 on the port's own fit of the 50-module paper fleet (the
    campaign's defaults through ``impl='cuda'``; ``specs`` and ``plan``
    cut it for a rehearsal).  ``run_validation`` holds out the paper's 22
    modules (8 A, 7 B, 7 C) and scores the 23 sweeps of ``N_READS`` with
    all three estimators through ``'cuda'``, against ``'vectorized'``
    (every measured and predicted current at rtol 1e-5); the MAPEs beside
    the paper's; the Fig 14 table; the structural surface maps of the three
    kinds through both impls.  Returns (the launches of the ``'cuda'``
    validation and maps, the fitted model)."""
    import numpy as np
    import torch

    from repro_torch.core import (device_sim, estimate_batch as eb,
                                  fleet, idd_loops, model_api, params,
                                  validate)
    modules = device_sim.make_fleet(specs or params.paper_fleet())
    model = model_api.fit("vampire", modules, impl="cuda", device=device,
                          **plan)
    n_values = validate.N_READS if n_values is None else n_values
    models = {kind: model_api.make_estimator(kind, model) for kind in KINDS}
    names = list(validate.default_estimators(model))

    reset_counters()
    t0 = time.perf_counter()
    res = validate.run_validation(model, fleet=modules, n_values=n_values,
                                  impl="cuda")
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    maps = {kind: validate.structural_surface_maps(models[kind],
                                                   impl="cuda")
            for kind in KINDS}
    torch.cuda.synchronize()
    maps_s = time.perf_counter() - t0
    launched = read_counters()
    missing = [k for k in CHARGE_WRAPPERS if not launched[k]]
    check(not missing, f"validation: kernels not launched: {missing}")

    t0 = time.perf_counter()
    vec = validate.run_validation(model, fleet=modules, n_values=n_values,
                                  impl="vectorized")
    vec_s = time.perf_counter() - t0
    check(list(vec.raw) == list(res.raw),
          "validation: the two impls scored different (module, sweep) sets")
    grid = validation_rows(res, names)
    err = assert_close(torch.from_numpy(grid),
                       torch.from_numpy(validation_rows(vec, names)), RTOL,
                       "validation: cuda vs vectorized currents")
    held_out = validate.select_validation_modules(modules)
    counts = [sum(m.spec.vendor == v for m in held_out) for v in range(3)]
    print(f"[validation] fleet={len(modules)} held_out={len(held_out)} "
          f"(A {counts[0]}, B {counts[1]}, C {counts[2]}) sweeps="
          f"{len(n_values)} measured=({len(held_out)} x {len(n_values)}) "
          f"grids=({len(n_values)} x {len(model.vendors)}) x {len(names)} "
          f"run_validation_s={val_s:.3f} (cuda) vectorized_s={vec_s:.3f} "
          f"surface_maps_s={maps_s:.3f} cuda_vs_vectorized_max_abs_err="
          f"{err:.3e} mA (rtol {RTOL}) launches="
          f"{ {k: c for k, c in launched.items() if c} } card=\"{card}\"",
          flush=True)
    for name in names:
        per_v = res.mape[name]
        print(f"[validation] mape {name:9s} A={per_v.get(0, float('nan')):.2f}"
              f"% B={per_v.get(1, float('nan')):.2f}% "
              f"C={per_v.get(2, float('nan')):.2f}% mean="
              f"{res.mape_mean[name]:.2f}% paper={PAPER_MAPE[name]}%",
              flush=True)
    m = res.mape_mean
    check(m["vampire"] < m["drampower"] < m["micron"],
          f"validation: the paper's ordering VAMPIRE < DRAMPower < Micron "
          f"does not hold ({m})")
    for line in validate.render_fig14_table(
            validate.measured_over_datasheet(model)).splitlines():
        print(f"[validation] fig14 {line}", flush=True)

    for kind in KINDS:
        vmap = validate.structural_surface_maps(models[kind])
        err = assert_close(torch.from_numpy(maps[kind]),
                           torch.from_numpy(vmap), RTOL,
                           f"validation: {kind} surface map cuda vs "
                           f"vectorized")
        check(bool(np.allclose(maps[kind].sum(axis=(1, 2)), 1.0,
                               rtol=1e-9)),
              f"validation: a {kind} surface map does not sum to 1")
        if kind != "vampire":
            assert_close(torch.from_numpy(maps[kind]),
                         torch.full(maps[kind].shape, 1 / 64,
                                    dtype=torch.float64), RTOL,
                         f"validation: the {kind} map is not flat")
        rel = maps[kind] * 64
        print(f"[validation] surface {kind:9s} cell/mean min="
              f"{rel.min():.4f} max={rel.max():.4f} sums_to_1=True "
              f"cuda_vs_vectorized_max_abs_err={err:.3e}", flush=True)

    # the kernels at the validation shapes: the sweep batch at the
    # model's V = 3, and the held-out modules' true params on the vendor
    # axis (V = 22), as run_probes hands them over
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    sweeps = [idd_loops.validation_sweep(n) for n in n_values]
    tb = eb.TraceBatch.from_traces(sweeps).to(device)
    validation_kernel_rows(f"validation, {len(sweeps)} sweeps", tb, models,
                           card, flush_buf.zero_)
    shape_rows(f"validation probes, {len(held_out)} modules", tb,
               fleet.fleet_stacked(held_out, device), len(held_out), card,
               flush_buf.zero_)
    del flush_buf
    return launched, model


class TimedEstimates:
    """A model whose ``estimate`` calls are timed (host clock to a device
    synchronize), for the studies' host/estimate split."""

    def __init__(self, model):
        self.model = model
        self.seconds = 0.0

    def params(self, vendor):
        return self.model.params(vendor)

    def estimate(self, *args, **kw):
        import torch
        t0 = time.perf_counter()
        rep = self.model.estimate(*args, **kw)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return rep


POLICIES = ("aggressive", "breakeven", "lazy")


def apps_phase(model, card: str, n_requests: int = 2000) -> dict[str, int]:
    """Phase 11, ``[apps]``: the paper's Section 9.3 applications on all
    23 ``SPEC_APPS`` at ``app_trace``'s default of 2000 requests, as
    ``bench_applications.py`` runs them: variation-aware page allocation
    on vendor C and power-down scheduling on vendor A, both through
    ``impl='cuda'`` against ``'vectorized'`` (rtol 1e-5); every power-down
    rewrite lints clean, and a remap keeps the command stream and the
    data.
    Returns the launches of the ``'cuda'`` studies."""
    import numpy as np
    import torch

    from repro_torch.analysis import trace_lint
    from repro_torch.core import applications as A
    from repro_torch.core import traces
    apps = traces.SPEC_APPS
    timed = TimedEstimates(model)
    reset_counters()
    t0 = time.perf_counter()
    page = [A.page_allocation_study(timed, app, 2, n_requests=n_requests,
                                    impl="cuda") for app in apps]
    power = [A.powerdown_study(timed, app, 0, n_requests=n_requests,
                               impl="cuda") for app in apps]
    total_s = time.perf_counter() - t0
    launched = read_counters()
    check(launched["batched_features"] > 0 and launched["vampire_charge"] > 0,
          f"apps: the feature and charge kernels were not both launched "
          f"({launched})")
    t0 = time.perf_counter()
    vpage = [A.page_allocation_study(model, app, 2, n_requests=n_requests)
             for app in apps]
    vpower = [A.powerdown_study(model, app, 0, n_requests=n_requests)
              for app in apps]
    vec_s = time.perf_counter() - t0

    def energies(page_rows, power_rows):
        keys = ("baseline_pj", *(f"{p}_pj" for p in POLICIES))
        return torch.tensor(
            [r[k] for r in page_rows for k in ("baseline_pj", "remapped_pj")]
            + [r[k] for r in power_rows for k in keys], dtype=torch.float64)
    err = assert_close(energies(page, power), energies(vpage, vpower), RTOL,
                       "apps: cuda vs vectorized energies")

    # the traces, rebuilt: every power-down rewrite lints clean; a remap
    # keeps the command stream and the data (it is a pure address map,
    # which may land two hot pages in one bank: its lint errors are
    # counted, not checked, as in the reference)
    rewritten, remaps = [], []
    for app, pw in zip(apps, power):
        tr = traces.app_trace(app, n_requests=n_requests)
        remapped = A.remap_trace(tr, model.params(2))
        check(torch.equal(tr.cmd, remapped.cmd)
              and torch.equal(tr.data, remapped.data)
              and torch.equal(tr.dt, remapped.dt),
              f"apps: the remap of {app.name} changed commands or data")
        be = pw["breakeven_cycles"]
        remaps.append(remapped)
        rewritten += [A.apply_powerdown_policy(tr, t) for t in
                      (max(int(be * 0.25), 8), max(int(be), 8),
                       max(int(be * 8), 8))]
    errors = trace_lint.errors_of(trace_lint.lint_traces(rewritten))
    check(not errors, f"apps: {len(errors)} lint errors in the power-down "
                      f"rewrites, first {errors[:1]}")
    remap_errors = trace_lint.errors_of(trace_lint.lint_traces(remaps))
    print(f"[apps] apps={len(apps)} n_requests={n_requests} "
          f"page_allocation=vendor C powerdown=vendor A total_s="
          f"{total_s:.3f} (cuda) host_s={total_s - timed.seconds:.3f} "
          f"estimate_s={timed.seconds:.3f} estimate_calls={2 * len(apps)} "
          f"vectorized_total_s={vec_s:.3f} cuda_vs_vectorized_max_abs_err="
          f"{err:.3e} pJ (rtol {RTOL}) powerdown_rewrites={len(rewritten)} "
          f"lint_errors=0 remaps={len(remaps)} (commands and data kept; "
          f"remap_lint_errors={len(remap_errors)}) launches="
          f"{ {k: c for k, c in launched.items() if c} } card=\"{card}\"",
          flush=True)
    saving = np.mean([r["saving_frac"] for r in page])
    print(f"[apps] page allocation (vendor C): mean_saving={saving:.4f} "
          f"min={min(r['saving_frac'] for r in page):.4f} "
          f"max={max(r['saving_frac'] for r in page):.4f}", flush=True)
    for p in POLICIES:
        modes = {k: sum(r[f"{p}_modes"][k] for r in power)
                 for k in ("fast", "slow", "sr")}
        print(f"[apps] powerdown (vendor A) {p}: mean_saving="
              f"{np.mean([r[f'{p}_saving'] for r in power]):.4f} "
              f"windows fast={modes['fast']} slow={modes['slow']} "
              f"sr={modes['sr']}", flush=True)
    return launched


RECAL_CONFIG = dict(probe_reps=256, n_rows=24, probe_modules=5, decay=0.7,
                    slice_size=120)
RECAL_DRIFT = dict(temp_amp=0.01, temp_period=64.0, aging_rate=8e-3,
                   act_aging_rate=5e-3, noise_sigma=1e-3)  # bench_recalibrate
RECAL_CHECKPOINTS = (30, 60, 90, 120)


def recal_phase(card: str, device="cuda", specs=None,
                checkpoints=RECAL_CHECKPOINTS, **config) -> dict[str, int]:
    """Phase 12, ``[recal]``: online recalibration on the 50-module paper
    fleet, ``RecalConfig(probe_reps=256, n_rows=24, probe_modules=5,
    decay=0.7, slice_size=120)`` (the campaign's own 360 cells), under
    ``bench_recalibrate.py``'s drift: 120 ticks through ``impl='cuda'``,
    refitting on every trigger, the frozen and recalibrated errors at the
    checkpoints against the drifted truth, a fresh campaign fit of the
    drifted fleet as the oracle; telemetry through ``'cuda'`` against
    ``'vectorized'``; then the estimation service hot-swapping a refit
    over a planted step.  ``specs``, ``checkpoints`` and ``config`` cut it
    for a rehearsal.  Returns the launches of the tick loop."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.core import (device_sim, idd_loops, model_api, params,
                                  recalibrate)
    from repro_torch.kernels import build
    from repro_torch.serving import EstimationService, ServiceConfig
    modules = device_sim.make_fleet(specs or params.paper_fleet())
    specs = [m.spec for m in modules]
    cfg = recalibrate.RecalConfig(**{**RECAL_CONFIG, **config})
    drift = device_sim.DriftProcess(**RECAL_DRIFT)
    t0 = time.perf_counter()
    fitter = model_api.fit("vampire", modules, fitter="streaming",
                           config=cfg, impl="cuda", device=device)
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    frozen = fitter.model
    src = recalibrate.TelemetrySource(modules, cfg, drift=drift, impl="cuda",
                                      device=device)
    vec_src = recalibrate.TelemetrySource(modules, cfg, drift=drift,
                                          device=device)
    tel_err = 0.0
    for tick in (1, checkpoints[-1] // 2):
        (a, ia), (b, ib) = src.measure(tick), vec_src.measure(tick)
        check(list(ia) == list(ib), "recal: the two sources sliced apart")
        tel_err = max(tel_err, assert_close(
            torch.from_numpy(a), torch.from_numpy(b), RTOL,
            f"recal: telemetry at tick {tick}, cuda vs vectorized"))

    tb = src.batch
    measure_ms, observe_ms, refit_ms = [], [], []
    frozen_err, recal_err = [], []
    peak = 0.0
    reset_counters()
    for tick in range(1, checkpoints[-1] + 1):
        t0 = time.perf_counter()
        cur, idx = src.measure(tick)
        t1 = time.perf_counter()
        report = fitter.observe(cur, idx, tick)
        t2 = time.perf_counter()
        measure_ms.append((t1 - t0) * 1e3)
        observe_ms.append((t2 - t1) * 1e3)
        peak = max(peak, report.score)
        if report.triggered:
            fitter.refit()
            torch.cuda.synchronize()
            refit_ms.append((time.perf_counter() - t2) * 1e3)
        if tick in checkpoints:
            truth = src.true_params_at(tick)
            frozen_err.append(recalibrate.fleet_current_mape(
                frozen, tb.trace, tb.weight, specs, truth, impl="cuda"))
            recal_err.append(recalibrate.fleet_current_mape(
                fitter.model, tb.trace, tb.weight, specs, truth,
                impl="cuda"))
    torch.cuda.synchronize()
    launched = read_counters()
    check(launched["batched_features"] > 0 and launched["vampire_charge"] > 0,
          f"recal: the feature and charge kernels were not both launched "
          f"({launched})")
    check(all(b > a for a, b in zip(frozen_err, frozen_err[1:])),
          f"recal: the frozen error does not rise at every checkpoint "
          f"({frozen_err})")
    check(recal_err[-1] < frozen_err[-1],
          f"recal: the recalibrated error {recal_err[-1]} is not below the "
          f"frozen {frozen_err[-1]} at tick {checkpoints[-1]}")

    truth = src.true_params_at(checkpoints[-1])
    drifted = [device_sim.SimulatedModule(s, truth.select(i).to("cpu"))
               for i, s in enumerate(specs)]
    t0 = time.perf_counter()
    oracle = model_api.fit("vampire", drifted, impl="cuda", device=device,
                           probe_modules=cfg.probe_modules,
                           probe_reps=cfg.probe_reps, n_rows=cfg.n_rows)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    oracle_err = recalibrate.fleet_current_mape(
        oracle, tb.trace, tb.weight, specs, truth, impl="cuda")
    print(f"[recal] fleet={len(modules)} cells={src.n_cells} (IDD "
          f"{len(src.plan.idd_points)} + probes {len(src.plan.probe_points)})"
          f" slice={min(cfg.slice_size, src.n_cells)} decay={cfg.decay} "
          f"ticks={checkpoints[-1]} prime_s={prime_s:.3f} "
          f"telemetry_cuda_vs_vectorized_max_abs_err={tel_err:.3e} mA "
          f"(rtol {RTOL}) launches="
          f"{ {k: c for k, c in launched.items() if c} } card=\"{card}\"",
          flush=True)
    print(f"[recal] checkpoints={list(checkpoints)} frozen_mape="
          f"{[round(e, 6) for e in frozen_err]} recalibrated_mape="
          f"{[round(e, 6) for e in recal_err]} oracle_mape={oracle_err:.6f}",
          flush=True)
    print(f"[recal] frozen/recalibrated={frozen_err[-1] / recal_err[-1]:.3f}"
          f" (reference test asks >= 5) recalibrated/oracle="
          f"{recal_err[-1] / oracle_err:.3f} (reference test asks <= 2)",
          flush=True)
    print(f"[recal] timings: measure_ms_median="
          f"{statistics.median(measure_ms):.3f} observe_ms_median="
          f"{statistics.median(observe_ms):.3f} refit_ms_median="
          f"{statistics.median(refit_ms) if refit_ms else 0.0:.3f} "
          f"triggers={len(refit_ms)} peak_score={peak:.3f} "
          f"campaign_refit_s={oracle_s:.3f} card=\"{card}\"", flush=True)

    # the kernels at the tick loop's shapes: a telemetry slice of 120
    # probe cells and the 12 IDD cells on the drifted fleet (V = 50)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    probes = src.plan.batch_on("probe_batch", device)
    width = min(cfg.slice_size, probes.weight.shape[0])
    shape_rows(f"recal slice, {width} probe cells", probes.select(
        list(range(width))), truth, len(specs), card, flush_buf.zero_)
    shape_rows(f"recal IDD cells, {len(src.plan.idd_points)}",
               src.plan.batch_on("idd_batch", device), truth, len(specs),
               card, flush_buf.zero_)
    del flush_buf

    # fit-while-serving: a planted step, full-coverage slices
    full = dataclasses.replace(cfg, slice_size=10_000)
    step = dataclasses.replace(device_sim.NO_DRIFT, step_tick=1,
                               step_frac=0.2)
    svc_fitter = recalibrate.StreamingFitter(frozen, specs, full,
                                             impl="cuda")
    svc = EstimationService(frozen, ServiceConfig(lint=False, impl="cuda"),
                            fitter=svc_fitter)
    step_src = recalibrate.TelemetrySource(modules, full, drift=step,
                                           impl="cuda", device=device)
    trs = [idd_loops.idd0(reps=2), idd_loops.idd4r(reps=2),
           idd_loops.validation_sweep(24)]
    tickets, _ = svc.submit_many(trs)
    svc.drain()
    programs = svc.engine.cache_size()
    buckets = set(svc.ring._buffers)
    libs = dict(build._LIBS)
    before = torch.stack([svc.result(t).energy_pj for t in tickets])
    report = svc.observe_telemetry(*step_src.measure(1), tick=1)
    tickets, _ = svc.submit_many(trs)
    svc.drain()
    after = torch.stack([svc.result(t).energy_pj for t in tickets])
    m = svc.metrics()
    check(report.triggered and m.recalibrations == 1,
          f"recal: the planted step did not trigger one refit ({report})")
    check(m.engine_programs == programs and set(svc.ring._buffers) == buckets
          and dict(build._LIBS) == libs
          and all(build._LIBS[k] is v for k, v in libs.items()),
          "recal: the hot swap added a batch shape, a ring bucket or a "
          "kernel build")
    check(not torch.equal(before, after),
          "recal: the refit did not change the service's answers")
    direct = svc_fitter.model.estimate(trs, impl="cuda").energy_pj
    swap_err = assert_close(after.cpu(), direct.cpu(), RTOL,
                            "recal: the service after the refit vs the "
                            "refreshed model")
    print(f"[recal] service: drift_score={m.drift_score:.3f} "
          f"recalibrations={m.recalibrations} engine_programs="
          f"{m.engine_programs} (unchanged) ring_buckets={len(buckets)} "
          f"(unchanged) kernel_libraries={len(libs)} (none rebuilt) "
          f"answers_changed=True max_rel_change="
          f"{float(((after - before).abs() / before.abs()).max()):.4f} "
          f"service_vs_model_max_abs_err={swap_err:.3e} pJ", flush=True)
    return launched


def analysis_phase(tb, model, card: str, device="cuda") -> None:
    """The port's analysis gate on the card: ``python -m
    repro_torch.analysis --device cuda`` in process (the 51-trace corpus
    lint, the dispatch audit of a quick fit with the serving, fleet and
    recalibration probes, the repo lint), then the dispatch audit of
    ``model`` over the estimation batch ``tb``: 3 kinds x 3 impls x 4
    modes, the sync debug mode "error" on for ``'vectorized'`` and
    ``'cuda'``.  Every pass must report 0 errors."""
    import contextlib
    import io

    from repro_torch.analysis import __main__ as gate
    from repro_torch.analysis import dispatch_audit as da
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = gate.main(["--device", device])
    for line in out.getvalue().splitlines():
        print(f"[analysis] {line}", flush=True)
    check(rc == 0, f"python -m repro_torch.analysis exited {rc}")
    t1 = time.perf_counter()
    print(f"[analysis] gate: rc={rc} wall_s={t1 - t0:.3f}", flush=True)
    for impls in (("vectorized", "cuda"), ("reference",)):
        t = time.perf_counter()
        findings = da.audit_all(model, tb=tb, device=device, impls=impls,
                                recompile=False)
        for f in findings:
            print(f"[analysis] {f}", flush=True)
        errs = da.errors_of(findings)
        print(f"[analysis] estimation batch (T={tb.n_traces}, "
              f"N={tb.trace.cmd.shape[1]}) impls={'/'.join(impls)}: "
              f"{len(KINDS) * len(impls) * len(MODES)} combinations, "
              f"errors={len(errs)} warnings={len(findings) - len(errs)} "
              f"wall_s={time.perf_counter() - t:.3f}", flush=True)
        check(not errs, f"the dispatch audit found {len(errs)} errors on "
              f"the estimation batch")
    print(f"[analysis] phase wall_s={time.perf_counter() - t0:.3f} "
          f"{card}", flush=True)


def autotune_phase(card: str, device="cuda") -> None:
    """The charge kernels' autotuner on the card: at every main-path shape
    of each family (``autotune.FAMILY_SHAPES``; a family is the mean or
    the surface kernels of one source) the committed config
    (``best_config``) against the default one, timed in turns (tuned,
    default, default, tuned, twice; medians of :func:`event_ms`); the
    tuned result the same bits twice and within rtol 1e-5 of the
    default's; then one sweep of the twelve candidates at the validation
    shape."""
    import statistics

    import torch

    from repro_torch.kernels import autotune
    default = dict(autotune.DEFAULT_CONFIG)
    for family in autotune.FAMILIES:
        for name, (t, n, v) in autotune.MAIN_PATH_SHAPES.items():
            if (t, n, v) not in autotune.FAMILY_SHAPES[family]:
                continue
            cfg = autotune.best_config(family, t, n)

            def run(c):
                return autotune.run_charge(family, t, n, v, c, device=device)
            tuned, again, base = run(cfg), run(cfg), run(default)
            torch.cuda.synchronize()
            check(torch.equal(tuned, again),
                  f"{family} tuned config: not the same bits twice")
            err = assert_close(tuned, base, RTOL,
                               f"{family} tuned against default config")
            times = {"tuned": [], "default": []}
            for order in (("tuned", "default", "default", "tuned") * 2):
                c = cfg if order == "tuned" else default
                times[order].append(event_ms(lambda: run(c), 10))
            ms, d_ms = (statistics.median(times[k])
                        for k in ("tuned", "default"))
            print(f"[autotune] {family} {name} (T={t}, N={n}, V={v}) "
                  f"bucket={autotune.shape_bucket(t, n)} config="
                  f"blocks_per_sm {cfg['blocks_per_sm']} max_cluster "
                  f"{cfg['max_cluster']} ms={ms:.4f} default_ms={d_ms:.4f} "
                  f"(medians of 4 in turns) max_abs_err={err:.3e} {card}",
                  flush=True)
    t, n, v = autotune.MAIN_PATH_SHAPES["validation"]
    t0 = time.perf_counter()
    won = autotune.sweep(
        "vampire_energy",
        lambda *a: autotune.run_charge("vampire_energy", *a, device=device),
        [(t, n, v)], timer=lambda fn: event_ms(fn, 10) * 1e3)
    (bucket, row), = won.items()
    check(len(row["candidates_us"]) == len(autotune.candidates()),
          "the sweep did not time every candidate")
    print(f"[autotune] sweep vampire_energy {bucket} V={v}: "
          f"{len(row['candidates_us'])} candidates, winner blocks_per_sm "
          f"{row['blocks_per_sm']} max_cluster {row['max_cluster']} "
          f"us={row['us']} default_us={row['default_us']} "
          f"wall_s={time.perf_counter() - t0:.3f} {card}", flush=True)


def vocab_bar(got, want, vocab: int, rel: float = 0.15,
              floor: float = 0.05) -> tuple[float, float]:
    """Max abs difference of two logit arrays over the real vocabulary, and
    the reference's teacher-forcing bar for it (``rel`` std + ``floor``:
    0.15 std + 0.05 for GQA, 0.5 std for MLA, ``tests/test_models.py``)."""
    g, w = got[..., :vocab].double(), want[..., :vocab].double()
    return (float((g - w).abs().max()),
            rel * (float(w.std()) + 1e-6) + floor)


def prefill_work(cfg, batch: int, seq: int, weight_bytes: int
                 ) -> tuple[float, str]:
    """The least time one prefill could take: the bf16 matrix products of
    every layer over ``batch * seq`` tokens (GQA or MLA projections and
    causal attention; an MoE layer's router, its routed tokens' ``top_k``
    expert products and the shared experts; a Mamba2 layer's projections
    in bf16 and its chunked scan in float32 at the float32 rate; a
    cross-attention layer's query and output projections, the memory's
    K/V projection and non-causal attention over ``aux_seq`` keys; the
    encoder's layers over ``aux_seq`` frames), and the last position's
    unembedding, against reading every weight once."""
    d, f, dh, h, kv = (cfg.d_model, cfg.d_ff, cfg.d_head, cfg.n_heads,
                       cfg.n_kv)
    t, aux = batch * seq, cfg.aux_seq
    gqa = d * (h + 2 * kv) * dh + h * dh * d
    cross = (2 * t * 2 * d * h * dh + 2 * batch * aux * 2 * d * kv * dh
             + attention_flops(batch * h, seq, aux, dh, False))
    ops, f32_ops = 2 * batch * d * cfg.vocab_padded, 0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn" and cfg.attn_kind == "mla":
            m = cfg.mla
            ops += 2 * t * (d * h * (m.d_nope + m.d_rope)
                            + d * (m.kv_lora + m.d_rope)
                            + m.kv_lora * h * (m.d_nope + m.d_v)
                            + h * m.d_v * d)
            ops += attention_flops(batch * h, seq, seq, m.d_nope + m.d_rope,
                                   True, dv=m.d_v)
        elif kind == "attn":
            ops += 2 * t * gqa + attention_flops(batch * h, seq, seq, dh,
                                                 True)
            if cfg.n_encoder_layers:
                ops += cross
        elif kind == "mamba":
            s = cfg.ssm
            di, nh = s.d_inner(d), s.n_heads(d)
            gn = s.n_groups * s.d_state
            ops += 2 * t * (d * (2 * di + 2 * gn + nh) + di * d)
            cl = min(s.chunk, seq)
            padded = -(-seq // cl) * cl
            # C B^T within each chunk, its (cl x cl) weights times x, each
            # chunk's state and the carried-in state's term
            f32_ops += 2 * batch * padded * cl * (s.n_groups * s.d_state
                                                  + nh * s.head_dim)
            f32_ops += 2 * 2 * batch * padded * nh * s.d_state * s.head_dim
        else:
            ops += cross
        if cfg.is_moe_layer(i):
            e = cfg.moe
            ops += 2 * t * (d * e.n_experts + 3 * d * e.d_ff_expert
                            * (e.top_k + e.n_shared))
        elif f > 0:
            ops += 2 * t * 3 * d * f
    ta = batch * aux
    ops += cfg.n_encoder_layers * (2 * ta * (gqa + 3 * d * f)
                                   + attention_flops(batch * h, aux, aux,
                                                     dh, False))
    return bound(weight_bytes,
                 ops + f32_ops * BF16_OPS_PER_S / FP32_OPS_PER_S,
                 BF16_OPS_PER_S)


def power_impls_agree(job, res: dict, traffic: float, logits,
                      what: str) -> float:
    """The power report of one decode step's ``logits`` and the run's
    tokens through ``'cuda'`` and ``'vectorized'``: positive energies
    equal at rtol 1e-5 and the same HBM step energy.  Returns the largest
    difference (pJ)."""
    import dataclasses

    import torch

    from repro_torch.launch import serve
    tokens = torch.from_numpy(res["tokens"])
    step_s = max(res["decode_p50_ms"], 1e-3) * 1e-3
    reports = {impl: serve.power_report(
        dataclasses.replace(job, power_impl=impl), traffic, logits, tokens,
        step_seconds=step_s) for impl in ("cuda", "vectorized")}
    got, want = (torch.from_numpy(reports[i]["ddr_energy_pj_per_seq_step"])
                 for i in ("cuda", "vectorized"))
    check(bool((got > 0).all()), f"{what}: power report energy not "
                                 "positive")
    err = assert_close(got, want, RTOL, f"{what}: power report cuda vs "
                                        "vectorized")
    check(reports["cuda"]["hbm_step_energy_uj"]
          == reports["vectorized"]["hbm_step_energy_uj"],
          f"{what}: HBM step energy differs between impls")
    return err


def serve_phase(seed: int, card: str, device="cuda", arch="qwen2.5-3b",
                smoke=False, batch=4, prompt_len=2048,
                decode_tokens=32) -> dict[str, int]:
    """Phase 13, ``[serve]``: the serving entry point at full width
    (:func:`serve_run`), flash launched once per layer of the prefill;
    then teacher forcing, a prefill with the plain attention against the
    kernel's, where the time goes and the power report's impls.  Returns
    the launches of the ``run``."""
    import functools
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops as fa_ops
    tag = "[serve]"
    ctx = serve_run(tag, seed, card, device, arch, smoke, batch, prompt_len,
                    decode_tokens)
    cfg, lm, params, prompts = (ctx[k] for k in ("cfg", "lm", "params",
                                                 "prompts"))
    launched = ctx["launched"]
    check(launched["flash_attention"] == cfg.n_layers,
          f"serve: {launched['flash_attention']} flash-attention launches in "
          f"one prefill of {cfg.n_layers} layers")
    tf_err, tf_bar, step = teacher_forcing(lm, params, prompts)
    check(tf_err < tf_bar, f"serve: decode differs from the prefill by "
                           f"{tf_err:.4f} (bar {tf_bar:.4f})")
    full, _ = lm.prefill(params, prompts)
    plain_fn = functools.partial(fa_ops.flash_attention, use_kernel=False)
    with mock.patch.object(fa_ops, "flash_attention", plain_fn):
        plain, _ = lm.prefill(params, prompts)
    pl_err, pl_bar = vocab_bar(full, plain, cfg.vocab)
    check(pl_err < pl_bar, f"serve: the kernel's prefill differs from the "
                           f"plain attention's by {pl_err:.4f} "
                           f"(bar {pl_bar:.4f})")
    where_time_goes(tag, lm, params, prompts, card)
    err = power_impls_agree(ctx["job"], ctx["res"], ctx["traffic"], step,
                            "serve")
    print(f"{tag} checks: teacher_forcing_err={tf_err:.4f} (bar "
          f"{tf_bar:.4f}) plain_vs_kernel_err={pl_err:.4f} (bar "
          f"{pl_bar:.4f}) power cuda vs vectorized max_abs_err={err:.3e} "
          f"pJ (rtol {RTOL}) launches="
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    return launched


def last_token_routes(fn, calls_per_layer: int, pins=None):
    """Run ``fn`` and record, at every MoE layer, each batch row's last
    token's chosen experts (sorted) and the log-probability margin between
    the least chosen and the most likely other expert (0 on a tie).  ``calls_per_layer``: the router
    calls a layer makes (2 in ``forward``: the auxiliary loss, then the
    layer; 1 in ``decode_step``).  With ``pins`` (one (B, k) expert choice
    per layer, one token a row) the router takes those experts instead of
    its own top-k, with gates from its own probabilities renormalised over
    them.  Returns (fn's result, [(experts (B, k), margins (B,)) per
    layer])."""
    from unittest import mock

    import torch

    from repro_torch.models import layers as L
    calls = []
    route = L.moe_route

    def recording(params, x, cfg):
        xf, probs, gate, expert = route(params, x, cfg)
        b, s = x.shape[:2]
        last = probs.view(b, s, -1)[:, -1]
        chosen = expert.view(b, s, -1)[:, -1]
        others = last.scatter(-1, chosen, 0.0)
        calls.append((chosen.sort(dim=-1).values,
                      last.gather(-1, chosen).amin(dim=-1).log()
                      - others.amax(dim=-1).log()))
        if pins is not None:
            expert = pins[len(calls) // calls_per_layer - 1]
            gate = probs.gather(-1, expert)
            gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True),
                                      min=1e-9)
        return xf, probs, gate, expert
    with mock.patch.object(L, "moe_route", recording):
        result = fn()
    return result, calls[calls_per_layer - 1::calls_per_layer]


def routed_alike(full_routes, step_routes):
    """The batch rows whose last token took the same experts in every MoE
    layer of the prefill and of the decode step, and for each other row
    the first layer that differs with the smaller of its two margins."""
    import torch
    same = torch.ones(full_routes[0][0].shape[0], dtype=torch.bool)
    flips = {}
    for layer, ((ef, mf), (es, ms)) in enumerate(zip(full_routes,
                                                     step_routes)):
        differ = (ef != es).any(dim=-1).cpu()
        for row in torch.nonzero(differ & same).flatten().tolist():
            flips[row] = (layer, float(torch.minimum(mf[row], ms[row])))
        same &= ~differ
    return same, flips


def mla_teacher_forcing(lm, params, prompts, tag: str) -> str:
    """Teacher forcing without drops (``lm`` at ``capacity_factor`` 16) at
    the reference's MLA bar (0.5 std): the decode step of the last prompt
    token on the prefill's own cache against the prefill's last position.

    The router logits are bf16 products (an ulp of 2^-7 at 1..2), so a
    row's k-th and next expert are often a tie or an ulp apart, and the
    two paths' rounding may pick either.  Checked: layer by layer on the
    prefill's own inputs, each layer's ``mla_decode`` against its
    ``mla_apply`` output, its MoE on the prefill's experts against the
    prefill's, and its router, which may differ only on a near tie
    (margin under 2^-5); then the whole decode step with the prefill's
    experts pinned.  Reported beside them: the residual's relative
    difference at a few depths (with random weights an MoE layer adds
    ~100x its input, so a bf16 difference grows from layer to layer), and
    the unpinned step (the rows routed alike, the first flip of the
    others).  Returns the summary."""
    from unittest import mock

    from repro_torch.models import layers as L
    cfg = lm.cfg
    s = prompts.shape[1] - 1
    rec = {"x": [], "a": [], "h": [], "m": []}
    real_mla, real_moe = L.mla_apply, L.moe_apply

    def mla_rec(p, x, c, positions=None):
        out = real_mla(p, x, c, positions)
        rec["x"].append(x[:, -1:].clone())
        rec["a"].append(out[0][:, -1:].clone())
        return out

    def moe_rec(p, x, c):
        out = real_moe(p, x, c)
        rec["h"].append(x[:, -1:].clone())
        rec["m"].append(out[:, -1:].clone())
        return out
    with mock.patch.object(L, "mla_apply", mla_rec), \
            mock.patch.object(L, "moe_apply", moe_rec):
        (full, caches), full_routes = last_token_routes(
            lambda: lm.prefill(params, prompts), 2)
    pins = [ex for ex, _ in full_routes]

    worst = {"attn": 0.0, "moe": 0.0}
    layer_flips = {}
    for i, p in enumerate(params["layers"]):
        sub = {name: t[i] for name, t in caches["sub0"].items()}
        sub["pos"] = s
        a_dec, _ = L.mla_decode(p["mixer"], rec["x"][i], sub, cfg)
        m_dec, routes = last_token_routes(
            lambda: L.moe_apply(p["mlp"], rec["h"][i], cfg), 1,
            pins=pins[i:i + 1])
        _, flips = routed_alike(full_routes[i:i + 1], routes)
        for row, (_, margin) in flips.items():
            check(margin < 2.0 ** -5,
                  f"{tag} layer {i}: row {row}'s router picks other "
                  f"experts on the prefill's input with a margin of "
                  f"{margin:.4f} (not a near tie)")
            layer_flips[i, row] = margin
        for part, got, want in (("attn", a_dec, rec["a"][i]),
                                ("moe", m_dec, rec["m"][i])):
            err, bar = vocab_bar(got, want, want.shape[-1], rel=0.5,
                                 floor=0.0)
            check(err < bar, f"{tag} layer {i}: the decode step's {part} "
                             f"output differs from the prefill's by "
                             f"{err:.4f} (bar {bar:.4f})")
            worst[part] = max(worst[part], err / bar)

    xs = []
    real_decode = L.mla_decode

    def decode_rec(p, x, cache, c):
        xs.append(x.clone())
        return real_decode(p, x, cache, c)

    def decode_last(pin):
        caches["pos"] = s            # the decode rewrites slot s itself
        return last_token_routes(
            lambda: lm.decode_step(params, caches, prompts[:, s:]), 1,
            pins=pin)
    with mock.patch.object(L, "mla_decode", decode_rec):
        (pinned, _), _ = decode_last(pins)
    free, step_routes = decode_last(None)
    rows, flips = routed_alike(full_routes, step_routes)
    e2e_err, e2e_bar = vocab_bar(pinned, full, cfg.vocab, rel=0.5,
                                 floor=0.0)
    check(e2e_err < e2e_bar, f"{tag} the decode step (the prefill's "
                             f"experts) differs from the prefill by "
                             f"{e2e_err:.4f} (bar {e2e_bar:.4f})")
    growth = {i: float((xs[i] - rec["x"][i]).abs().max()
                       / rec["x"][i].abs().max())
              for i in sorted({0, 1, 2, 4, 8, 16, cfg.n_layers - 1})
              if i < cfg.n_layers}
    free_err = (vocab_bar(free[0][rows.to(full.device)],
                          full[rows.to(full.device)], cfg.vocab)[0]
                if bool(rows.any()) else None)
    return (f"teacher forcing (capacity_factor 16, prompt {s + 1}): by "
            f"layer on the prefill's inputs, worst err/bar attn "
            f"{worst['attn']:.3f} moe {worst['moe']:.3f} (bar 0.5 std), "
            f"near-tie router flips {len(layer_flips)}; whole step with "
            f"the prefill's experts err={e2e_err:.4f} (bar "
            f"{e2e_bar:.4f}; residual rel diff by layer "
            f"{ {i: round(g, 5) for i, g in growth.items()} }); unpinned "
            f"rows routed alike {int(rows.sum())} of {len(rows)} (err "
            f"{'none' if free_err is None else f'{free_err:.4f}'}), first "
            f"flips (row: layer, margin) "
            f"{ {r: (l, round(m, 5)) for r, (l, m) in flips.items()} }")


def serve_mla_phase(seed: int, card: str, device="cuda",
                    arch="deepseek-v2-lite-16b", smoke=False, batch=4,
                    prompt_len=2048, decode_tokens=32) -> dict[str, int]:
    """Phase 14, ``[serve-mla]``: the serving entry point on
    deepseek-v2-lite-16b at full width and depth (MLA + MoE, 27 layers;
    :func:`serve_run`), flash launched once per layer of the prefill; then
    the same bits from the same prompt twice (prefill and a decode step:
    the MoE combine has no atomics), each layer's flash-attention output
    against the plain attention on the same inputs (the flash bf16 bar),
    teacher forcing (:func:`mla_teacher_forcing`), where the time goes and
    the power report's impls.  Returns the launches of the ``run``."""
    import dataclasses

    import torch

    from repro_torch.models.lm import LM
    tag = "[serve-mla]"
    ctx = serve_run(tag, seed, card, device, arch, smoke, batch, prompt_len,
                    decode_tokens)
    cfg, lm, params, prompts = (ctx[k] for k in ("cfg", "lm", "params",
                                                 "prompts"))
    launched = ctx["launched"]
    check(launched["flash_attention"] == cfg.n_layers,
          f"serve-mla: {launched['flash_attention']} flash-attention "
          f"launches in one prefill of {cfg.n_layers} layers")
    s = prompt_len - 1
    first, caches = lm.prefill(params, prompts[:, :s], max_len=prompt_len)
    again, _ = lm.prefill(params, prompts[:, :s], max_len=prompt_len)
    step, _ = lm.decode_step(params, caches, prompts[:, s:])
    step2, _ = lm.decode_step(params, caches, prompts[:, s:])
    check(bool(torch.isfinite(first[:, :cfg.vocab]).all())
          and bool(torch.isfinite(step[:, :cfg.vocab]).all()),
          "serve-mla: logits not finite")
    check(torch.equal(first, again) and torch.equal(step, step2),
          "serve-mla: the same prompt gave other bits")
    del first, again, step2, caches
    _, calls = kernel_vs_plain(lambda: lm.prefill(params, prompts))
    errs = [err for _, _, _, err, _ in calls]
    atol = FLASH_ATOL["bfloat16"]
    check(len(errs) == cfg.n_layers and max(errs) <= atol,
          f"serve-mla: per-layer kernel vs plain attention errors {errs} "
          f"(atol {atol})")
    tf_lm = LM(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0)))
    teacher = mla_teacher_forcing(tf_lm, params, prompts, tag)
    where_time_goes(tag, lm, params, prompts, card)
    err = power_impls_agree(ctx["job"], ctx["res"], ctx["traffic"], step,
                            "serve-mla")
    print(f"{tag} checks: same_bits_twice=True "
          f"plain_vs_kernel_max_err_by_layer={max(errs):.3e} (atol {atol}, "
          f"{len(errs)} layers) {teacher} power "
          f"cuda vs vectorized max_abs_err={err:.3e} pJ (rtol {RTOL}) "
          f"launches={ {k: v for k, v in launched.items() if v} } "
          f"card=\"{card}\"", flush=True)
    return launched


def flash_calls():
    """A context manager that records every call the model layers make of
    the flash-attention op as ``(q shape, k shape, causal)`` and passes it
    on (the wrapper's own counter still counts the launches)."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops as fa_ops

    @contextlib.contextmanager
    def recording():
        calls = []
        real = fa_ops.flash_attention

        def rec(q, k, v, **kw):
            calls.append((tuple(q.shape), tuple(k.shape),
                          kw.get("causal", True)))
            return real(q, k, v, **kw)
        with mock.patch.object(fa_ops, "flash_attention", rec):
            yield calls
    return recording()


def kernel_vs_plain(fn):
    """Run ``fn`` with every flash-attention call of the model layers also
    computed by the plain version on the same inputs.  Returns (fn's
    result, [(q shape, k shape, causal, max abs err, max |plain|)])."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops as fa_ops
    errs = []
    kernel = fa_ops.flash_attention

    def both(q, k, v, **kw):
        got = kernel(q, k, v, **kw)
        want = kernel(q, k, v, use_kernel=False, **kw)
        errs.append((tuple(q.shape), tuple(k.shape), kw.get("causal", True),
                     float((got.float() - want.float()).abs().max()),
                     float(want.float().abs().max())))
        return got
    with mock.patch.object(fa_ops, "flash_attention", both):
        out = fn()
    return out, errs


def serve_run(tag: str, seed: int, card: str, device: str, arch: str,
              smoke: bool, batch: int, prompt_len: int,
              decode_tokens: int) -> dict:
    """One run of the serving entry point (``launch.serve.run``, the power
    report through ``'cuda'``) with the launch counts set to 0 just before
    it and read just after, its flash calls by shape, and its numbers
    beside their bounds; then the model's weights drawn again from the
    seed for the phase's checks (the earlier phases' weights are released
    first)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    cfg = registry.get_config(arch, smoke=smoke)
    job = serve.ServeJob(arch=arch, smoke=smoke, batch=batch,
                         prompt_len=prompt_len, decode_tokens=decode_tokens,
                         seed=seed, power_report=True, power_impl="cuda",
                         device=device)
    reset_counters()
    t0 = time.perf_counter()
    with flash_calls() as calls:
        res = serve.run(job)
    run_s = time.perf_counter() - t0
    launched = read_counters()
    pw = res["power"]
    traffic = pw["traffic_bytes_per_step"]
    check(res["tokens"].shape == (batch, decode_tokens)
          and bool((res["tokens"] < cfg.vocab).all()),
          f"{tag}: tokens of shape {res['tokens'].shape}")
    check(bool((pw["ddr_energy_pj_per_seq_step"] > 0).all())
          and pw["hbm_step_energy_uj"] > 0, f"{tag}: energy not positive")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(seed))
    weight_bytes = serve.tree_nbytes(params)
    decode_bound = traffic / HBM_BYTES_PER_S * 1e3
    prefill_bound = prefill_work(cfg, batch, prompt_len, weight_bytes)
    kinds = {k: sum(cfg.layer_kind(i) == k for i in range(cfg.n_layers))
             for k in dict.fromkeys(cfg.pattern)}
    parts = " ".join(f"{name}={getattr(cfg, name)}"
                     for name in ("mla", "moe", "ssm")
                     if getattr(cfg, name) is not None)
    print(f"{tag} {cfg.name}: layers={cfg.n_layers} {kinds} "
          f"encoder_layers={cfg.n_encoder_layers} aux_seq={cfg.aux_seq} "
          f"d_model={cfg.d_model} heads={cfg.n_heads} kv={cfg.n_kv} "
          f"d_head={cfg.d_head} d_ff={cfg.d_ff} {parts} "
          f"vocab={cfg.vocab} dtype={cfg.dtype} weight_bytes={weight_bytes} "
          f"batch={batch} prompt={prompt_len} decode_tokens={decode_tokens} "
          f"run_s={run_s:.3f} card=\"{card}\"", flush=True)
    prefill_calls = sum(q[1] > 1 for q, _, _ in calls)
    print(f"{tag} prefill_s={res['prefill_s']:.4f} prefill_bound_ms="
          f"{prefill_bound[0]:.3f} ({prefill_bound[1]}) decode_p50_ms="
          f"{res['decode_p50_ms']:.3f} decode_p99_ms="
          f"{res['decode_p99_ms']:.3f} tokens_per_s="
          f"{res['tokens_per_s']:.1f} traffic_bytes_per_step={traffic:.0f} "
          f"decode_bound_ms={decode_bound:.3f} decode_share_of_bound="
          f"{decode_bound / max(res['decode_p50_ms'], 1e-9):.3f} "
          f"flash_launches={launched['flash_attention']} (prefill "
          f"{prefill_calls}, decode {len(calls) - prefill_calls}) "
          f"card=\"{card}\"", flush=True)
    svc = pw["serving"]
    print(f"{tag} power[{pw['power_model']}] impl=cuda "
          f"ddr_uj_per_token_mean={pw['ddr_energy_uj_per_token_mean']:.4f} "
          f"hbm_step_uj={pw['hbm_step_energy_uj']:.2f} "
          f"hbm_ones_frac={pw['hbm_ones_frac']:.6f} "
          f"hbm_toggle_frac={pw['hbm_toggle_frac']:.6f} "
          f"vendors={pw['vendors']} service: admitted={svc['admitted']} "
          f"dispatches={svc['dispatches']} batch_fill={svc['batch_fill']} "
          f"dispatch_p50_ms={svc['dispatch_p50_ms']:.3f} "
          f"engine_programs={svc['engine_programs']} card=\"{card}\"",
          flush=True)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           size=(batch, prompt_len)),
                              dtype=torch.long, device=device)
    return dict(cfg=cfg, job=job, res=res, launched=launched, calls=calls,
                lm=lm, params=params, prompts=prompts, traffic=traffic)


def teacher_forcing(lm, params, prompts, aux=None):
    """Two decode steps after a prefill of all but the last two prompt
    tokens, each against the prefill that ends at its token, at the
    reference's bar (test_decode_matches_teacher_forcing).  Returns the
    worst (err, bar) by err / bar and the last step's logits."""
    s = prompts.shape[1] - 2
    _, caches = lm.prefill(params, prompts[:, :s], aux=aux,
                           max_len=s + 2)
    worst = (0.0, 1.0)
    for t in (s, s + 1):
        want, _ = lm.prefill(params, prompts[:, :t + 1], aux=aux)
        got, caches = lm.decode_step(params, caches, prompts[:, t:t + 1])
        err, bar = vocab_bar(got, want, lm.cfg.vocab)
        worst = max(worst, (err, bar), key=lambda e: e[0] / e[1])
    return (*worst, got)


def where_time_goes(tag: str, lm, params, prompts, card: str, aux=None):
    """A warm prefill and one decode step, each on the host clock and
    profiled on the card (the idle share is the rest)."""
    s = prompts.shape[1] - 1
    prefill_ms = wall_ms(lambda: lm.prefill(params, prompts, aux=aux), 2)
    device_profile(lambda: lm.prefill(params, prompts, aux=aux),
                   "prefill (warm)", prefill_ms, card, tag=tag, top=6)
    _, caches = lm.prefill(params, prompts[:, :s], aux=aux,
                           max_len=s + 1)

    def step():
        caches["pos"] = s             # the step rewrites slot s itself
        return lm.decode_step(params, caches, prompts[:, s:])
    step_ms = wall_ms(step, 5)
    device_profile(step, "decode_step", step_ms, card, tag=tag, top=6)


def rec_close(got, want, atol: float = 2e-3, rtol: float = 2e-2) -> float:
    """|got - want| <= atol + rtol |want| element-wise (the reference's
    chunked-vs-recurrent bars); returns the max abs error."""
    err = (got.double() - want.double()).abs()
    ok = bool((err <= atol + rtol * want.double().abs()).all())
    check(ok, f"chunked scan against the recurrence: max abs err "
              f"{float(err.max()):.3e} beyond atol {atol}, rtol {rtol}")
    return float(err.max())


def ssm_teacher_forcing(lm, params, prompts, tag: str) -> str:
    """Teacher forcing of a Mamba2 model, three ways.  In float32 (the
    weights cast from the run's bf16 draws): two decode steps after a
    prefill of all but the last two prompt tokens, each against the
    prefill ending at its token, at the reference's bar.  In the config
    dtype, layer by layer on the prefill's own inputs: each layer's
    chunked scan over all but the last token, then its one-token
    recurrence on the last, against its chunked output over all the
    tokens, at the same bar.  And
    the whole bf16 step, reported beside them: with random weights a
    one-ulp bf16 difference between the two paths grows from layer to
    layer (the reference's own bf16 model reaches its bar at 12 layers).
    Returns the summary."""
    import dataclasses
    from unittest import mock

    from repro_torch.models import layers as L
    from repro_torch.models.lm import LM
    cfg = lm.cfg

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [f32(v) for v in tree]
        return tree.float()
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"))
    err32, bar32, _ = teacher_forcing(lm32, f32(params), prompts)
    check(err32 < bar32, f"{tag}: float32 decode differs from the prefill "
                         f"by {err32:.5f} (bar {bar32:.4f})")
    s = prompts.shape[1] - 1
    rec = []
    real = L.mamba_apply

    def recording(p, x, c):
        out = real(p, x, c)
        rec.append((x.clone(), out[0][:, -1:].clone()))
        return out
    with mock.patch.object(L, "mamba_apply", recording):
        lm.prefill(params, prompts)
    worst, worst_layer = 0.0, 0
    for i, p in enumerate(params["layers"]):
        x, want = rec[i]
        _, cache = L.mamba_apply(p["mixer"], x[:, :s], cfg)
        got, _ = L.mamba_decode(p["mixer"], x[:, s:], cache, cfg)
        err, bar = vocab_bar(got, want, cfg.d_model)
        check(err < bar, f"{tag} layer {i}: the recurrence differs from "
                         f"the chunked scan by {err:.4f} (bar {bar:.4f})")
        if err / bar > worst:
            worst, worst_layer = err / bar, i
    err16, bar16, _ = teacher_forcing(lm, params, prompts)
    return (f"teacher forcing (two steps after a prefill of {s - 1}): "
            f"float32 err={err32:.5f} (bar {bar32:.4f}); {cfg.dtype} by "
            f"layer on the prefill's inputs worst err/bar {worst:.3f} "
            f"(layer {worst_layer} of {len(rec)}); {cfg.dtype} whole step "
            f"err={err16:.4f} (bar {bar16:.4f}, reported)")


def serve_ssm_phase(seed: int, card: str, device="cuda", arch="mamba2-780m",
                    smoke=False, batch=4, prompt_len=2048, decode_tokens=32,
                    scan_len=600) -> dict[str, int]:
    """Phase 15, ``[serve-ssm]``: the serving entry point on mamba2-780m at
    full width and depth (48 Mamba2 blocks, d_model 1536, no attention:
    the flash kernel must launch 0 times), then its checks: the same bits
    from the same prompt twice (prefill, the state and conv caches, a
    decode step), teacher forcing at the reference's bar for two decode
    steps after a prefill of ``prompt_len - 2`` tokens (not a multiple of
    the chunk: the front pad runs), layer 0's chunked scan against its
    one-token recurrence in float32 over ``scan_len`` tokens at the
    reference's bars, the power report's ``'cuda'`` against
    ``'vectorized'``, and where the time goes.  Returns the launches."""
    import dataclasses

    import torch

    from repro_torch.models import layers as L
    tag = "[serve-ssm]"
    ctx = serve_run(tag, seed, card, device, arch, smoke, batch, prompt_len,
                    decode_tokens)
    cfg, lm, params, prompts = (ctx[k] for k in ("cfg", "lm", "params",
                                                 "prompts"))
    launched = ctx["launched"]
    check(launched["flash_attention"] == 0 and not ctx["calls"],
          f"{tag}: {launched['flash_attention']} flash launches in a model "
          "with no attention")
    s = prompt_len - 2
    first, caches = lm.prefill(params, prompts[:, :s], max_len=prompt_len)
    again, caches2 = lm.prefill(params, prompts[:, :s], max_len=prompt_len)
    step, _ = lm.decode_step(params, caches, prompts[:, s:s + 1])
    step2, _ = lm.decode_step(params, caches2, prompts[:, s:s + 1])
    check(bool(torch.isfinite(first[:, :cfg.vocab]).all())
          and bool(torch.isfinite(step[:, :cfg.vocab]).all()),
          f"{tag}: logits not finite")
    check(torch.equal(first, again) and torch.equal(step, step2)
          and all(torch.equal(caches[sub][n], caches2[sub][n])
                  for sub in caches if sub != "pos" for n in caches[sub]),
          f"{tag}: the same prompt gave other bits")
    del first, again, caches, caches2
    teacher = ssm_teacher_forcing(lm, params, prompts, tag)
    # layer 0's chunked scan against the recurrence, in float32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p0 = {k: v.float() for k, v in params["layers"][0]["mixer"].items()}
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    x = torch.randn(2, scan_len, cfg.d_model, generator=gen,
                    device=device) * 0.3
    full, final = L.mamba_apply(p0, x, cfg32)
    meta = lm.init_cache_meta(2, 1)["sub0"]
    cache = {k: torch.zeros(m.shape[1:], dtype=torch.float32, device=device)
             for k, m in meta.items()}
    outs = [L.mamba_decode(p0, x[:, t:t + 1], cache, cfg32)[0]
            for t in range(scan_len)]
    scan_err = rec_close(torch.cat(outs, 1), full)
    state_err = rec_close(cache["state"], final["state"])
    del full, final, outs, cache
    where_time_goes(tag, lm, params, prompts, card)
    err = power_impls_agree(ctx["job"], ctx["res"], ctx["traffic"], step,
                            "serve-ssm")
    print(f"{tag} checks: same_bits_twice=True {teacher} "
          f"chunked_vs_recurrent (layer 0, float32, S={scan_len}, "
          f"chunk {cfg.ssm.chunk}) out_err={scan_err:.3e} state_err="
          f"{state_err:.3e} (atol 2e-3, rtol 2e-2) power cuda vs vectorized "
          f"max_abs_err={err:.3e} pJ (rtol {RTOL}) launches="
          f"{ {k: v for k, v in launched.items() if v} } card=\"{card}\"",
          flush=True)
    return launched


def cross_checks(tag: str, ctx: dict, seed: int, card: str, device: str,
                 expect: dict[str, int], classes) -> dict[str, int]:
    """The checks of a model that cross-attends: the run's flash calls by
    class (``classes(calls)`` -> counts, held to ``expect``); then on
    seeded N(0, 1) aux embeddings (zeros make every cross K/V zero and the
    kernel's comparison trivial) every flash call of a prefill and a
    decode step against the plain attention on the same inputs (the bf16
    bar), and teacher forcing at the reference's bar; where the time goes;
    the power report's impls.  Returns the class counts."""
    import numpy as np
    import torch
    cfg, lm, params, prompts = (ctx[k] for k in ("cfg", "lm", "params",
                                                 "prompts"))
    got = classes(ctx["calls"])
    check(got == expect and ctx["launched"]["flash_attention"]
          == len(ctx["calls"]),
          f"{tag}: flash calls {got} (want {expect}), launches "
          f"{ctx['launched']['flash_attention']}")
    aux = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (prompts.shape[0], cfg.aux_seq, cfg.d_model)),
        dtype=torch.float32).to(device, getattr(torch, cfg.dtype))
    s = prompts.shape[1] - 1

    def prefill_and_step():
        _, caches = lm.prefill(params, prompts[:, :s], aux=aux,
                               max_len=s + 1)
        return lm.decode_step(params, caches, prompts[:, s:])
    (step, _), errs = kernel_vs_plain(prefill_and_step)
    atol = FLASH_ATOL["bfloat16"]
    by_class, ulps = {}, 0.0
    for q, k, causal, err, amax in errs:
        name = ("decode" if q[1] == 1 else "causal" if causal
                else "encoder" if q[1] == k[1] == cfg.aux_seq
                and cfg.n_encoder_layers else "cross")
        by_class[name] = max(by_class.get(name, 0.0), err)
        if causal:
            # the self-attention layers behind a cross layer: one bf16 ulp
            # of the largest output (2e-2 is under one ulp from 4 up)
            ulp = 2.0 ** (math.floor(math.log2(max(amax, 1e-30))) - 7)
            ulps = max(ulps, err / ulp)
            check(err <= max(atol, ulp), f"{tag}: a causal call's kernel "
                                         f"output differs from the plain "
                                         f"attention's by {err:.3e}, more "
                                         f"than one ulp ({ulp:.3e})")
    check(bool(torch.isfinite(step[:, :cfg.vocab]).all())
          and max(v for k, v in by_class.items() if k != "causal") <= atol,
          f"{tag}: kernel vs plain attention, worst by call class "
          f"{by_class} (atol {atol} but causal)")
    tf_err, tf_bar, _ = teacher_forcing(lm, params, prompts, aux=aux)
    check(tf_err < tf_bar, f"{tag}: decode differs from the prefill by "
                           f"{tf_err:.4f} (bar {tf_bar:.4f})")
    where_time_goes(tag, lm, params, prompts, card, aux=aux)
    err = power_impls_agree(ctx["job"], ctx["res"], ctx["traffic"], step,
                            tag)
    print(f"{tag} checks: flash calls {got} over the run; on seeded N(0, 1) "
          f"aux, kernel vs plain attention worst by call class "
          f"{ {k: float(f'{v:.3e}') for k, v in by_class.items()} } "
          f"({len(errs)} calls; atol {atol}, causal calls within "
          f"{ulps:.2f} ulp of their largest output) teacher_forcing_err="
          f"{tf_err:.4f} (bar {tf_bar:.4f}) power cuda vs vectorized "
          f"max_abs_err={err:.3e} pJ launches="
          f"{ {k: v for k, v in ctx['launched'].items() if v} } "
          f"card=\"{card}\"", flush=True)
    return got


def serve_xattn_phase(seed: int, card: str, device="cuda",
                      arch="llama-3.2-vision-11b", smoke=False, batch=4,
                      prompt_len=2048, decode_tokens=32
                      ) -> tuple[dict[str, int], dict[str, int]]:
    """Phase 16, ``[serve-xattn]``: the serving entry point on
    llama-3.2-vision-11b at full width and depth (40 layers, d_model 4096,
    8 cross-attention layers over 1601 patch embeddings; the run feeds
    zeros, as the reference does): one flash launch per layer in the
    prefill (32 causal, 8 cross at Sq = prompt against 1601 keys) and one
    per cross layer in each decode step (Sq = 1); then
    :func:`cross_checks`.  Returns the launches and the call counts."""
    tag = "[serve-xattn]"
    ctx = serve_run(tag, seed, card, device, arch, smoke, batch, prompt_len,
                    decode_tokens)
    cfg = ctx["cfg"]
    n_cross = sum(cfg.layer_kind(i) == "xattn" for i in range(cfg.n_layers))

    def classes(calls):
        return {"causal": sum(c for _, _, c in calls),
                "cross": sum(not c and q[1] > 1 for q, _, c in calls),
                "decode": sum(q[1] == 1 for q, _, _ in calls)}
    expect = {"causal": cfg.n_layers - n_cross, "cross": n_cross,
              "decode": n_cross * (decode_tokens - 1)}
    return ctx["launched"], cross_checks(tag, ctx, seed, card, device,
                                         expect, classes)


def serve_enc_phase(seed: int, card: str, device="cuda", arch="whisper-small",
                    smoke=False, batch=4, prompt_len=416, decode_tokens=32
                    ) -> tuple[dict[str, int], dict[str, int]]:
    """Phase 17, ``[serve-enc]``: the serving entry point on whisper-small
    at its published widths and depth (12 encoder layers over 1500 frames,
    12 decoder layers each with cross-attention; prompt 416 + 32 decode
    tokens = the 448-token text context): the prefill launches flash once
    per encoder layer (non-causal, 1500 x 1500), once per decoder layer's
    self-attention (causal) and once per cross-attention (416 against 1500
    keys), and each decode step once per cross-attention (Sq = 1); then
    :func:`cross_checks`.  Returns the launches and the call counts."""
    tag = "[serve-enc]"
    ctx = serve_run(tag, seed, card, device, arch, smoke, batch, prompt_len,
                    decode_tokens)
    cfg = ctx["cfg"]
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers

    def classes(calls):
        enc = calls[:n_enc]
        return {"encoder": sum(not c and q[1] == k[1] == cfg.aux_seq
                               for q, k, c in enc),
                "causal": sum(c for _, _, c in calls),
                "cross": sum(not c and q[1] > 1 for q, _, c in calls[n_enc:]),
                "decode": sum(q[1] == 1 for q, _, _ in calls)}
    expect = {"encoder": n_enc, "causal": n_dec, "cross": n_dec,
              "decode": n_dec * (decode_tokens - 1)}
    return ctx["launched"], cross_checks(tag, ctx, seed, card, device,
                                         expect, classes)


def serve_hybrid_phase(seed: int, card: str, device="cuda",
                       arch="jamba-1.5-large-398b", batch=4,
                       prompt_len=64) -> dict[str, int]:
    """Phase 18, ``[serve-hybrid]``: jamba's hybrid pattern (Mamba2 and
    attention 1:7, MoE every second layer) at its smoke widths (at its
    published widths it is 397.7 B parameters, 795 GB in bf16: more than
    one card), through ``LM.prefill`` and ``decode_step`` with
    ``capacity_factor`` 16 (no drops, as the reference's test): one flash
    launch per period in the prefill (d_head 16 on the (64, 64) instance),
    teacher forcing at the reference's bar.  Returns the launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    tag = "[serve-hybrid]"
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    cfg = registry.get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(seed))
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(batch, prompt_len)), dtype=torch.long,
        device=device)
    reset_counters()
    with flash_calls() as calls:
        _, caches = lm.prefill(params, prompts[:, :-2], max_len=prompt_len)
        in_prefill = len(calls)
        for t in (prompt_len - 2, prompt_len - 1):
            logits, caches = lm.decode_step(params, caches,
                                            prompts[:, t:t + 1])
    launched = read_counters()
    periods = cfg.n_layers // lm.period
    check(in_prefill == periods and launched["flash_attention"] == periods
          and bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
          f"{tag}: {in_prefill} flash calls in the prefill, "
          f"{launched['flash_attention']} launches (want {periods}, one a "
          "period)")
    tf_err, tf_bar, _ = teacher_forcing(lm, params, prompts)
    check(tf_err < tf_bar, f"{tag}: decode differs from the prefill by "
                           f"{tf_err:.4f} (bar {tf_bar:.4f})")
    print(f"{tag} {cfg.name}: layers={cfg.n_layers} pattern={cfg.pattern} "
          f"moe every {cfg.moe.every} (capacity_factor 16) d_model="
          f"{cfg.d_model} d_head={cfg.d_head} batch={batch} prompt="
          f"{prompt_len}: flash launches in the prefill {in_prefill} (one a "
          f"period), teacher_forcing_err={tf_err:.4f} (bar {tf_bar:.4f}) "
          f"launches={ {k: v for k, v in launched.items() if v} } "
          f"card=\"{card}\"", flush=True)
    return launched


# --------------------------------------------------------------------------
# The train path
# --------------------------------------------------------------------------
# test_torch_train_grads.py's float32 bars (atol as a share of each
# gradient leaf's largest value, beside rtol 1e-4)
GRAD_ATOL = {"qwen2.5-3b": 1e-4, "granite-8b": 1e-4, "qwen2-7b": 1e-4,
             "yi-34b": 1e-4, "mamba2-780m": 1e-5,
             "llama-3.2-vision-11b": 5e-3, "qwen3-moe-30b-a3b": 2e-4,
             "deepseek-v2-lite-16b": 5e-4, "whisper-small": 3e-3,
             "jamba-1.5-large-398b": 4e-4}
# bf16 gradients, kernel against plain, as a share of each leaf's largest:
# 2e-2 was the aim; six configs' worst leaves read 2.02e-2 to 2.52e-2
# on the H100 (float32 reads at most 2.2e-6 on the same path), the
# forward kernel rounding P to bf16 before P V where the plain attention
# keeps it in float32, and the rest of the bf16 network carrying that
# one-ulp difference to the front layers.  Leaves above 2e-2 are listed.
BF16_GRAD_BAR = 3e-2


def train_work(cfg, batch: int, seq: int) -> int:
    """The operations of one train step of a dense GQA decoder with every
    layer recomputed in the backward: the layers' products three times
    (forward, and twice in the backward) plus once more for the
    recompute, less the recompute's MLP down projection (torch's
    non-reentrant checkpoint stops recomputing once it has remade every
    tensor the backward saved, and the down projection's input is the
    last), the unembedding three times, and causal attention 4.5 times
    (the forward, the recompute and the backward's five products)."""
    if cfg.attn_kind != "gqa" or cfg.moe is not None or set(
            cfg.pattern) != {"attn"} or cfg.n_encoder_layers:
        raise ValueError(f"train_work counts dense GQA decoders, not "
                         f"{cfg.name}")
    d, f, dh, h, kv = (cfg.d_model, cfg.d_ff, cfg.d_head, cfg.n_heads,
                       cfg.n_kv)
    t = batch * seq
    layer = 2 * t * (d * (h + 2 * kv) * dh + h * dh * d + 3 * d * f)
    attn = attention_flops(batch * h, seq, seq, dh, True)
    head = 2 * t * d * cfg.vocab_padded
    down = 2 * t * f * d
    return cfg.n_layers * (4 * layer - down) + 3 * head + int(
        4.5 * cfg.n_layers * attn)


def train_memory(cfg, weight_bytes: int, moment_bytes: int, batch: int,
                 seq: int) -> int:
    """The predicted peak of a train step: weights, their gradients and
    the moments; every layer's saved input; at the loss, the logits in the
    config dtype and three float32 copies (the logits, the softmax's
    gradient and the gold logits' scatter)."""
    t = batch * seq
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    saved = cfg.n_layers * t * cfg.d_model * itemsize
    logits = t * cfg.vocab_padded * (itemsize + 3 * 4)
    return 2 * weight_bytes + moment_bytes + saved + logits


def profiled_first_step(device: str, into: dict):
    """A wrapper of ``steps.make_train_step`` whose step runs its first
    call under ``torch.profiler`` and records, in ``into``, that call's
    host-clock ms and its device kernels' ms by name."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as steps_lib
    real = steps_lib.make_train_step
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.startswith("cuda") else [])

    def make(lm, ocfg, **kw):
        step = real(lm, ocfg, **kw)

        def first_profiled(params, opt_state, batch):
            if into:
                return step(params, opt_state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                out = step(params, opt_state, batch)
                torch.cuda.synchronize()
            into["wall_ms"] = (time.perf_counter() - t0) * 1e3
            by_name = collections.Counter()
            ops = 0
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by_name[e.name] += e.device_time_total / 1e3
                    ops += 1
            into["by_name"], into["ops"] = by_name, ops
            return out
        return first_profiled
    return make


def train_phase(seed: int, card: str, device="cuda", arch="qwen2.5-3b",
                smoke=False, batch=4, seq=2048, steps=5,
                stats: dict | None = None) -> dict[str, int]:
    """``[train]``: the train entry point (``launch.train.run``) on
    qwen2.5-3b at full width and depth (random bf16 weights, float32 AdamW
    moments), batch 4 x 2048 tokens, one warm step (under
    ``torch.profiler``: device busy ms by kernel against its host-clock ms)
    and four timed steps, no checkpoint directory, the power report once.
    Every loss finite; the flash forward launched twice a layer a step
    (the forward and the recompute) and K0-K2 once a layer a step.
    Returns the run's launches; ``stats``, given, receives the step's
    median seconds, the measured peak and ``train_memory``'s prediction
    (bytes)."""
    from unittest import mock

    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import serve, train
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import LM
    tag = "[train]"
    cfg = registry.get_config(arch, smoke=smoke)
    prof: dict = {}
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with mock.patch.object(steps_lib, "make_train_step",
                           profiled_first_step(device, prof)):
        t0 = time.perf_counter()
        res = train.run(train.TrainJob(arch=arch, smoke=smoke, steps=steps,
                                       batch=batch, seq=seq,
                                       power_every=steps, seed=seed,
                                       device=device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = read_counters()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    losses = res["losses"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"train: losses {losses}")
    want = {"flash_attention": 2 * cfg.n_layers * steps}
    want.update(dict.fromkeys(fa.BWD_KERNELS, cfg.n_layers * steps))
    check(all(launched[k] == n for k, n in want.items()),
          f"train: launches { {k: launched[k] for k in want} } where "
          f"{want} were due")
    step_s = sorted(res["step_seconds"][1:])[(steps - 1) // 2]
    tokens = batch * seq
    w_bytes = serve.tree_nbytes(res["params"])
    m_bytes = serve.tree_nbytes({k: v for k, v in res["opt_state"].items()
                                 if k != "step"})
    ops = train_work(cfg, batch, seq)
    traffic = train.train_traffic_bytes(LM(cfg), res["params"],
                                        res["opt_state"], tokens)
    b_ms, b_by = bound(traffic, ops, BF16_OPS_PER_S)
    predicted = train_memory(cfg, w_bytes, m_bytes, batch, seq)
    power = res["power"]
    print(f"{tag} {arch} layers={cfg.n_layers} d={cfg.d_model} "
          f"batch={batch} seq={seq} weights_gb={w_bytes / 1e9:.3f} "
          f"moments_gb={m_bytes / 1e9:.3f} steps={steps} (1 warm + "
          f"{steps - 1} timed) step_s={step_s:.4f} (median) "
          f"tokens_per_s={tokens / step_s:.1f} warm_step_s="
          f"{res['step_seconds'][0]:.3f} run_wall_s={wall:.2f} "
          f"bound_ms={b_ms:.3f} ({b_by}: {ops:.4e} ops at 989 TFLOP/s, "
          f"{traffic / 1e9:.2f} GB at 3.35 TB/s) share_of_bound="
          f"{b_ms / 1e3 / step_s:.3f} card=\"{card}\"", flush=True)
    print(f"{tag} losses={[round(x, 4) for x in losses]}", flush=True)
    print(f"{tag} peak memory max_memory_allocated_gb="
          + (f"{peak / 1e9:.3f}" if on_card else "not measured")
          + f" predicted_gb={predicted / 1e9:.3f} (weights, gradients, "
          f"moments, saved layer inputs, the logits)", flush=True)
    busy = sum(prof.get("by_name", {}).values())
    if busy:
        print(f"{tag} warm step: device_busy_ms={busy:.3f} of wall_ms="
              f"{prof['wall_ms']:.3f} (idle share "
              f"{max(0.0, 1 - busy / prof['wall_ms']):.3f}, the profiler's "
              f"own host time included) device_ops={prof['ops']} "
              f"distinct={len(prof['by_name'])}", flush=True)
        for name, ms in prof["by_name"].most_common(10):
            print(f"{tag}   {ms:9.3f} ms  {name[:90]}", flush=True)
        flash = {label: sum(ms for name, ms in prof["by_name"].items()
                            if key in name)
                 for label, key in (("forward", "flash_bf16_kernel"),
                                    ("K0", "bwd_delta"), ("K1", "bwd_dkdv"),
                                    ("K2", "bwd_dq"))}
        k012 = flash["K0"] + flash["K1"] + flash["K2"]
        print(f"{tag} warm step flash busy ms: "
              + " ".join(f"{k}={v:.3f}" for k, v in flash.items())
              + f"; K0-K2 {k012:.3f}, share {k012 / busy:.3f} of the busy "
              "time", flush=True)
    else:
        print(f"{tag} warm step: device time not measured (the profiler "
              "recorded no kernel)", flush=True)
    if stats is not None:
        stats.update(step_s=step_s, peak=peak, predicted=predicted)
    (step0, joules), = res["energies"]
    print(f"{tag} power: step {step0} est. HBM energy {joules:.4f} J "
          f"(read {power.read_bytes / 1e9:.2f} GB, write "
          f"{power.write_bytes / 1e9:.2f} GB of train_traffic_bytes; "
          f"the largest leaf's ones/toggles through the line kernels) "
          f"launches={ {k: v for k, v in launched.items() if v} }",
          flush=True)
    del res
    return launched


def plain_attention():
    """The flash op's stand-in for ``[train-grad]``: the plain attention
    (``attention_ref``) forward and the plain backward
    (``attention_bwd_ref``), as an autograd function."""
    import torch

    from repro_torch.kernels.flash_attention import ref as fa_ref

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, sm_scale):
            out = fa_ref.attention_ref(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
            ctx.save_for_backward(q, k, v, out)
            ctx.causal, ctx.sm_scale = causal, sm_scale
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out = ctx.saved_tensors
            return (*fa_ref.attention_bwd_ref(
                q, k, v, out, dout.contiguous(), causal=ctx.causal,
                sm_scale=ctx.sm_scale), None, None)

    def plain(q, k, v, *, causal=True, use_kernel=True, sm_scale=None,
              q_offset=0):
        check(q_offset == 0, "train-grad: a q offset in a train step")
        return PlainAttention.apply(q, k, v, causal,
                                    sm_scale or q.shape[-1] ** -0.5)
    return plain


def train_grad_phase(seed: int, card: str, device="cuda", archs=None,
                     batch=2, seq=32) -> None:
    """``[train-grad]``: every leaf's gradient of ``LM.loss`` on each of
    the ten configs at smoke widths (MoE at ``capacity_factor`` 16), on
    the card, through the kernels and through the plain attention with
    the plain backward (``attention_bwd_ref``) on the same weights and
    batch: float32 at the CPU tests' bar (rtol 1e-4, ``GRAD_ATOL`` of each
    leaf's largest), bf16 within ``BF16_GRAD_BAR`` of each leaf's largest
    gradient (those above 2e-2 listed);
    a q/k/v bias at its projection's scale (``bias_scale``); then one
    train step of each through the kernels, its loss finite.  Every leaf
    beyond its bar is listed before the phase fails."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw
    plain = plain_attention()
    failed, over = [], []
    for arch in archs or registry.ARCH_NAMES:
        worst = {}
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                                      dtype=dtype)
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=16.0))
            lm = LM(cfg)
            gen = torch.Generator(device=device).manual_seed(seed)
            params = lm.init(gen)
            b = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                            global_batch=batch,
                                            seed=seed + 7),
                                 device=device).global_batch(0)
            if cfg.aux_seq:
                b["aux"] = (0.5 * torch.randn(
                    batch, cfg.aux_seq, cfg.d_model, generator=gen,
                    device=device)).to(getattr(torch, dtype))
            reset_counters()
            (loss, _), got = steps_lib.value_and_grad(lm, params, b)
            launched = read_counters()
            with mock.patch.object(fa_ops, "flash_attention", plain):
                (loss_p, _), want = steps_lib.value_and_grad(lm, params, b)
            has_attn = any(cfg.layer_kind(i) != "mamba"
                           for i in range(cfg.n_layers))
            check(all((launched[k] > 0) == has_attn for k in
                      ("flash_attention", "flash_attention_bwd_prep",
                       "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")),
                  f"train-grad {arch} {dtype}: launches {launched}")
            wants = dict(zip((p for p, _ in T.leaves_with_paths(got)),
                             T.leaves(want)))
            err = 0.0
            for path, g in T.leaves_with_paths(got):
                g, w = g.float(), wants[path].float()
                top = float(bias_scale(path, wants).abs().max()) or 1e-30
                gap = float((g - w).abs().max())
                if dtype == "float32":
                    ok = bool(((g - w).abs() <= 1e-4 * w.abs()
                               + GRAD_ATOL[arch] * top).all())
                else:
                    ok = gap <= BF16_GRAD_BAR * top
                    if gap > 2e-2 * top:
                        over.append(f"{arch} {path} {gap / top:.3e}")
                if not (ok and bool(torch.isfinite(g).all())):
                    failed.append(f"{arch} {dtype} {path}: {gap / top:.3e}")
                err = max(err, gap / top)
            worst[dtype] = (err, float(loss), float(loss_p))
        step = steps_lib.make_train_step(lm, adamw.AdamWConfig())
        _, _, met = step(params, adamw.init(params, adamw.AdamWConfig()), b)
        check(math.isfinite(float(met["loss"])),
              f"train-grad {arch}: train step loss {float(met['loss'])}")
        print(f"[train-grad] {arch}: kernel vs plain gradients, worst leaf "
              f"f32 {worst['float32'][0]:.3e} (bar rtol 1e-4 + "
              f"{GRAD_ATOL[arch]:.0e} of the largest) bf16 "
              f"{worst['bfloat16'][0]:.3e} (bar {BF16_GRAD_BAR}); loss "
              f"kernel/plain "
              f"f32 {worst['float32'][1]:.6f}/{worst['float32'][2]:.6f}; "
              f"bf16 train step loss {float(met['loss']):.4f}", flush=True)
    print(f"[train-grad] bf16 leaves above 2e-2 of their largest: "
          f"{len(over)} {over}", flush=True)
    check(not failed, f"train-grad: kernel gradients beyond the bar: "
                      f"{failed}")


def bias_scale(path: str, grads: dict):
    """The scale a gradient leaf is held at: the leaf itself, or for a
    q/k/v bias its projection's weight gradient.  A bias's gradient is the
    sum of the projection's output gradients over every token, and these
    nearly cancel (a shift shared by every key moves no softmax, and RoPE
    only turns it), so its own largest value is no scale for the rounding
    of the terms."""
    for b, w in (("['bq']", "['wq']"), ("['bk']", "['wk']"),
                 ("['bv']", "['wv']")):
        if path.endswith(b):
            return grads[path[:-len(b)] + w].float()
    return grads[path].float()


def train_ckpt_phase(seed: int, card: str, device="cuda",
                     arch="qwen2.5-3b") -> dict[str, int]:
    """``[train-ckpt]``: the smoke model through ``launch.train.run`` on
    the card, 12 steps with a checkpoint every 4 and a fault at step 7,
    against the same 12 steps uninterrupted: one recovery, and the final
    weights and moments allclose (R12: the checkpoint's label is the next
    step to run).  Returns the interrupted run's launches."""
    import shutil

    import torch

    from repro_torch import tree as T
    from repro_torch.launch import train
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(arch=arch, smoke=True, steps=12, batch=2, seq=32,
              ckpt_every=4, power_every=0, seed=seed, device=device)
    clean = train.run(train.TrainJob(**kw))
    reset_counters()
    hit = train.run(train.TrainJob(ckpt_dir=str(ckpt_dir), fail_at=(7,),
                                   **kw))
    launched = read_counters()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(hit["recoveries"] == 1 and hit["steps_run"] == 15,
          f"train-ckpt: {hit['recoveries']} recoveries, {hit['steps_run']} "
          "steps run")
    pairs = list(zip(T.leaves(clean["params"]) + T.leaves(clean["opt_state"]),
                     T.leaves(hit["params"]) + T.leaves(hit["opt_state"])))
    same = all(torch.equal(a, b) for a, b in pairs)
    err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    check(all(torch.allclose(a.double(), b.double(), rtol=1e-5, atol=1e-6)
              for a, b in pairs),
          f"train-ckpt: the restored run ends {err:.3e} from the "
          "uninterrupted one")
    print(f"[train-ckpt] {arch} smoke: 12 steps, checkpoint every 4, fault "
          f"at 7: recoveries={hit['recoveries']} steps_run="
          f"{hit['steps_run']} final weights and moments against the "
          f"uninterrupted run: max abs diff {err:.3e}, bit-equal={same}; "
          f"losses {hit['losses'][-1]:.6f} / {clean['losses'][-1]:.6f}",
          flush=True)
    return launched


# --------------------------------------------------------------------------
# The dry-run tooling
# --------------------------------------------------------------------------
DRYRUN_PEAK_BAR = 0.05     # the predicted peak against the measured one


def dryrun_checks(res: dict, cfg, batch: int, seq: int,
                  measured_peak: int) -> float:
    """``[dryrun]``'s checks of a traced train step: its counted
    operations equal ``train_work`` to the operation, and its predicted
    peak is within 5 % of the measured one.  Returns the peak's relative
    miss."""
    want = train_work(cfg, batch, seq)
    got = res["flops_per_device"]
    check(got == want, f"dryrun: the trace counted {got:.6e} operations "
          f"where train_work gives {want:.6e}")
    miss = res["memory"]["peak_bytes_est"] / measured_peak - 1
    check(abs(miss) <= DRYRUN_PEAK_BAR,
          f"dryrun: the predicted peak {res['memory']['peak_bytes_est']} B "
          f"is {miss:+.4f} off the measured {measured_peak} B (bar "
          f"{DRYRUN_PEAK_BAR})")
    return miss


def dryrun_cli(card: str, mesh: str = "pod") -> None:
    """``python -m repro_torch.launch.dryrun --all --mesh <mesh>`` in a
    subprocess: an ``[ok]`` for every cell of the reference's cell list,
    no ``[not-ported]``, no ``[FAIL]``, exit 0; then the roofline table
    of the cells it wrote."""
    import os

    from repro_torch.configs import registry
    from repro_torch.launch import roofline
    tag = "[dryrun]"
    out = ROOT / "artifacts" / "dryrun_torch"
    tags = {"pod": ["16x16"], "multipod": ["2x16x16"],
            "both": ["16x16", "2x16x16"]}[mesh]
    cells = registry.all_cells()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", mesh, "--out", str(out)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    count = {k: sum(line.startswith(k) for line in lines)
             for k in ("[ok]", "[not-ported]", "[FAIL]")}
    print(f"{tag} python -m repro_torch.launch.dryrun --all --mesh {mesh}: "
          f"rc={proc.returncode} ok={count['[ok]']} not_ported="
          f"{count['[not-ported]']} failed={count['[FAIL]']} wall_s="
          f"{wall:.1f} (the trace needs no card)", flush=True)
    for line in lines:
        if line.startswith(("[ok]", "[FAIL]")):
            print(f"{tag}   {line}", flush=True)
    want = {"[ok]": len(cells) * len(tags), "[not-ported]": 0, "[FAIL]": 0}
    if proc.returncode or count != want:
        print(proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0 and count == want,
          f"dryrun: the CLI gave rc {proc.returncode} and {count} where "
          f"{want} were due")
    for mesh_tag in tags:
        print(f"{tag} roofline on the {mesh_tag} mesh (H100: 989 TFLOP/s, "
              f"3.35 TB/s, 50 GB/s a card between nodes):", flush=True)
        for line in roofline.table(roofline.load_artifacts(
                str(out), mesh_tag)).splitlines():
            print(f"{tag}   {line}", flush=True)


def dryrun_phase(card: str, train: dict, arch="qwen2.5-3b", smoke=False,
                 batch=4, seq=2048, cli_mesh: str | None = "pod") -> None:
    """``[dryrun]``: the dry run of ``[train]``'s step (``arch`` at batch
    ``batch`` x ``seq``) on fake tensors on a 1 x 1 fake mesh, against
    ``[train]``'s measured numbers in ``train`` (``train_phase``'s
    ``stats``): the counted operations, the predicted peak, the roofline
    bound and the step's model FLOP utilisation; then the dry-run CLI on
    ``cli_mesh`` (None: not run)."""
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline, steps
    tag = "[dryrun]"
    cfg = registry.get_config(arch, smoke=smoke)
    spec = registry.ShapeSpec(f"train_{seq}", "train", seq, batch)
    res = steps.dryrun_cell(arch, spec, mesh_lib.make_local_mesh(
        1, 1, fake=True), multi_pod=False, smoke=smoke)
    compute, memory, _ = roofline.terms(res)
    model = roofline.model_flops_per_device(cfg, spec, 1)
    est, peak = res["memory"]["peak_bytes_est"], train["peak"]
    print(f"{tag} {cfg.name} batch={batch} seq={seq} on a 1x1 fake mesh: "
          f"trace_s={res['trace_s']:.3f} flops={res['flops_per_device']:.6e}"
          f" train_work={train_work(cfg, batch, seq):.6e} traffic_gb="
          f"{res['traffic_bytes_per_device'] / 1e9:.3f} score_traffic_gb="
          f"{res['score_traffic_bytes_per_device'] / 1e9:.3f} "
          f"argument_gb={res['memory']['argument_bytes'] / 1e9:.3f}",
          flush=True)
    print(f"{tag} peak: predicted_gb={est / 1e9:.3f} measured "
          f"max_memory_allocated_gb={peak / 1e9:.3f} (miss "
          f"{est / peak - 1:+.4f}) train_memory_gb="
          f"{train['predicted'] / 1e9:.3f}", flush=True)
    bound_by = "compute" if compute >= memory else "memory"
    mfu = model / roofline.PEAK_FLOPS_BF16 / train["step_s"]
    print(f"{tag} roofline: compute_s={compute:.4f} memory_s={memory:.4f} "
          f"bound_s={max(compute, memory):.4f} ({bound_by}) measured "
          f"step_s={train['step_s']:.4f} model_flops(6ND)={model:.4e} "
          f"mfu={mfu:.4f} card=\"{card}\"", flush=True)
    dryrun_checks(res, cfg, batch, seq, peak)
    if cli_mesh:
        dryrun_cli(card, cli_mesh)


def print_result(rows: list[dict], launches: dict[str, int], card: str,
                 device_name: str, count: int) -> None:
    """The last three lines: the per-kernel JSON object, the card's
    ``name, power.limit`` line and the ``{"ok": true, ...}`` line."""
    print(json.dumps({"kernels": [
        {"name": r["name"], "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": launches[r["name"]],
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r.get("library_ms")} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": count}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import model_api
        from repro_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc})",
              file=sys.stderr)
        return 2

    # phase 1: environment
    card = card_line()
    device_name = torch.cuda.get_device_name(0)
    print(f"[env] torch={torch.__version__} cuda={torch.version.cuda} "
          f"device={device_name} count={torch.cuda.device_count()} "
          f"nvidia-smi=\"{card}\"", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {len(build.SIGNATURES)} sources built and loaded in "
          f"{time.perf_counter() - t0:.2f} s",
          flush=True)

    # phase 3: workload and models
    t0 = time.perf_counter()
    trs, tb = build_workload(args.seed, 64, 6000, 16384, "cuda")
    lengths = [tr.n for tr in trs]
    vampire = model_api.load_estimator(str(MODEL_FILE), device="cuda")
    models = {kind: model_api.make_estimator(kind, vampire) for kind in KINDS}
    torch.cuda.synchronize()
    print(f"[workload] seed={args.seed} traces={len(trs)} "
          f"commands min={min(lengths)} max={max(lengths)} "
          f"total={sum(lengths)} batch=(T={tb.n_traces}, "
          f"N={tb.trace.cmd.shape[1]}) vendors={len(vampire.vendors)} "
          f"line_bytes={tb.trace.data.numel() * 4} "
          f"setup_s={time.perf_counter() - t0:.2f}", flush=True)

    # phase 4: kernels against their plain versions (the line kernels
    # after phase 5, whose timings then run before any profiler session)
    charge = kernel_phase(tb, models, card)
    flash = (flash_kernel_phase(args.seed, card)
             + flash_mla_kernel_phase(args.seed, card)
             + flash_cross_kernel_phase(args.seed, card)
             + flash_bwd_kernel_phase(args.seed, card))

    # phase 5: the estimation path end to end
    launches, times = e2e_phase(tb, trs, models,
                                {r["name"]: r["ms"] for r in charge + flash},
                                card)
    profile_phase(tb, models, times["vampire", "mean"], card)
    one_kernel_phase(charge)
    rows = charge + line_kernel_phase(args.seed, card) + flash
    toggles_gib_phase(args.seed, card)
    oracle_phase(models, trs)
    faults_phase(models)
    f7_phase(card)
    analysis_phase(tb, models["vampire"], card)
    autotune_phase(card)
    del tb

    # phases 6-18: the encoding study, the HBM statistics, the
    # characterization campaign, fleet scale, validation, the Section 9.3
    # applications, online recalibration, serving (GQA, MLA + MoE, Mamba2,
    # cross-attention, the encoder, the hybrid)
    paths = [study_phase(args.seed, models["vampire"], card),
             hbm_phase(args.seed, models["vampire"], card),
             campaign_phase(card), fleet_phase(card),
             mesh_phase(card, args.seed)]
    t0 = time.perf_counter()
    validation, fitted = validation_phase(card)
    t1 = time.perf_counter()
    paths += [validation, apps_phase(fitted, card)]
    t2 = time.perf_counter()
    paths.append(recal_phase(card))
    t3 = time.perf_counter()
    print(f"[phases] validation_s={t1 - t0:.3f} apps_s={t2 - t1:.3f} "
          f"recal_s={t3 - t2:.3f} (wall, kernel rows included)", flush=True)
    t0 = time.perf_counter()
    paths.append(serve_phase(args.seed, card))
    mla = serve_mla_phase(args.seed, card)
    t1 = time.perf_counter()
    paths += [mla, serve_ssm_phase(args.seed, card)]
    t2 = time.perf_counter()
    xattn, xattn_calls = serve_xattn_phase(args.seed, card)
    enc, enc_calls = serve_enc_phase(args.seed, card)
    paths += [xattn, enc, serve_hybrid_phase(args.seed, card)]
    print(f"[phases] serve+serve-mla_s={t1 - t0:.3f} serve-ssm_s="
          f"{t2 - t1:.3f} xattn+enc+hybrid_s={time.perf_counter() - t2:.3f}"
          " (wall)", flush=True)
    # phases 19-21: the train path (qwen2.5-3b at full width; every
    # config's gradients kernel against plain; R12 on the card)
    t0 = time.perf_counter()
    train = {}
    paths.append(train_phase(args.seed, card, stats=train))
    t1 = time.perf_counter()
    train_grad_phase(args.seed, card)
    t2 = time.perf_counter()
    paths.append(train_ckpt_phase(args.seed, card))
    t3 = time.perf_counter()
    # phase 22: the dry run of the train step, then of the 16 x 16 cells
    dryrun_phase(card, train)
    print(f"[phases] train_s={t1 - t0:.3f} train-grad_s={t2 - t1:.3f} "
          f"train-ckpt_s={t3 - t2:.3f} dryrun_s="
          f"{time.perf_counter() - t3:.3f} (wall)", flush=True)
    for path in paths:
        for name, c in path.items():
            launches[name] += c
    # the flash rows of other shapes: the launches of their paths at those
    # shapes (the deepseek prefill; the cross and encoder calls and the
    # Sq = 1 decode calls of llama-3.2-vision and whisper)
    launches["flash_attention_mla"] = mla["flash_attention"]
    launches["flash_attention_xattn"] = xattn_calls["cross"]
    launches["flash_attention_encoder"] = enc_calls["encoder"]
    launches["flash_attention_xdecode"] = (xattn_calls["decode"]
                                           + enc_calls["decode"])
    for r in rows:
        check(launches[r["name"]] > 0,
              f"kernel {r['name']} was not launched on a main path")
        print(f"[launches] {r['name']}: {launches[r['name']]} over the "
              f"main-path runs", flush=True)

    print_result(rows, launches, card, device_name,
                 torch.cuda.device_count())
    return 0


if __name__ == "__main__":
    sys.exit(main())
