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
   call, and GB/s beside the time), the line kernels (popcount,
   toggle, byte LUT, BDI) bit-exact on a seeded 32 MiB bf16 tensor, with
   ``torch.take`` timed beside the byte LUT (run after phase 5);
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
   launched once per layer of the prefill.

Each main path (5 to 13) runs with the kernels' launch counts set to 0
just before it and read just after; every kernel must have been launched.
Any failed check exits non-zero.  The last lines are one JSON object of
per-kernel numbers, the card's ``name, power.limit`` line, and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import argparse
import json
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


def kernel_inputs(tb, models):
    """The per-command inputs the path hands each kernel, built by the
    same assembler steps as ``impl='cuda'``."""
    import torch

    from repro_torch.core.dram import ACT
    from repro_torch.core.energy_model import prev_lines, structural_state
    from repro_torch.kernels.vampire_energy import ops as vops
    tr, w = tb.trace, tb.weight
    t, n = tr.cmd.shape
    st = structural_state(tr)
    return dict(
        data=tr.data.reshape(t * n, -1),
        prev=prev_lines(tr.data, st).reshape(t * n, -1),
        tmask=(st.has_prev & st.is_rw).to(torch.float32).reshape(t * n),
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
    ones, togg = ve.batched_features(x["data"], x["prev"], x["tmask"])
    vargs = (ones.reshape(t, n), togg.reshape(t, n), tr.cmd, tr.bank, tr.row,
             tr.dt, x["state"], x["w"], x["params"])
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


def kernel_phase(tb, models, card: str) -> list[dict]:
    """Phase 4: every kernel against its plain version at the path's
    shapes, timed beside its bound."""
    import torch

    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    x = kernel_inputs(tb, models)
    t, n = tb.trace.cmd.shape
    m = t * n
    v = x["params"].shape[0]
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=tb.device)
    flush = flush_buf.zero_

    # features: exact
    ones, togg = ve.batched_features(x["data"], x["prev"], x["tmask"])
    p_ones, p_togg = ve.batched_features_plain(x["data"], x["prev"],
                                               x["tmask"])
    check(torch.equal(ones, p_ones) and torch.equal(togg, p_togg),
          "features kernel differs from its plain version")
    nbytes = m * (64 + 64 + 4) + 2 * m * 4
    rows = [dict(
        name="batched_features", fn=lambda: ve.batched_features(
            x["data"], x["prev"], x["tmask"]),
        plain=lambda: ve.batched_features_plain(x["data"], x["prev"],
                                                x["tmask"]),
        source="src/repro_torch/csrc/features.cu",
        replaces="src/repro/kernels/vampire_energy/vampire_energy.py:90",
        err=0.0, bound=bound(nbytes, m * 64))]
    rows += charge_rows(tb, models, x)

    for r in rows[1:]:           # the charge kernels
        got = r["fn"]()
        r["err"] = assert_close(got, r["plain"](), RTOL, r["name"])
        check(torch.equal(got, r["fn"]()),
              f"{r['name']}: two calls give different bits")
        r["bound"] = bound(r["nbytes"], r["nops"])

    for r in rows:
        r["ms"] = event_ms(r["fn"], 20, flush)
        r["plain_ms"] = event_ms(r["plain"], 5, flush)
        rate = ("" if r is rows[0] else
                f" gb_per_s={r['nbytes'] / r['ms'] / 1e6:.1f}")
        print(f"[kernel] {r['name']}: ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]}) share_of_bound="
              f"{r['bound'][0] / r['ms']:.3f}{rate} "
              f"max_abs_err={r['err']:.3e} "
              f"shape=(T={t}, N={n}, V={v}) card=\"{card}\"", flush=True)
    del flush_buf
    return rows


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


def attention_flops(bh: int, sq: int, skv: int, d: int, causal: bool) -> int:
    """Operations of Q K^T and P V over the (query, key) pairs the inputs
    need: every pair, or for causal attention the pairs with key <= query
    (top-left aligned)."""
    if causal:
        pairs = sum(min(i + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    return 4 * bh * pairs * d


def flash_kernel_phase(seed: int, card: str, device="cuda",
                       shape=(4, 16, 2, 2048, 128),
                       ragged: int = 2000,
                       wide=(4, 28, 4, 2048, 128)) -> list[dict]:
    """Phase 4, third part: the flash-attention kernel at the serving
    prefill shape ``(B, H, Kh, S, D)`` (qwen2.5-3b, batch 4, prompt 2048:
    q ``(B*H, S, D)``, k and v ``(B*Kh, S, D)``), causal bf16, against its
    plain version at atol 2e-2 and timed beside its bound and
    ``scaled_dot_product_attention``, with its rate in TFLOP/s; then, checked
    only, a ragged length (S = ``ragged``) in bf16, the prefill shape in
    float32 (atol 2e-5) and ``wide``, a group of 7 q heads per kv head
    (qwen2-7b's 28 and 4 heads at batch 4) in bf16."""
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
    errs = {}
    for name, case in cases.items():
        q, k, v = inputs(*case)
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa_ref.attention_ref(q, k, v, causal=True)
        atol = FLASH_ATOL[str(case[-1]).split(".")[-1]]
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= atol,
              f"flash_attention {name} (BH={case[0]}, BH_kv={case[1]}, "
              f"Sq={case[2]}, Skv={case[3]}, D={case[4]}, {case[5]}): max "
              f"abs err {err:.3e} beyond atol {atol}")
        errs[name] = err
        del got, want
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
    row["ms"] = event_ms(row["fn"], 20, flush)
    row["plain_ms"] = event_ms(row["plain"], 3, flush)
    row["library_ms"] = event_ms(row["library"], 20, flush)
    tflops = attention_flops(bh, sq, skv, d, True) / row["ms"] / 1e9
    print(f"[kernel] flash_attention: ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound'][0]:.4f} "
          f"({row['bound'][1]}) share_of_bound="
          f"{row['bound'][0] / row['ms']:.3f} tflops={tflops:.1f} "
          f"library_ms={row['library_ms']:.4f} (sdpa, k/v expanded) "
          f"max_abs_err={errs['prefill']:.3e} "
          f"ragged_err={errs['ragged']:.3e} f32_err={errs['float32']:.3e} "
          f"group7_err={errs['group7']:.3e} (BH={wb * wh}, "
          f"BH_kv={wb * wkh}, S={ws}) shape=(BH={bh}, S={sq}, "
          f"BH_kv={bh_kv}, D={d}, causal, bf16) card=\"{card}\"",
          flush=True)
    del flush_buf, q4, k4, v4
    return [row]


def counters():
    from repro_torch.kernels.baseline_energy import baseline_energy as be
    from repro_torch.kernels.bdi import bdi
    from repro_torch.kernels.byte_lut import byte_lut
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.popcount import popcount
    from repro_torch.kernels.toggle import toggle
    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    wrappers = [ve.batched_features, ve.vampire_charge,
                ve.vampire_charge_surface, *be.WRAPPERS.values(),
                popcount.line_ones, toggle.line_toggles,
                byte_lut.apply_lut_lines, bdi.bdi_sizes, fa.flash_attention]
    return {w.__name__: w for w in wrappers}


def reset_counters() -> None:
    for w in counters().values():
        w.launches = 0


def read_counters() -> dict[str, int]:
    return {name: w.launches for name, w in counters().items()}


def path_kernels(kind: str, mode: str) -> set[str]:
    """The kernels ``estimate(..., impl='cuda')`` must launch."""
    if kind == "vampire":
        charge = ("vampire_charge_surface" if mode == "surface"
                  else "vampire_charge")
        return {charge} | ({"batched_features"} if mode != "distribution"
                           else set())
    return {f"{kind}_charge" + ("_surface" if mode == "surface" else "")}


def leaves(rep, mode):
    return rep if mode == "range" else (rep,)


def e2e_phase(tb, trs, models, kernel_ms: dict[str, float], card: str):
    """Phase 5: the main path, through the entry point a user calls.
    Returns the launches of every kernel over the main-path runs and the
    host-clock ms of every (kind, mode) estimate."""
    import torch

    from repro_torch.core.energy_model import (prev_lines,
                                               structural_state)
    from repro_torch.core.estimate_batch import bucketed_trace_batch
    from repro_torch.kernels.vampire_energy import ops as vops
    t, n = tb.trace.cmd.shape
    total = {name: 0 for name in counters()}
    times = {}

    def bookkeeping():
        st = structural_state(tb.trace)
        prev_lines(tb.trace.data, st)
        vops.pack_state(st)

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

    from repro_torch.core.energy_model import prev_lines, structural_state
    from repro_torch.kernels.vampire_energy import ops as vops
    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    tr, w = batch.trace, batch.weight
    t, n = tr.cmd.shape
    v = stacked.i2n.shape[0]
    m = t * n
    st = structural_state(tr)
    data = tr.data.reshape(m, -1)
    prev = prev_lines(tr.data, st).reshape(m, -1)
    tmask = (st.has_prev & st.is_rw).to(torch.float32).reshape(m)
    ones, togg = ve.batched_features(data, prev, tmask)
    p_ones, p_togg = ve.batched_features_plain(data, prev, tmask)
    check(torch.equal(ones, p_ones) and torch.equal(togg, p_togg),
          f"{tag}: features kernel differs from its plain version")
    params = vops.pack_param_blocks(stacked)
    args = [ones.reshape(t, n), togg.reshape(t, n), tr.cmd, tr.bank, tr.row,
            tr.dt, vops.pack_state(st), w.contiguous(), params]
    plain_args = args[:-1] + [params[:plain_v].contiguous()]
    masked = int((w[:, :1] == 0).sum())
    rows = [("batched_features", lambda: ve.batched_features(data, prev,
                                                             tmask),
             lambda: ve.batched_features_plain(data, prev, tmask), 0.0,
             bound(m * (64 + 64 + 4) + 2 * m * 4, m * 64))]
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


def vocab_bar(got, want, vocab: int) -> tuple[float, float]:
    """Max abs difference of two logit arrays over the real vocabulary, and
    the reference's teacher-forcing bar for it (0.15 std + 0.05,
    ``tests/test_models.py``)."""
    g, w = got[..., :vocab].double(), want[..., :vocab].double()
    return (float((g - w).abs().max()),
            0.15 * (float(w.std()) + 1e-6) + 0.05)


def prefill_work(cfg, batch: int, seq: int, weight_bytes: int
                 ) -> tuple[float, str]:
    """The least time one prefill could take: the bf16 matrix products of
    every layer over ``batch * seq`` tokens, causal attention, and the
    last position's unembedding, against reading every weight once."""
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.d_head
    layer = (d * (cfg.n_heads + 2 * cfg.n_kv) * dh + cfg.n_heads * dh * d
             + 3 * d * f)
    ops = (2 * batch * seq * layer * cfg.n_layers
           + cfg.n_layers * attention_flops(batch * cfg.n_heads, seq, seq,
                                            dh, True)
           + 2 * batch * d * cfg.vocab_padded)
    return bound(weight_bytes, ops, BF16_OPS_PER_S)


def serve_phase(seed: int, card: str, device="cuda", arch="qwen2.5-3b",
                smoke=False, batch=4, prompt_len=2048,
                decode_tokens=32) -> dict[str, int]:
    """Phase 8: the serving entry point at full width through the entry point a
    user calls, then its checks on weights drawn again from the same seed.
    Returns the launches of the ``run``."""
    import dataclasses
    import functools
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    cfg = registry.get_config(arch, smoke=smoke)
    job = serve.ServeJob(arch=arch, smoke=smoke, batch=batch,
                         prompt_len=prompt_len, decode_tokens=decode_tokens,
                         seed=seed, power_report=True, power_impl="cuda",
                         device=device)
    reset_counters()
    t0 = time.perf_counter()
    res = serve.run(job)
    run_s = time.perf_counter() - t0
    launched = read_counters()
    check(launched["flash_attention"] == cfg.n_layers,
          f"serve: {launched['flash_attention']} flash-attention launches in "
          f"one prefill of {cfg.n_layers} layers")
    pw = res["power"]
    traffic = pw["traffic_bytes_per_step"]
    check(res["tokens"].shape == (batch, decode_tokens),
          f"serve: tokens of shape {res['tokens'].shape}")
    check(bool((pw["ddr_energy_pj_per_seq_step"] > 0).all())
          and pw["hbm_step_energy_uj"] > 0, "serve: energy not positive")

    lm = LM(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(seed))
    weight_bytes = serve.tree_nbytes(params)
    decode_bound = traffic / HBM_BYTES_PER_S * 1e3
    prefill_bound = prefill_work(cfg, batch, prompt_len, weight_bytes)
    print(f"[serve] {cfg.name}: layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads} kv={cfg.n_kv} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} dtype={cfg.dtype} weight_bytes={weight_bytes} "
          f"batch={batch} prompt={prompt_len} decode_tokens={decode_tokens} "
          f"run_s={run_s:.3f} card=\"{card}\"", flush=True)
    print(f"[serve] prefill_s={res['prefill_s']:.4f} prefill_bound_ms="
          f"{prefill_bound[0]:.3f} ({prefill_bound[1]}) decode_p50_ms="
          f"{res['decode_p50_ms']:.3f} decode_p99_ms="
          f"{res['decode_p99_ms']:.3f} tokens_per_s="
          f"{res['tokens_per_s']:.1f} traffic_bytes_per_step={traffic:.0f} "
          f"decode_bound_ms={decode_bound:.3f} decode_share_of_bound="
          f"{decode_bound / max(res['decode_p50_ms'], 1e-9):.3f} "
          f"flash_launches_per_prefill={launched['flash_attention']} "
          f"card=\"{card}\"", flush=True)
    svc = pw["serving"]
    print(f"[serve] power[{pw['power_model']}] impl=cuda "
          f"ddr_uj_per_token_mean={pw['ddr_energy_uj_per_token_mean']:.4f} "
          f"hbm_step_uj={pw['hbm_step_energy_uj']:.2f} "
          f"hbm_ones_frac={pw['hbm_ones_frac']:.6f} "
          f"hbm_toggle_frac={pw['hbm_toggle_frac']:.6f} "
          f"vendors={pw['vendors']} service: admitted={svc['admitted']} "
          f"dispatches={svc['dispatches']} batch_fill={svc['batch_fill']} "
          f"dispatch_p50_ms={svc['dispatch_p50_ms']:.3f} "
          f"engine_programs={svc['engine_programs']}", flush=True)

    # checks: teacher forcing, plain attention, the report's impls
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           size=(batch, prompt_len)),
                              dtype=torch.long, device=device)
    s = prompt_len - 1
    full, _ = lm.prefill(params, prompts)
    _, caches = lm.prefill(params, prompts[:, :s], max_len=prompt_len)
    step, _ = lm.decode_step(params, caches, prompts[:, s:])
    tf_err, tf_bar = vocab_bar(step, full, cfg.vocab)
    check(tf_err < tf_bar, f"serve: decode after a prefill of {s} differs "
                           f"from the prefill of {s + 1} by {tf_err:.4f} "
                           f"(bar {tf_bar:.4f})")
    plain_fn = functools.partial(fa_ops.flash_attention, use_kernel=False)
    with mock.patch.object(fa_ops, "flash_attention", plain_fn):
        plain, _ = lm.prefill(params, prompts)
    pl_err, pl_bar = vocab_bar(full, plain, cfg.vocab)
    check(pl_err < pl_bar, f"serve: the kernel's prefill differs from the "
                           f"plain attention's by {pl_err:.4f} "
                           f"(bar {pl_bar:.4f})")
    # where the time goes: a warm prefill and one decode step, profiled
    prefill_ms = wall_ms(lambda: lm.prefill(params, prompts), 3)
    device_profile(lambda: lm.prefill(params, prompts), "prefill (warm)",
                   prefill_ms, card, tag="[serve]", top=6)
    step_ms = wall_ms(lambda: lm.decode_step(params, caches,
                                             prompts[:, s:]), 5)
    device_profile(lambda: lm.decode_step(params, caches, prompts[:, s:]),
                   "decode_step", step_ms, card, tag="[serve]", top=6)
    tokens = torch.from_numpy(res["tokens"])
    step_s = max(res["decode_p50_ms"], 1e-3) * 1e-3
    reports = {impl: serve.power_report(
        dataclasses.replace(job, power_impl=impl), traffic, step, tokens,
        step_seconds=step_s) for impl in ("cuda", "vectorized")}
    got, want = (torch.from_numpy(reports[i]["ddr_energy_pj_per_seq_step"])
                 for i in ("cuda", "vectorized"))
    check(bool((got > 0).all()), "serve: power report energy not positive")
    err = assert_close(got, want, RTOL, "serve: power report cuda vs "
                                        "vectorized")
    check(reports["cuda"]["hbm_step_energy_uj"]
          == reports["vectorized"]["hbm_step_energy_uj"],
          "serve: HBM step energy differs between impls")
    print(f"[serve] checks: teacher_forcing_err={tf_err:.4f} (bar "
          f"{tf_bar:.4f}) plain_vs_kernel_err={pl_err:.4f} (bar "
          f"{pl_bar:.4f}) power cuda vs vectorized max_abs_err={err:.3e} "
          f"pJ (rtol {RTOL}) launches="
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    del params, caches
    return launched


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
    flash = flash_kernel_phase(args.seed, card)

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
    analysis_phase(tb, models["vampire"], card)
    autotune_phase(card)
    del tb

    # phases 6-13: the encoding study, the HBM statistics, the
    # characterization campaign, fleet scale, validation, the Section 9.3
    # applications, online recalibration, serving
    paths = [study_phase(args.seed, models["vampire"], card),
             hbm_phase(args.seed, models["vampire"], card),
             campaign_phase(card), fleet_phase(card)]
    t0 = time.perf_counter()
    validation, fitted = validation_phase(card)
    t1 = time.perf_counter()
    paths += [validation, apps_phase(fitted, card)]
    t2 = time.perf_counter()
    paths.append(recal_phase(card))
    t3 = time.perf_counter()
    print(f"[phases] validation_s={t1 - t0:.3f} apps_s={t2 - t1:.3f} "
          f"recal_s={t3 - t2:.3f} (wall, kernel rows included)", flush=True)
    paths.append(serve_phase(args.seed, card))
    for path in paths:
        for name, c in path.items():
            launches[name] += c
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
