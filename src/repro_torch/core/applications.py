"""The paper's Section 9.3 example applications, in PyTorch.

The paper names three uses VAMPIRE enables; Section 10 develops the third
(data encodings — see ``encodings.py``).  This module implements the
first two, as ``repro.core.applications`` does:

1. **Variation-aware physical page allocation**: using the fitted
   structural model (per-bank idle/read factors, row-address-ones
   activation slope), place frequently-accessed pages in the cheapest
   (bank, row) locations and quantify the energy saved against a
   variation-oblivious allocator.

2. **Power-down scheduling**: from the fitted idle / power-down currents
   and entry/exit overheads, derive the break-even idle time per vendor
   and evaluate a timeout-based low-power policy on application traces —
   picking among fast power-down, slow power-down (DLL off) and
   self-refresh per idle-gap length (the deepest state whose exit latency
   the gap can absorb).

The remap and the policy are per-command walks on the host (the address
map and the :class:`~repro_torch.core.traces.TraceBuilder` rewrite); both
studies score their variants in one ``estimate`` call through ``impl``
(``'vectorized'`` or ``'cuda'``) on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dram, traces
from repro_torch.core.dram import (ACT, NOP, PDE, PDX, PRE, PREA, RD, TIMING,
                                   WR, host_array as _host)
from repro_torch.core.energy_model import PowerParams

_T = TIMING


# ---------------------------------------------------------------------------
# 1. Variation-aware page allocation
# ---------------------------------------------------------------------------
def rank_banks_for_reads(pp: PowerParams) -> np.ndarray:
    """Banks sorted by (read factor, idle increment): the allocator targets
    read-heavy hot pages, then open-page residency cost."""
    rf = _host(pp.bank_read_factor)
    idle = _host(pp.bank_open_delta)
    score = rf + idle / max(float(np.max(idle)), 1e-9) * 0.01
    return np.argsort(score)


def cheap_rows(n_rows: int, total_rows: int = 1 << dram.ROW_BITS
               ) -> np.ndarray:
    """Rows sorted by address popcount (activation energy grows with it)."""
    rows = np.arange(total_rows, dtype=np.int64)
    pops = np.zeros(total_rows, dtype=np.int16)
    for b in range(dram.ROW_BITS):
        pops += ((rows >> b) & 1).astype(np.int16)
    order = np.argsort(pops, kind="stable")
    return rows[order[:n_rows]]


def remap_trace(trace: dram.CommandTrace, pp: PowerParams,
                hot_frac: float = 0.25) -> dram.CommandTrace:
    """Re-map the hottest (bank, row) pages of a trace onto the cheapest
    banks/rows per the structural model.  Returns the re-mapped trace,
    its bank and row ``int32`` tensors on the trace's device.

    The remap is a pure address transformation (data untouched): exactly
    what an OS page allocator could do with VAMPIRE's structural tables.
    """
    cmd = _host(trace.cmd)
    bank = _host(trace.bank).copy()
    row = _host(trace.row).copy()

    rw = (cmd == RD) | (cmd == WR) | (cmd == ACT)
    pages, counts = np.unique(
        np.stack([bank[rw], row[rw]], axis=1), axis=0, return_counts=True)
    hot_idx = np.argsort(-counts)[:max(1, int(len(pages) * hot_frac))]
    hot_pages = pages[hot_idx]

    bank_order = rank_banks_for_reads(pp)
    target_rows = cheap_rows(len(hot_pages))
    mapping = {}
    for i, (b, r) in enumerate(hot_pages):
        nb = int(bank_order[i % len(bank_order)])
        nr = int(target_rows[i])
        mapping[(int(b), int(r))] = (nb, nr)

    # apply; non-hot pages keep their location (collisions with relocated
    # hot rows are acceptable for the study: same row ids in other banks)
    for i in range(len(cmd)):
        key = (int(bank[i]), int(row[i]))
        if key in mapping:
            bank[i], row[i] = mapping[key]

    dev = trace.device
    return trace._replace(
        bank=torch.as_tensor(bank, dtype=torch.int32, device=dev),
        row=torch.as_tensor(row, dtype=torch.int32, device=dev))


def page_allocation_study(model, app: traces.AppSpec, vendor: int,
                          n_requests: int = 800,
                          impl: str = "vectorized") -> dict:
    """A trace of ``app`` and its remap for ``model.params(vendor)``,
    scored in one ``estimate`` call through ``impl``."""
    tr = traces.app_trace(app, n_requests=n_requests)
    remapped = remap_trace(tr, model.params(vendor))
    energy = _host(model.estimate([tr, remapped], (vendor,),
                                  impl=impl).energy_pj).astype(np.float64)
    base, opt = float(energy[0, 0]), float(energy[1, 0])
    return {"app": app.name, "vendor": "ABC"[vendor],
            "baseline_pj": base, "remapped_pj": opt,
            "saving_frac": 1 - opt / base}


# ---------------------------------------------------------------------------
# 2. Power-down scheduling
# ---------------------------------------------------------------------------
def breakeven_idle_cycles(pp: PowerParams) -> float:
    """Idle cycles beyond which entering fast power-down wins.

    Cost of powering down: the PRE-all + PDE/PDX overhead cycles spent at
    i2n plus losing the open rows (one extra ACT on resume, amortized
    pessimistically as one full activate charge).  Benefit: (i2n - i_pd)
    per idle cycle.
    """
    i2n = float(pp.i2n)
    i_pd = float(pp.i_pd)
    overhead_cycles = _T.tRP + _T.tCKE + _T.tXP
    overhead_charge = overhead_cycles * i2n + float(pp.q_actpre)
    per_cycle_gain = max(i2n - i_pd, 1e-6)
    return overhead_charge / per_cycle_gain


# the resume penalty must stay small next to the idle it prices: a gap
# qualifies for a state only when it is this many exit latencies long
IDLE_EXIT_HEADROOM = 8


def select_idle_state(gap_cycles: int):
    """The deepest low-power state whose exit latency the gap can absorb
    (performance-neutral rule).  Returns (entry_cmd, exit_cmd,
    exit_cycles): self-refresh for long gaps, slow power-down (DLL off)
    for medium ones, fast power-down otherwise."""
    if gap_cycles >= IDLE_EXIT_HEADROOM * _T.tXS:
        return dram.SRE, dram.SRX, _T.tXS
    if gap_cycles >= IDLE_EXIT_HEADROOM * _T.tXPDLL:
        return dram.PDE_SLOW, PDX, _T.tXPDLL
    return PDE, PDX, _T.tXP


_ENTRY_CMDS = (PDE, dram.PDE_SLOW, dram.SRE)


def apply_powerdown_policy(trace: dram.CommandTrace,
                           timeout_cycles: int) -> dram.CommandTrace:
    """Insert {PREA, entry, NOP-dwell, exit} into idle gaps >= timeout (a
    classic timeout policy), picking the low-power state per gap length
    via :func:`select_idle_state`; gaps already powered down are left
    untouched.

    The rewrite goes through :class:`traces.TraceBuilder`, so the inserted
    PREA lands only once tRAS/tWR allow it and accesses to banks a window
    closed lazily re-activate first; when the trace carries refreshes they
    are re-placed afterwards (windows push the original schedule past
    tREFI), and the result is protocol-linted.  The result is a CPU
    trace."""
    cmd = _host(trace.cmd).tolist()
    bank = _host(trace.bank).tolist()
    row = _host(trace.row).tolist()
    col = _host(trace.col).tolist()
    dt = _host(trace.dt).tolist()
    data = _host(trace.data).view(np.uint32)

    bld = traces.TraceBuilder(pad_nop=True)
    n = len(cmd)
    in_lp = False  # inside a low-power window the trace already has
    for i in range(n):
        c = cmd[i]
        b = bank[i]
        r = row[i]
        if c in _ENTRY_CMDS:
            in_lp = True
        elif c in (PDX, dram.SRX):
            in_lp = False
        if c in (RD, WR):
            # an inserted window may have closed this bank since the
            # original schedule opened it
            bld.require_open(b, r)
        if c == ACT:
            if bld.open_row[b] == r:
                continue  # a lazy re-activation already opened it
            if bld.open_row[b] >= 0:
                bld.emit(PRE, b, dt=_T.tRP)
        gap = dt[i] - (_T.tBURST if c in (RD, WR) else 0)
        if not in_lp and c in (RD, WR, NOP) and gap >= timeout_cycles \
                and (i + 1 >= n or cmd[i + 1] not in _ENTRY_CMDS):
            # truncate this slot to its busy part, spend the gap in the
            # selected state: entry bills powered-up, the dwell rides a
            # NOP slot, the exit slot is the last billed at low power
            entry, exit_cmd, exit_dt = select_idle_state(gap)
            busy = dt[i] - gap
            dwell = max(gap - _T.tRP - _T.tCKE - exit_dt, 1)
            bld.emit(c, b, r, col[i], data[i], max(busy, 1))
            bld.emit(PREA, dt=_T.tRP)
            bld.emit(entry, dt=_T.tCKE)
            bld.emit(NOP, dt=dwell)
            bld.emit(exit_cmd, dt=exit_dt)
        else:
            bld.emit(c, b, r, col[i], data[i], dt[i])

    if dram.REF in cmd:
        # the windows stretched wall-clock time between the original
        # refreshes: rebuild the refresh schedule (lints its output)
        return traces.reschedule_refresh(bld.build())
    return bld.build("applications.apply_powerdown_policy")


def powerdown_study(model, app: traces.AppSpec, vendor: int,
                    n_requests: int = 800,
                    impl: str = "vectorized") -> dict:
    """Evaluate the VAMPIRE-derived break-even timeout against naive
    timeouts: the baseline trace and every policy variant in ONE
    ``estimate`` call through ``impl``.

    NOTE: energies are compared at equal work; the PD trace is longer in
    wall-clock (exit latencies), which the paper's second example is
    precisely about pricing correctly.
    """
    pp = model.params(vendor)
    be = breakeven_idle_cycles(pp)
    tr = traces.app_trace(app, n_requests=n_requests)
    policies = (("aggressive", max(int(be * 0.25), 8)),
                ("breakeven", max(int(be), 8)),
                ("lazy", max(int(be * 8), 8)))
    variants = [tr] + [apply_powerdown_policy(tr, timeout)
                       for _, timeout in policies]
    energy = _host(model.estimate(variants, (vendor,),
                                  impl=impl).energy_pj).astype(
                                      np.float64)[:, 0]
    base = float(energy[0])
    results = {"app": app.name, "vendor": "ABC"[vendor],
               "breakeven_cycles": be, "baseline_pj": base}
    for (name, _), var, e in zip(policies, variants[1:], energy[1:]):
        results[f"{name}_pj"] = float(e)
        results[f"{name}_saving"] = 1 - float(e) / base
        c = _host(var.cmd)
        results[f"{name}_modes"] = {
            "fast": int((c == PDE).sum()),
            "slow": int((c == dram.PDE_SLOW).sum()),
            "sr": int((c == dram.SRE).sum())}
    return results
