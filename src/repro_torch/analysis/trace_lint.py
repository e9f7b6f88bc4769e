"""Declarative JEDEC-style DRAM protocol linter over command traces.

Every timing and state rule a trace generator must obey is a registered
:class:`TimingRule`, evaluated by three interchangeable engines:

* :func:`lint_trace` — vectorized numpy over one trace, the
  construction-time hook the generators call through
  :func:`check_generated`;
* :func:`lint_batch` / :func:`lint_traces` — a whole padded ``(T, N)``
  batch in one pass of the same rule formulas over torch tensors on the
  traces' device (the reference's jitted ``vmap``), for serving
  admission (:func:`lint_ingested`);
* :func:`reference_lint` — an independent per-command Python walk kept as
  the parity oracle.

All return structured :class:`Diagnostic` records (rule id, command
index, bank, severity, deficit in cycles) instead of a bare raise.  A port
of ``repro.analysis.trace_lint``: the same rules, the same diagnostics.

Rule semantics
--------------
Command *i* issues at ``t[i] = sum(dt[:i])``; ``dt`` is the cycles the slot
owns, so a dt=0 NOP is exactly invisible (the padding contract).  Every
rule sees only state from commands strictly before *i* ("last event time"
tables built by exclusive cumulative max — valid because ``t`` is
monotone; open/background-state questions use event *indices* so dt=0 ties
resolve by program order).  ``tREFI`` is a deadline on the *scheduler*, not
an interface timing, so it lints as a WARNING with one refresh-pair's worth
of slack (:data:`REFI_SLACK`); traces with no REF at all are vacuously
clean — JEDEC IDD loops measure with refresh suspended.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.dram import (ACT, CMD_NAMES, NOP, N_BANKS, PDE,
                                   PDE_SLOW, PDX, PRE, PREA, RD, REF, SRE,
                                   SRX, TIMING, WR, CommandTrace,
                                   _PDN_ILLEGAL, _SR_LEGAL, host_array)

NEG = -(1 << 30)          # "never happened" sentinel time/index
ERROR = "error"
WARNING = "warning"

# Slack on the tREFI deadline: the refresh pair's own slots (tRFC + tRP)
# plus one maximal request slot (the generators refresh after the RD/WR
# that crosses the deadline; app_trace's largest non-low-power slot is
# tBURST + 128 cycles of gap).
REFI_SLACK = TIMING.tRFC + TIMING.tRP + 160


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One rule violation at one command of one trace."""
    rule: str
    severity: str          # ERROR | WARNING
    trace_index: int
    cmd_index: int
    bank: int
    margin: int            # cycles short of the constraint (>0 = violated)
    message: str

    def __str__(self) -> str:  # pragma: no cover - formatting convenience
        return self.message


def _message(rule_id: str, cmd: int, i: int, b: int, margin: int) -> str:
    name = CMD_NAMES.get(int(cmd), str(int(cmd)))
    tail = f" (short by {margin} cycles)" if margin > 0 else ""
    return (f"{rule_id}: {name} at command #{i} bank {b} violates "
            f"{RULES[rule_id].description}{tail}")


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TimingRule:
    """A declaratively registered protocol rule.

    ``check(ctx) -> (mask, deficit, bank)``: per-command violation mask,
    cycles-short deficit, and the bank each violation charges against —
    computed with backend-agnostic array code, so a batched engine can run
    the same formula.
    """
    rule_id: str
    severity: str
    description: str
    check: Callable


RULES: dict[str, TimingRule] = {}


def rule(rule_id: str, description: str, severity: str = ERROR):
    """Decorator registering a rule's check function."""
    def deco(fn):
        RULES[rule_id] = TimingRule(rule_id, severity, description, fn)
        return fn
    return deco


# ---------------------------------------------------------------------------
# Backend adapters: the array primitives numpy and torch spell apart.  Every
# engine works on a batch: scalars per command are (T, N), per-bank tables
# (T, N, N_BANKS); the command axis is axis 1, the bank axis the last.
# ---------------------------------------------------------------------------
class _NumpyBackend:
    name = "numpy"
    xp = np

    @staticmethod
    def arange(n):
        return np.arange(n)

    @staticmethod
    def cumsum(x):
        return np.cumsum(x, axis=1)

    @staticmethod
    def astype(x, like):
        return x.astype(like.dtype)

    @staticmethod
    def take_last(tbl, idx):
        """``tbl[..., idx]`` per element: gather along the last axis."""
        return np.take_along_axis(tbl, idx, axis=-1)

    @staticmethod
    def reduce_last(x, op: str):
        """``any``, ``max`` or ``argmax`` (first on ties) over the last
        axis."""
        return getattr(x, op)(axis=-1)

    @staticmethod
    def exclusive_cummax(x):
        c = np.maximum.accumulate(x, axis=1)
        out = np.empty_like(c)
        out[:, :1] = NEG
        out[:, 1:] = c[:, :-1]
        return out

    @staticmethod
    def scatter_times(size: int, slot, times):
        """Per trace ``arr = full(size, NEG); arr[slot] = times`` with slot
        ``size - 1`` reserved as a guaranteed-NEG dump index."""
        arr = np.full((times.shape[0], size), NEG, dtype=times.dtype)
        np.put_along_axis(arr, slot, times, axis=1)
        arr[:, size - 1] = NEG
        return arr


class _TorchXp:
    """The few numpy-namespace functions the rules call, over tensors."""

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def maximum(a, b):
        return torch.maximum(a, b)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def stack(xs, axis=0):
        return torch.stack(xs, dim=axis)


class _TorchBackend:
    """The batched engine's backend: int64 tensors on the traces' device
    (the reference's ``jit(vmap(...))`` becomes a batch axis written
    out)."""
    name = "torch"
    xp = _TorchXp

    def __init__(self, device):
        self.device = device

    def arange(self, n):
        return torch.arange(n, device=self.device)

    @staticmethod
    def cumsum(x):
        return torch.cumsum(x, dim=1)

    @staticmethod
    def astype(x, like):
        return x.to(like.dtype)

    @staticmethod
    def take_last(tbl, idx):
        return torch.gather(tbl, -1, idx)

    @staticmethod
    def reduce_last(x, op: str):
        if op == "any":
            return x.any(dim=-1)
        if op == "max":
            return x.amax(dim=-1)
        return x.argmax(dim=-1)

    @staticmethod
    def exclusive_cummax(x):
        c = torch.cummax(x, dim=1).values
        return torch.cat([torch.full_like(c[:, :1], NEG), c[:, :-1]], dim=1)

    @staticmethod
    def scatter_times(size: int, slot, times):
        arr = torch.full((times.shape[0], size), NEG, dtype=times.dtype,
                         device=times.device)
        arr.scatter_(1, slot, times)
        arr[:, size - 1] = NEG
        return arr


# ---------------------------------------------------------------------------
# Context: every derived table the rules read, built in one vectorized pass
# ---------------------------------------------------------------------------
class _Ctx:
    """Rule-evaluation context of a (T, N) batch (plain attribute bag)."""

    def __init__(self, cmd, bank, dt, backend):
        B = backend
        xp = B.xp
        self.B = B
        self.xp = xp
        self.T = TIMING
        n = cmd.shape[1]
        self.n = n
        self.cmd = cmd
        self.bank = bank
        self.dt = dt
        idx = B.arange(n)
        self.t = B.cumsum(dt) - dt                    # issue time of slot i

        self.is_act = cmd == ACT
        self.is_pre = cmd == PRE
        self.is_prea = cmd == PREA
        self.is_rd = cmd == RD
        self.is_wr = cmd == WR
        self.is_rw = self.is_rd | self.is_wr
        self.is_ref = cmd == REF
        self.nonnop = cmd != NOP

        onehot = bank[..., None] == B.arange(N_BANKS)
        act_b = self.is_act[..., None] & onehot
        close_b = (self.is_pre[..., None] & onehot) | self.is_prea[..., None]
        wr_b = self.is_wr[..., None] & onehot
        rd_b = self.is_rd[..., None] & onehot
        self.close_b = close_b

        def last_t(ev):
            return B.exclusive_cummax(xp.where(ev, self.t, NEG))

        def last_t_b(ev_b):
            return B.exclusive_cummax(xp.where(ev_b, self.t[..., None], NEG))

        def last_i(ev):
            return B.exclusive_cummax(xp.where(ev, idx, -1))

        def last_i_b(ev_b):
            return B.exclusive_cummax(xp.where(ev_b, idx[:, None], -1))

        def own(tbl):
            return B.take_last(tbl, bank[..., None])[..., 0]

        # per-bank last-event time tables (strictly before i) + own gathers
        self.t_act_b = last_t_b(act_b)
        self.t_wr_b = last_t_b(wr_b)
        self.t_rd_b = last_t_b(rd_b)
        self.t_act_own = own(self.t_act_b)
        self.t_close_own = own(last_t_b(close_b))

        # bank open state before i: index-based so dt=0 ties keep order
        self.open_b = last_i_b(act_b) > last_i_b(close_b)
        self.open_own = own(self.open_b)

        # any-bank scalars
        self.t_act_any = last_t(self.is_act)
        self.t_wr_any = last_t(self.is_wr)
        self.t_rw_any = last_t(self.is_rw)
        self.t_ref = last_t(self.is_ref)

        # background-state machine (power-down / self-refresh)
        is_pde = cmd == PDE
        is_pds = cmd == PDE_SLOW
        is_pdx = cmd == PDX
        is_sre = cmd == SRE
        is_srx = cmd == SRX
        self.in_pdn = last_i(is_pde | is_pds) > last_i(is_pdx)
        self.in_sr = last_i(is_sre) > last_i(is_srx)
        self.t_pdx = last_t(is_pdx)
        self.t_srx = last_t(is_srx)
        # a PDX exiting a SLOW power-down needs the DLL relock (tXPDLL)
        slow_entry = last_i(is_pds) > last_i(is_pde)
        self.t_pdx_slow = last_t(is_pdx & slow_entry)

        # tFAW: time of the 4th-previous ACT (rolling four-activate window)
        k = B.cumsum(B.astype(self.is_act, self.t))
        slot = xp.where(self.is_act, k - 1, n)
        act_times = B.scatter_times(n + 1, slot, self.t)
        gather = xp.where(self.is_act & (k >= 5), k - 5, n)
        self.t_act_4ago = B.take_last(act_times, gather)


# ---------------------------------------------------------------------------
# The rules (check(ctx) -> (mask, deficit, bank))
# ---------------------------------------------------------------------------
def _scalar(ctx, base, req):
    """Helper for rules on the command's own bank: violated when the base
    condition holds and the command issues before ``req``."""
    deficit = req - ctx.t
    return base & (deficit > 0), deficit, ctx.bank


def _per_bank(ctx, viol_b, deficit_b):
    """Helper for close-side rules that can violate on any bank at once:
    report the worst-deficit bank (first such bank on ties)."""
    deficit_b = ctx.xp.where(viol_b, deficit_b, 0)
    B = ctx.B
    return (B.reduce_last(viol_b, "any"), B.reduce_last(deficit_b, "max"),
            B.astype(B.reduce_last(deficit_b, "argmax"), ctx.bank))


@rule("tRCD", "RD/WR before the bank's activate completed (tRCD)")
def _r_trcd(c):
    mask, deficit, bank = _scalar(c, c.is_rw, c.t_act_own + c.T.tRCD)
    return mask & c.open_own, deficit, bank


@rule("tRP", "ACT before the bank's precharge completed (tRP)")
def _r_trp(c):
    return _scalar(c, c.is_act, c.t_close_own + c.T.tRP)


@rule("tRAS", "precharge before the bank's row was open tRAS cycles")
def _r_tras(c):
    req = c.t_act_b + c.T.tRAS
    viol = c.close_b & c.open_b & (c.t[..., None] < req)
    return _per_bank(c, viol, req - c.t[..., None])


@rule("tRC", "ACT-to-ACT on one bank inside tRC")
def _r_trc(c):
    return _scalar(c, c.is_act, c.t_act_own + c.T.tRC)


@rule("tRRD", "ACT-to-ACT across banks inside tRRD")
def _r_trrd(c):
    return _scalar(c, c.is_act, c.t_act_any + c.T.tRRD)


@rule("tFAW", "fifth ACT inside the rolling four-activate window (tFAW)")
def _r_tfaw(c):
    return _scalar(c, c.is_act, c.t_act_4ago + c.T.tFAW)


@rule("tWR", "precharge inside the write-recovery window (tWR)")
def _r_twr(c):
    req = c.t_wr_b + c.T.tBURST + c.T.tWR
    viol = c.close_b & c.open_b & (c.t[..., None] < req)
    return _per_bank(c, viol, req - c.t[..., None])


@rule("tRTP", "precharge inside the read-to-precharge window (tRTP)")
def _r_trtp(c):
    req = c.t_rd_b + c.T.tRTP
    viol = c.close_b & c.open_b & (c.t[..., None] < req)
    return _per_bank(c, viol, req - c.t[..., None])


@rule("tWTR", "read inside the write-to-read turnaround (tWTR)")
def _r_twtr(c):
    return _scalar(c, c.is_rd, c.t_wr_any + c.T.tBURST + c.T.tWTR)


@rule("tCCD", "column command inside the column-to-column window (tCCD)")
def _r_tccd(c):
    return _scalar(c, c.is_rw, c.t_rw_any + c.T.tCCD)


@rule("tRFC", "command issued while a refresh was still in flight (tRFC)")
def _r_trfc(c):
    return _scalar(c, c.nonnop, c.t_ref + c.T.tRFC)


@rule("tXP", "command issued inside the power-down exit latency (tXP)")
def _r_txp(c):
    return _scalar(c, c.nonnop, c.t_pdx + c.T.tXP)


@rule("tXPDLL", "RD/WR before the DLL relocked after a slow power-down "
                "exit (tXPDLL)")
def _r_txpdll(c):
    return _scalar(c, c.is_rw, c.t_pdx_slow + c.T.tXPDLL)


@rule("tXS", "command issued inside the self-refresh exit latency (tXS)")
def _r_txs(c):
    return _scalar(c, c.nonnop, c.t_srx + c.T.tXS)


@rule("BANK_RW_CLOSED", "RD/WR to a bank with no open row")
def _r_rw_closed(c):
    mask = c.is_rw & ~c.open_own
    return mask, c.xp.where(mask, 1, 0), c.bank


@rule("BANK_ACT_OPEN", "ACT to a bank that already has an open row")
def _r_act_open(c):
    mask = c.is_act & c.open_own
    return mask, c.xp.where(mask, 1, 0), c.bank


@rule("REF_BANK_OPEN", "REF issued with banks still open")
def _r_ref_open(c):
    viol = c.is_ref[..., None] & c.open_b
    return _per_bank(c, viol, c.xp.where(viol, 1, 0))


@rule("PDN_ILLEGAL_CMD", "command not legal during power-down")
def _r_pdn(c):
    illegal = c.cmd == _PDN_ILLEGAL[0]
    for code in _PDN_ILLEGAL[1:]:
        illegal = illegal | (c.cmd == code)
    mask = c.in_pdn & illegal
    return mask, c.xp.where(mask, 1, 0), c.bank


@rule("SR_ILLEGAL_CMD", "command not legal during self-refresh")
def _r_sr(c):
    legal = c.cmd == _SR_LEGAL[0]
    for code in _SR_LEGAL[1:]:
        legal = legal | (c.cmd == code)
    mask = c.in_sr & ~legal
    return mask, c.xp.where(mask, 1, 0), c.bank


@rule("DT_NEGATIVE", "command slot owns a negative number of cycles")
def _r_dt(c):
    mask = c.dt < 0
    return mask, c.xp.where(mask, -c.dt, 0), c.bank


@rule("tREFI", "refresh arrived past the tREFI deadline (plus scheduling "
               "slack)", severity=WARNING)
def _r_trefi(c):
    anchor = c.xp.maximum(c.xp.maximum(c.t_ref, c.t_srx),
                          c.xp.zeros_like(c.t))
    deadline = anchor + c.T.tREFI + REFI_SLACK
    deficit = c.t - deadline
    return c.is_ref & (deficit > 0), deficit, c.bank


_RULE_ORDER: tuple[str, ...] = tuple(RULES)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------
def _eval_rules(cmd, bank, dt, backend):
    """(T, R, N) stacked (mask, deficit, bank) over every registered rule
    for a (T, N) batch."""
    ctx = _Ctx(cmd, bank, dt, backend)
    xp = ctx.xp
    masks, deficits, banks = [], [], []
    for rid in _RULE_ORDER:
        m, d, b = RULES[rid].check(ctx)
        masks.append(m)
        deficits.append(xp.where(m, d, 0))
        banks.append(b)
    return (xp.stack(masks, axis=1), xp.stack(deficits, axis=1),
            xp.stack(banks, axis=1))


def _extract(mask, deficit, bank, cmd, trace_index: int) -> list[Diagnostic]:
    out = []
    rule_rows, cmd_idx = np.nonzero(mask)
    for r, i in zip(rule_rows.tolist(), cmd_idx.tolist()):
        rid = _RULE_ORDER[r]
        margin = int(deficit[r, i])
        b = int(bank[r, i])
        out.append(Diagnostic(rid, RULES[rid].severity, trace_index, i, b,
                              margin, _message(rid, int(cmd[i]), i, b,
                                               margin)))
    out.sort(key=lambda d: (d.trace_index, d.cmd_index,
                            _RULE_ORDER.index(d.rule)))
    return out


def lint_trace(trace: CommandTrace, trace_index: int = 0) -> list[Diagnostic]:
    """Lint one trace with the numpy engine (the construction-time hook)."""
    cmd, bank, dt = _host(trace.cmd), _host(trace.bank), _host(trace.dt)
    mask, deficit, bank_r = _eval_rules(cmd[None], bank[None], dt[None],
                                        _NumpyBackend)
    return _extract(mask[0], deficit[0], bank_r[0], cmd, trace_index)


def lint_arrays_batched(cmd, bank, dt) -> list[Diagnostic]:
    """Lint a padded (T, N) command batch in one pass of the torch engine
    on the tensors' device (numpy arrays run on the CPU)."""
    cmd, bank, dt = (torch.as_tensor(x).to(torch.int64)
                     for x in (cmd, bank, dt))
    mask, deficit, bank_r = _eval_rules(cmd, bank, dt,
                                        _TorchBackend(cmd.device))
    mask, deficit, bank_r, cmd = (x.cpu().numpy()
                                  for x in (mask, deficit, bank_r, cmd))
    out = []
    for ti in range(mask.shape[0]):
        out.extend(_extract(mask[ti], deficit[ti], bank_r[ti], cmd[ti], ti))
    return out


def lint_batch(tb) -> list[Diagnostic]:
    """Lint a prebuilt :class:`~repro_torch.core.estimate_batch.TraceBatch`
    in one batched pass.  NOP/dt=0 padding is inert under every rule, so
    no weight masking is needed — pad rows simply cannot violate
    anything."""
    return lint_arrays_batched(tb.trace.cmd, tb.trace.bank, tb.trace.dt)


def lint_traces(traces: Sequence[CommandTrace]) -> list[Diagnostic]:
    """Lint a sequence of ragged traces through the batched engine on the
    first trace's device, padding the length to the next power of two (the
    reference's shape vocabulary).

    Only the three fields the rules read are padded (one allocation each):
    the NOP/dt=0 pad rows are inert under every rule."""
    traces = list(traces)
    if not traces:
        return []
    longest = max(int(tr.n) for tr in traces)
    length = 1 << max(longest - 1, 1).bit_length()
    dev = traces[0].device
    fields = [torch.zeros((len(traces), length), dtype=torch.int64,
                          device=dev) for _ in range(3)]   # NOP == 0
    for i, tr in enumerate(traces):
        for buf, x in zip(fields, (tr.cmd, tr.bank, tr.dt)):
            buf[i, :int(tr.n)] = x.to(dev)
    return lint_arrays_batched(*fields)


# ---------------------------------------------------------------------------
# Reference engine: an independent per-command Python walk (parity oracle)
# ---------------------------------------------------------------------------
def reference_lint(trace: CommandTrace,
                   trace_index: int = 0) -> list[Diagnostic]:
    """Per-command reference checker, deliberately implemented as a plain
    state-machine walk sharing nothing with the vectorized engine beyond
    the rule table — the parity tests pin the two against each other."""
    T = TIMING
    cmd = _host(trace.cmd).tolist()
    bank = _host(trace.bank).tolist()
    dts = _host(trace.dt).tolist()
    out: list[Diagnostic] = []

    act_t = [NEG] * N_BANKS
    close_t = [NEG] * N_BANKS
    wr_t = [NEG] * N_BANKS
    rd_t = [NEG] * N_BANKS
    open_b = [False] * N_BANKS
    act_times: list[int] = []
    last_act = last_wr = last_rw = NEG
    last_ref = last_pdx = last_pdx_slow = last_srx = NEG
    in_pdn = in_sr = False
    slow_entry = False
    t = 0

    def add(rid, i, b, margin):
        out.append(Diagnostic(rid, RULES[rid].severity, trace_index, i,
                              int(b), int(margin),
                              _message(rid, cmd[i], i, int(b), int(margin))))

    def worst_open(i, targets, ref_t, lead, rid):
        deficit, at = 0, -1
        for b in targets:
            if open_b[b] and t < ref_t[b] + lead:
                d = ref_t[b] + lead - t
                if d > deficit:
                    deficit, at = d, b
        if at >= 0:
            add(rid, i, at, deficit)

    for i in range(len(cmd)):
        c, b, d = cmd[i], bank[i], dts[i]
        if d < 0:
            add("DT_NEGATIVE", i, b, -d)
        if c != NOP:
            if t < last_ref + T.tRFC:
                add("tRFC", i, b, last_ref + T.tRFC - t)
            if t < last_pdx + T.tXP:
                add("tXP", i, b, last_pdx + T.tXP - t)
            if t < last_srx + T.tXS:
                add("tXS", i, b, last_srx + T.tXS - t)
        if in_pdn and c in _PDN_ILLEGAL:
            add("PDN_ILLEGAL_CMD", i, b, 1)
        if in_sr and c not in _SR_LEGAL:
            add("SR_ILLEGAL_CMD", i, b, 1)

        if c == ACT:
            if open_b[b]:
                add("BANK_ACT_OPEN", i, b, 1)
            if t < close_t[b] + T.tRP:
                add("tRP", i, b, close_t[b] + T.tRP - t)
            if t < act_t[b] + T.tRC:
                add("tRC", i, b, act_t[b] + T.tRC - t)
            if t < last_act + T.tRRD:
                add("tRRD", i, b, last_act + T.tRRD - t)
            if len(act_times) >= 4 and t < act_times[-4] + T.tFAW:
                add("tFAW", i, b, act_times[-4] + T.tFAW - t)
            act_t[b] = t
            open_b[b] = True
            last_act = t
            act_times.append(t)
        elif c in (RD, WR):
            if not open_b[b]:
                add("BANK_RW_CLOSED", i, b, 1)
            elif t < act_t[b] + T.tRCD:
                add("tRCD", i, b, act_t[b] + T.tRCD - t)
            if t < last_rw + T.tCCD:
                add("tCCD", i, b, last_rw + T.tCCD - t)
            if t < last_pdx_slow + T.tXPDLL:
                add("tXPDLL", i, b, last_pdx_slow + T.tXPDLL - t)
            if c == RD:
                if t < last_wr + T.tBURST + T.tWTR:
                    add("tWTR", i, b, last_wr + T.tBURST + T.tWTR - t)
                rd_t[b] = t
            else:
                wr_t[b] = t
                last_wr = t
            last_rw = t
        elif c in (PRE, PREA):
            targets = range(N_BANKS) if c == PREA else (b,)
            worst_open(i, targets, act_t, T.tRAS, "tRAS")
            worst_open(i, targets, wr_t, T.tBURST + T.tWR, "tWR")
            worst_open(i, targets, rd_t, T.tRTP, "tRTP")
            for tb in targets:
                close_t[tb] = t
                open_b[tb] = False
        elif c == REF:
            for ob in range(N_BANKS):
                if open_b[ob]:
                    add("REF_BANK_OPEN", i, ob, 1)
                    break
            anchor = max(last_ref, last_srx, 0)
            if t > anchor + T.tREFI + REFI_SLACK:
                add("tREFI", i, b, t - (anchor + T.tREFI + REFI_SLACK))
            last_ref = t
        elif c == PDE:
            in_pdn = True
            slow_entry = False
        elif c == PDE_SLOW:
            in_pdn = True
            slow_entry = True
        elif c == PDX:
            last_pdx = t
            if slow_entry:
                last_pdx_slow = t
            in_pdn = False
        elif c == SRE:
            in_sr = True
        elif c == SRX:
            in_sr = False
            last_srx = t
        t += d
    out.sort(key=lambda di: (di.trace_index, di.cmd_index,
                             _RULE_ORDER.index(di.rule)))
    return out


# ---------------------------------------------------------------------------
# Policy surface: how producers/consumers consume the diagnostics
# ---------------------------------------------------------------------------
class TraceProtocolError(ValueError):
    """A trace violated ERROR-severity protocol rules.  Carries the
    structured diagnostics so callers (serving ingestion, tests) can match
    on rule id / command index instead of parsing the message."""

    def __init__(self, diagnostics: Sequence[Diagnostic], origin: str = ""):
        self.diagnostics = tuple(diagnostics)
        self.origin = origin
        shown = [d.message for d in self.diagnostics[:8]]
        if len(self.diagnostics) > len(shown):
            shown.append(f"... {len(self.diagnostics) - len(shown)} more")
        super().__init__(
            f"protocol-illegal trace from {origin or 'caller'}: "
            f"{len(self.diagnostics)} violation(s)\n  " + "\n  ".join(shown))


def errors_of(diags: Sequence[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def _host(x) -> np.ndarray:
    """A trace field as a host int64 array."""
    return host_array(x).astype(np.int64)


def check_generated(trace: CommandTrace, origin: str) -> CommandTrace:
    """The strict construction-time guard every generator calls on its
    output: raises :class:`TraceProtocolError` on ERROR diagnostics, warns
    on WARNING ones, and passes the trace through.  Set
    ``REPRO_TRACE_LINT=off`` to disable (e.g. when intentionally producing
    broken traces to study)."""
    if os.environ.get("REPRO_TRACE_LINT", "").lower() == "off":
        return trace
    diags = lint_trace(trace)
    errors = errors_of(diags)
    if errors:
        raise TraceProtocolError(errors, origin)
    for d in diags:
        warnings.warn(f"[{origin}] {d.message}", stacklevel=3)
    return trace


def check_trace(trace: CommandTrace, origin: str = "make_trace",
                mode: str = "strict") -> list[Diagnostic]:
    """The opt-in ``dram.make_trace`` hook (``REPRO_TRACE_LINT=warn|strict``):
    lint a construction, warn or raise per ``mode``."""
    diags = lint_trace(trace)
    if mode == "strict":
        errors = errors_of(diags)
        if errors:
            raise TraceProtocolError(errors, origin)
    for d in diags:
        warnings.warn(f"[{origin}] {d.message}", stacklevel=3)
    return diags


def lint_ingested(traces: Sequence[CommandTrace],
                  origin: str = "ingestion") -> None:
    """Strict batched gate for externally ingested traces (the serving
    ``--power-report`` path): one batched lint over the whole sequence,
    raising with rule id + command index on any ERROR."""
    errors = errors_of(lint_traces(traces))
    if errors:
        raise TraceProtocolError(errors, origin)
