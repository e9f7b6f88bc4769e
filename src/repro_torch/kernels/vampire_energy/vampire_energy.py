"""Wrappers and plain versions of the VAMPIRE estimation kernels.

Three CUDA kernels (``repro_torch/csrc``) split the work where the model
does:

0. :func:`batched_state` (``features.cu``) — the state kernel, run once
   per batch: ``structural_state``'s ``prev_rw`` and the packed state
   word (:func:`pack_state`) in one pass.  Replaces no TPU kernel: the
   reference's ``structural_state`` is jnp.
1. :func:`batched_features` (``features.cu``) — the param-independent
   feature kernel, run once per batch: per-line popcount and the bus-XOR
   toggle popcount against the previous RD/WR's line, which it gathers
   itself from ``structural_state``'s ``prev_rw``.  Replaces
   ``batched_features_pallas`` and the gather that fed it.
2. :func:`vampire_charge` / :func:`vampire_charge_surface`
   (``vampire_energy.cu``) — the per-vendor charge kernel over compact
   per-command inputs, reduced inside the kernel to a ``(T, V)`` matrix or
   to the ``(T, V, 64)`` structural surface.  Replace
   ``batched_energy_pallas`` (``_energy_kernel`` / ``_surface_kernel``).

Each wrapper launches its kernel for CUDA tensors (and raises on anything
it cannot take) and uses the plain PyTorch version beside it only for
tensors on the CPU.  ``<wrapper>.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.dram import (ACT, LINE_BITS, N_BANKS, RD, REF, TIMING,
                                   WR, CommandTrace, popcount_u32)
from repro_torch.core.energy_model import StructuralState, structural_state
from repro_torch.kernels import build
from repro_torch.kernels.common import (cell_index, launch_charge, on_cpu,
                                       reduce_charge, require_aligned,
                                       require_cuda)

# layout of one vendor's packed parameter row (see ops.pack_param_blocks
# and P_* in vampire_energy.cu)
SCAL_FIELDS = ("i2n", "q_actpre", "row_ones_slope", "q_ref", "i_pd",
               "io_read_ma_per_one", "io_write_ma_per_zero", "ones_quad",
               "i_pd_slow", "i_actpd", "i_sr")
P_COEFFS, P_SCAL, P_BVEC, P_SURF, P_SIZE = 0, 24, 35, 59, 123


# ---------------------------------------------------------------------------
# 0. the state kernel
# ---------------------------------------------------------------------------
def pack_state(st: StructuralState) -> torch.Tensor:
    """One int32 word per command: interleave mode (bits 0-1), background
    state (bits 2-4) and the open-bank mask before the command (bits
    8-15), as the kernels unpack it (``common.cuh``)."""
    weights = 1 << torch.arange(N_BANKS, dtype=torch.int32,
                                device=st.open_before.device)
    mask = (st.open_before.to(torch.int32) * weights).sum(
        dim=-1, dtype=torch.int32)
    return st.il_mode | (st.bg_state << 2) | (mask << 8)


def batched_state_plain(cmd, bank, col):
    """Plain version of :func:`batched_state`: ``structural_state`` and
    :func:`pack_state`."""
    zero = torch.zeros_like(cmd)
    st = structural_state(CommandTrace(cmd, bank, zero, col, None, zero))
    return st.prev_rw, pack_state(st)


def batched_state(cmd: torch.Tensor, bank: torch.Tensor, col: torch.Tensor):
    """A padded batch's ``(T, N)`` int32 command codes, banks (in
    ``[0, 8)``) and columns -> ``(prev_rw, state)``, both ``(T, N)``
    int32: ``structural_state``'s index of the previous RD/WR in the same
    trace (-1 where there is none) and :func:`pack_state`'s word of the
    state before each command."""
    if on_cpu(cmd, bank, col):
        return batched_state_plain(cmd, bank, col)
    t, n = cmd.shape
    i32 = torch.int32
    dev = require_cuda(dict(cmd=cmd, bank=bank, col=col),
                       dict(cmd=i32, bank=i32, col=i32),
                       dict(cmd=(t, n), bank=(t, n), col=(t, n)))
    prev_rw = torch.empty((t, n), dtype=i32, device=dev)
    state = torch.empty((t, n), dtype=i32, device=dev)
    lib = build.library("features")
    rc = lib.repro_state(build.ptr(cmd), build.ptr(bank), build.ptr(col),
                         build.ptr(prev_rw), build.ptr(state), t, n,
                         build.stream(dev))
    build.check(rc, "state kernel")
    batched_state.launches += 1
    return prev_rw, state


batched_state.launches = 0


# ---------------------------------------------------------------------------
# 1. the feature kernel
# ---------------------------------------------------------------------------
def batched_features_plain(data, cmd, prev_rw):
    """Plain version of :func:`batched_features` (``torch.gather`` of the
    previous RD/WR's line)."""
    ones = popcount_u32(data).sum(dim=-1).to(torch.float32)
    index = prev_rw.clamp(min=0).long()[..., None].expand(data.shape)
    prev = torch.gather(data, -2, index)
    togg = popcount_u32(torch.bitwise_xor(data, prev)).sum(dim=-1)
    take = ((cmd == RD) | (cmd == WR)) & (prev_rw >= 0)
    return ones, torch.where(take, togg.to(torch.float32), 0.0)


def batched_features(data: torch.Tensor, cmd: torch.Tensor,
                     prev_rw: torch.Tensor):
    """A padded batch's ``(T, N, 16)`` int32 line bit patterns ``data``,
    ``(T, N)`` int32 command codes ``cmd`` and ``(T, N)`` int32
    ``prev_rw`` (``structural_state``'s index of the previous RD/WR in the
    same trace, -1 where there is none) -> ``(ones, togg)``, both
    ``(T, N)`` float32: each line's popcount, and the popcount of the line
    XOR the previous RD/WR's line where the command is a RD or WR with
    one (else 0)."""
    if on_cpu(data, cmd, prev_rw):
        return batched_features_plain(data, cmd, prev_rw)
    t, n = cmd.shape
    dev = require_cuda(
        {"data": data, "cmd": cmd, "prev_rw": prev_rw},
        {"data": torch.int32, "cmd": torch.int32, "prev_rw": torch.int32},
        {"data": (t, n, 16), "cmd": (t, n), "prev_rw": (t, n)})
    require_aligned(data=data)
    ones = torch.empty((t, n), dtype=torch.float32, device=dev)
    togg = torch.empty((t, n), dtype=torch.float32, device=dev)
    lib = build.library("features")
    rc = lib.repro_features(build.ptr(data), build.ptr(cmd),
                            build.ptr(prev_rw), build.ptr(ones),
                            build.ptr(togg), t * n, n, build.stream(dev))
    build.check(rc, "features kernel")
    batched_features.launches += 1
    return ones, togg


batched_features.launches = 0


# ---------------------------------------------------------------------------
# 2. the per-vendor charge kernel
# ---------------------------------------------------------------------------
def charge_plain(ones, togg, cmd, bank, row, dt, state, w, params):
    """The per-command masked charge of every vendor -> ``(V, T, N)``:
    the arithmetic of ``masked_charge`` in ``vampire_energy.cu``."""
    v = params.shape[0]
    coeffs = params[:, P_COEFFS:P_SCAL].reshape(v, 4, 2, 3)
    sc = params[:, P_SCAL:P_BVEC].reshape(v, 11, 1, 1)
    (i2n, q_act, slope, q_ref, i_pd, io_r, io_w, quad, i_pd_slow, i_actpd,
     i_sr) = sc.unbind(1)
    delta = params[:, P_BVEC:P_BVEC + 8]
    rd_fac = params[:, P_BVEC + 8:P_BVEC + 16]
    wr_fac = params[:, P_BVEC + 16:P_SURF]
    surf = params[:, P_SURF:P_SIZE]

    mode, bg, open_ = state & 3, (state >> 2) & 7, (state >> 8) & 0xFF
    bank_l = (bank & 7).long()
    cell = cell_index(bank, row).long()
    dtf = dt.to(torch.float32)
    open_bits = ((open_[..., None] >> torch.arange(8, device=state.device))
                 & 1).bool()                                   # (T, N, 8)
    bg_delta = torch.where(open_bits, delta[:, None, None, :], 0.0).sum(-1)
    i_low = torch.where(bg == 1, i_pd, torch.where(
        bg == 2, i_pd_slow, torch.where(bg == 3, i_actpd, i_sr)))
    i_bg = torch.where(bg == 0, i2n + bg_delta, i_low)         # (V, T, N)

    is_rw = (cmd == RD) | (cmd == WR)
    op = (cmd == WR).long()
    cf = coeffs[:, mode.long(), op]                            # (V, T, N, 3)
    base = cf[..., 0] + cf[..., 1] * ones + cf[..., 2] * togg
    base = base + quad * cf[..., 1] * ones * (ones / LINE_BITS - 0.5)
    fac = torch.where(op == 1, wr_fac[:, bank_l], rd_fac[:, bank_l])
    io = torch.where(op == 1, io_w * (LINE_BITS - ones), io_r * ones)
    i_rw = base * fac + io

    charge = i_bg * dtf
    burst = torch.clamp(dtf, max=float(TIMING.tBURST))
    charge = torch.where(is_rw, charge + (i_rw - i_bg) * burst, charge)
    act = q_act * (1.0 + slope * popcount_u32(row).to(torch.float32)) \
        * surf[:, cell]
    charge = torch.where(cmd == ACT, charge + act, charge)
    charge = torch.where(cmd == REF, charge + q_ref, charge)
    return charge * w


def vampire_charge_plain(ones, togg, cmd, bank, row, dt, state, w, params,
                         surface: bool = False):
    """Plain version of :func:`vampire_charge` (``surface=False``) and
    :func:`vampire_charge_surface` (``surface=True``)."""
    cw = charge_plain(ones, togg, cmd, bank, row, dt, state, w, params)
    return reduce_charge(cw, bank, row, surface)


def _launch_vampire(surface: bool, ones, togg, cmd, bank, row, dt, state, w,
                    params, config=None):
    t, n = cmd.shape
    v = params.shape[0]
    f32, i32 = torch.float32, torch.int32
    require_cuda(
        dict(ones=ones, togg=togg, cmd=cmd, bank=bank, row=row, dt=dt,
             state=state, w=w, params=params),
        dict(ones=f32, togg=f32, cmd=i32, bank=i32, row=i32, dt=i32,
             state=i32, w=f32, params=f32),
        dict(ones=(t, n), togg=(t, n), cmd=(t, n), bank=(t, n), row=(t, n),
             dt=(t, n), state=(t, n), w=(t, n), params=(v, P_SIZE)))
    lib = build.library("vampire_energy")
    fn = (lib.repro_vampire_charge_surface if surface
          else lib.repro_vampire_charge)
    planes = dict(ones=ones, togg=togg, cmd=cmd, bank=bank, row=row, dt=dt,
                  state=state, w=w)
    return launch_charge(fn, (*planes.values(), params), planes, t, n, v,
                         surface, "vampire charge kernel", "vampire_energy",
                         config)


def vampire_charge(ones, togg, cmd, bank, row, dt, state, w, params, *,
                   config: dict | None = None):
    """Masked charge of every (trace, vendor) pair -> ``(T, V)`` float32.

    Per-command inputs are ``(T, N)``: float32 ``ones``/``togg``/``w``,
    int32 ``cmd``/``bank``/``row``/``dt`` (the trace fields) and the
    packed ``state`` word (:func:`pack_state`); ``params`` is the
    ``(V, 123)`` packed parameter block (``ops.pack_param_blocks``);
    ``config`` pins the launch geometry's knobs (``kernels.autotune``)."""
    if on_cpu(ones, togg, cmd, bank, row, dt, state, w, params):
        return vampire_charge_plain(ones, togg, cmd, bank, row, dt, state, w,
                                    params)
    out = _launch_vampire(False, ones, togg, cmd, bank, row, dt, state, w,
                          params, config)
    vampire_charge.launches += 1
    return out


def vampire_charge_surface(ones, togg, cmd, bank, row, dt, state, w, params,
                           *, config: dict | None = None):
    """:func:`vampire_charge` reduced per (bank, row-band) cell ->
    ``(T, V, 64)`` float32."""
    if on_cpu(ones, togg, cmd, bank, row, dt, state, w, params):
        return vampire_charge_plain(ones, togg, cmd, bank, row, dt, state, w,
                                    params, surface=True)
    out = _launch_vampire(True, ones, togg, cmd, bank, row, dt, state, w,
                          params, config)
    vampire_charge_surface.launches += 1
    return out


vampire_charge.launches = 0
vampire_charge_surface.launches = 0
