"""Wrappers and plain versions of the datasheet-baseline charge kernel.

``csrc/baseline_energy.cu`` holds one kernel templated on the baseline
kind (Micron calculator, DRAMPower) and on the surface reduction; it
replaces ``baseline_energy_pallas`` (``_make_kernel`` /
``_make_surface_kernel``).  One wrapper per (kind, variant), each with its
own launch count, in :data:`WRAPPERS`; each launches its kernel for CUDA
tensors and uses the plain PyTorch version only for tensors on the CPU.

The IDD row layout is ``BASELINE_IDD_KEYS``: ``(IDD0, IDD2N, IDD2P1,
IDD3N, IDD4R, IDD4W, IDD5B, IDD2P0, IDD3P, IDD6)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.baselines_power import act_pair_charge
from repro_torch.core.dram import ACT, RD, REF, TIMING, WR
from repro_torch.kernels import build
from repro_torch.kernels.common import (launch_charge, on_cpu,
                                       reduce_charge, require_cuda)

KINDS = ("micron", "drampower")
N_IDD = 10
_T = TIMING


def charge_plain(kind: str, cmd, dt, state, w, any_act, table):
    """Per-command masked charge of every vendor -> ``(V, T, N)``: the
    arithmetic of ``masked_charge<KIND>`` in ``baseline_energy.cu``."""
    idd = table[:, :, None, None].unbind(1)            # 10 x (V, 1, 1)
    idd0, idd2n, idd2p1, idd3n, idd4r, idd4w, idd5b, idd2p0, idd3p, idd6 = idd
    bg = (state >> 2) & 7
    dtf = dt.to(torch.float32)
    i_low = torch.where(bg == 1, idd2p1, torch.where(
        bg == 2, idd2p0, torch.where(bg == 3, idd3p, idd6)))
    burst = torch.clamp(dtf, max=float(_T.tBURST))
    q_act = act_pair_charge(idd0, idd2n, idd3n)
    is_rd, is_wr = cmd == RD, cmd == WR
    if kind == "micron":
        i_bg = torch.where(bg == 0, idd3n, i_low)
        charge = i_bg * dtf
        spec_act = (bg == 0) & (any_act[:, None] != 0)
        charge = torch.where(spec_act, charge + q_act * dtf / _T.tRC, charge)
        charge = torch.where(is_rd, charge + idd4r * burst, charge)
        charge = torch.where(is_wr, charge + idd4w * burst, charge)
    elif kind == "drampower":
        open_banks = ((((state >> 8) & 0xFF)[..., None]
                       >> torch.arange(8, device=state.device)) & 1
                      ).sum(-1).to(torch.float32)
        i_bg = torch.where(bg == 0,
                           idd2n + (idd3n - idd2n) * open_banks / 8.0, i_low)
        charge = i_bg * dtf
        charge = torch.where(cmd == ACT, charge + q_act, charge)
        charge = torch.where(is_rd, charge + (idd4r - i_bg) * burst, charge)
        charge = torch.where(is_wr, charge + (idd4w - i_bg) * burst, charge)
    else:
        raise ValueError(f"unknown baseline kind {kind!r}")
    charge = torch.where(cmd == REF, charge + (idd5b - idd2n) * _T.tRFC,
                         charge)
    return charge * w


def baseline_charge_plain(kind: str, cmd, bank, row, dt, state, w, any_act,
                          table, surface: bool = False):
    """Plain version of every wrapper in :data:`WRAPPERS`."""
    cw = charge_plain(kind, cmd, dt, state, w, any_act, table)
    return reduce_charge(cw, bank, row, surface)


def _make_wrapper(kind: str, surface: bool):
    symbol = f"repro_{kind}_charge" + ("_surface" if surface else "")

    def wrapper(cmd, bank, row, dt, state, w, any_act, table):
        if on_cpu(cmd, bank, row, dt, state, w, any_act, table):
            return baseline_charge_plain(kind, cmd, bank, row, dt, state, w,
                                         any_act, table, surface)
        t, n = cmd.shape
        v = table.shape[0]
        f32, i32 = torch.float32, torch.int32
        require_cuda(
            dict(cmd=cmd, bank=bank, row=row, dt=dt, state=state, w=w,
                 any_act=any_act, table=table),
            dict(cmd=i32, bank=i32, row=i32, dt=i32, state=i32, w=f32,
                 any_act=f32, table=f32),
            dict(cmd=(t, n), bank=(t, n), row=(t, n), dt=(t, n),
                 state=(t, n), w=(t, n), any_act=(t,), table=(v, N_IDD)))
        fn = getattr(build.library("baseline_energy"), symbol)
        planes = dict(cmd=cmd, bank=bank, row=row, dt=dt, state=state, w=w)
        out = launch_charge(fn, (*planes.values(), any_act, table), planes,
                            t, n, v, surface, f"{kind} charge kernel")
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = symbol[len("repro_"):]
    wrapper.__doc__ = (
        f"Masked {kind} charge of every (trace, vendor) pair -> "
        + ("``(T, V, 64)`` per (bank, row-band) cell" if surface
           else "``(T, V)``")
        + ".  Per-command inputs are ``(T, N)`` int32 trace fields, the "
        "packed ``state`` word and float32 ``w``; ``any_act`` is ``(T,)`` "
        "float32, ``table`` the ``(V, 10)`` float32 IDD rows.")
    wrapper.launches = 0
    return wrapper


#: (kind, surface) -> wrapper
WRAPPERS = {(kind, surface): _make_wrapper(kind, surface)
            for kind in KINDS for surface in (False, True)}
