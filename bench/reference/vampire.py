"""The plain reference of the VAMPIRE estimate, in PyTorch.

A frozen copy of the port's ``'vectorized'`` math (origin: commit
3b119a0): the structural pass (``repro_torch/core/energy_model.py``
``structural_state``), the data features (``extract_structural_features``:
the popcount of each line and of its XOR with the previous RD/WR's
line), the VAMPIRE charge integration (``finalize_features``,
``rw_current``, ``integrate_charges``), the surface binning
(``surface_charge``, ``surface_cycles``) and the report (``_report``).
It imports nothing of the program.  Every float operation runs in the
``dtype`` it is given: float64 for the reference, a lower precision for
the control; the integer bookkeeping is exact in int64.

A batch is a dict of ``(T, N)`` tensors ``cmd``, ``bank``, ``row``,
``col``, ``dt``, ``weight`` and ``(T, N, W)`` int32 ``data``; a set of
parameters is a dict of leaves with a leading axis of ``V`` sets
(``reference/params.py``).

Two evaluations of the same sums: :func:`estimate` integrates every
command's charge for every set, as the port's ``'vectorized'`` path
does; :func:`estimate_by_moments` first sums, per trace and (bank,
row-band) cell, the command features each parameter multiplies
(:func:`moments`: every command's charge is a sum of such products),
then weighs the sums with each set's parameters
(:func:`from_moments`).  In float64 the moments of integer features are
exact, so the two agree to float64 rounding; the second scores ten
thousand sets in a few dense products, and is what the check runs.

The check finds this module by a configuration's ``reference`` key
(``"vampire"``): it calls :func:`reports` and compares the leaves named
in ``EXACT`` and ``FLOAT``.
"""
from __future__ import annotations

import torch

from reference import params as ref_params

#: report leaves compared exactly, and by their relative gap
EXACT = ("cycles",)
FLOAT = ("charge_ma_cycles", "avg_current_ma", "energy_pj", "time_ns")
#: pool traces :func:`reports` takes at a time
ROWS = 32

ACT, PRE, RD, WR, REF, PDE, PDX, PREA, PDE_SLOW, SRE, SRX = \
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11
IL_NONE, IL_COL, IL_BANK, IL_BANKCOL = 0, 1, 2, 3
BG_ACTIVE, BG_PDN_FAST, BG_PDN_SLOW, BG_PDN_ACT, BG_SR = 0, 1, 2, 3, 4


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Ones in the low 32 bits of each element (int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _before(ev: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Index of the last event strictly before each command (-1 if none),
    along the last axis."""
    c = torch.cummax(torch.where(ev, idx, -1), dim=-1).values
    return torch.cat([torch.full_like(c[..., :1], -1), c[..., :-1]], dim=-1)


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, index.clamp(min=0))


def structure(b: dict, n_banks: int) -> dict:
    """The parameter-independent state before each command."""
    cmd, bank, col = b["cmd"].long(), b["bank"].long(), b["col"].long()
    n = cmd.shape[-1]
    idx = torch.arange(n, device=cmd.device)
    is_rw = (cmd == RD) | (cmd == WR)
    op = (cmd == WR).long()
    oh = bank[..., None, :] == torch.arange(n_banks, device=cmd.device)[:,
                                                                       None]
    last_act = _before((cmd == ACT)[..., None, :] & oh, idx)
    last_pre = _before(((cmd == PRE)[..., None, :] & oh)
                       | (cmd == PREA)[..., None, :], idx)
    open_before = (last_act > last_pre).transpose(-1, -2)     # (T, N, B)

    pdf, pds, pdx = (_before(cmd == c, idx) for c in (PDE, PDE_SLOW, PDX))
    sre, srx = _before(cmd == SRE, idx), _before(cmd == SRX, idx)
    in_pdn = torch.maximum(pdf, pds) > pdx
    any_open = open_before.any(dim=-1)
    pd_kind = torch.where(pdf >= pds,
                          torch.where(any_open, BG_PDN_ACT, BG_PDN_FAST),
                          BG_PDN_SLOW)
    bg = torch.where(sre > srx, BG_SR,
                     torch.where(in_pdn, pd_kind, BG_ACTIVE))

    prev = _before(is_rw, idx)
    has_prev = prev >= 0
    prev_bank = torch.where(has_prev, _take(bank, prev), -1)
    last_in_bank = _before(is_rw[..., None, :] & oh, idx)      # (T, B, N)
    mine = torch.gather(last_in_bank, -2, bank[..., None, :])[..., 0, :]
    col_in_bank = torch.where(mine >= 0, _take(col, mine), -1)
    same_bank = has_prev & (prev_bank == bank)
    il = torch.where(
        ~has_prev, IL_NONE,
        torch.where(same_bank,
                    torch.where(_take(col, prev) == col, IL_NONE, IL_COL),
                    torch.where((mine >= 0) & (col_in_bank == col), IL_BANK,
                                IL_BANKCOL)))

    data = b["data"]
    ones = popcount(data).sum(dim=-1)
    prev_line = torch.gather(
        data, -2, prev.clamp(min=0)[..., None].expand(data.shape))
    togg = torch.where(is_rw & has_prev,
                       popcount(data ^ prev_line).sum(dim=-1), 0)
    return dict(is_rw=is_rw, op=op, il=il, open_before=open_before, bg=bg,
                ones=ones, togg=togg, row_ones=popcount(b["row"]))


def charges(b: dict, st: dict, p: dict, dram: dict,
            dtype: torch.dtype) -> torch.Tensor:
    """Masked per-command charge (mA x cycles) of every parameter set ->
    ``(V, T, N)`` in ``dtype``."""
    f = {k: v.to(dtype) for k, v in p.items()}
    nv = f["i2n"].shape[0]

    def per_set(x):            # (V,) -> (V, 1, 1)
        return x.reshape(nv, 1, 1)

    bank = b["bank"].long()
    cmd = b["cmd"].long()
    dt = b["dt"].to(dtype)
    line_bits = float(dram["line_bytes"] * 8)
    open_f = st["open_before"].to(dtype)                       # (T, N, B)
    bg_delta = torch.einsum("tnb,vb->vtn", open_f, f["bank_open_delta"])
    i_up = per_set(f["i2n"]) + bg_delta
    bg = st["bg"]
    i_low = torch.where(bg == BG_PDN_FAST, per_set(f["i_pd"]),
                        torch.where(bg == BG_PDN_SLOW, per_set(f["i_pd_slow"]),
                                    torch.where(bg == BG_PDN_ACT,
                                                per_set(f["i_actpd"]),
                                                per_set(f["i_sr"]))))
    i_bg = torch.where(bg == BG_ACTIVE, i_up, i_low)

    op = st["op"]
    coeffs = f["datadep"][:, st["il"], op]                     # (V, T, N, 3)
    ones = st["ones"].to(dtype)
    togg = st["togg"].to(dtype)
    base = coeffs[..., 0] + coeffs[..., 1] * ones + coeffs[..., 2] * togg
    base = base + per_set(f["ones_quad"]) * coeffs[..., 1] * ones * (
        ones / line_bits - 0.5)
    factor = torch.where(op == 0, f["bank_read_factor"][:, bank],
                         f["bank_write_factor"][:, bank])
    io = torch.where(op == 0, per_set(f["io_read_ma_per_one"]) * ones,
                     per_set(f["io_write_ma_per_zero"]) * (line_bits - ones))
    i_rw = base * factor + io

    charge = i_bg * dt
    burst = torch.clamp(dt, max=float(dram["timing"]["tBURST"]))
    charge = charge + torch.where(st["is_rw"], (i_rw - i_bg) * burst, 0.0)
    band = b["row"].long() >> int(dram["row_band_shift"])
    act = per_set(f["q_actpre"]) * (1.0 + per_set(f["row_ones_slope"])
                                    * st["row_ones"].to(dtype))
    act = act * f["act_surface"][:, bank, band]
    charge = charge + torch.where(cmd == ACT, act, 0.0)
    charge = charge + torch.where(cmd == REF, per_set(f["q_ref"]), 0.0)
    return charge * b["weight"].to(dtype)


def cells(b: dict, dram: dict) -> torch.Tensor:
    """(bank, row-band) cell of every command."""
    return (b["bank"].long() * int(dram["row_bands"])
            + (b["row"].long() >> int(dram["row_band_shift"])))


def report(charge: torch.Tensor, cycles: torch.Tensor, dram: dict) -> dict:
    """The report's five leaves from total charge and cycles (cycles
    broadcast to the charge's shape)."""
    cycles = cycles.expand(charge.shape)
    cyc_f = cycles.to(charge.dtype)
    return dict(charge_ma_cycles=charge, cycles=cycles,
                avg_current_ma=charge / torch.clamp(cyc_f, min=1.0),
                energy_pj=charge * dram["tck_ns"] * dram["vdd"],
                time_ns=cyc_f * dram["tck_ns"])


def estimate(b: dict, p: dict, dram: dict, *, surface: bool,
             dtype: torch.dtype = torch.float64) -> dict:
    """The report of every (trace, parameter set) pair of the batch ``b``:
    leaves ``(T, V)``, or ``(T, V, banks, bands)`` with ``surface``."""
    st = structure(b, int(dram["banks"]))
    cw = charges(b, st, p, dram, dtype)                        # (V, T, N)
    cyc = b["dt"].long() * (b["weight"] != 0).long()
    if not surface:
        return report(cw.sum(dim=-1).T, cyc.sum(dim=-1)[:, None], dram)
    n_cells = int(dram["banks"]) * int(dram["row_bands"])
    cell = cells(b, dram)
    idx = cell[None].expand(cw.shape)
    charge = torch.zeros(cw.shape[:-1] + (n_cells,), dtype=cw.dtype,
                         device=cw.device).scatter_add_(-1, idx, cw)
    cycles = torch.zeros(cyc.shape[:-1] + (n_cells,), dtype=torch.int64,
                         device=cyc.device).scatter_add_(-1, cell, cyc)
    shape = (int(dram["banks"]), int(dram["row_bands"]))
    return report(charge.transpose(0, 1).reshape(
        (charge.shape[1], charge.shape[0]) + shape),
        cycles.reshape((cycles.shape[0], 1) + shape), dram)


# ---------------------------------------------------------------------------
# The same sums by moments
# ---------------------------------------------------------------------------
LOW_POWER = (BG_PDN_FAST, BG_PDN_SLOW, BG_PDN_ACT, BG_SR)


def moments(b: dict, dram: dict, dtype: torch.dtype = torch.float64
            ) -> dict:
    """Per trace and cell, the sums of the command features each
    parameter multiplies -> leaves ``(T, C[, K])`` in ``dtype``, and the
    cell's cycles (int64).  ``e = dt - burst`` on a RD or WR (its burst
    is billed at the RD/WR current) and ``dt`` elsewhere is the time
    billed at the background current; ``j = 2 * il + op`` indexes the
    RD/WR sums."""
    n_banks = int(dram["banks"])
    n_cells = n_banks * int(dram["row_bands"])
    st = structure(b, n_banks)
    cell = cells(b, dram)
    w = (b["weight"] != 0).to(dtype)
    dt = b["dt"].long()
    rw = st["is_rw"]
    burst = torch.clamp(dt, max=int(dram["timing"]["tBURST"])) * rw
    e = (dt - burst).to(dtype)
    burst = burst.to(dtype)

    def binned(v):
        v = v.to(dtype) * (w if v.ndim == 2 else w[..., None])
        idx = cell if v.ndim == 2 else cell[..., None].expand(v.shape)
        out = torch.zeros((v.shape[0], n_cells) + v.shape[2:], dtype=dtype,
                          device=v.device)
        return out.scatter_add_(1, idx, v)

    bg = st["bg"]
    active = (bg == BG_ACTIVE).to(dtype)
    states = torch.stack([active] + [(bg == s).to(dtype) for s in LOW_POWER],
                         dim=-1)
    j = torch.nn.functional.one_hot(2 * st["il"] + st["op"], 8).to(dtype)
    ones = st["ones"].to(dtype)
    togg = st["togg"].to(dtype)
    bits = float(dram["line_bytes"] * 8)
    curve = ones * (ones / bits - 0.5)
    jb = j * burst[..., None]
    cmd = b["cmd"].long()
    act = (cmd == ACT).to(dtype)
    cyc = b["dt"].long() * (b["weight"] != 0).long()
    return dict(
        bg=binned(states * e[..., None]),
        open=binned(st["open_before"].to(dtype)
                    * (active * e)[..., None]),
        k0=binned(jb), k1=binned(jb * ones[..., None]),
        k2=binned(jb * togg[..., None]), kq=binned(jb * curve[..., None]),
        act=binned(act), act_rows=binned(act * st["row_ones"].to(dtype)),
        ref=binned((cmd == REF).to(dtype)),
        cycles=torch.zeros((cyc.shape[0], n_cells), dtype=torch.int64,
                           device=cyc.device).scatter_add_(1, cell, cyc))


def from_moments(mo: dict, p: dict, dram: dict, *, surface: bool,
                 dtype: torch.dtype = torch.float64) -> dict:
    """The report of every (trace, parameter set) pair from the moments
    -> leaves ``(T, V)`` or ``(T, V, banks, bands)``."""
    f = {k: v.to(dtype) for k, v in p.items()}
    nv = f["i2n"].shape[0]
    n_bands = int(dram["row_bands"])
    n_cells = int(dram["banks"]) * n_bands
    dev = mo["act"].device
    bank = torch.arange(n_cells, device=dev) // n_bands
    lut = torch.stack([f["i2n"], f["i_pd"], f["i_pd_slow"], f["i_actpd"],
                       f["i_sr"]], dim=-1)                      # (V, 5)
    charge = torch.einsum("tck,vk->tvc", mo["bg"], lut)
    charge = charge + torch.einsum("tcb,vb->tvc", mo["open"],
                                   f["bank_open_delta"])
    factor = torch.stack([f["bank_read_factor"][:, bank],
                          f["bank_write_factor"][:, bank]], dim=1)
    factor = factor[:, torch.arange(8, device=dev) % 2]        # (V, 8, C)
    coef = f["datadep"].reshape(nv, 8, 3)                      # j = 2il+op
    x1 = factor * coef[..., 1, None]
    charge = charge + torch.einsum("tcj,vjc->tvc", mo["k0"],
                                   factor * coef[..., 0, None])
    charge = charge + torch.einsum("tcj,vjc->tvc", mo["k1"], x1)
    charge = charge + f["ones_quad"][None, :, None] * torch.einsum(
        "tcj,vjc->tvc", mo["kq"], x1)
    charge = charge + torch.einsum("tcj,vjc->tvc", mo["k2"],
                                   factor * coef[..., 2, None])
    bits = float(dram["line_bytes"] * 8)
    reads = mo["k1"][..., 0::2].sum(-1)
    writes = (bits * mo["k0"][..., 1::2] - mo["k1"][..., 1::2]).sum(-1)
    charge = charge + f["io_read_ma_per_one"][None, :, None] * reads[:, None]
    charge = charge + (f["io_write_ma_per_zero"][None, :, None]
                       * writes[:, None])
    surf = f["act_surface"].reshape(nv, n_cells)
    qs = f["q_actpre"][:, None] * surf                          # (V, C)
    charge = charge + mo["act"][:, None] * qs[None]
    charge = charge + (mo["act_rows"][:, None]
                       * (qs * f["row_ones_slope"][:, None])[None])
    charge = charge + mo["ref"][:, None] * f["q_ref"][None, :, None]
    cycles = mo["cycles"][:, None]
    if not surface:
        return report(charge.sum(-1), cycles.sum(-1), dram)
    shape = (int(dram["banks"]), n_bands)
    return report(charge.reshape(charge.shape[:2] + shape),
                  cycles.reshape(cycles.shape[:2] + shape), dram)


def estimate_by_moments(b: dict, p: dict, dram: dict, *, surface: bool,
                        dtype: torch.dtype = torch.float64) -> dict:
    """:func:`estimate`'s report, by :func:`moments`."""
    return from_moments(moments(b, dram, dtype), p, dram, surface=surface,
                        dtype=dtype)


def parameter_sets(root, cfg: dict, inputs) -> dict:
    """float32 numpy leaves of the configuration's parameter sets: the
    fit file's vendors, or the synthetic fleet the run made."""
    p = cfg["params"]
    d = cfg["dram"]
    if p["kind"] == "fit_file":
        return ref_params.from_fit_file(str(root / p["file"]), p["vendors"],
                                        int(d["banks"]), int(d["row_bands"]))
    if p["kind"] == "synthetic_fleet":
        return inputs.fleet
    raise ValueError(f"no parameter sets of kind {p['kind']!r}")


def reports(root, cfg: dict, mix: dict, inputs, device,
            dtype: torch.dtype = torch.float64) -> dict:
    """The report of every pool trace (``inputs.pool``) and parameter set
    -> leaves ``(P, V)`` or ``(P, V, banks, bands)`` on ``device``: the
    moments of ``ROWS`` pool traces at a time, weighed with every set."""
    p = ref_params.on_device(parameter_sets(root, cfg, inputs), device)
    pool = inputs.pool
    surface = mix["mode"] == "surface"
    parts = []
    for r0 in range(0, pool["cmd"].shape[0], ROWS):
        b = {f: torch.from_numpy(x[r0:r0 + ROWS]).to(device)
             for f, x in pool.items()}
        mo = moments(b, cfg["dram"], dtype)
        parts.append(from_moments(mo, p, cfg["dram"], surface=surface,
                                  dtype=dtype))
    return {k: torch.cat([x[k] for x in parts]) for k in parts[0]}
