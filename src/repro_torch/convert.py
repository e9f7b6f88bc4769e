"""Carry fitted weights from numpy (the reference's arrays or a schema-v2
file) into the port's tensors.

* :func:`power_params_from_numpy` — a ``PowerParams``'s leaves by field
  name, stacked (leading vendor axis) or not, as float32 tensors.
* :func:`params_from_fitted` — the v2 loader's transform of the stored
  fitted quantities into ``PowerParams`` leaves: float32 casts, the
  I/O-driver constants, ``ones_quad = 0`` (the fitted model is linear),
  the neutral all-ones surface when absent, and the low-power LUT entries
  defaulting to the fast power-down current ``i_pd``.
* :func:`fleet_model_from_numpy` — a whole ``FleetModel``.
* :func:`lm_params_from_jax` / :func:`lm_caches_from_jax` — the LM's
  parameters (``repro.models.lm.LM.init``'s tree, each sub-layer of the
  period stacked on a leading layer axis: GQA, MLA, Mamba2 or
  cross-attention mixers, an optional per-layer ``xattn``, an MLP, MoE
  with its nested ``shared`` experts or none; the encoder's layers
  stacked over ``n_encoder_layers``) and a prefill's decode cache (K/V,
  the MLA latent ``ckv`` and RoPE key ``kr``, Mamba2's ``state`` and
  ``conv``, the cross K/V), as numpy arrays, into the port's per-layer
  parameter dicts and stacked cache tensors.  A gradient tree has the
  parameters' structure and comes across the same way.
* :func:`adamw_state_from_jax` — the reference's AdamW state (float32
  moments or int8 ``{q, scale}`` pairs, and ``step``) into the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import params as P
from repro_torch.core.dram import N_BANKS, N_ROW_BANDS
from repro_torch.core.energy_model import PowerParams
from repro_torch.optim.adamw import is_moment_pair

# PowerParams leaves that may be absent (the NamedTuple's defaults)
_OPTIONAL = {"act_surface": 1.0, "i_pd_slow": 0.0, "i_actpd": 0.0,
             "i_sr": 0.0}


def power_params_from_numpy(leaves: dict, device="cpu") -> PowerParams:
    """``PowerParams`` from numpy leaves keyed by field name (all sharing
    one leading vendor axis, or none); the optional leaves default as the
    NamedTuple does."""
    lead = np.asarray(leaves["i2n"]).shape
    out = {}
    for name in PowerParams._fields:
        if name in leaves:
            x = np.array(leaves[name], np.float32)
        elif name == "act_surface":
            x = np.ones(lead + (N_BANKS, N_ROW_BANDS), np.float32)
        elif name in _OPTIONAL:
            x = np.full(lead, _OPTIONAL[name], np.float32)
        else:
            raise KeyError(f"PowerParams leaf {name!r} missing")
        out[name] = torch.from_numpy(x).to(device)
    return PowerParams(**out)


def params_from_fitted(fitted: dict) -> dict:
    """The stored fitted quantities of every vendor (``(V, ...)`` arrays
    keyed as in the v2 file) -> numpy ``PowerParams`` leaves, exactly as
    the reference's ``_rebuild_vendor`` + ``build_params`` builds them."""
    i_pd = np.asarray(fitted["i_pd"], np.float64)
    v = i_pd.shape[0]
    leaves = {name: np.asarray(fitted[name], np.float64) for name in
              ("datadep", "i2n", "bank_open_delta", "bank_read_factor",
               "bank_write_factor", "q_actpre", "row_ones_slope", "q_ref")}
    leaves["i_pd"] = i_pd
    leaves["io_read_ma_per_one"] = np.full(v, P.IO_DRIVER_MA_PER_ONE_READ)
    leaves["io_write_ma_per_zero"] = np.full(v, P.IO_DRIVER_MA_PER_ZERO_WRITE)
    leaves["ones_quad"] = np.zeros(v)
    leaves["act_surface"] = (
        np.asarray(fitted["act_surface"], np.float64)
        if fitted.get("act_surface") is not None
        else np.ones((v, N_BANKS, N_ROW_BANDS)))
    for name in ("i_pd_slow", "i_actpd", "i_sr"):
        leaves[name] = (np.asarray(fitted[name], np.float64)
                        if fitted.get(name) is not None else i_pd)
    return {name: leaves[name].astype(np.float32) for name in leaves}


def fleet_model_from_numpy(params: dict, band, idd_datasheet, vendor_ids,
                           device="cpu"):
    """A ``FleetModel`` from numpy: ``params`` are stacked ``PowerParams``
    leaves by name, ``band`` is ``(V, 2)``, ``idd_datasheet`` ``(V, K)``,
    ``vendor_ids`` ``(V,)``."""
    from repro_torch.core.vampire import FleetModel
    return FleetModel(
        params=power_params_from_numpy(params, device),
        band=torch.as_tensor(np.asarray(band, np.float32), device=device),
        idd_datasheet=torch.as_tensor(np.asarray(idd_datasheet, np.float32),
                                      device=device),
        vendor_ids=torch.as_tensor(np.asarray(vendor_ids, np.int32),
                                   device=device))


def _tensor(a, device="cpu") -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as JAX hands them over) as a
    tensor of the same type."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _layer_slice(tree, i: int, device):
    """Entry ``i`` of the leading axis of every leaf of a nest of dicts."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree)[i], device)


def lm_params_from_jax(params_np: dict, cfg, device="cpu") -> dict:
    """The reference LM's parameter tree (numpy leaves: ``embed``,
    ``final_norm``, optional ``unembed``, ``layers/sub{j}/{mixer, xattn,
    mlp}`` nests stacked on a leading axis over the layers ``j, j +
    period, ...``, and with an encoder ``encoder/layers/{attn, mlp}``
    stacked over its ``n_encoder_layers`` and ``encoder/final_norm``) ->
    the port's ``LM`` parameters: one dict per layer, with the parts that
    layer has."""
    layers = params_np["layers"]
    period = len(layers)
    out = {name: _tensor(params_np[name], device)
           for name in ("embed", "final_norm", "unembed")
           if name in params_np}
    out["layers"] = [
        {part: _layer_slice(tree, i // period, device)
         for part, tree in layers[f"sub{i % period}"].items()}
        for i in range(cfg.n_layers)]
    if "encoder" in params_np:
        enc = params_np["encoder"]
        out["encoder"] = {
            "layers": [_layer_slice(enc["layers"], i, device)
                       for i in range(cfg.n_encoder_layers)],
            "final_norm": _tensor(enc["final_norm"], device)}
    return out


def lm_caches_from_jax(caches_np: dict, device="cpu") -> dict:
    """A reference prefill's decode cache (numpy leaves) -> the port's:
    the same stacked tensors (K/V and scales, ``ckv``/``kr``, ``state``/
    ``conv``, cross K/V) under each ``sub{j}`` and ``sub{j}_x``, ``pos``
    as an int."""
    out = {sub: {name: _tensor(x, device) for name, x in leaves.items()}
           for sub, leaves in caches_np.items() if sub != "pos"}
    out["pos"] = int(np.asarray(caches_np["pos"]))
    return out


def _pick(tree, part: str):
    """Every int8 moment pair ``{"q", "scale"}`` of a nest of dicts
    replaced by its ``part``."""
    if is_moment_pair(tree):
        return tree[part]
    if isinstance(tree, dict):
        return {k: _pick(v, part) for k, v in tree.items()}
    return tree


def _pair_up(q, scale):
    if isinstance(q, dict):
        return {k: _pair_up(q[k], scale[k]) for k in q}
    if isinstance(q, list):
        return [_pair_up(a, b) for a, b in zip(q, scale)]
    return {"q": q, "scale": scale}


def adamw_state_from_jax(state_np: dict, cfg, device="cpu") -> dict:
    """The reference's ``adamw.init``/``update`` state (numpy leaves:
    ``m`` and ``v`` in the parameters' structure, float32 or int8 ``{q,
    scale}`` pairs, and the int32 ``step``) -> the port's, laid out as
    :func:`lm_params_from_jax` lays out the parameters."""
    out = {}
    for name in ("m", "v"):
        tree = state_np[name]
        if is_moment_pair(tree["embed"]):
            out[name] = _pair_up(
                lm_params_from_jax(_pick(tree, "q"), cfg, device),
                lm_params_from_jax(_pick(tree, "scale"), cfg, device))
        else:
            out[name] = lm_params_from_jax(tree, cfg, device)
    out["step"] = torch.tensor(int(np.asarray(state_np["step"])),
                               dtype=torch.int32, device=device)
    return out
