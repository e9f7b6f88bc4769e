"""Plain twin of the VAMPIRE kernel family: the vectorized integrator of
``repro_torch.core.energy_model`` applied pair by pair over the padded
batch (the oracle of ``ops.batched_charge_matrix`` in measured-data
mode)."""
from __future__ import annotations

import torch

from repro_torch.core.energy_model import (PowerParams, charge_from_features,
                                           extract_features, masked_cycles)


def batched_charge_ref(trace, weight, stacked: PowerParams):
    """Same contract as ``ops.batched_charge_matrix`` (measured data)."""
    charges = []
    for v in range(stacked.i2n.shape[0]):
        pp = stacked.select(v)
        c = charge_from_features(trace, extract_features(trace, pp), pp)
        charges.append((c * weight).sum(dim=-1))
    return torch.stack(charges, dim=-1), masked_cycles(trace, weight)
