"""Roofline analysis: three terms per (arch x mesh) cell, on one H100.

    compute    = flops_per_device                  / peak FLOP/s per card
    memory     = traffic_bytes_per_device          / HBM bytes/s per card
    collective = collective_total_bytes_per_device / link bytes/s per card

A port of ``repro.launch.roofline`` with an H100 SXM's constants in place
of a TPU v5e's.  The inputs are the dry run's per-device numbers
(``launch.op_analysis`` over a trace on fake tensors: eager ops, each
counted as it runs), so the traffic term counts every op's operands and
results once, with no fusion; the dominant term and before/after deltas
are what the table is for.

MODEL_FLOPS uses 6·N·D for training (N = active params for MoE) and 2·N·D
for inference forward passes; the model/counted ratio shows recompute and
padding: a train step with every layer recomputed counts ~4/3 of 6ND in
its products, so ~0.75 is expected, and values far below mean redundant
work.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

# --- NVIDIA H100 SXM constants (per card) ----------------------------------
# dense bf16 tensor-core peak, NVIDIA's data sheet (chip_smoke.BF16_OPS_PER_S)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
# HBM3 bandwidth, NVIDIA's data sheet (chip_smoke.HBM_BYTES_PER_S)
HBM_BW = 3.35e12                # B/s
# The slowest link a 16-wide mesh axis crosses: 16 cards span two 8-GPU
# NVLink nodes, joined by one 400 Gb/s InfiniBand NIC a GPU (a DGX H100's
# ConnectX-7 ports), so the collective term takes 50 GB/s a card, not
# NVLink's 450 GB/s each way.
LINK_BW = 50e9                  # B/s per card


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_device: float
    flops_per_device: float
    peak_gib: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the binding roofline that useful compute occupies:
        (model_flops / peak) / max(term). 1.0 = compute-bound at peak."""
        ideal = self.model_flops_per_device / PEAK_FLOPS_BF16
        return ideal / max(self.bound_s, 1e-30)

    @property
    def flops_ratio(self) -> float:
        return self.model_flops_per_device / max(self.flops_per_device,
                                                 1e-30)


def model_flops_per_device(cfg, shape, n_devices: int) -> float:
    """6ND (train) / 2ND (inference) useful-model FLOPs per device."""
    n_active = cfg.active_params_estimate()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices


def terms(art: dict, kernel_adjusted: bool = False
          ) -> tuple[float, float, float]:
    """(compute, memory, collective) seconds of a dry-run artifact; the
    memory term from the kernel-adjusted traffic when asked."""
    traffic = art["kernel_adjusted_traffic_bytes_per_device"
                  if kernel_adjusted else "traffic_bytes_per_device"]
    return (art["flops_per_device"] / PEAK_FLOPS_BF16, traffic / HBM_BW,
            art["collective_total_bytes_per_device"] / LINK_BW)


def from_artifact(art: dict) -> Roofline:
    from repro_torch.configs import registry
    cfg = registry.get_config(art["arch"], smoke=art.get("smoke", False))
    shape = registry.SHAPES[art["shape"]]
    compute, memory, collective = terms(art)
    return Roofline(
        arch=art["arch"], shape=art["shape"], mesh=art["mesh"],
        compute_s=compute, memory_s=memory, collective_s=collective,
        model_flops_per_device=model_flops_per_device(
            cfg, shape, art["n_devices"]),
        flops_per_device=art["flops_per_device"],
        peak_gib=art.get("memory", {}).get("peak_bytes_est", 0) / 2 ** 30,
    )


def load_artifacts(directory: str = "artifacts/dryrun_torch",
                   mesh_tag: str | None = "16x16") -> list[Roofline]:
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            art = json.load(f)
        if mesh_tag and art["mesh"] != mesh_tag:
            continue
        out.append(from_artifact(art))
    return out


def table(rows: list[Roofline]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'compute':>10s} {'memory':>10s} "
           f"{'collect':>10s} {'dominant':>10s} {'roofl%':>7s} "
           f"{'6ND/cnt':>8s} {'peakGiB':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.compute_s:10.3e} "
            f"{r.memory_s:10.3e} {r.collective_s:10.3e} {r.dominant:>10s} "
            f"{100*r.roofline_fraction:6.1f}% {r.flops_ratio:8.2f} "
            f"{r.peak_gib:8.2f}")
    return "\n".join(lines)


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="artifacts/dryrun_torch")
    p.add_argument("--mesh", default="16x16")
    args = p.parse_args()
    print(table(load_artifacts(args.dir, args.mesh)))


if __name__ == "__main__":
    main()
