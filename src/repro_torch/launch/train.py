"""The trainer: checkpointed, fault-tolerant, power-monitored.

A port of ``repro.launch.train``.  It trains any of the ten
architectures with the step functions of :mod:`repro_torch.launch.steps`
(``LM.loss`` with per-layer recomputation, attention through the
flash-attention kernels in both directions, AdamW with float32 or int8
moments), the deterministic restartable data pipeline, atomic keep-K
asynchronous checkpoints with a restore-on-fault retry loop, straggler
monitoring, and a per-step HBM energy estimate from the paper's model.

Checkpoints are labelled with the next step to run, so a restored run
equals an uninterrupted one (the reference labels the state after step
``s`` with ``s`` and runs that step again after a restore: ROADMAP R12).

Usage (the smoke widths on the CPU; on the card, drop ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/ckpt --fail-at 17
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --no-smoke --steps 5 --batch 4 --seq 2048 --power-every 1

Weights are random, drawn from ``--seed`` by a ``torch.Generator``.

``--data`` or ``--model`` above 1 trains on a ``(data, model)`` mesh of
processes, one card each (``torchrun``; every rank runs the same
program): the parameters are drawn whole from the seed on every rank and
placed by ``make_rules``/``specs_for`` as DTensors (so they equal the
one-process init bit for bit), AdamW's moments in the same placements,
each step's batch from ``SyntheticDataset.make_global_array`` over
``data``, and checkpoints are gathered whole and written by rank 0; a
restore places them on the mesh the run resumes on, which may differ
from the one that saved (the elastic rescale).

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2.5-3b --data 2 --model 1 --steps 4 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core import model_api
from repro_torch.data.pipeline import DataConfig, SyntheticDataset
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import tree_nbytes
from repro_torch.models import shard
from repro_torch.models.lm import LM
from repro_torch.models.meta import Spec, specs_for
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import shardings_from_specs
from repro_torch.sharding import rules as R
from repro_torch.runtime.fault import (FaultInjector, SimulatedFault,
                                       StepTimer, StragglerMonitor)


@dataclasses.dataclass
class TrainJob:
    arch: str
    smoke: bool = True
    steps: int = 50
    batch: int = 8
    seq: int = 128
    ckpt_dir: str | None = None
    ckpt_every: int = 10
    fail_at: tuple[int, ...] = ()
    data: int = 1
    model: int = 1
    power_every: int = 20
    seed: int = 0
    config: object = None       # an explicit ModelConfig overrides arch
    device: str | None = None   # cuda unless the caller names another


def train_traffic_bytes(lm: LM, params, opt_state, tokens: int) -> float:
    """The device-memory bytes one train step must move, for ``tokens``
    tokens a step (batch x sequence):

    * the weights read three times: the forward, the recompute of each
      layer under ``checkpoint`` and the backward;
    * the gradients (the weights' dtypes) written by the backward and read
      by AdamW;
    * the moments and the weights read and written by AdamW;
    * the saved layer inputs (``n_layers`` x tokens x ``d_model`` in the
      config dtype) written in the forward and read in the backward;
    * the float32 logits (tokens x ``vocab_padded``) written and read, and
      their gradient written and read.

    The reference counts the compiled step's HLO traffic instead."""
    cfg = lm.cfg
    w = tree_nbytes(params)
    moments = tree_nbytes({k: v for k, v in opt_state.items()
                           if k != "step"})
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    saved = cfg.n_layers * tokens * cfg.d_model * itemsize
    logits = tokens * cfg.vocab_padded * 4
    return float(3 * w + 2 * w + 2 * moments + 2 * w + 2 * saved
                 + 4 * logits)


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


class PowerMonitor:
    """Per-step HBM energy from the paper's data-dependent model: the
    step's traffic (:func:`train_traffic_bytes`, split 0.6 read / 0.4
    write as in the reference) with the ones and toggle fractions of the
    largest floating-point parameter's first 64 Ki elements
    (``hbm.tensor_stats``, on the card the popcount and toggle kernels).
    The HBM model comes from ``reference_vampire``'s vendor 0 unless one
    is given."""

    def __init__(self, traffic_bytes: float = 0.0, model=None):
        self.model = model
        self.read_bytes = 0.6 * traffic_bytes
        self.write_bytes = 0.4 * traffic_bytes

    def report(self, params, step_seconds: float):
        from repro_torch.core import hbm
        from repro_torch.core.vampire import reference_vampire
        leaves = [x for x in T.leaves(params)
                  if x.dtype in (torch.bfloat16, torch.float32)]
        big = max(leaves, key=lambda x: x.numel())
        if self.model is None:
            self.model = hbm.HbmEnergyModel.from_vampire(
                reference_vampire(device=big.device).params(0))
        ones, togg = hbm.tensor_stats(big[:4096] if big.dim() == 1
                                      else big.reshape(-1)[:65536])
        return hbm.step_energy(
            self.model, read_bytes=self.read_bytes,
            write_bytes=self.write_bytes, step_seconds=step_seconds,
            ones_frac=ones, toggle_frac=togg)


def _local(tree):
    """Each DTensor of ``tree`` as this rank's shard of it."""
    return T.tree_map(shard.local_of, tree)


def run(job: TrainJob) -> dict:
    device = model_api.resolve_device(job.device)
    cfg = job.config or registry.get_config(job.arch, smoke=job.smoke)
    lm = LM(cfg)
    ocfg = adamw.AdamWConfig(warmup_steps=5, decay_steps=max(job.steps, 10))
    mesh = (make_local_mesh(job.data, job.model, device=device)
            if job.data * job.model > 1 else None)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    params = lm.init(torch.Generator(device=device).manual_seed(job.seed))
    opt_state = adamw.init(params, ocfg)
    step_fn = steps_lib.make_train_step(lm, ocfg)

    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=job.seq,
                                     global_batch=job.batch,
                                     seed=job.seed + 7), device=device)
    sharded, shardings = contextlib.nullcontext, None
    local_batch = job.batch
    if mesh is not None:
        rules = R.make_rules(cfg, multi_pod=False)
        pmeta = lm.param_meta()
        specs = {"params": specs_for(pmeta, rules, mesh),
                 "opt": specs_for(adamw.state_meta(pmeta, ocfg), rules,
                                  mesh)}
        params = steps_lib.place(params, specs["params"], mesh)
        opt_state = steps_lib.place(opt_state, specs["opt"], mesh)
        shardings = shardings_from_specs(specs, mesh)
        n_data = model_api.mesh_axis(mesh, "data")
        bentry = ("data",) if job.batch % n_data == 0 else None
        local_batch = job.batch // n_data if bentry else job.batch
        if cfg.moe is not None:
            lm.moe_exec = {"dp_axes": bentry}
        sharded = implicit_replication

    def batch_of(step: int) -> dict:
        if mesh is None:
            batch = ds.global_batch(step)
        else:
            batch = ds.make_global_array(step, mesh, Spec(bentry, None))
        if cfg.aux_seq:
            aux = torch.zeros((job.batch, cfg.aux_seq, cfg.d_model),
                              dtype=getattr(torch, cfg.dtype), device=device)
            batch["aux"] = (aux if mesh is None else steps_lib.place(
                aux, Spec(bentry, None, None), mesh))
        return batch
    ckpt = (CheckpointManager(job.ckpt_dir, keep=2, async_save=True)
            if job.ckpt_dir else None)
    injector = FaultInjector(fail_at_steps=tuple(job.fail_at))
    straggler = StragglerMonitor()
    power = None

    # a checkpoint's label is the next step to run (R12)
    step = 0
    if ckpt and ckpt.latest_step() is not None:
        step = ckpt.latest_step()
        state = ckpt.restore(step, {"params": params, "opt": opt_state},
                             shardings=shardings)
        params, opt_state = state["params"], state["opt"]

    losses, seconds, energies, recoveries = [], [], [], 0
    while step < job.steps:
        batch = batch_of(step)
        try:
            injector.check(step)
            with StepTimer(device) as t, sharded():
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                loss = float(_full(metrics["loss"]))
            straggler.record(step, t.seconds)
            if power is None:
                # one device's traffic: its shards and its rows
                power = PowerMonitor(train_traffic_bytes(
                    lm, _local(params), _local(opt_state),
                    local_batch * job.seq))
            losses.append(loss)
            seconds.append(t.seconds)
            if job.power_every and step % job.power_every == 0:
                rep = power.report(_local(params), t.seconds)
                energies.append((step, rep.total_j))
            step += 1
            if ckpt and step % job.ckpt_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state},
                          extra={"loss": loss})
        except SimulatedFault:
            recoveries += 1
            if ckpt:
                ckpt.wait()
            if ckpt and ckpt.latest_step() is not None:
                restore_step = ckpt.latest_step()
                state = ckpt.restore(restore_step,
                                     {"params": params, "opt": opt_state},
                                     shardings=shardings)
                params, opt_state = state["params"], state["opt"]
                step = restore_step
            # without a checkpoint directory the step is simply retried
    if ckpt:
        ckpt.save(step, {"params": params, "opt": opt_state})
        ckpt.wait()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "step_seconds": seconds,
            "recoveries": recoveries,
            "straggler_flags": straggler.flagged, "energies": energies,
            "steps_run": len(losses), "params": params,
            "opt_state": opt_state, "power": power, "device": device}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen2.5-3b")
    p.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the reduced config (--no-smoke: published widths)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--fail-at", type=int, nargs="*", default=[])
    p.add_argument("--data", type=int, default=1,
                   help="data-parallel mesh axis size (a mesh when data x "
                        "model > 1: run under torchrun)")
    p.add_argument("--model", type=int, default=1,
                   help="model-parallel mesh axis size")
    p.add_argument("--power-every", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)
    res = run(TrainJob(arch=args.arch, smoke=args.smoke, steps=args.steps,
                       batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       fail_at=tuple(args.fail_at), data=args.data,
                       model=args.model, power_every=args.power_every,
                       seed=args.seed, device=args.device))
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    print(f"steps={res['steps_run']} final_loss={res['final_loss']:.4f} "
          f"recoveries={res['recoveries']} device={res['device']}")
    for s, e in res["energies"]:
        print(f"  step {s}: est. HBM energy {e:.3f} J/step/device")


if __name__ == "__main__":
    main()
