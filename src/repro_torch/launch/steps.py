"""Step functions (the train step, with gradient accumulation over
microbatches, the prefill step and the decode step) and the dry-run cell
pipeline.

A port of ``repro.launch.steps``.  Gradients come from
``torch.autograd.grad`` of ``LM.loss`` with respect to detached views of
the parameters (so the caller's tensors stay leaves), and the optimizer
writes the new weights and moments into the given tensors
(``repro_torch.optim.adamw.update``).

:func:`dryrun_cell` builds the step of an (arch x shape) cell
(:func:`build_cell`), shards its parameters, optimizer state, batch and
caches by the cell plan as fake DTensors on a fake mesh
(``launch.mesh``), runs it once under a ``FakeTensorMode`` (no
allocation) and reads one device's FLOPs, traffic, collectives and peak
memory from ``launch.op_analysis``.  Where the reference lowers and
compiles a jitted program, the port traces its own eager step: the train
step updates weights and moments in place, so no donated second copy
exists to count.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.launch import op_analysis
from repro_torch.models import shard
from repro_torch.models.lm import LM
from repro_torch.models.meta import (Spec, abstractify, is_meta, mesh_shape,
                                     placements, specs_for)
from repro_torch.optim import adamw
from repro_torch.sharding import rules as R

F32 = torch.float32


def value_and_grad(lm: LM, params, batch):
    """``((loss, {"nll", "aux_loss"}), grads)`` of ``lm.loss`` at
    ``params``; the gradients have the parameters' structure and dtypes."""
    flat = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    with torch.enable_grad():
        loss, extras = lm.loss(T.unflatten_like(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
    extras = {k: v.detach() for k, v in extras.items()}
    return (loss.detach(), extras), T.unflatten_like(params, list(grads))


def _microbatch(x, k: int, i: int):
    """Microbatch ``i`` of ``k`` of ``x``'s rows; of a DTensor, of each
    device's batch shard (the reference re-pins the split batch's
    sharding), so every microbatch keeps the batch's placements."""
    if isinstance(x, DTensor):
        return DTensor.from_local(_microbatch(x.to_local(), k, i),
                                  x.device_mesh, x.placements,
                                  run_check=False)
    return x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]


def _moments(opt_state) -> list:
    """Each parameter's first moment (its int8 values where quantized), in
    leaf order: a tensor of the parameter's shape, placed as the optimizer
    state is."""
    return [m["q"] if adamw.is_moment_pair(m) else m
            for m in T.leaves(opt_state["m"], is_leaf=adamw.is_moment_pair)]


def _reduced(grads, moments):
    """Each DTensor gradient reduced once, into its moment's placements: an
    all-reduce, or a reduce-scatter onto the parameter's FSDP shards or
    ZeRO-1's data shards, as the reference's partitioner shards a
    gradient for its update.  Left partial, every op that reads it would
    reduce it again."""
    return T.unflatten_like(grads, [
        shard.constrain(g, getattr(m, "placements", None))
        for g, m in zip(T.leaves(grads), moments, strict=True)])


def _zero_sums(params, moments, grad_dtype):
    """The running sums of the microbatches: ``(grads, loss, nll, aux)``,
    the gradients placed as the moments, partial where those are
    replicated, so the microbatches' partial gradients add up unreduced
    (DTensor would otherwise choose, by torch's version, to reduce each
    one)."""
    zero = torch.zeros((), dtype=F32, device=T.leaves(params)[0].device)
    return (T.unflatten_like(params, [
        shard.as_partial(torch.zeros_like(m, dtype=grad_dtype))
        for m in moments]), zero, zero, zero)


def _add_microbatch(lm: LM, params, mb, k: int, grad_dtype, sums):
    """``sums`` plus one ``k``-th of microbatch ``mb``'s gradients (cast to
    ``grad_dtype``), loss, nll and auxiliary loss.  DTensor gradients add
    up unreduced where the sums are partial, to be reduced once by
    :func:`_update`."""
    (l_i, ex), g_i = value_and_grad(lm, params, mb)
    grads, loss, nll, aux = sums
    return (T.tree_map(lambda a, g: a + g.to(grad_dtype) / k, grads, g_i),
            loss + l_i / k, nll + ex["nll"] / k, aux + ex["aux_loss"] / k)


def _update(params, opt_state, ocfg, sums):
    grads, loss, nll, aux = sums
    grads = _reduced(grads, _moments(opt_state))
    params, opt_state, om = adamw.update(grads, opt_state, params, ocfg)
    return params, opt_state, {"loss": loss, "nll": nll, "aux_loss": aux,
                               **om}


def make_train_step(lm: LM, ocfg: adamw.AdamWConfig,
                    microbatches: int = 1, grad_dtype=F32):
    """A train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  With ``k > 1`` microbatches the batch is split ``(k, B/k,
    ...)`` along its first axis and the microbatches' gradients, cast to
    ``grad_dtype``, are averaged in order (saved activations scale with
    ``B/k``); with one the gradients keep the parameters' dtype, as in the
    reference."""
    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, extras), grads = value_and_grad(lm, params, batch)
            sums = (grads, loss, extras["nll"], extras["aux_loss"])
        else:
            for name, x in batch.items():
                if x.shape[0] % microbatches:
                    raise ValueError(f"batch {name} of {x.shape[0]} rows "
                                     f"does not split into {microbatches}")
            sums = _zero_sums(params, _moments(opt_state), grad_dtype)
            for i in range(microbatches):
                mb = {name: _microbatch(x, microbatches, i)
                      for name, x in batch.items()}
                sums = _add_microbatch(lm, params, mb, microbatches,
                                       grad_dtype, sums)
        return _update(params, opt_state, ocfg, sums)
    return train_step


def make_prefill_step(lm: LM):
    def prefill_step(params, batch):
        return lm.prefill(params, batch["tokens"], aux=batch.get("aux"))
    return prefill_step


def make_decode_step(lm: LM):
    def decode_step(params, caches, tokens):
        return lm.decode_step(params, caches, tokens)
    return decode_step


# ---------------------------------------------------------------------------
# Cell assembly
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: Any
    lm: LM
    plan: R.CellPlan
    mesh: Any
    step: Callable         # the step, called as step(*example_args)
    example_args: tuple    # fake DTensors, placed by the plan
    kind: str
    fake_mode: FakeTensorMode   # the mode the example args live in
    analysis: op_analysis.OpAnalysis   # counts one trace of the step


def shard_tree(mesh, spec_tree):
    """:class:`Spec` tree -> DTensor placements tree on ``mesh``."""
    return T.tree_map(lambda s: placements(s, mesh), spec_tree,
                      is_leaf=lambda x: isinstance(x, Spec))


def place(tree, spec_tree, mesh):
    """Each tensor of ``tree`` (the same on every rank, as SPMD code makes
    it) as the DTensor of its box here, placed by the matching
    :class:`Spec` of ``spec_tree`` (one Spec for a single tensor).  No
    collective runs; a box that is a view is copied, so the whole tensor
    can be freed."""
    def one(t, spec):
        d = distribute_tensor(t.to(mesh.device_type), mesh,
                              placements(spec, mesh), src_data_rank=None)
        local = d.to_local()
        if local.untyped_storage().nbytes() == local.nbytes:
            return d
        return DTensor.from_local(local.clone(), mesh, d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())
    if isinstance(tree, torch.Tensor):
        return one(tree, spec_tree)
    return T.tree_map(one, tree, spec_tree)


def _fake_dtensors(meta_tree, place_tree, mesh, dtype=None):
    """A fake DTensor per meta leaf: its shard on this device (rank 0),
    made under the caller's ``FakeTensorMode``; on a mesh of one device a
    plain fake tensor, so the trace is the one-card step's own."""
    if mesh.size() == 1:
        return abstractify(meta_tree, dtype=dtype)

    def one(m, pl):
        shape, _ = shard.local_box(m.shape, mesh, pl)
        local = torch.empty(shape, dtype=dtype or m.dtype)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=torch.Size(m.shape),
                                  stride=torch.empty(m.shape,
                                                     device="meta").stride())
    return T.tree_map(one, meta_tree, place_tree, is_leaf=is_meta)


def _placed(x, mesh, spec: Spec):
    """A fake tensor (global shape) as the DTensor of its shard here (as
    it is on a mesh of one device)."""
    if mesh.size() == 1:
        return x
    pl = placements(spec, mesh)
    shape, offset = shard.local_box(x.shape, mesh, pl)
    local = x[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def build_cell(arch: str, shape_name, mesh, *, multi_pod: bool,
               smoke: bool = False, batch_override: int | None = None,
               fsdp: bool | None = None, zero1: bool = False,
               interior_pin: bool = False,
               kv_cache_dtype=None) -> Cell:
    """The cell's step and its example arguments, with the reference's plan
    overrides: ZeRO-1, FSDP, boundary-SP (attention-only stacks) and the
    interior pin.  ``shape_name`` names one of ``registry.SHAPES``, or is a
    ``registry.ShapeSpec`` of the caller's own (``chip_smoke.py``'s
    ``[train]`` shape)."""
    cfg = registry.get_config(arch, smoke=smoke)
    spec = (shape_name if isinstance(shape_name, registry.ShapeSpec)
            else registry.SHAPES[shape_name])
    gb = batch_override or spec.global_batch
    plan = R.plan_for(cfg, spec.kind, gb, mesh, multi_pod,
                      seq_len=spec.seq_len)
    kv_seq = plan.rules.rules.get("kv_seq")
    if zero1:
        # ZeRO-1: weights TP-only (fsdp=False), optimizer state data-sharded
        plan = dataclasses.replace(
            plan, fsdp=False, zero1=True,
            rules=R.make_rules(cfg, multi_pod=multi_pod, fsdp=False,
                               kv_seq_axis=kv_seq))
    if fsdp is not None:
        plan = dataclasses.replace(
            plan, fsdp=fsdp,
            rules=R.make_rules(cfg, multi_pod=multi_pod, fsdp=fsdp,
                               kv_seq_axis=kv_seq))
    lm = LM(cfg)
    if kv_cache_dtype is not None:
        lm.kv_cache_dtype = getattr(torch, str(kv_cache_dtype))
    baxes = R.batch_axes(multi_pod)
    n_data = 1
    for a in baxes:
        n_data *= mesh_shape(mesh).get(a, 1)
    # batch-dim sharding entry: None (replicated) when not divisible
    bentry = baxes if gb % n_data == 0 else None
    if cfg.moe is not None:
        # the expert-parallel MoE: local routing on each data shard, one
        # all-reduce over model (None: the batch is replicated over data)
        lm.moe_exec = {"dp_axes": bentry}
    act = Spec(baxes, "model", None)
    pin = Spec(bentry, None, None)
    # Boundary-SP: shard remat-saved layer inputs over the model axis
    # (stacks without Mamba2 layers, as in the reference)
    if plan.fsdp and spec.kind == "train" \
            and spec.seq_len % mesh_shape(mesh).get("model", 1) == 0 \
            and "mamba" not in cfg.pattern:
        lm.boundary_sp = (placements(act, mesh), placements(pin, mesh))
    elif (interior_pin or plan.zero1) and spec.kind == "train":
        # pin layer-interior activations to (batch-sharded, replicated)
        lm.boundary_sp = (placements(pin, mesh),) * 2
    elif spec.kind == "prefill":
        lm.boundary_sp = (placements(pin, mesh),) * 2
    dt = getattr(torch, cfg.dtype)
    fake_mode = FakeTensorMode()
    analysis = op_analysis.OpAnalysis()
    pmeta = lm.param_meta()
    with fake_mode:
        params = _fake_dtensors(
            pmeta, shard_tree(mesh, specs_for(pmeta, plan.rules, mesh)),
            mesh, dtype=dt)
        inputs = registry.input_specs(cfg, spec, batch_override=gb)
        if spec.kind == "train":
            ocfg = adamw.AdamWConfig(quantize_moments=plan.quantized_moments)
            # grads accumulate in bf16 for the very largest models
            gdt = torch.bfloat16 if plan.quantized_moments else F32
            ometa = adamw.state_meta(pmeta, ocfg)
            opt = _fake_dtensors(ometa, shard_tree(mesh, specs_for(
                ometa, plan.opt_rules(cfg, multi_pod), mesh)), mesh)
            batch = {k: _placed(x, mesh, Spec(bentry,
                                              *([None] * (x.dim() - 1))))
                     for k, x in inputs.items()}

            k = plan.microbatches
            if k == 1:
                step = make_train_step(lm, ocfg)
            else:
                def step(params, opt_state, batch):
                    # the microbatches run the same shapes: the first,
                    # counted k times, as the reference weights its
                    # microbatch loop by its trip count
                    sums = _zero_sums(params, _moments(opt_state), gdt)
                    with analysis.repeat(k):
                        mb = {n: _microbatch(x, k, 0)
                              for n, x in batch.items()}
                        sums = _add_microbatch(lm, params, mb, k, gdt, sums)
                    return _update(params, opt_state, ocfg, sums)
            args = (params, opt, batch)
        elif spec.kind == "prefill":
            batch = {k: _placed(x, mesh, Spec(bentry,
                                              *([None] * (x.dim() - 1))))
                     for k, x in inputs.items()}
            # the emitted caches are placed as decode caches
            cmeta = lm.init_cache_meta(gb, spec.seq_len)
            cplace = shard_tree(mesh, specs_for(cmeta, R.make_rules(
                cfg, multi_pod=multi_pod, fsdp=plan.fsdp,
                kv_seq_axis="model"), mesh))
            prefill = make_prefill_step(lm)

            def step(params, batch):
                logits, caches = prefill(params, batch)
                return logits, {name: {k: shard.constrain(
                    t, cplace[name][k]) for k, t in sub.items()}
                    for name, sub in caches.items() if name != "pos"}

            args = (params, batch)
        elif spec.kind == "decode":
            cmeta = lm.init_cache_meta(gb, spec.seq_len)
            cmeta.pop("pos")
            caches = _fake_dtensors(cmeta, shard_tree(mesh, specs_for(
                cmeta, plan.rules, mesh)), mesh)
            # a full cache: the step writes the last slot
            caches["pos"] = spec.seq_len - 1
            tokens = _placed(inputs["tokens"], mesh, Spec(bentry, None))
            step = make_decode_step(lm)
            args = (params, caches, tokens)
        else:
            raise ValueError(spec.kind)
    return Cell(arch, spec.name, cfg, lm, plan, mesh, step, args,
                spec.kind, fake_mode, analysis)


# ---------------------------------------------------------------------------
# Dry run: trace + analyze
# ---------------------------------------------------------------------------
def dryrun_cell(arch: str, shape_name: str, mesh, *, multi_pod: bool,
                smoke: bool = False, fsdp: bool | None = None,
                batch_override: int | None = None, zero1: bool = False,
                interior_pin: bool = False, kv_cache_dtype=None) -> dict:
    """One cell's per-device numbers, keyed as the reference's artifact
    (without its ``hlo_`` prefixes): its step run once on its fake
    arguments under its :class:`op_analysis.OpAnalysis`, as the device at
    mesh coordinate 0 runs it."""
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, mesh, multi_pod=multi_pod,
                      smoke=smoke, fsdp=fsdp, batch_override=batch_override,
                      zero1=zero1,
                      interior_pin=interior_pin,
                      kv_cache_dtype=kv_cache_dtype)
    with cell.fake_mode, implicit_replication():
        cell.analysis.track(cell.example_args)
        with cell.analysis:
            cell.step(*cell.example_args)
    rep = cell.analysis.report()
    return {
        "arch": arch, "shape": cell.shape, "kind": cell.kind,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "multi_pod": multi_pod, "n_devices": int(mesh.size()),
        "torch": torch.__version__,
        "smoke": smoke, "fsdp": cell.plan.fsdp, "zero1": cell.plan.zero1,
        "microbatches": cell.plan.microbatches,
        "quantized_moments": cell.plan.quantized_moments,
        "batch": cell.example_args[-1]["tokens"].shape[0]
        if cell.kind != "decode" else cell.example_args[-1].shape[0],
        "trace_s": round(time.perf_counter() - t0, 3),
        "flops_per_device": rep.flops,
        "traffic_bytes_per_device": rep.traffic_bytes,
        "score_traffic_bytes_per_device": rep.score_traffic_bytes,
        "kernel_adjusted_traffic_bytes_per_device":
            rep.kernel_adjusted_traffic,
        "collective_bytes_per_device": rep.collective_bytes,
        "collective_total_bytes_per_device": rep.total_collective_bytes,
        "n_collectives": rep.n_collectives,
        "memory": {"argument_bytes": rep.argument_bytes,
                   "peak_bytes_est": rep.peak_bytes},
    }
