"""The dry run's sharded step with real values: several CPU processes on
the ``gloo`` backend run the smoke LM's loss and gradients, a train step
of two microbatches (the gradients added up partial and reduced into
the moments' placements, the global norm, AdamW's moments), a prefill
(its last logits and every cache leaf) and a decode step (of
``--decode-rows`` rows: one row is whole on every device and its cache's
sequence is split over data and model), with every parameter, optimizer
moment, batch and cache placed as
DTensors by the dry run's rules (``specs_for``, ``placements``), through
the sharding points of ``repro_torch.models.shard``; rank 0 holds them
against the same step on plain tensors in one process and prints one
JSON line of the largest differences.

    PYTHONPATH=src python tests/torch_gloo_step.py --mesh 1 4 --heads 6
    PYTHONPATH=src python tests/torch_gloo_step.py --mesh 2 2 \
        --arch deepseek-v2-lite-16b
    PYTHONPATH=src python tests/torch_gloo_step.py --mesh 2 2 \
        --arch jamba-1.5-large-398b --decode-rows 1

(float32; ``--arch`` names the smoke config, qwen2-7b by default, whose
4 q heads ``--heads`` replaces, so 6 heads over a 4-way model axis split
unevenly and leave one device none.)  An MoE config's sharded step runs
the expert-parallel MoE (``LM.moe_exec``), whose capacity is per data
shard, and the one-process step ``moe_apply``, whose capacity is global:
on a data axis of one they are the same, and the config's own capacity
stands; over a data axis of two, the capacity factor is raised to
``n_experts / top_k``, so that no token is dropped in either.  A config
that cross-attends gets N(0, 1) ``aux`` embeddings.  Run by
``tests/test_torch_dryrun.py`` and ``tests/test_torch_dryrun_cells.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import logging
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _relative(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _config(arch: str, heads: int, data: int):
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              dtype="float32")
    if arch == "qwen2-7b":
        cfg = dataclasses.replace(cfg, n_heads=heads)
    if cfg.moe is not None and data > 1:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def run(rank: int, world: int, mesh_shape, arch: str, heads: int,
        decode_rows: int, store: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree as T
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM
    from repro_torch.models.meta import Spec, placements, specs_for
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    torch.set_num_threads(1)
    cfg = _config(arch, heads, mesh_shape[0])
    lm = LM(cfg)                    # one process: moe_apply
    dlm = LM(cfg)                   # sharded: the expert-parallel MoE
    dlm.moe_exec = {"dp_axes": ("data",)}
    params = lm.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)

    def make_batch(rows: int) -> dict:
        out = {k: torch.randint(0, cfg.vocab, (rows, 32), generator=g)
               for k in ("tokens", "labels")}
        if cfg.aux_seq:
            out["aux"] = torch.randn((rows, cfg.aux_seq, cfg.d_model),
                                     generator=g)
        return out

    batch = make_batch(2)
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))

    def place(tree, spec_tree):
        return T.tree_map(lambda t, s: distribute_tensor(
            t, mesh, placements(s, mesh)), tree, spec_tree)

    def place_batch(b: dict) -> dict:
        return {k: distribute_tensor(v, mesh, placements(
            Spec("data", *([None] * (v.dim() - 1))), mesh))
            for k, v in b.items()}

    plan = R.plan_for(cfg, "train", 2, mesh, False, seq_len=32)
    with implicit_replication():
        (dloss, _), dgrads = steps.value_and_grad(
            dlm, place(params, specs_for(lm.param_meta(), plan.rules, mesh)),
            place_batch(batch))
        dloss = dloss.full_tensor()
        dgrads = [t.full_tensor() for t in T.leaves(dgrads)]
    (loss, _), grads = steps.value_and_grad(lm, params, batch)

    # one train step over two microbatches of a 4-row batch (AdamW writes
    # into the tensors it is given); a device splits its own rows, so the
    # one process takes the rows in the order that groups them alike (the
    # MoE's auxiliary loss depends on the grouping, a mean does not)
    ocfg = adamw.AdamWConfig()
    pmeta = lm.param_meta()
    ospecs = specs_for(adamw.state_meta(pmeta, ocfg),
                       plan.opt_rules(cfg, False), mesh)
    batch4 = make_batch(4)
    with implicit_replication():
        _, dopt, dmet = steps.make_train_step(dlm, ocfg, microbatches=2)(
            place(T.tree_map(torch.clone, params),
                  specs_for(pmeta, plan.rules, mesh)),
            place(adamw.init(params, ocfg), ospecs), place_batch(batch4))
        dmoments = [t.full_tensor() for t in T.leaves(dopt["m"])
                    + T.leaves(dopt["v"])]
        dnorm = float(dmet["grad_norm"].full_tensor())
    data = mesh_shape[0]
    grouped = torch.arange(4).reshape(data, 2, 2 // data).transpose(
        0, 1).reshape(-1)
    _, opt, met = steps.make_train_step(lm, ocfg, microbatches=2)(
        T.tree_map(torch.clone, params), adamw.init(params, ocfg),
        {k: v[grouped] for k, v in batch4.items()})

    # prefill: a 9-token prompt, placed as the dry run's prefill places it
    # (the layers' insides batch-sharded and whole over model)
    tokens = batch["tokens"]
    pre = {"tokens": tokens[:, :9], **({"aux": batch["aux"]}
                                       if cfg.aux_seq else {})}
    plogits, pcaches = lm.prefill(params, pre["tokens"], aux=pre.get("aux"))
    pplan = R.plan_for(cfg, "prefill", 2, mesh, False)
    dlm.boundary_sp = (placements(Spec(("data",), None, None), mesh),) * 2
    with implicit_replication():
        dplogits, dpcaches = dlm.prefill(
            place(params, specs_for(lm.param_meta(), pplan.rules, mesh)),
            place_batch(pre)["tokens"], aux=place_batch(pre).get("aux"))
        prefill_err = max(
            [float((dplogits.full_tensor() - plogits).abs().max())]
            + [float((t.full_tensor() - pcaches[k][n]).abs().max())
               for k, v in dpcaches.items() if k != "pos"
               for n, t in v.items()])
    dlm.boundary_sp = None

    # decode: the prompt into a 16-slot cache, one step, for
    # ``decode_rows`` rows (one row does not divide over data: the batch
    # is whole on every device and the cache's sequence is split over
    # data and model, as ``long_500k``'s)
    rows = tokens[:decode_rows]
    _, caches = lm.prefill(params, rows[:, :9],
                           aux=None if not cfg.aux_seq
                           else batch["aux"][:decode_rows], max_len=16)
    plain = {k: {n: t.clone() for n, t in v.items()}
             for k, v in caches.items() if k != "pos"}
    plain["pos"] = 9
    logits, _ = lm.decode_step(params, plain, rows[:, 9:10])
    dplan = R.plan_for(cfg, "decode", decode_rows, mesh, False)
    bentry = ("data",) if decode_rows % mesh_shape[0] == 0 else None
    dlm.moe_exec = {"dp_axes": bentry}
    cspecs = specs_for(lm.init_cache_meta(decode_rows, 16), dplan.rules,
                       mesh)
    dcaches = {k: place(v, cspecs[k]) for k, v in caches.items()
               if k != "pos"}
    dcaches["pos"] = 9
    with implicit_replication():
        dlogits, dnew = dlm.decode_step(
            place(params, specs_for(lm.param_meta(), dplan.rules, mesh)),
            dcaches, distribute_tensor(rows[:, 9:10], mesh, placements(
                Spec(bentry, None), mesh)))
        dlogits = dlogits.full_tensor()
        # every cache leaf, the written slot and the memory's K/V alike
        dcache = {(k, n): t.full_tensor() for k, v in dnew.items()
                  if k != "pos" for n, t in v.items()}
    res = {"loss": float(loss), "loss_err": abs(float(dloss) - float(loss)),
           "prefill_err": prefill_err,
           "kv_seq": list(dplan.rules.rules["kv_seq"]) if isinstance(
               dplan.rules.rules["kv_seq"], list)
           else [dplan.rules.rules["kv_seq"]],
           "grad_err": max(_relative(a, b) for a, b in
                           zip(dgrads, T.leaves(grads))),
           "norm_err": abs(dnorm / float(met["grad_norm"]) - 1),
           "moment_err": max(_relative(a, b) for a, b in zip(
               dmoments, T.leaves(opt["m"]) + T.leaves(opt["v"]))),
           "logit_err": float((dlogits - logits).abs().max()),
           "cache_err": max(float((t - plain[k][n]).abs().max())
                            for (k, n), t in dcache.items())}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=int, nargs=2, default=(1, 4))
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--decode-rows", type=int, default=2)
    args = ap.parse_args()
    world = args.mesh[0] * args.mesh[1]
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.json")
        mp.spawn(run, args=(world, args.mesh, args.arch, args.heads,
                            args.decode_rows, os.path.join(d, "store"),
                            out),
                 nprocs=world)
        with open(out) as f:
            print(f.read())


if __name__ == "__main__":
    main()
