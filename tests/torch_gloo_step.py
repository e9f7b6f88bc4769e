"""The dry run's sharded step with real values: several CPU processes on
the ``gloo`` backend run the smoke LM's loss and gradients, a train step
of two microbatches (the gradients added up partial and reduced into
the moments' placements, the global norm, AdamW's moments) and a decode
step, with every parameter, optimizer moment, batch and cache placed as
DTensors by the dry run's rules (``specs_for``, ``placements``), through
the sharding points of ``repro_torch.models.shard``; rank 0 holds them
against the same step on plain tensors in one process and prints one
JSON line of the largest differences.

    PYTHONPATH=src python tests/torch_gloo_step.py --mesh 1 4 --heads 6

(float32; ``--heads`` replaces the smoke config's 4 q heads, so 6 heads
over a 4-way model axis split unevenly and leave one device none.)
Run by ``tests/test_torch_dryrun.py``.
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


def run(rank: int, world: int, mesh_shape, heads: int, store: str,
        out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM
    from repro_torch.models.meta import Spec, placements, specs_for
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    torch.set_num_threads(1)
    cfg = dataclasses.replace(registry.get_config("qwen2-7b", smoke=True),
                              n_heads=heads, dtype="float32")
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 32), generator=g)}
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))

    def place(tree, spec_tree):
        return T.tree_map(lambda t, s: distribute_tensor(
            t, mesh, placements(s, mesh)), tree, spec_tree)

    rows = placements(Spec("data", None), mesh)
    plan = R.plan_for(cfg, "train", 2, mesh, False, seq_len=32)
    with implicit_replication():
        (dloss, _), dgrads = steps.value_and_grad(
            lm, place(params, specs_for(lm.param_meta(), plan.rules, mesh)),
            {k: distribute_tensor(v, mesh, rows) for k, v in batch.items()})
        dloss = dloss.full_tensor()
        dgrads = [t.full_tensor() for t in T.leaves(dgrads)]
    (loss, _), grads = steps.value_and_grad(lm, params, batch)

    # one train step over two microbatches of a 4-row batch (AdamW writes
    # into the tensors it is given); a device splits its own rows, so the
    # microbatches group other rows than one process's, to the same mean
    ocfg = adamw.AdamWConfig()
    pmeta = lm.param_meta()
    ospecs = specs_for(adamw.state_meta(pmeta, ocfg),
                       plan.opt_rules(cfg, False), mesh)
    train = steps.make_train_step(lm, ocfg, microbatches=2)
    batch4 = {k: torch.randint(0, cfg.vocab, (4, 32), generator=g)
              for k in ("tokens", "labels")}
    with implicit_replication():
        _, dopt, dmet = train(
            place(T.tree_map(torch.clone, params),
                  specs_for(pmeta, plan.rules, mesh)),
            place(adamw.init(params, ocfg), ospecs),
            {k: distribute_tensor(v, mesh, rows) for k, v in batch4.items()})
        dmoments = [t.full_tensor() for t in T.leaves(dopt["m"])
                    + T.leaves(dopt["v"])]
        dnorm = float(dmet["grad_norm"].full_tensor())
    _, opt, met = train(T.tree_map(torch.clone, params),
                        adamw.init(params, ocfg), batch4)

    # decode: a 9-token prompt into a 16-slot cache, one step
    tokens = batch["tokens"]
    _, caches = lm.prefill(params, tokens[:, :9], max_len=16)
    plain = {k: {n: t.clone() for n, t in v.items()}
             for k, v in caches.items() if k != "pos"}
    plain["pos"] = 9
    logits, _ = lm.decode_step(params, plain, tokens[:, 9:10])
    dplan = R.plan_for(cfg, "decode", 2, mesh, False)
    cspecs = specs_for(lm.init_cache_meta(2, 16), dplan.rules, mesh)
    dcaches = {k: place(v, cspecs[k]) for k, v in caches.items()
               if k != "pos"}
    dcaches["pos"] = 9
    with implicit_replication():
        dlogits, dnew = lm.decode_step(
            place(params, specs_for(lm.param_meta(), dplan.rules, mesh)),
            dcaches, distribute_tensor(tokens[:, 9:10], mesh, rows))
        dlogits = dlogits.full_tensor()
        dk = dnew["sub0"]["k"].full_tensor()
    res = {"loss": float(loss), "loss_err": abs(float(dloss) - float(loss)),
           "grad_err": max(_relative(a, b) for a, b in
                           zip(dgrads, T.leaves(grads))),
           "norm_err": abs(dnorm / float(met["grad_norm"]) - 1),
           "moment_err": max(_relative(a, b) for a, b in zip(
               dmoments, T.leaves(opt["m"]) + T.leaves(opt["v"]))),
           "logit_err": float((dlogits - logits).abs().max()),
           "cache_err": float((dk - plain["sub0"]["k"]).abs().max())}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=int, nargs=2, default=(1, 4))
    ap.add_argument("--heads", type=int, default=6)
    args = ap.parse_args()
    world = args.mesh[0] * args.mesh[1]
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.json")
        mp.spawn(run, args=(world, args.mesh, args.heads,
                            os.path.join(d, "store"), out), nprocs=world)
        with open(out) as f:
            print(f.read())


if __name__ == "__main__":
    main()
