"""The expert-parallel MoE with real values: four CPU processes on the
``gloo`` backend, a (data 2, model 2) mesh, run
``repro_torch.models.layers.moe_apply_shardmap`` on one MoE layer's
weights placed by the dry run's rules (FSDP off and on: the expert
weights then arrive data-sharded and are gathered), with ``x`` sharded
over data.  Rank 0 writes the output and the gradients of ``sum(y * g)``
with respect to ``x`` and every weight, whole, into a ``.npz``; beside
them the same function on plain tensors in one process: each data
shard's rows through the one-device path (local routing over all
experts at the per-shard capacity), whose gradients autograd takes.

    PYTHONPATH=src python tests/torch_gloo_moe.py IN.npz OUT.npz

``IN.npz`` holds, per architecture ``a`` (a smoke config), ``a/x``,
``a/g``, ``a/cf`` (the capacity factor) and the weights as ``a/p/...``
(``/`` between nested keys).  Run by ``tests/test_torch_moe_shardmap.py``.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _nest(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = torch.from_numpy(np.array(value))
    return out


def config(arch: str, cf: float):
    from repro_torch.configs import registry
    cfg = registry.get_config(arch, smoke=True)
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _grads(y, g, leaves):
    return torch.autograd.grad((y * g).sum(), leaves)


def run(rank: int, world: int, src: str, store: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import tree as T
    from repro_torch.models import layers as L
    from repro_torch.models.meta import placements, specs_for
    from repro_torch.sharding import rules as R
    torch.set_num_threads(1)
    data = np.load(src)
    archs = sorted({k.split("/")[0] for k in data.files})
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}
    for arch in archs:
        cfg = config(arch, float(data[f"{arch}/cf"]))
        params = _nest({k: data[k] for k in data.files}, f"{arch}/p/")
        x = torch.from_numpy(data[f"{arch}/x"])
        g = torch.from_numpy(data[f"{arch}/g"])
        for fsdp in (False, True):
            specs = specs_for(L.moe_meta(cfg), R.make_rules(cfg, fsdp=fsdp),
                              mesh)
            dparams = T.tree_map(lambda t, s: distribute_tensor(
                t, mesh, placements(s, mesh)).requires_grad_(True),
                params, specs)
            dx = distribute_tensor(x, mesh, (Shard(0), Replicate()))
            dx.requires_grad_(True)
            y = L.moe_apply_shardmap(dparams, dx, cfg, dp_axes=("data",))
            leaves = [dx, *T.leaves(dparams)]
            grads = _grads(y, distribute_tensor(g, mesh, y.placements),
                           leaves)
            tag = f"{arch}/{'fsdp' if fsdp else 'tp'}"
            res[f"{tag}/y"] = y.full_tensor().detach().numpy()
            for i, t in enumerate(grads):
                res[f"{tag}/grad{i}"] = t.full_tensor().numpy()
        # one process: each data shard's rows on their own, all experts
        leaves = [x.clone().requires_grad_(True),
                  *(t.clone().requires_grad_(True) for t in T.leaves(params))]
        p = T.unflatten_like(params, leaves[1:])
        y = torch.cat([L.moe_apply_shardmap(p, rows, cfg)
                       for rows in leaves[0].chunk(2)])
        res[f"{arch}/plain/y"] = y.detach().numpy()
        for i, t in enumerate(_grads(y, g, leaves)):
            res[f"{arch}/plain/grad{i}"] = t.numpy()
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()


def main() -> None:
    src, out = sys.argv[1], sys.argv[2]
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(run, args=(4, src, os.path.join(d, "store"), out), nprocs=4)


if __name__ == "__main__":
    main()
