"""Which collectives the ``gloo`` backend takes for CUDA tensors: several
processes share one card (NCCL refuses two ranks on one device) and run
one probe, a raw collective or a DTensor redistribution the mesh paths
issue; each probe gets processes of its own, so one that crashes a rank
(a segfault) is reported as such and the next still runs.  Rank 0 prints
one line a probe, ``ok``, the error's first line or the crash, then one
JSON object of them all.

    python3 tools/gloo_cuda_probe.py            # 2 processes on cuda:0
    python3 tools/gloo_cuda_probe.py --device cpu --procs 4

A probe that fails is reported, not raised: this script maps what the
backend accepts; it is not a check.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile
import time
import warnings

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _try(name, fn, out: dict) -> None:
    try:
        ok = fn()
        out[name] = "ok" if ok is None or ok else "wrong values"
    except Exception as e:          # noqa: BLE001 - the probe reports it
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def run(rank: int, world: int, device: str, store: str, path: str,
        only: str) -> None:
    warnings.simplefilter("ignore", FutureWarning)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.zeros(1, device=dev)
    res: dict = {"init": "ok", "init_s": time.perf_counter() - t0}
    n = 8

    def x():
        return torch.arange(n, dtype=torch.float32, device=dev) + rank

    def all_gather_into_tensor():
        out = torch.empty(world * n, device=dev)
        dist.all_gather_into_tensor(out, x())
        want = torch.cat([torch.arange(n, dtype=torch.float32, device=dev)
                          + r for r in range(world)])
        return torch.equal(out, want)

    def all_gather():
        outs = [torch.empty(n, device=dev) for _ in range(world)]
        dist.all_gather(outs, x())
        return torch.equal(outs[-1], x() - rank + world - 1)

    def all_reduce():
        t = x()
        dist.all_reduce(t)
        return torch.equal(t, world * (x() - rank) + sum(range(world)))

    def reduce_scatter_tensor():
        out = torch.empty(n // world, device=dev)
        dist.reduce_scatter_tensor(out, x())
        return out.shape[0] == n // world

    def broadcast():
        t = x()
        dist.broadcast(t, 0)
        return torch.equal(t, x() - rank)

    def all_to_all_single():
        out = torch.empty(n, device=dev)
        dist.all_to_all_single(out, x())
        return True

    def barrier():
        dist.barrier()

    for fn in (all_gather_into_tensor, all_gather, all_reduce,
               reduce_scatter_tensor, broadcast, all_to_all_single, barrier):
        if fn.__name__ == only:
            _try(fn.__name__, fn, res)

    shapes = [(world, 1), (1, world)] + ([(2, world // 2)]
                                         if world % 2 == 0 and world > 2
                                         else [])
    for shape in shapes:
        tag = f"{shape[0]}x{shape[1]}"
        if not only.startswith(f"mesh {tag}"):
            continue
        _try(f"mesh {tag}", lambda: init_device_mesh(
            dev.type, shape, mesh_dim_names=("data", "model")), res)
        if res[f"mesh {tag}"] != "ok":
            continue
        mesh = init_device_mesh(dev.type, shape,
                                mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)
        a = torch.randn(8, 16, generator=g).to(dev)
        b = torch.randn(16, 12, generator=g).to(dev)

        def shard_full():
            d = distribute_tensor(a, mesh, (Shard(0), Shard(1)))
            return torch.equal(d.full_tensor(), a)

        def partial_replicate():
            p = DTensor.from_local(a / shape[0], mesh,
                                   (Partial(), Replicate()))
            return torch.allclose(p.full_tensor(), a)

        def partial_shard():
            p = DTensor.from_local(a / shape[1], mesh,
                                   (Replicate(), Partial()))
            return torch.allclose(
                p.redistribute(mesh, (Replicate(), Shard(0))).full_tensor(),
                a)

        def matmul():
            da = distribute_tensor(a, mesh, (Shard(0), Shard(1)))
            db = distribute_tensor(b, mesh, (Replicate(), Shard(0)))
            return torch.allclose((da @ db).full_tensor(), a @ b,
                                  atol=1e-5)

        def backward():
            w = distribute_tensor(b, mesh, (Replicate(), Shard(1)))
            w.requires_grad_(True)
            da = distribute_tensor(a, mesh, (Shard(0), Replicate()))
            (da @ w).sum().backward()
            return torch.allclose(w.grad.full_tensor(),
                                  a.sum(0)[:, None].expand_as(b), atol=1e-4)

        for fn in (shard_full, partial_replicate, partial_shard, matmul,
                   backward):
            if only == f"mesh {tag} {fn.__name__}":
                _try(only, fn, res)
    res["s"] = time.perf_counter() - t0
    if rank == 0:
        with open(path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=2)
    args = ap.parse_args()
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "devices", torch.cuda.device_count(), flush=True)
    world = args.procs
    names = ["init", "all_gather_into_tensor", "all_gather", "all_reduce",
             "reduce_scatter_tensor", "broadcast", "all_to_all_single",
             "barrier"]
    shapes = [(world, 1), (1, world)] + ([(2, world // 2)]
                                         if world % 2 == 0 and world > 2
                                         else [])
    for a, b in shapes:
        names += [f"mesh {a}x{b} {n}" for n in (
            "shard_full", "partial_replicate", "partial_shard", "matmul",
            "backward")]
    res = {}
    for name in names:
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "out.json")
            try:
                mp.spawn(run, args=(world, args.device,
                                    os.path.join(d, "store"), out, name),
                         nprocs=world)
                with open(out) as f:
                    one = json.load(f)
                res[name] = one.get(name, one.get(name.rsplit(" ", 1)[0],
                                                  "not run"))
                res[name + " s"] = round(one["s"], 2)
            except mp.ProcessExitedException as e:
                res[name] = f"crashed: {str(e).splitlines()[0][:120]}"
        print(f"[probe] {name}: {res[name]}", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
