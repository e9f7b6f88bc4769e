"""The ``mesh=`` paths with real values: several CPU processes on the
``gloo`` backend run the sharded estimation, serving, training, data and
checkpoint paths of ``repro_torch`` on real ``DeviceMesh``es, and rank 0
holds each against the same call in one process (no mesh) and prints one
JSON line; arrays the reference is held against go to ``--out``.

    PYTHONPATH=src python tests/torch_gloo_mesh.py --part estimate
    PYTHONPATH=src python tests/torch_gloo_mesh.py --part train [--ref F]
    PYTHONPATH=src python tests/torch_gloo_mesh.py --part serve [--ref F]

* ``estimate`` (4 processes, meshes (2, 2) and (4, 1)): the fleet surface
  and the probe matrix through ``'vectorized'`` and ``'cuda'`` (on CPU
  tensors the kernels' plain versions), the stacked fleet's placements,
  the estimation service and the engine's plain fallback, a one-device
  mesh's fallback, ``make_global_array`` and ``crosspod_compressed_psum``;
* ``train`` (4 processes): ``launch.train.run`` for 2 steps on (2, 2)
  with a checkpoint, then the rescale: the same run resumed on (4, 1) for
  a third step, against 3 steps in one process;
* ``serve`` (2 processes): ``launch.serve.run`` on (2, 1) and (1, 2)
  against one process.

With ``--ref F`` (an ``.npz`` of the reference's initial parameters,
written by ``tests/test_torch_mesh.py``) the train part also runs 3 steps
on (2, 2), and the serve part a run on (2, 1), from the reference's
weights (``convert.lm_params_from_jax``), for the test to hold against
``repro.launch.train`` and ``repro.launch.serve`` on the same mesh.

Run by ``tests/test_torch_mesh.py``.  The models are the smoke configs in
float32.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import logging
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPECS = [(v, i, 2015) for v in range(3) for i in range(4)]
#: the probe points: (idd_loops function, args, kwargs); one noise key each
PROBES = [("ones_sweep_point", (256,), dict(reps=8)),
          ("bank_idle_probe", (3,), {}),
          ("row_act_probe", (0x55,), dict(reps=16)),
          ("idd4w", (), dict(reps=3)),
          ("idd6", (), {}),
          ("idd0", (), dict(reps=2)),
          ("column_read_probe", (), dict(col=3, reps=8)),
          ("validation_sweep", (24,), {})]
#: the surface traces: validation sweeps (n_reads, reps), skip 2
SWEEPS = [(8, 12), (16, 8), (4, 6), (24, 4)]
#: long sweeps (34,000-38,400 commands): a box of one of them is a lone
#: row of more than 32768 values, which torch on the CPU would sum over
#: its threads, unlike the same row among others (``kernels.common.row_sums``)
LONG_SWEEPS = [(24, 1400), (8, 3400), (16, 2000), (30, 1200)]
N_SYNTH = 12
ARCH = "qwen2.5-3b"


def probe_traces(idd) -> list:
    """``(trace, skip)`` of each of :data:`PROBES` through ``idd``
    (``repro.core.idd_loops`` or the port's)."""
    out = []
    for name, args, kw in PROBES:
        fn = idd.IDD_LOOPS[name] if name in idd.IDD_LOOPS else \
            getattr(idd, name)
        got = fn(*args, **kw)
        out.append(got if isinstance(got, tuple) and not hasattr(got, "cmd")
                   else (got, 0))
    return out


def key(i: int) -> int:
    return 4096 + 7 * i


def _equal(a, b) -> bool:
    from repro_torch.core import model_api
    fa, fb = [], []
    model_api.map_tensors(a, fa.append)
    model_api.map_tensors(b, fb.append)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(fa, fb))


def _cfg32():
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_config(ARCH, smoke=True),
                               dtype="float32")


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def nested(flat: dict) -> dict:
    """A ``"a/b/c"``-keyed dict as nested dicts."""
    out: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return out


def reference_init(ref: str, prefix: str):
    """``LM.init`` replaced by the reference's initial parameters stored
    under ``prefix`` in ``ref``, converted to the port's tree (a fresh
    copy each call)."""
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.models.lm import LM
    with np.load(ref) as z:
        flat = {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}
    params = convert.lm_params_from_jax(nested(flat), _cfg32())
    LM.init = lambda self, *args, **kw: T.tree_map(torch.clone, params)


# ---------------------------------------------------------------------------
# estimate
# ---------------------------------------------------------------------------
def part_estimate(rank: int, out_dir: str) -> dict:
    from repro_torch.core import device_sim, dram, fleet, idd_loops, traces
    from repro_torch.core import model_api, params
    from repro_torch.core.estimate_batch import TraceBatch
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import QUICK_FIT
    from repro_torch.models.meta import Spec
    from repro_torch.optim import compress
    from repro_torch.serving import (EstimationService, RingConfig,
                                     ServiceConfig)

    mods = device_sim.make_fleet([params.ModuleSpec(*s) for s in SPECS])
    points = [fleet.ProbePoint(("p", i), tr, skip, key(i))
              for i, (tr, skip) in enumerate(probe_traces(idd_loops))]
    trace, weight = dram.batch_traces(
        [(idd_loops.validation_sweep(n, reps=r), 2) for n, r in SWEEPS])
    _, synth = device_sim.synth_fleet_params(N_SYNTH, device="cpu")
    model = model_api.load_estimator(str(QUICK_FIT), device="cpu")
    apps = traces.SPEC_APPS[:8]
    app_trs = [traces.app_trace(a, n_requests=60) for a in apps]
    long_trs = [idd_loops.validation_sweep(n, reps=r)
                for n, r in LONG_SWEEPS]
    long_pts = [fleet.ProbePoint(("long", i), tr, 2, key(100 + i))
                for i, tr in enumerate(long_trs)]

    def cfg(name: str, impl: str) -> ServiceConfig:
        # the long traces in windows of four, one row a device; the lint
        # is the host's, the same on every rank, and left out for them
        ring = RingConfig(length_buckets=(40960,), count_buckets=(4,))
        return ServiceConfig(impl=impl, **(
            {"ring": ring, "lint": False} if name == "long_service"
            else {}))

    res: dict = {}
    arrays: dict = {}
    one = {}                 # the one-process results, rank 0's
    for impl in ("vectorized", "cuda"):
        one["surface", impl] = fleet.fleet_surface_energy(
            synth, trace, weight, impl=impl, device="cpu")
        one["surface_mods", impl] = fleet.fleet_surface_energy(
            mods, trace, weight, impl=impl, device="cpu")
        for noisy in (False, True):
            one["probes", impl, noisy] = fleet.run_probes(
                mods, points, impl=impl, noisy=noisy, device="cpu")
        one["long_probes", impl] = fleet.run_probes(
            mods, long_pts, impl=impl, noisy=False, device="cpu")
        for name, trs in (("service", app_trs), ("long_service", long_trs)):
            svc = EstimationService(model, cfg(name, impl))
            tickets, _ = svc.submit_many(trs)
            svc.close()
            one[name, impl] = [svc.result(t) for t in tickets]
    ds = SyntheticDataset(DataConfig(vocab=1000, seq_len=16,
                                     global_batch=8, seed=5))

    for shape in ((2, 2), (4, 1)):
        tag = f"{shape[0]}x{shape[1]}"
        mesh = make_local_mesh(*shape, device="cpu")
        for impl in ("vectorized", "cuda"):
            got = fleet.fleet_surface_energy(synth, trace, weight, impl=impl,
                                             device="cpu", mesh=mesh)
            res[f"surface {tag} {impl}"] = _equal(got, one["surface", impl])
            got_m = fleet.fleet_surface_energy(mods, trace, weight,
                                               impl=impl, device="cpu",
                                               mesh=mesh)
            res[f"surface_mods {tag} {impl}"] = _equal(
                got_m, one["surface_mods", impl])
            if impl == "vectorized":
                arrays[f"surface_{tag}"] = got.energy_pj.numpy()
            cur = fleet.run_probes(mods, long_pts, impl=impl, noisy=False,
                                   device="cpu", mesh=mesh)
            res[f"long_probes {tag} {impl}"] = bool(
                np.array_equal(cur, one["long_probes", impl]))
            for noisy in (False, True):
                cur = fleet.run_probes(mods, points, impl=impl, noisy=noisy,
                                       device="cpu", mesh=mesh)
                res[f"probes {tag} {impl} noisy={noisy}"] = bool(
                    np.array_equal(cur, one["probes", impl, noisy]))
                if impl == "vectorized" and not noisy:
                    arrays[f"probes_{tag}"] = cur
            for name, trs in (("long_service", long_trs),
                              ("service", app_trs)):
                svc = EstimationService(model, cfg(name, impl), mesh=mesh)
                tickets, _ = svc.submit_many(trs)
                svc.close()
                res[f"{name} {tag} {impl}"] = _equal(
                    [svc.result(t) for t in tickets], one[name, impl])
                res[f"{name}_rows {tag}"] = list(svc.engine.last_rows)
            res[f"n_shards {tag}"] = svc.engine.n_shards
        # the box this rank computed last (the probe matrix's) and the
        # engine's rows
        res[f"box {tag}"] = list(fleet.LAST_BOX)
        res[f"rows {tag}"] = list(svc.engine.last_rows)
        st = fleet.fleet_stacked(mods, "cpu", mesh)
        res[f"stacked {tag}"] = [str(p) for p in st.i2n.placements]
        res[f"stacked_local {tag}"] = list(st.i2n.to_local().shape)
        # a window of three traces does not divide four devices: plain
        eng = EstimationService(model, ServiceConfig(), mesh=mesh).engine
        three = TraceBatch.from_traces(app_trs[:3])
        rep = eng.dispatch(three, None)
        res[f"three_rows {tag}"] = list(eng.last_rows)
        want = model.estimate(app_trs[:3])
        res[f"three {tag}"] = max(_rel(a, b) for a, b in zip(rep, want))
        # make_global_array: the global batch, each rank its rows
        placed = ds.make_global_array(3, mesh, Spec(("data",), None))
        whole = ds.global_batch(3)
        rows = 8 // shape[0]
        i = model_api.mesh_index(mesh, ("data",))
        res[f"global_array {tag}"] = all(
            torch.equal(placed[k].full_tensor(), whole[k])
            and torch.equal(placed[k].to_local(),
                            whole[k][i * rows:(i + 1) * rows])
            for k in whole)
        # the compressed psum over data: each rank's own gradients
        g = torch.from_numpy(np.random.default_rng(rank).standard_normal(
            (3, 8)).astype(np.float32))
        out = compress.crosspod_compressed_psum({"w": g}, "data", mesh)
        arrays[f"psum_{tag}"] = out["w"].numpy()
        res[f"psum_ranks {tag}"] = [
            int(r) for r in dist.get_process_group_ranks(
                mesh.get_group("data"))]
    # chunking with a mesh is refused
    try:
        fleet.fleet_surface_energy(synth, trace, weight, device="cpu",
                                   mesh=mesh, module_chunk=4)
        res["chunk_and_mesh"] = "accepted"
    except ValueError as e:
        res["chunk_and_mesh"] = str(e)
    if rank == 0:
        np.savez(os.path.join(out_dir, "estimate.npz"), **arrays)
    return res


# ---------------------------------------------------------------------------
# train: (2, 2), then the rescale onto (4, 1)
# ---------------------------------------------------------------------------
def part_train(rank: int, out_dir: str, ref: str | None) -> dict:
    from repro_torch import tree as T
    from repro_torch.launch import train

    def job(steps, data, model, ckpt):
        return train.TrainJob(arch=ARCH, config=_cfg32(), steps=steps,
                              batch=4, seq=16, ckpt_dir=ckpt, ckpt_every=2,
                              data=data, model=model, power_every=0,
                              device="cpu")

    ckpt = os.path.join(out_dir, "ckpt")
    first = train.run(job(2, 2, 2, ckpt))
    again = train.run(job(3, 4, 1, ckpt))        # resumes at step 2
    full = [t.full_tensor() for t in T.leaves(again["params"])]
    moments = [t.full_tensor() for t in T.leaves(again["opt_state"]["m"])]
    res = {"steps_run": [first["steps_run"], again["steps_run"]],
           "losses": first["losses"] + again["losses"]}
    if rank == 0:
        one = train.run(job(3, 1, 1, None))
        res["one_losses"] = one["losses"]
        res["loss_err"] = max(abs(a - b) / abs(b) for a, b in
                              zip(res["losses"], one["losses"]))
        res["param_abs_err"] = max(
            float((a - b).abs().max())
            for a, b in zip(full, T.leaves(one["params"])))
        res["moment_err"] = max(_rel(a, b) for a, b in zip(
            moments, T.leaves(one["opt_state"]["m"])))
    if ref is not None:
        # 3 steps on (2, 2) from the reference's weights
        reference_init(ref, "train_init/")
        got = train.run(job(3, 2, 2, None))
        res["ref_weights_losses"] = got["losses"]
        final = {path: t.full_tensor().numpy()
                 for path, t in T.leaves_with_paths(got["params"])}
        if rank == 0:
            np.savez(os.path.join(out_dir, "train_ref_weights.npz"), **final)
    return res


# ---------------------------------------------------------------------------
# serve: (2, 1) and (1, 2)
# ---------------------------------------------------------------------------
def part_serve(rank: int, out_dir: str, ref: str | None) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import serve
    from repro_torch.models.lm import LM

    def job(data, model, power=False):
        return serve.ServeJob(arch=ARCH, batch=4, prompt_len=8,
                              decode_tokens=4, data=data, model=model,
                              power_report=power, device="cpu")

    # the smoke config in float32
    cfg = _cfg32()
    serve.registry.get_config = lambda arch, smoke=False: cfg
    prefill = LM.prefill
    seen = []

    def spy(self, *args, **kw):
        """``LM.prefill``, keeping its last logits whole."""
        logits, caches = prefill(self, *args, **kw)
        seen.append(logits.full_tensor() if isinstance(logits, DTensor)
                    else logits)
        return logits, caches
    LM.prefill = spy

    full_tensor = DTensor.full_tensor
    gathered = []

    def gather_spy(self, *args, **kw):
        """``DTensor.full_tensor``, noting the shape it gathers."""
        gathered.append(tuple(self.shape))
        return full_tensor(self, *args, **kw)
    DTensor.full_tensor = gather_spy

    def run(j):
        out = serve.run(j)
        out["prefill_logits"] = seen.pop()
        return out

    res = {}
    one = run(job(1, 1)) if rank == 0 else None
    for data, model in ((2, 1), (1, 2)):
        tag = f"{data}x{model}"
        gathered.clear()
        got = run(job(data, model, power=data == 2))
        # serve.run gathers the logits, never a cache leaf (five axes:
        # layers, batch, sequence, heads, width)
        res[f"gathered_caches {tag}"] = [s for s in gathered if len(s) > 2]
        res[f"tokens_rank {tag}"] = got["tokens"].tolist()
        if data == 2:
            pw = got["power"]["serving"]
            res["power_admitted"] = pw["admitted"]
        if rank == 0:
            res[f"tokens {tag}"] = bool(np.array_equal(got["tokens"],
                                                       one["tokens"]))
            res[f"logit_err {tag}"] = float(
                (got["prefill_logits"] - one["prefill_logits"]).abs().max())
    if ref is not None:
        # a greedy run on (2, 1) from the reference's weights
        reference_init(ref, "serve_init/")
        res["ref_weights_tokens"] = run(job(2, 1))["tokens"].tolist()
    return res


PARTS = {"estimate": (part_estimate, 4), "train": (part_train, 4),
         "serve": (part_serve, 2)}


def run(rank: int, world: int, part: str, store: str, out_dir: str,
        ref: str | None) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    # each rank its share of the cores: torch's threads in four processes
    # at its default count contend for the cores and slow every op (the
    # estimation part took 13x as long on eight cores).  The estimation
    # part keeps at least two threads a rank, so torch splits a lone long
    # row over threads there as at its default count (the boxes must give
    # the one process's bits all the same); the LM parts' bars are float32
    # tolerances, and they run one thread a rank
    torch.set_num_threads(max(2, (os.cpu_count() or 1) // world)
                          if part == "estimate" else 1)
    res = (PARTS[part][0](rank, out_dir) if part == "estimate"
           else PARTS[part][0](rank, out_dir, ref))
    # every rank's answer, so the test sees that they agree
    every = [None] * world
    dist.all_gather_object(every, res)
    if rank == 0:
        with open(os.path.join(out_dir, f"{part}.json"), "w") as f:
            json.dump({"rank0": res, "ranks": every}, f)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=sorted(PARTS), required=True)
    ap.add_argument("--out", default=None,
                   help="directory for the arrays (a temporary one if "
                        "omitted)")
    ap.add_argument("--ref", default=None,
                    help="the reference's initial parameters (.npz) for "
                         "the train and serve parts")
    args = ap.parse_args()
    world = PARTS[args.part][1]
    with tempfile.TemporaryDirectory() as d:
        out = args.out or d
        mp.spawn(run, args=(world, args.part, os.path.join(d, "store"), out,
                            args.ref), nprocs=world)
        with open(os.path.join(out, f"{args.part}.json")) as f:
            print(f.read())


if __name__ == "__main__":
    main()
