"""Serving entry point: batched prefill + cached decode of any of the ten
architectures (GQA or MLA decoders, dense or MoE; Mamba2 and the jamba
hybrid; whisper's encoder-decoder and llama-3.2-vision's cross-attention
decoder), with per-token latency and the decode step's memory energy
scored by the paper's power model.

A port of ``repro.launch.serve``.  Prefill runs every
attention layer (self, cross and the encoder's) through the hand-written
flash-attention kernel and Mamba2's chunked scan in eager torch; decode
runs ``decode_attention`` over the K/V cache, MLA's absorbed-matrix
attention over the latent cache, Mamba2's one-token recurrence, and
cross-attention through the flash kernel at one query.  Where the config
cross-attends (``aux_seq``), the stub frontend's embeddings are zeros of
shape ``(batch, aux_seq, d_model)`` in the config dtype, as in the
reference.

``--power-report`` turns on the power side: the decode step's device-memory
traffic (:func:`decode_traffic_bytes`, an analytic count of the bytes one
step must move) is apportioned per sequence, wrapped into DRAM command
traces carrying the decode batch's actual output bytes, and scored through
the estimation service (``repro_torch.serving``): lint-gated admission,
ring-bucketed pad shapes, the model resident on the card, one batched
dispatch per window — plus the HBM2e-anchored extrapolation
(``repro_torch.core.hbm``).  ``--power-model vampire|micron|drampower``
picks the physics, ``--power-impl vectorized|cuda|reference`` the
evaluation path, and ``--vampire PATH`` a saved schema-v2 model (the
committed quick fit when omitted).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --device cpu --power-report
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --no-smoke --prompt-len 2048 \\
        --power-report --power-impl cuda        # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --no-smoke --prompt-len 2048 --power-report --power-impl cuda

Weights are random, drawn from ``--seed`` by a ``torch.Generator``;
temperature sampling draws from a generator seeded from ``--seed`` too, so
its tokens differ from the reference's ``jax.random`` ones (greedy decoding
at temperature 0 agrees).

``--data`` or ``--model`` above 1 serves on a ``(data, model)`` mesh of
processes, one card each (``torchrun``; every rank runs the same
program): the parameters and the caches are placed by the decode plan's
rules (``sharding.rules.plan_for``, ``models.meta.specs_for``) as
DTensors, the prompts over ``data`` when the batch divides it, and the
prefill and decode steps run through ``models.shard``'s sharding points,
each rank's attention on its local heads through the flash kernel.  Every
rank returns the same tokens; rank 0 prints.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen2.5-3b --no-smoke --data 1 --model 2 --power-report
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import pathlib
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.core import model_api
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import shard
from repro_torch.models.lm import LM
from repro_torch.models.meta import Spec, placements, specs_for
from repro_torch.sharding import rules as R

QUICK_FIT = (pathlib.Path(__file__).resolve().parents[1] / "data"
             / "vampire_quickfit_v2.npz")


@dataclasses.dataclass
class ServeJob:
    arch: str
    smoke: bool = True
    batch: int = 4
    prompt_len: int = 64
    decode_tokens: int = 32
    data: int = 1
    model: int = 1
    seed: int = 0
    temperature: float = 0.0
    # power reporting (off by default: it loads a VAMPIRE model)
    power_report: bool = False
    power_vendors: tuple[int, ...] = (0, 1, 2)
    power_model: str = "vampire"      # vampire | micron | drampower
    power_impl: str = "vectorized"    # vectorized | cuda | reference
    vampire_path: str | None = None   # saved schema-v2 model
    device: str | None = None         # cuda unless the caller names another


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _decode_layout(lm: LM, caches, cspecs, s: int, max_len: int, mesh):
    """The prefill's caches (prompt length ``s``) placed as the decode plan
    places them (``cspecs``) and grown to ``max_len``, as the reference's
    prefill emits them (``out_shardings``).  Each leaf is redistributed
    to its decode placements and a growing leaf is padded on each rank's
    own shard, so no rank holds more of a cache than its decode shard (a
    sequence axis the plan splits is padded whole over that axis, then
    split)."""
    from torch.distributed.tensor import Replicate, Shard

    def one(name, key, t):
        pl = list(placements(cspecs[name][key], mesh))
        if not isinstance(t, DTensor):          # the same on every rank
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if not (lm.grows(name, key) and max_len > s):
            return t.redistribute(mesh, pl)
        whole_seq = [Replicate() if isinstance(p, Shard) and p.dim == 2
                     else p for p in pl]
        local = t.redistribute(mesh, whole_seq).to_local()
        grown = local.new_zeros(local.shape[:2] + (max_len,)
                                + local.shape[3:])
        grown[:, :, :s] = local
        shape = t.shape[:2] + (max_len,) + t.shape[3:]
        g = DTensor.from_local(grown, mesh, whole_seq, run_check=False,
                               shape=shape,
                               stride=torch.empty(shape,
                                                  device="meta").stride())
        return g.redistribute(mesh, pl)
    out = {name: {key: one(name, key, t) for key, t in sub.items()}
           for name, sub in caches.items() if name != "pos"}
    out["pos"] = s
    return out


def run(job: ServeJob) -> dict:
    device = model_api.resolve_device(job.device)
    cfg = registry.get_config(job.arch, smoke=job.smoke)
    lm = LM(cfg)
    max_len = job.prompt_len + job.decode_tokens
    mesh = (make_local_mesh(job.data, job.model, device=device)
            if job.data * job.model > 1 else None)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    params = lm.init(torch.Generator(device=device).manual_seed(job.seed))

    rng = np.random.default_rng(job.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(job.batch, job.prompt_len)),
        dtype=torch.long, device=device)

    aux = None
    if cfg.aux_seq:
        aux = torch.zeros((job.batch, cfg.aux_seq, cfg.d_model),
                          dtype=getattr(torch, cfg.dtype), device=device)

    sharded = contextlib.nullcontext
    if mesh is not None:
        # the decode plan's placements; the batch over data when it divides
        n_data = model_api.mesh_axis(mesh, "data")
        bentry = ("data",) if job.batch % n_data == 0 else None
        plan = R.plan_for(cfg, "decode", job.batch, mesh, False,
                          seq_len=max_len)
        params = steps_lib.place(
            params, specs_for(lm.param_meta(), plan.rules, mesh), mesh)
        prompts = steps_lib.place(prompts, Spec(bentry, None), mesh)
        if aux is not None:
            aux = steps_lib.place(aux, Spec(bentry, None, None), mesh)
        if cfg.moe is not None:
            lm.moe_exec = {"dp_axes": bentry}
        cspecs = specs_for(lm.init_cache_meta(job.batch, max_len),
                           plan.rules, mesh)
        sharded = implicit_replication

    t0 = time.perf_counter()
    with sharded():
        if mesh is None:
            logits, caches = lm.prefill(params, prompts, aux=aux,
                                        max_len=max_len)
        else:
            # the layers' insides batch-sharded and whole over model, as
            # the dry run's prefill cells run them
            lm.boundary_sp = (placements(Spec(bentry, None, None),
                                         mesh),) * 2
            logits, caches = lm.prefill(params, prompts, aux=aux)
            lm.boundary_sp = None
            caches = _decode_layout(lm, caches, cspecs, job.prompt_len,
                                    max_len, mesh)
            logits = shard.constrain(
                logits, placements(Spec(bentry, "model"), mesh))
    _sync(device)
    t_prefill = time.perf_counter() - t0

    def step_tokens(tok):
        return (tok if mesh is None
                else steps_lib.place(tok, Spec(bentry, None), mesh))

    tok = torch.argmax(_full(logits), dim=-1)[:, None]
    sampler = torch.Generator(device=device).manual_seed(job.seed + 1)
    generated = [tok]
    lat = []
    for _ in range(job.decode_tokens - 1):
        t1 = time.perf_counter()
        with sharded():
            logits, caches = lm.decode_step(params, caches, step_tokens(tok))
            logits = _full(logits)
        _sync(device)
        lat.append(time.perf_counter() - t1)
        if job.temperature > 0:
            probs = torch.softmax(logits / job.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=sampler)
        else:
            tok = torch.argmax(logits, dim=-1)[:, None]
        generated.append(tok)

    tokens = torch.cat(generated, dim=1).to(torch.int32)
    lat = np.asarray(lat[1:]) if len(lat) > 1 else np.asarray(lat)
    res = {
        "tokens": tokens.cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_p50_ms": float(np.median(lat) * 1e3) if lat.size else 0.0,
        "decode_p99_ms": float(np.percentile(lat, 99) * 1e3)
        if lat.size else 0.0,
        "tokens_per_s": (job.batch * lat.size / lat.sum())
        if lat.size and lat.sum() > 0 else 0.0,
    }
    if job.power_report:
        # one device's traffic: its shards of the weights and the caches
        local = (lambda tree: tree) if mesh is None else (
            lambda tree: T.tree_map(shard.local_of, tree))
        res["power"] = power_report(
            job, decode_traffic_bytes(lm, local(params), local(caches),
                                      _local_batch(job.batch, mesh)),
            _full(logits), tokens,
            step_seconds=float(np.median(lat)) if lat.size else 1e-3,
            mesh=mesh)
    return res


def _local_batch(batch: int, mesh) -> int:
    """The rows one device's step covers: ``batch / data`` when the data
    axis divides the batch, else the whole batch."""
    n_data = 1 if mesh is None else model_api.mesh_axis(mesh, "data")
    return batch // n_data if batch % n_data == 0 else batch


# ---------------------------------------------------------------------------
# Power reporting
# ---------------------------------------------------------------------------
def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_nbytes(x) for x in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(x) for x in tree)
    return 0


def decode_traffic_bytes(lm: LM, params, caches, batch: int) -> float:
    """The device-memory bytes one decode step must move: every parameter
    byte read once (MoE included: the dispatch runs every expert on its
    ``cap >= 8`` slots), every cache byte read once (``decode_attention``
    and ``mla_decode`` read the whole ``max_len`` cache under their mask,
    cross-attention the whole memory), the new self-attention slots
    written (K/V and their scales, or the MLA latent and RoPE key), Mamba2's
    state and conv window written whole, and the float32 logits written.
    The reference counts the compiled step's HLO traffic instead."""
    layer_caches = {k: v for k, v in caches.items() if k != "pos"}
    written = 0
    for sub, leaves in layer_caches.items():
        for name, t in leaves.items():
            if lm.grows(sub, name):        # (layers, batch, max_len, ...)
                written += tree_nbytes(t) // t.shape[2]
            elif name in ("state", "conv"):
                written += tree_nbytes(t)
    logits = batch * lm.cfg.vocab_padded * 4
    return float(tree_nbytes(params) + tree_nbytes(layer_caches) + written
                 + logits)


def _load_estimator(job: ServeJob, device):
    """Resolve the power model: a saved schema-v2 file if given, else the
    committed quick fit — then adapt it to the requested ``power_model``
    kind."""
    model = model_api.load_estimator(job.vampire_path or str(QUICK_FIT),
                                     device=device)
    if model.kind == job.power_model:
        return model
    if model.kind != "vampire":
        raise ValueError(
            f"{job.vampire_path} holds a {model.kind!r} estimator but "
            f"power_model={job.power_model!r} was requested")
    return model_api.make_estimator(job.power_model, model)


def lint_ingested(seq_traces) -> None:
    """Batched protocol lint of traces bound for the power report.  Raises
    :class:`repro_torch.analysis.trace_lint.TraceProtocolError` carrying
    the structured diagnostics when any ingested trace is protocol-illegal
    (``power_report`` itself admits through the service, whose gate runs
    the same linter)."""
    from repro_torch.analysis import trace_lint
    trace_lint.lint_ingested(seq_traces, origin="serve.power_report")


def power_report(job: ServeJob, traffic: float, logits, tokens, *,
                 step_seconds: float, mesh=None) -> dict:
    """Score one decode batch's memory traffic through the estimation
    service.

    One DRAM command trace per sequence (carrying that sequence's actual
    logits/token bytes as line data), admitted through the
    :class:`~repro_torch.serving.EstimationService` — lint-gated, bucketed,
    the model resident on the logits' device, and the dispatch sharded
    over ``mesh`` when it has more than one device.  ``traffic`` is one
    device's, which covers ``batch / data`` sequences when the data axis
    divides the batch.  Energies scale from each trace's modeled bytes to
    the step's traffic share; the service's metrics ride along under
    ``"serving"``."""
    from repro_torch.analysis import trace_lint
    from repro_torch.core import hbm, traces
    from repro_torch.core.dram import LINE_BYTES
    from repro_torch.serving import EstimationService, ServiceConfig

    model = _load_estimator(job, logits.device)
    vendors = [v for v in job.power_vendors if v in model.vendors]
    bytes_per_seq = traffic / max(_local_batch(job.batch, mesh), 1)

    logits_np = logits.detach().to(torch.float32).cpu().numpy()
    tokens_np = np.asarray(tokens.cpu().numpy(), np.int32)
    seq_traces = []
    for b in range(job.batch):
        # the sequence's real decode output bytes, recycled to fill the
        # traffic share (decode re-reads the same weights every step, so
        # repeating content is the honest analogue)
        payload = logits_np[b].tobytes() + tokens_np[b].tobytes()
        lines = traces.lines_from_bytes(payload)
        n_req = int(min(max(bytes_per_seq // LINE_BYTES, 8), 512))
        reps = int(np.ceil(n_req / max(len(lines), 1)))
        lines = np.tile(lines, (max(reps, 1), 1))[:n_req]
        spec = traces.AppSpec(f"decode{b}", intensity=0.8, row_hit=0.7,
                              read_frac=0.85, data_dist="random",
                              seed=job.seed + b)
        seq_traces.append(traces.app_trace(spec, n_requests=n_req,
                                           lines=lines))

    # the service lints on admission (never bill a protocol-illegal trace)
    # and dispatches the whole batch on the ring's bucketed pad shapes
    svc = EstimationService(model, ServiceConfig(impl=job.power_impl),
                            mesh=mesh)
    tickets, rejections = svc.submit_many(seq_traces, vendors)
    if rejections:
        raise trace_lint.TraceProtocolError(
            [d for r in rejections for d in r.diagnostics],
            origin="serve.power_report")
    svc.close()
    rows = [svc.result(t) for t in tickets]               # B vendor-rows

    modeled_bytes = np.asarray(
        [traces.trace_request_lines(tr).shape[0] * LINE_BYTES
         for tr in seq_traces], np.float64)
    scale = (bytes_per_seq / np.maximum(modeled_bytes, 1.0))[:, None]
    energy_pj = torch.stack([r.energy_pj for r in rows]).to(
        torch.float64).numpy() * scale                    # (B, V) per step

    out = {
        "vendors": list(vendors),
        "power_model": model.kind,
        "traffic_bytes_per_step": traffic,
        "bytes_per_seq_per_step": bytes_per_seq,
        "ddr_energy_pj_per_seq_step": energy_pj,          # (B, V)
        "ddr_energy_uj_per_token_mean": float(energy_pj.mean() * 1e-6),
        "serving": dataclasses.asdict(svc.metrics()),
    }
    # the HBM2e-anchored extrapolation needs fitted VAMPIRE PowerParams;
    # the datasheet baselines have none (no data dependency to anchor)
    if model.kind == "vampire":
        ones_frac, toggle_frac = hbm.tensor_stats(logits)
        hmodel = hbm.HbmEnergyModel.from_vampire(model.params(vendors[0]))
        step = hbm.step_energy(hmodel, read_bytes=traffic * 0.85,
                               write_bytes=traffic * 0.15,
                               step_seconds=step_seconds,
                               ones_frac=ones_frac, toggle_frac=toggle_frac)
        out.update(hbm_step_energy_uj=step.total_pj * 1e-6,
                   hbm_ones_frac=ones_frac, hbm_toggle_frac=toggle_frac)
    return out


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen2.5-3b")
    p.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the reduced config (--no-smoke: published widths)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--decode-tokens", type=int, default=32)
    p.add_argument("--data", type=int, default=1,
                   help="data-parallel mesh axis size (a mesh when data x "
                        "model > 1: run under torchrun)")
    p.add_argument("--model", type=int, default=1,
                   help="model-parallel mesh axis size")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--power-report", action="store_true")
    p.add_argument("--power-model", default="vampire",
                   choices=model_api.ESTIMATOR_KINDS,
                   help="estimator kind scoring the decode memory traffic")
    p.add_argument("--power-impl", default="vectorized",
                   choices=model_api.registered_impls(),
                   help="impl-registry evaluation path for the power report")
    p.add_argument("--vampire", default=None,
                   help="saved schema-v2 model file; the committed quick "
                        "fit when omitted")
    args = p.parse_args()
    res = run(ServeJob(arch=args.arch, smoke=args.smoke, batch=args.batch,
                       prompt_len=args.prompt_len,
                       decode_tokens=args.decode_tokens,
                       data=args.data, model=args.model, seed=args.seed,
                       temperature=args.temperature,
                       power_report=args.power_report,
                       power_model=args.power_model,
                       power_impl=args.power_impl,
                       vampire_path=args.vampire, device=args.device))
    if _rank() != 0:
        return
    print(f"prefill={res['prefill_s']:.2f}s decode p50="
          f"{res['decode_p50_ms']:.1f}ms p99={res['decode_p99_ms']:.1f}ms "
          f"throughput={res['tokens_per_s']:.1f} tok/s")
    if "power" in res:
        pw = res["power"]
        line = (f"power[{pw['power_model']}]: "
                f"{pw['traffic_bytes_per_step']/1e6:.1f} MB/step memory "
                f"traffic, DDR-model {pw['ddr_energy_uj_per_token_mean']:.2f} "
                f"uJ/token (vendors {pw['vendors']})")
        if "hbm_step_energy_uj" in pw:
            line += f", HBM2e-anchored {pw['hbm_step_energy_uj']:.1f} uJ/step"
        print(line)


if __name__ == "__main__":
    main()
