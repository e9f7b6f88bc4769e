"""The port's dry run beyond the dense decoders' (4, 4) cells: the dense
cells on meshes with an axis of one device (F9), the MLA, MoE,
cross-attention and encoder cells, a multi-pod MoE train cell, and the
expert-parallel MoE's prefill and the MoE and MLA train cells'
collectives (F10), counted from their plans.

Traced in a subprocess at smoke widths, batch 8, as
``test_torch_dryrun.py`` traces (the fake process group is process
state); the gloo runs hold the MoE, MLA and encoder-decoder steps'
real values against one process."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
NEW = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b", "llama-3.2-vision-11b",
       "whisper-small")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")

SCRIPT = textwrap.dedent("""\
    import json, logging, sys
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh

    new, shapes = json.loads(sys.argv[1])
    out = {}
    kw = dict(smoke=True, batch_override=8)
    for data, model in ((4, 1), (1, 4)):
        mesh = make_local_mesh(data=data, model=model, fake=True)
        for shape in shapes:
            out[f"qwen2.5-3b__{shape}__{data}x{model}"] = steps.dryrun_cell(
                "qwen2.5-3b", shape, mesh, multi_pod=False, **kw)
    mesh = make_local_mesh(data=4, model=4, fake=True)
    for arch in new:
        for shape in shapes:
            out[f"{arch}__{shape}__4x4"] = steps.dryrun_cell(
                arch, shape, mesh, multi_pod=False, **kw)
    mesh = make_local_mesh(data=2, model=2, fake=True)
    out["qwen3-moe-30b-a3b__prefill_32k__2x2"] = steps.dryrun_cell(
        "qwen3-moe-30b-a3b", "prefill_32k", mesh, multi_pod=False, **kw)
    for arch in ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"):
        out[f"{arch}__train_4k__2x2"] = steps.dryrun_cell(
            arch, "train_4k", mesh, multi_pod=False, **kw)

    # one AdamW update with int8 moments (jamba's plan) of a weight whose
    # rows are split over data and columns over model
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models.meta import ParamMeta, ShardingRules, specs_for
    from repro_torch.optim import adamw
    rules = ShardingRules({"embed": "data", "ffn": "model"})
    pmeta = {"w": ParamMeta((64, 32), ("embed", "ffn"))}
    ocfg = adamw.AdamWConfig(quantize_moments=True)
    ometa = adamw.state_meta(pmeta, ocfg)
    a = OpAnalysis()
    with FakeTensorMode():
        place = lambda m: steps._fake_dtensors(m, steps.shard_tree(
            mesh, specs_for(m, rules, mesh)), mesh)
        params, grads, state = place(pmeta), place(pmeta), place(ometa)
        with implicit_replication(), a:
            adamw.update(grads, state, params, ocfg)
    out["int8_update__2x2"] = a.report().collective_bytes
    mesh = make_local_mesh(data=2, model=4, pod=2, fake=True)
    out["qwen3-moe-30b-a3b__train_4k__2x2x4"] = steps.dryrun_cell(
        "qwen3-moe-30b-a3b", "train_4k", mesh, multi_pod=True, **kw)
    print(json.dumps(out))
    """)


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def cells():
    proc = _run(["-c", SCRIPT, json.dumps([NEW, SHAPES])])
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", ["4x1", "1x4"])
@pytest.mark.parametrize("shape", SHAPES)
def test_dense_cells_trace_on_an_axis_of_one_device(cells, shape, mesh):
    """F9: a mesh whose data or model axis is one device wide traces
    every dense shape; an axis of one device shards nothing, so the
    (4, 1) decode step, batch over data and nothing over model, issues
    no collective, as the reference's does on that mesh, and the (4, 1)
    train step only all-reduces (its gradients, once each: each device
    looks up its own tokens in the whole table)."""
    res = cells[f"qwen2.5-3b__{shape}__{mesh}"]
    assert res["mesh"] == mesh and res["n_devices"] == 4
    assert res["flops_per_device"] > 0 and res["traffic_bytes_per_device"] > 0
    if mesh == "4x1":
        assert set(res["collective_bytes_per_device"]) <= {"all-reduce"}
    if mesh == "4x1" and shape == "decode_32k":
        assert res["collective_total_bytes_per_device"] == 0
        assert res["collective_bytes_per_device"] == {}
    if mesh == "1x4":
        assert res["collective_total_bytes_per_device"] > 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", NEW)
def test_new_cells_hold_the_artifact_invariants(cells, arch, shape):
    """``test_torch_dryrun.py``'s invariants for the 12 new smoke cells
    on a (4, 4) mesh: counts above 0, no score traffic (the flash op is
    shape-only at MLA's (192, 128) widths and in cross attention too),
    collectives on a sharded mesh, the torch that counted them."""
    res = cells[f"{arch}__{shape}__4x4"]
    assert res["kind"] == shape.split("_")[0]
    assert res["flops_per_device"] > 0
    assert res["traffic_bytes_per_device"] > 0
    assert res["memory"]["peak_bytes_est"] > 0
    assert res["memory"]["argument_bytes"] > 0
    assert res["score_traffic_bytes_per_device"] == 0
    assert res["kernel_adjusted_traffic_bytes_per_device"] \
        == res["traffic_bytes_per_device"]
    assert res["collective_total_bytes_per_device"] > 0
    assert res["torch"] == torch.__version__


def test_a_multipod_moe_train_cell(cells):
    res = cells["qwen3-moe-30b-a3b__train_4k__2x2x4"]
    assert res["multi_pod"] and res["mesh"] == "2x2x4"
    assert res["n_devices"] == 16 and res["batch"] == 8
    assert res["flops_per_device"] > 0
    assert res["score_traffic_bytes_per_device"] == 0
    reduce = ("all-reduce", "reduce-scatter")
    assert sum(res["collective_bytes_per_device"].get(k, 0)
               for k in reduce) > 0


def test_the_moe_collectives_are_the_plans(cells):
    """The qwen3-moe smoke ``prefill_32k`` cell on (2, 2), no FSDP,
    against a count from its plan: each MoE layer adds exactly one bf16
    (rows, d) all-reduce over ``model`` (the expert-parallel MoE's sum of
    partial outputs) and no all-gather, beside the vocab-sharded lookup's
    and each attention output's all-reduce; its auxiliary loss (which the
    port's prefill forms) reduces the expert counts and the mean
    probabilities over the data shards, a float32 per expert each; the
    only all-gathers are the emitted K/V caches', moved from head shards
    to sequence shards (each whole kv head, ``R`` stacked layers)."""
    from repro_torch.configs import registry
    cfg = registry.get_config("qwen3-moe-30b-a3b", smoke=True)
    res = cells["qwen3-moe-30b-a3b__prefill_32k__2x2"]
    assert (res["fsdp"], res["batch"]) == (False, 8)
    rows = 8 // 2 * 32768                 # a device's (batch x sequence)
    act = rows * cfg.d_model * 2
    kv = cfg.n_layers * rows * cfg.n_kv * cfg.d_head * 2
    aux = 2 * cfg.moe.n_experts * 4
    assert res["collective_bytes_per_device"] == {
        "all-reduce": (1 + 2 * cfg.n_layers) * act + cfg.n_layers * aux,
        "all-gather": 2 * kv}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_the_moe_and_mla_train_collectives_are_the_plans(cells, arch):
    """F10: the MoE (qwen3-moe) and MLA-with-MoE (deepseek) smoke
    ``train_4k`` cells on (2, 2), no FSDP, one microbatch, against a
    count from their plan, as ``test_torch_dryrun.py``'s dense train
    cell is counted.  Each collective is placed by the port, none left
    to DTensor (whose choices differ between torch 2.11 and 2.13): MLA
    and the MoE run on each device's heads and experts
    (``shard.model_parallel``), the MoE's auxiliary loss from its own
    routing.  All of them are all-reduces:

    * a bf16 (rows, d) activation at the vocab-sharded lookup and its
      gradient, at each layer's two outputs (the attention's and the
      MoE's) and its recomputed attention output, and at each layer's
      two input gradients (each reduced once, where the attention and
      the MoE take their input);
    * each gradient's shard once over data, and a leaf whole over model
      (the router, the norms, MLA's latent projections) once more over
      model; the embedding table's gradient, which the lookup's backward
      leaves whole over model, whole over data;
    * the loss's row max, sum of exponentials and gold logit, a float32
      a row each; the global norm's two float32 scalars;
    * the auxiliary loss's expert counts and mean probabilities, a
      float32 an expert each over data, in each MoE layer's forward and
      again in its recomputation."""
    import math

    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    from repro_torch.models.meta import Spec, is_meta, specs_for
    from repro_torch.sharding import rules as R

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (2, 2)
    cfg = registry.get_config(arch, smoke=True)
    res = cells[f"{arch}__train_4k__2x2"]
    assert (res["fsdp"], res["zero1"], res["microbatches"]) \
        == (False, False, 1)
    rules = R.plan_for(cfg, "train", 8, Mesh, False, seq_len=4096).rules
    rows = 8 // 2 * 4096                  # a device's (batch x sequence)
    act, row = rows * cfg.d_model * 2, rows * 4
    meta = LM(cfg).param_meta()
    grads = norms = 0
    for (path, m), spec in zip(
            T.leaves_with_paths(meta, is_leaf=is_meta),
            T.leaves(specs_for(meta, rules, Mesh),
                     is_leaf=lambda x: isinstance(x, Spec))):
        n = 2 * math.prod(m.shape)
        if path == "['embed']":
            grads += n
        elif "model" in tuple(spec):
            grads += n // 2
        else:
            grads, norms = grads + n, norms + n
    layers = cfg.n_layers
    aux = 4 * cfg.moe.n_experts * 4 * layers
    assert res["collective_bytes_per_device"] == {
        "all-reduce": (2 + 5 * layers) * act + grads + norms + 3 * row + 8
        + aux}


def test_the_int8_moments_reduce_their_row_maxima_once(cells):
    """An AdamW step with int8 moments (jamba's plan) of a (64, 32)
    weight split over data by rows and over model by columns: each
    moment's row maxima (32 rows a device, float32) all-reduced once
    over model, by hand, and the global norm's float32 scalar over data
    and over model; no reduce-scatter and no gather (torch 2.13's
    DTensor chose those where 2.11's all-reduced)."""
    assert cells["int8_update__2x2"] == {"all-reduce": 2 * 32 * 4 + 2 * 4}


@pytest.mark.parametrize("arch,mesh", [
    ("qwen2-7b", (2, 1)),
    ("qwen3-moe-30b-a3b", (1, 4)), ("qwen3-moe-30b-a3b", (2, 2)),
    ("deepseek-v2-lite-16b", (1, 4)), ("deepseek-v2-lite-16b", (2, 2)),
    ("whisper-small", (1, 4))])
def test_the_sharded_step_computes_the_one_device_step(arch, mesh):
    """``torch_gloo_step.py --arch``: ``gloo`` processes run the MoE
    (expert-parallel, local routing), MLA (the RoPE key broadcast to
    each device's heads, the absorbed decode) and encoder-decoder smoke
    steps, and the dense step on a data-only (2, 1) mesh (F9's kind: the
    table whole, each device's lookup local), with real values; the
    loss, every gradient, a two-microbatch
    train step's norm and moments, and a decode step's logits and cache
    equal one process's at the dense test's bars.  Over a data axis of
    two the capacity is raised so that no token drops (the one-process
    step routes the whole batch at once)."""
    proc = _run(["tests/torch_gloo_step.py", "--mesh", *map(str, mesh),
                 "--arch", arch])
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loss_err"] <= 1e-6 * abs(res["loss"])
    assert res["grad_err"] < 1e-5
    assert res["norm_err"] < 1e-5 and res["moment_err"] < 1e-5
    assert res["logit_err"] < 1e-5 and res["cache_err"] < 1e-5
