"""The port's dry run of the Mamba2 and hybrid stacks: every mamba2-780m
and jamba-1.5-large-398b cell (``long_500k`` included) at smoke widths
on (4, 4), (4, 1) and (1, 4) fake meshes, a device's share of one
Mamba2 layer's products, the ``long_500k`` cache's split over ``data``
and ``model``, the sharded steps' real values over ``gloo`` against one
process, and the one-process loss against the JAX package's.

Traced in a subprocess, as ``test_torch_dryrun.py`` traces (the fake
process group is process state): batch 8, but ``long_500k`` at its own
batch of 1, which does not divide over ``data``."""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-780m", "jamba-1.5-large-398b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("4x4", "4x1", "1x4")
LAYER = (8, 64)          # (batch, sequence) of the one-layer count

SCRIPT = textwrap.dedent("""\
    import json, logging, sys
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import layers as L
    from repro_torch.models.meta import Spec, abstractify, specs_for
    from repro_torch.sharding import rules as R

    archs, shapes, meshes, (b, s) = json.loads(sys.argv[1])
    out = {}
    for tag in meshes:
        data, model = map(int, tag.split("x"))
        mesh = make_local_mesh(data=data, model=model, fake=True)
        for arch in archs:
            for shape in shapes:
                kw = {} if shape == "long_500k" else {"batch_override": 8}
                out[f"{arch}__{shape}__{tag}"] = steps.dryrun_cell(
                    arch, shape, mesh, multi_pod=False, smoke=True, **kw)

    # the long_500k cache of jamba's attention layer on (4, 4)
    mesh = make_local_mesh(data=4, model=4, fake=True)
    cell = steps.build_cell("jamba-1.5-large-398b", "long_500k", mesh,
                            multi_pod=False, smoke=True)
    k = cell.example_args[1]["sub4"]["k"]
    state = cell.example_args[1]["sub0"]["state"]
    out["long_cache"] = {
        "kv_seq": cell.plan.rules.rules["kv_seq"],
        "moe_exec": cell.lm.moe_exec,
        "k_shape": list(k.shape), "k_local": list(k.to_local().shape),
        "k_placements": [repr(p) for p in k.placements],
        "state_local": list(state.to_local().shape)}

    # one mamba2 layer's forward: a device's products on (1, 4) against
    # one device's
    cfg = registry.get_config("mamba2-780m", smoke=True)
    meta = L.mamba_meta(cfg)
    rules = R.make_rules(cfg)
    flops = {}
    for tag in ("1x1", "1x4"):
        mesh = make_local_mesh(1, int(tag[-1]), fake=True)
        a = OpAnalysis()
        with FakeTensorMode():
            x = torch.empty(b, s, cfg.d_model, dtype=torch.bfloat16)
            if tag == "1x1":
                params = abstractify(meta, dtype=torch.bfloat16)
            else:
                params = steps._fake_dtensors(meta, steps.shard_tree(
                    mesh, specs_for(meta, rules, mesh)), mesh,
                    dtype=torch.bfloat16)
                x = steps._placed(x, mesh, Spec("data", None, None))
            with implicit_replication(), a:
                L.mamba_apply(params, x, cfg)
        flops[tag] = a.report().flops
    out["layer_flops"] = flops
    print(json.dumps(out))
    """)


def _run(args, timeout=900):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def cells():
    proc = _run(["-c", SCRIPT, json.dumps([ARCHS, SHAPES, MESHES, LAYER])])
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_cells_hold_the_artifact_invariants(cells, arch, shape, mesh):
    """``test_torch_dryrun.py``'s invariants for each smoke cell: counts
    above 0, no score traffic (jamba's attention runs the flash op's
    shape-only path; Mamba2 has no attention), the torch that counted
    them; collectives wherever ``model`` splits the heads, and none in a
    (4, 1) decode step, whose batch splits over ``data`` and nothing
    else (``long_500k``'s one row is whole on every device there)."""
    res = cells[f"{arch}__{shape}__{mesh}"]
    assert res["kind"] == ("decode" if shape == "long_500k"
                           else shape.split("_")[0])
    assert res["mesh"] == mesh
    assert res["n_devices"] == math.prod(map(int, mesh.split("x")))
    assert res["batch"] == (1 if shape == "long_500k" else 8)
    assert res["flops_per_device"] > 0
    assert res["traffic_bytes_per_device"] > 0
    assert res["memory"]["peak_bytes_est"] > 0
    assert res["memory"]["argument_bytes"] > 0
    assert res["score_traffic_bytes_per_device"] == 0
    assert res["kernel_adjusted_traffic_bytes_per_device"] \
        == res["traffic_bytes_per_device"]
    assert res["torch"] == torch.__version__
    if mesh != "4x1":
        assert res["collective_total_bytes_per_device"] > 0
    elif res["kind"] == "decode" and shape != "long_500k":
        assert res["collective_bytes_per_device"] == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_the_heads_split_the_work_over_model(cells, arch):
    """Over a 4-way ``model`` axis a device does at most a third of the
    1 x 1 cell's operations (a quarter of the heads' work, with the B and
    C terms, the embedding and the loss whole), and over a 4-way ``data``
    axis a quarter of the batch's."""
    for shape in ("train_4k", "prefill_32k"):
        one = cells[f"{arch}__{shape}__4x1"]["flops_per_device"] * 4
        assert cells[f"{arch}__{shape}__1x4"]["flops_per_device"] \
            < one / 3, shape
        assert cells[f"{arch}__{shape}__4x4"]["flops_per_device"] \
            < one / 12, shape


def test_a_devices_mamba2_products_are_its_heads_and_its_groups(cells):
    """One mamba2 layer's forward (batch 8, 64 tokens) on a (1, 4) mesh
    against one device: every product indexed by heads (the z, x and dt
    columns of the input projection, the intra-chunk and carried-state
    terms, each chunk's state, the output projection) divides by 4; the
    group-form terms, which have no head index (the B and C columns of
    the projection, the C . B scores of each chunk), are counted whole,
    as the reference computes them; and a device projects the last
    ``W - 1`` tokens once more onto its share of the conv columns as
    stored, the decode window its cache holds."""
    from repro_torch.configs import registry
    cfg = registry.get_config("mamba2-780m", smoke=True)
    s = cfg.ssm
    b, seq = LAYER
    d, gn = cfg.d_model, s.n_groups * s.d_state
    cl = min(s.chunk, seq)
    group = 2 * b * seq * d * 2 * gn \
        + 2 * b * (seq // cl) * cl * cl * s.n_groups * s.d_state
    window = 2 * b * (s.conv_width - 1) * d * (s.d_inner(d) + 2 * gn) // 4
    flops = cells["layer_flops"]
    assert flops["1x4"] == (flops["1x1"] - group) // 4 + group + window


def test_long_500k_splits_the_cache_over_data_and_model(cells):
    """``long_500k`` decodes one row over 524,288 slots: the row does not
    divide over ``data``, so the batch is whole on every device, the
    MoE routes the same token on each, and jamba's attention cache
    splits its sequence over ``data`` and ``model`` (16 ways on (4, 4)):
    2 kv heads whole, 32,768 slots a device.  The Mamba2 state splits
    by heads (2 of 8 a device)."""
    lc = cells["long_cache"]
    assert lc["kv_seq"] == ["data", "model"]
    assert lc["moe_exec"] == {"dp_axes": None}
    assert lc["k_shape"] == [1, 1, 524288, 2, 16]
    assert lc["k_local"] == [1, 1, 524288 // 16, 2, 16]
    assert lc["k_placements"] == ["Shard(dim=2)", "Shard(dim=2)"]
    assert lc["state_local"] == [1, 1, 2, 16, 16]


# jamba's smoke model is badly conditioned in float32 (as
# ``test_torch_train_grads.py`` finds for its gradients): its one-process
# float32 step is itself up to 2.0e-5 of a gradient leaf's largest value
# and 1.6e-5 (absolute) on a state cache of |x| ~ 14 off the same step
# with dtype float64 (``test_jambas_float32_step_is_this_far_off``).  Its
# sharded step is held at about 2.5x those gaps; mamba2 at the dense
# test's.
GRAD_BAR = {"mamba2-780m": 1e-5, "jamba-1.5-large-398b": 5e-5}
ABS_BAR = {"mamba2-780m": 1e-5, "jamba-1.5-large-398b": 4e-5}


@pytest.mark.parametrize("arch,mesh,rows", [
    ("mamba2-780m", (1, 4), 2), ("mamba2-780m", (2, 2), 1),
    ("jamba-1.5-large-398b", (1, 4), 2),
    ("jamba-1.5-large-398b", (2, 2), 1)])
def test_the_sharded_step_computes_the_one_device_step(arch, mesh, rows):
    """``torch_gloo_step.py --arch``: four ``gloo`` processes run the
    Mamba2 and jamba smoke steps with real values: the loss, every
    gradient, a two-microbatch train step's norm and moments, a
    prefill's last logits and every cache leaf (the state split by
    heads, the conv window by its columns as stored) and a decode step's
    logits and caches written in place equal one process's.  With one
    row on (2, 2) the decode is ``long_500k``'s: the row whole on every
    device, jamba's attention cache split over ``data`` and ``model``."""
    proc = subprocess.run(
        [sys.executable, "tests/torch_gloo_step.py", "--mesh",
         *map(str, mesh), "--arch", arch, "--decode-rows", str(rows)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["kv_seq"] == (["data", "model"] if rows == 1 else ["model"])
    assert res["loss_err"] <= 1e-6 * abs(res["loss"])
    assert res["grad_err"] < GRAD_BAR[arch]
    assert res["moment_err"] < GRAD_BAR[arch]
    assert res["norm_err"] < 1e-5
    for key in ("prefill_err", "logit_err", "cache_err"):
        assert res[key] < ABS_BAR[arch], key


def _one_process(arch, dtype):
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              dtype=dtype)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 32), generator=g)
             for k in ("tokens", "labels")}
    _, grads = steps.value_and_grad(lm, params, batch)
    _, caches = lm.prefill(params, batch["tokens"][:, :9])
    return grads, caches


def test_jambas_float32_step_is_this_far_off():
    """The gaps that set jamba's bars above: its one-process float32
    gradients and prefill caches against the same step with dtype
    float64 (the gloo script's weights and tokens)."""
    from repro_torch import tree as T
    g32, c32 = _one_process("jamba-1.5-large-398b", "float32")
    g64, c64 = _one_process("jamba-1.5-large-398b", "float64")
    grad_gap = max(float((a.double() - b).abs().max() / b.abs().max())
                   for a, b in zip(T.leaves(g32), T.leaves(g64)))
    cache_gap = max(float((a.double() - b).abs().max())
                    for a, b in zip(T.leaves(c32), T.leaves(c64))
                    if isinstance(a, torch.Tensor))
    assert grad_gap < GRAD_BAR["jamba-1.5-large-398b"] / 2
    assert cache_gap < ABS_BAR["jamba-1.5-large-398b"] / 2


@pytest.mark.parametrize("arch", ARCHS)
def test_the_one_process_loss_is_the_references(arch):
    """The smoke step's loss (nll and the MoE auxiliary loss) on the
    reference's own weights, carried across by
    ``convert.lm_params_from_jax``, against ``repro``'s ``LM.loss`` in
    float32, at ``test_torch_train_grads.py``'s bar (rtol 1e-4)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as rreg
    from repro.models.lm import LM as RLM
    from repro_torch import convert
    from repro_torch.configs import registry as preg
    from repro_torch.models.lm import LM as PLM
    rcfg, pcfg = (dataclasses.replace(reg.get_config(arch, smoke=True),
                                      dtype="float32") for reg in (rreg, preg))
    params = jax.tree_util.tree_map(np.asarray,
                                    RLM(rcfg).init(jax.random.key(0)))
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rloss, rex = RLM(rcfg).loss(jax.tree_util.tree_map(jnp.asarray, params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, pex = PLM(pcfg).loss(convert.lm_params_from_jax(params, pcfg),
                                {k: torch.from_numpy(v).long()
                                 for k, v in batch.items()})
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-4)
    for name in ("nll", "aux_loss"):
        np.testing.assert_allclose(float(pex[name]), float(rex[name]),
                                   rtol=1e-4, atol=1e-7)
    assert math.isfinite(float(ploss))
