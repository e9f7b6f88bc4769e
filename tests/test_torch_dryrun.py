"""The port's dry run: the step traced on fake tensors on fake meshes.

In a subprocess (the fake process group is process state, and the
pytest process keeps none), as ``test_dryrun_integration.py`` runs the
reference's: qwen2.5-3b ``train_4k`` at smoke widths, batch 8, on a
(4, 4) fake mesh and a (2, 2, 4) multi-pod one, holding that file's
invariants, on a (2, 2) mesh, whose collectives are counted from its
plan, and on a 1 x 1 mesh, where the counted operations equal
``chip_smoke.train_work``'s closed form; the prefill and decode cells
(bf16 and int8 caches); a Mamba2 cell's build; the CLI (mamba2-780m's
cells at full width) and the three hills; and, over four
``gloo`` processes with real values, the sharded step against the
one-process step.  In process:
``OpAnalysis``'s rules on plain fake tensors, and the flash wrappers'
shape-only path."""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""\
    import json, logging, sys
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    kw = dict(smoke=True, batch_override=8)
    mesh = make_local_mesh(data=4, model=4, fake=True)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        out[shape] = steps.dryrun_cell("qwen2.5-3b", shape, mesh,
                                       multi_pod=False, **kw)
    cell = steps.build_cell("mamba2-780m", "train_4k", mesh,
                            multi_pod=False, **kw)
    w = cell.example_args[0]["layers"][0]["mixer"]["in_proj"]
    out["mamba2_cell"] = {
        "kind": cell.kind, "boundary_sp": cell.lm.boundary_sp,
        "moe_exec": cell.lm.moe_exec, "in_proj": list(w.shape),
        "in_proj_placements": [repr(p) for p in w.placements]}
    out["decode_int8"] = steps.dryrun_cell(
        "granite-8b", "decode_32k", mesh, multi_pod=False,
        kv_cache_dtype="int8", **kw)
    out["decode_bf16"] = steps.dryrun_cell(
        "granite-8b", "decode_32k", mesh, multi_pod=False, **kw)
    mesh = make_local_mesh(data=2, model=2, fake=True)
    out["train_4k__2x2"] = steps.dryrun_cell("qwen2.5-3b", "train_4k", mesh,
                                             multi_pod=False, **kw)
    mesh = make_local_mesh(data=2, model=4, pod=2, fake=True)
    out["train_4k__mp"] = steps.dryrun_cell("qwen2.5-3b", "train_4k", mesh,
                                            multi_pod=True, **kw)
    mesh = make_local_mesh(1, 1, fake=True)
    out["train_4k__1x1"] = steps.dryrun_cell("qwen2.5-3b", "train_4k", mesh,
                                             multi_pod=False, **kw)
    print(json.dumps(out))
    """)


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def cells():
    proc = _run(["-c", SCRIPT])
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _artifacts(cells):
    return {k: v for k, v in cells.items() if k != "mamba2_cell"}


def test_artifact_invariants(cells):
    for name, res in _artifacts(cells).items():
        assert res["flops_per_device"] > 0, name
        assert res["traffic_bytes_per_device"] > 0, name
        assert res["memory"]["peak_bytes_est"] > 0, name
        assert res["memory"]["argument_bytes"] > 0, name
        assert res["kernel_adjusted_traffic_bytes_per_device"] \
            == res["traffic_bytes_per_device"] \
            - res["score_traffic_bytes_per_device"], name
        # the flash kernels' shape-only ops: no score tile reaches memory
        assert res["score_traffic_bytes_per_device"] == 0, name
        assert res["torch"] == torch.__version__, name


def test_sharded_cells_have_collectives(cells):
    for name, res in _artifacts(cells).items():
        if name.endswith("__1x1"):
            assert res["collective_total_bytes_per_device"] == 0
            continue
        assert res["collective_total_bytes_per_device"] > 0, name
        assert any(k in res["collective_bytes_per_device"]
                   for k in ("all-reduce", "all-gather", "reduce-scatter"))


def test_multipod_adds_reduction_traffic(cells):
    sp, mp = cells["train_4k"], cells["train_4k__mp"]
    assert mp["n_devices"] == 16 and sp["n_devices"] == 16
    assert mp["multi_pod"] and not sp["multi_pod"]
    assert mp["mesh"] == "2x2x4" and sp["mesh"] == "4x4"
    reduce = ("all-reduce", "reduce-scatter")
    assert sum(mp["collective_bytes_per_device"].get(k, 0) for k in reduce) \
        > sum(sp["collective_bytes_per_device"].get(k, 0) for k in reduce)


def test_the_work_divides_over_the_mesh(cells):
    """The (4, 4) train step counts a 16th of the 1 x 1 step's operations:
    batch over data, heads, the MLP and the vocabulary over model, with
    no replicated compute."""
    assert cells["train_4k"]["flops_per_device"] * 16 \
        == cells["train_4k__1x1"]["flops_per_device"]


def test_the_collectives_are_the_plans(cells):
    """The (2, 2) train cell's collectives, a device's bytes by kind,
    against a count from its plan: no FSDP, one microbatch, the weights
    split over the 2-way model axis by their vocab, head and MLP columns,
    the batch over the 2-way data axis, the embedding tied.  The count
    holds DTensor's choices still: a torch whose DTensor reshards
    differently fails here (the train cells' collectives once moved with
    torch's version).

    All of them are all-reduces:

    * a bf16 (rows, d) activation at the vocab-sharded lookup, at each
      layer's two row-parallel outputs and its recomputed attention
      output, and at each layer's two column-parallel input gradients
      and the tied head's;
    * each gradient's shard once over data, and the replicated norm
      scales' once more over model (they are formed from their inputs'
      partial gradients);
    * the loss's row max, sum of exponentials and gold logit, a float32
      a row each;
    * the global norm's two float32 scalars."""
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    from repro_torch.models.meta import is_meta
    from repro_torch import tree as T
    cfg = registry.get_config("qwen2.5-3b", smoke=True)
    res = cells["train_4k__2x2"]
    assert (res["fsdp"], res["zero1"], res["microbatches"]) \
        == (False, False, 1)
    rows = 8 // 2 * 4096                  # a device's (batch x sequence)
    act, row = rows * cfg.d_model * 2, rows * 4
    model_axes = {"vocab", "heads_dh", "kv_dh", "ffn"}
    grads = norms = 0
    for m in T.leaves(LM(cfg).param_meta(), is_leaf=is_meta):
        n = 2 * math.prod(m.shape)
        if model_axes & set(m.logical):
            grads += n // 2
        else:
            grads, norms = grads + n, norms + n
    layers = cfg.n_layers
    assert res["collective_bytes_per_device"] == {
        "all-reduce": (2 + 5 * layers) * act + grads + norms + 3 * row + 8}


def test_one_device_counts_train_work(cells, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from repro_torch.configs import registry
    cfg = registry.get_config("qwen2.5-3b", smoke=True)
    res = cells["train_4k__1x1"]
    assert res["microbatches"] == 1 and res["batch"] == 8
    assert res["flops_per_device"] == chip_smoke.train_work(cfg, 8, 4096)


def test_roofline_terms_computable(cells):
    from repro_torch.launch import roofline
    for res in _artifacts(cells).values():
        r = roofline.from_artifact(res)
        assert r.bound_s > 0 and r.dominant in ("compute", "memory",
                                                "collective")
        assert 0 < r.roofline_fraction < 10


def test_the_int8_cache_holds_fewer_bytes(cells):
    """int8 K/V with a float32 scale a (token, head) in place of bf16
    K/V: the arguments shrink by (2 d_head - (d_head + 4)) bytes a slot."""
    from repro_torch.configs import registry
    cfg = registry.get_config("granite-8b", smoke=True)
    q, b = cells["decode_int8"], cells["decode_bf16"]
    slots = 2 * cfg.n_layers * 8 * 32768 * cfg.n_kv // 16   # per device
    assert b["memory"]["argument_bytes"] - q["memory"]["argument_bytes"] \
        == slots * (2 * cfg.d_head - (cfg.d_head + 4))


def test_cli_runs_the_mamba2_cells(tmp_path):
    """mamba2-780m's 8 cells at full width (``long_500k`` at batch 1) on
    both production meshes: 8 ``[ok]``, none ``[not-ported]`` or
    ``[FAIL]``, an artifact each."""
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", "mamba2-780m",
                 "--mesh", "both", "--out", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert sum(x.startswith("[ok]") for x in lines) == 8
    assert not any(x.startswith(("[not-ported]", "[FAIL]")) for x in lines)
    assert len(list(tmp_path.glob("mamba2-780m__*.json"))) == 8
    art = json.loads((tmp_path / "mamba2-780m__long_500k__16x16.json")
                     .read_text())
    assert art["batch"] == 1 and art["n_devices"] == 256


def test_cli_runs_a_dense_cell_at_full_width(tmp_path):
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen2.5-3b",
                 "--shape", "decode_32k", "--out", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("[ok]   qwen2.5-3b__decode_32k__16x16")
    art = json.loads((tmp_path / "qwen2.5-3b__decode_32k__16x16.json")
                     .read_text())
    assert art["n_devices"] == 256 and art["mesh"] == "16x16"
    assert art["collective_total_bytes_per_device"] > 0
    assert art["memory"]["peak_bytes_est"] < 80e9


def test_hillclimb_prints_the_three_hills():
    proc = _run(["-m", "repro_torch.launch.hillclimb", "--smoke"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    for hill in ("H1: yi-34b train_4k", "H2: yi-34b prefill_32k",
                 "H3: granite-8b decode_32k"):
        assert hill in out
    rows = [x for x in out.splitlines() if "bound=" in x]
    assert len(rows) == 7


@pytest.mark.parametrize("mesh,heads", [((1, 4), 6), ((2, 2), 4)])
def test_the_sharded_step_computes_the_one_device_step(mesh, heads):
    """Four CPU processes on ``gloo`` run the dry run's sharded step with
    real values (``torch_gloo_step.py``): the loss, every gradient, a
    train step's global norm and AdamW moments, and a decode step's
    logits and cache write equal the one-process step's in float32
    (summation order only: 1e-6 of the loss, 1e-5 of each gradient's and
    moment's largest and of the norm, 1e-5 absolute on logits and
    cache).  6 q heads over a 4-way model axis split unevenly and leave a
    device none; (2, 2) also shards the batch."""
    proc = _run(["tests/torch_gloo_step.py", "--mesh", *map(str, mesh),
                 "--heads", str(heads)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loss_err"] <= 1e-6 * abs(res["loss"])
    assert res["grad_err"] < 1e-5
    assert res["norm_err"] < 1e-5 and res["moment_err"] < 1e-5
    assert res["logit_err"] < 1e-5 and res["cache_err"] < 1e-5


def test_build_cell_builds_a_mamba2_cell(cells):
    """A Mamba2 stack's train cell on (4, 4): no boundary-SP (the
    reference keeps it off for any stack with a Mamba2 layer), no MoE,
    and the input projection's fused columns split contiguously over
    ``model`` as stored."""
    cell = cells["mamba2_cell"]
    assert cell["kind"] == "train"
    assert cell["boundary_sp"] is None and cell["moe_exec"] is None
    assert cell["in_proj"] == [64, 296]
    assert cell["in_proj_placements"] == ["Replicate()", "Shard(dim=1)"]


def test_a_mesh_of_real_cards_is_item_5():
    """A real mesh spans the process group's ranks: one device works in
    one process, four need a world of four."""
    from repro_torch.launch import mesh
    one = mesh.make_local_mesh(1, 1, device="cpu")
    assert one.mesh_dim_names == ("data", "model") and one.size() == 1
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        mesh.make_local_mesh(2, 2, device="cpu")


# --------------------------------------------------------------------------
# In process: the analysis rules and the flash wrappers on fake tensors
# --------------------------------------------------------------------------
def _analysed(fn, *shapes):
    from repro_torch.launch.op_analysis import OpAnalysis
    a = OpAnalysis()
    with FakeTensorMode():
        args = [torch.empty(s, dtype=torch.bfloat16) for s in shapes]
        a.track(args)
        with a:
            out = fn(*args)
    return a.report(), out


def test_a_matmul_counts_its_operands_and_result():
    rep, _ = _analysed(lambda x, w: x @ w, (64, 32), (32, 16))
    assert rep.flops == 2 * 64 * 32 * 16
    assert rep.traffic_bytes == 2 * (64 * 32 + 32 * 16 + 64 * 16)
    assert rep.argument_bytes == 2 * (64 * 32 + 32 * 16)
    assert rep.peak_bytes == rep.argument_bytes + 2 * 64 * 16


def test_views_copies_and_gathers_follow_the_references_rules():
    rep, _ = _analysed(lambda x: x.t().reshape(-1).clone(), (8, 4))
    assert rep.traffic_bytes == 0 and rep.flops == 0
    rep, _ = _analysed(lambda x: x[torch.tensor([0, 2])], (8, 4))
    assert rep.traffic_bytes == 2 * (2 * 4 * 2)      # the window, twice
    rep, _ = _analysed(lambda x: x.float(), (8, 4))
    assert rep.traffic_bytes == 8 * 4 * (2 + 4)      # a convert counts


def test_the_peak_follows_live_storages():
    def step(x):
        y = x * 2          # 64 B live beside x
        del y
        z = torch.cat([x, x])   # 128 B
        return z.sum()

    rep, _ = _analysed(step, (8, 4))
    assert rep.argument_bytes == 64
    assert rep.peak_bytes == 64 + 128 + 2     # z beside x, then its sum


def test_repeat_weights_the_counts_but_not_the_peak():
    from repro_torch.launch.op_analysis import OpAnalysis
    a = OpAnalysis()
    with FakeTensorMode():
        x = torch.empty(16, 16)
        with a:
            with a.repeat(4):
                y = x @ x
            del y
    rep = a.report()
    assert rep.flops == 4 * 2 * 16 ** 3
    assert rep.peak_bytes == 16 * 16 * 4


def test_only_the_plain_attentions_scores_are_score_traffic():
    """Score traffic is the plain attention's (Sq, Skv) scores, read and
    written while it runs on the CPU; a product of another op is none,
    whatever its shape (a (32, 32) result here, the shape of the smoke
    widths' AdamW shards and of their 32-wide attention block)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.op_analysis import OpAnalysis
    rep, _ = _analysed(lambda q, k: q @ k.transpose(-1, -2),
                       (2, 32, 8), (2, 32, 8))
    assert rep.score_traffic_bytes == 0 and rep.traffic_bytes > 0
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(n, s, 16, generator=g)
               for n, s in ((4, 24), (2, 40), (2, 40)))
    a = OpAnalysis()
    with a:
        fa.flash_attention(q, k, v, causal=False)
    assert fa.flash_attention.plain_scores is None
    rep = a.report()
    scores = 4 * 24 * 40 * 4          # one float32 (BH, Sq, Skv) tensor
    # Q K^T writes the scores, the softmax reads them and writes the
    # weights, P V reads those
    assert 4 * scores <= rep.score_traffic_bytes < rep.traffic_bytes


@pytest.mark.parametrize("causal,sq,skv,d,dv", [
    pytest.param(True, 64, 64, 32, 32, id="True"),
    pytest.param(False, 64, 64, 32, 32, id="False"),
    pytest.param(True, 64, 64, 192, 128, id="mla"),
    pytest.param(False, 48, 80, 32, 32, id="cross")])
def test_flash_on_fake_tensors_is_shape_only(causal, sq, skv, d, dv):
    """The forward and K0-K2 return the kernels' shapes and dtypes, count
    the kernels' products and bytes, and materialise no score tile: at
    MLA's (192, 128) widths, q/k and v counted apart, and in
    cross-attention's non-causal ``Sq != Skv``, every (query, key)
    pair."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.op_analysis import OpAnalysis
    a = OpAnalysis()
    bh, bh_kv = 8, 2
    with FakeTensorMode():
        q = torch.empty(bh, sq, d, dtype=torch.bfloat16, requires_grad=True)
        k = torch.empty(bh_kv, skv, d, dtype=torch.bfloat16,
                        requires_grad=True)
        v = torch.empty(bh_kv, skv, dv, dtype=torch.bfloat16,
                        requires_grad=True)
        with a:
            out = fa.flash_attention(q, k, v, causal=causal)
            out.backward(torch.ones_like(out))
        assert out.shape == (bh, sq, dv) and out.dtype == torch.bfloat16
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
        assert v.grad.shape == v.shape
    assert fa.flash_attention.launches == 0
    rep = a.report()
    fwd = fa.attention_flops(bh, sq, skv, d, dv, causal)
    pairs = fa.causal_pairs(sq, skv) if causal else sq * skv
    assert fwd == 2 * bh * pairs * (d + dv)
    assert rep.flops == fwd + 5 * fwd // 2
    assert rep.score_traffic_bytes == 0
    elem = 2
    q_o = bh * sq * (d + dv) * elem           # q and out (or dq and dout)
    k_v = bh_kv * skv * (d + dv) * elem       # k and v (or dk and dv)
    fwd_bytes = q_o + k_v + bh * sq * 4
    # backward: q, k, v, out, dout, lse in; dq, dk, dv, delta out
    bwd_bytes = 2 * q_o + 2 * k_v + 2 * bh * sq * 4
    assert rep.traffic_bytes >= fwd_bytes + bwd_bytes


def test_causal_pairs_count_each_querys_keys():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    for sq, skv, off in ((7, 7, 0), (3, 10, 5), (10, 4, 0), (1, 1601, 1600),
                         (13, 7, 3), (5, 100, 0)):
        assert fa.causal_pairs(sq, skv, off) == sum(
            min(off + i + 1, skv) for i in range(sq))
