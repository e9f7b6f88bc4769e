"""The dry run's plans against the reference's: for every cell of
``all_cells()`` on both production meshes, ``plan_for`` makes the same
decisions (FSDP, ZeRO-1, int8 moments, microbatches, the rules) and
``specs_for`` gives every parameter (and, for decode, every cache leaf)
the same partition spec; the cell list, the shapes and every input
spec's shape and dtype are the reference's.

Both packages read a mesh's axis names and sizes only, so a stand-in
object gives them the 16 x 16 and 2 x 16 x 16 meshes in-process, with no
``XLA_FLAGS`` and no process group."""
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.lm import LM as JLM
from repro.models.meta import specs_for as jspecs_for
from repro.sharding import rules as jrules
from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.models.lm import LM
from repro_torch.models.meta import (ParamMeta, ShardingRules, Spec,
                                     abstractify, is_meta, placements,
                                     specs_for)
from repro_torch.sharding import rules as R


class StandIn:
    """A mesh as both packages read one: axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = self.mesh_dim_names = axes
        self.shape = shape
        self.devices = np.empty(shape, dtype=object)


MESHES = {
    "16x16": (StandIn((16, 16), ("data", "model")), False),
    "2x16x16": (StandIn((2, 16, 16), ("pod", "data", "model")), True),
}
CELLS = [(a, s, m) for a, s in registry.all_cells() for m in MESHES]


def _plans(arch, shape, mesh_tag):
    mesh, multi_pod = MESHES[mesh_tag]
    spec = registry.SHAPES[shape]
    port = R.plan_for(registry.get_config(arch), spec.kind,
                      spec.global_batch, mesh, multi_pod,
                      seq_len=spec.seq_len)
    ref = jrules.plan_for(jreg.get_config(arch), spec.kind,
                          spec.global_batch, mesh, multi_pod,
                          seq_len=spec.seq_len)
    return port, ref


def test_the_cells_and_shapes_are_the_references():
    assert registry.all_cells() == jreg.all_cells()
    assert registry.skipped_cells() == jreg.skipped_cells()
    assert len(registry.all_cells()) == 32
    assert {k: (v.name, v.kind, v.seq_len, v.global_batch)
            for k, v in registry.SHAPES.items()} == {
        k: (v.name, v.kind, v.seq_len, v.global_batch)
        for k, v in jreg.SHAPES.items()}
    for arch in registry.ARCH_NAMES:
        assert registry.cell_applicable(arch, "long_500k") \
            == jreg.cell_applicable(arch, "long_500k")


@pytest.mark.parametrize("arch,shape,mesh_tag", CELLS)
def test_plan_matches_the_reference(arch, shape, mesh_tag):
    port, ref = _plans(arch, shape, mesh_tag)
    for field in ("fsdp", "zero1", "quantized_moments", "microbatches",
                  "multi_pod"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.rules.rules == ref.rules.rules
    cfg = registry.get_config(arch)
    multi_pod = MESHES[mesh_tag][1]
    assert port.opt_rules(cfg, multi_pod).rules == ref.opt_rules(
        jreg.get_config(arch), multi_pod).rules
    mesh = MESHES[mesh_tag][0]
    assert port.data_shards(mesh) == ref.data_shards(mesh)


def _port_specs(arch, rules, mesh):
    lm = LM(registry.get_config(arch))
    out = {}
    for path, spec in T.leaves_with_paths(
            specs_for(lm.param_meta(), rules, mesh),
            is_leaf=lambda x: isinstance(x, Spec)):
        # per-layer lists -> the reference's stacked sub-layers
        parts = path.split("]")
        if path.startswith("['layers']["):
            i = int(parts[1][1:])
            path = f"['layers']['sub{i % lm.period}']" + "]".join(parts[2:])
        elif path.startswith("['encoder']['layers']["):
            path = "['encoder']['layers']" + "]".join(parts[3:])
        else:
            out[path] = tuple(spec)
            continue
        out.setdefault(path, set()).add(tuple(spec))
    return out


def _spec(entries) -> tuple:
    """A spec read as a tuple, a one-name tuple as the name (newer JAX's
    ``PartitionSpec`` writes it so, older JAX keeps the tuple)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _ref_specs(arch, rules, mesh):
    import jax
    from jax.sharding import PartitionSpec as P
    specs = jspecs_for(JLM(jreg.get_config(arch)).param_meta(), rules, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(k): _spec(v) for k, v in flat}


@pytest.mark.parametrize("arch,shape,mesh_tag", CELLS)
def test_parameter_specs_match_the_reference(arch, shape, mesh_tag):
    """Each parameter's spec; a per-layer leaf against the reference's
    stacked leaf less its leading (replicated) layer axis."""
    port_plan, ref_plan = _plans(arch, shape, mesh_tag)
    mesh = MESHES[mesh_tag][0]
    port = _port_specs(arch, port_plan.rules, mesh)
    ref = _ref_specs(arch, ref_plan.rules, mesh)
    assert set(port) == set(ref)
    for path, spec in port.items():
        if isinstance(spec, set):
            assert ref[path][0] is None, path
            assert spec == {ref[path][1:]}, path
        else:
            assert spec == ref[path], path


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_decode_cache_specs_match_the_reference(arch):
    import jax
    from jax.sharding import PartitionSpec as P
    shape = registry.SHAPES["decode_32k"]
    for mesh_tag in MESHES:
        port_plan, ref_plan = _plans(arch, "decode_32k", mesh_tag)
        mesh = MESHES[mesh_tag][0]
        port = specs_for(LM(registry.get_config(arch)).init_cache_meta(
            shape.global_batch, shape.seq_len), port_plan.rules, mesh)
        ref = jspecs_for(JLM(jreg.get_config(arch)).init_cache_meta(
            shape.global_batch, shape.seq_len), ref_plan.rules, mesh)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            ref, is_leaf=lambda x: isinstance(x, P))
        assert {p: tuple(s) for p, s in T.leaves_with_paths(
            port, is_leaf=lambda x: isinstance(x, Spec))} == {
            jax.tree_util.keystr(k): _spec(v) for k, v in flat}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


@pytest.mark.parametrize("arch,shape", registry.all_cells())
def test_input_specs_match_the_reference(arch, shape):
    import jax
    port = registry.input_specs(registry.get_config(arch),
                                registry.SHAPES[shape], device="meta")
    ref = jreg.input_specs(jreg.get_config(arch), jreg.SHAPES[shape])
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    assert {p: (tuple(t.shape), _dtype_name(t.dtype))
            for p, t in T.leaves_with_paths(port)} == {
        jax.tree_util.keystr(k): (tuple(v.shape), _dtype_name(v.dtype))
        for k, v in flat}


def test_spec_rules_dedup_and_fall_back():
    rules = ShardingRules({"experts": "model", "ffn": "model",
                           "batch": ["pod", "data"]})
    assert tuple(rules.spec(ParamMeta((8, 16, 32),
                                      ("experts", None, "ffn")))) == (
        "model", None, None)
    assert tuple(rules.spec(ParamMeta((4, 2), ("batch", None)))) == (
        ("pod", "data"), None)
    mesh = StandIn((2, 4), ("data", "model"))
    specs = specs_for({"w": ParamMeta((3, 7), (None, "ffn")),
                       "v": ParamMeta((3, 8), (None, "ffn"))},
                      ShardingRules({"ffn": "model"}), mesh)
    assert tuple(specs["w"]) == (None, None)
    assert tuple(specs["v"]) == (None, "model")


def test_placements_follow_the_mesh_axes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = StandIn((2, 4, 4), ("pod", "data", "model"))
    assert placements(Spec(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(Spec(None, None), mesh) == (Replicate(),) * 3
    assert placements(Spec(("data", "model")), mesh) == (
        Replicate(), Shard(0), Shard(0))


def test_abstractify_makes_shape_only_tensors():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    meta = {"a": ParamMeta((4, 8), ("embed", "ffn")),
            "b": [ParamMeta((3,), (None,), dtype=torch.int32)]}
    with FakeTensorMode():
        out = abstractify(meta)
    assert isinstance(out["a"], FakeTensor) and out["a"].shape == (4, 8)
    assert out["b"][0].dtype == torch.int32
    assert all(is_meta(m) for m in (meta["a"], meta["b"][0]))
