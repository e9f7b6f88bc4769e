"""``repro_torch.runtime.elastic`` against ``repro.runtime.elastic``: the
same meta tree (jamba's Mamba2 mixer and MoE, an attention mixer and
jamba's decode cache, built by each package's own layer library) and the
same rules, resharded onto meshes where every axis divides and onto
meshes where some fall back to replication; the specs and the fallback
lists compared entry by entry.  Both packages read a mesh's axis names
and sizes only, so a stand-in object gives them the meshes in-process."""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import registry as rreg
from repro.models import layers as RL
from repro.models.lm import LM as RLM
from repro.models.meta import is_meta as r_is_meta
from repro.runtime import elastic as relastic
from repro.sharding import rules as rrules
from repro_torch import tree as T
from repro_torch.configs import registry as preg
from repro_torch.models import layers as PL
from repro_torch.models.lm import LM as PLM
from repro_torch.models.meta import Spec
from repro_torch.runtime import elastic
from repro_torch.sharding import rules as prules

ARCH = "jamba-1.5-large-398b"


class StandIn:
    """A mesh as both packages read one: axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = self.mesh_dim_names = axes
        self.shape = shape
        self.devices = np.empty(shape, dtype=object)


def _tree(cfg, layers, lm):
    return {"mamba": layers.mamba_meta(cfg), "moe": layers.moe_meta(cfg),
            "attn": layers.attn_meta(cfg),
            "cache": lm.init_cache_meta(1, 4096)}


def _spec(entries) -> tuple:
    """A spec read as a tuple, a one-name tuple as the name (newer JAX's
    ``PartitionSpec`` writes it so, older JAX keeps the tuple)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                 else tuple(e) if isinstance(e, list) else e
                 for e in entries)


# (shape, axes, fsdp, kv_seq): meshes that divide every sharded axis, and
# meshes with a 3-wide model axis (or data axis) where some fall back
MESHES = [((16, 16), ("data", "model"), False, "model"),
          ((2, 16, 16), ("pod", "data", "model"), True, ["data", "model"]),
          ((4, 3), ("data", "model"), False, "model"),
          ((3, 8), ("data", "model"), True, ["data", "model"]),
          ((2, 5, 3), ("pod", "data", "model"), True, "model")]


@pytest.mark.parametrize("shape,axes,fsdp,kv_seq", MESHES)
def test_reshard_plan_matches_the_reference(shape, axes, fsdp, kv_seq):
    multi_pod = "pod" in axes
    mesh = StandIn(shape, axes)
    rcfg, pcfg = rreg.get_config(ARCH), preg.get_config(ARCH)
    rmeta = _tree(rcfg, RL, RLM(rcfg))
    pmeta = _tree(pcfg, PL, PLM(pcfg))
    rrule = rrules.make_rules(rcfg, multi_pod=multi_pod, fsdp=fsdp,
                              kv_seq_axis=kv_seq)
    prule = prules.make_rules(pcfg, multi_pod=multi_pod, fsdp=fsdp,
                              kv_seq_axis=kv_seq)
    rspecs, rfall = relastic.reshard_plan(rmeta, rrule, mesh)
    pspecs, pfall = elastic.reshard_plan(pmeta, prule, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        rspecs, is_leaf=lambda x: isinstance(x, P))
    want = {jax.tree_util.keystr(k): _spec(v) for k, v in flat}
    got = {path: _spec(s) for path, s in T.leaves_with_paths(
        pspecs, is_leaf=lambda x: isinstance(x, Spec))}
    assert got == want
    # the same entries (the reference lists them in JAX's sorted key
    # order, the port in its trees' insertion order)
    fallen = {p: (_spec(i), _spec(s)) for p, i, s in pfall}
    assert len(fallen) == len(pfall)
    assert fallen == {p: (_spec(i), _spec(s)) for p, i, s in rfall}
    assert len(got) == len(jax.tree_util.tree_leaves(rmeta,
                                                     is_leaf=r_is_meta))
    # one row does not divide over data anywhere; jamba's fused Mamba2
    # input projection does not divide over an axis of 3 (its 33,280
    # columns over model, or its 8,192 rows over data under FSDP)
    assert "['cache']['sub0']['state']" in fallen
    assert ("['mamba']['in_proj']" in fallen) == (3 in shape)


def test_shardings_from_specs_are_the_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = StandIn((2, 4), ("data", "model"))
    tree = {"w": Spec("data", "model"), "v": [Spec(None, ("data", "model"))],
            "b": Spec(None)}
    out = elastic.shardings_from_specs(tree, mesh)
    assert out["w"] == (Shard(0), Shard(1))
    assert out["v"][0] == (Shard(1), Shard(1))
    assert out["b"] == (Replicate(), Replicate())
