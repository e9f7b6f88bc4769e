"""Parameter metadata: one declaration of every parameter's shape, logical
axis names and initialiser, from which

* :func:`materialize` makes tensors,
* :func:`abstractify` makes shape-only tensors (fake ones under a
  ``FakeTensorMode``) for the dry run,
* :func:`specs_for` makes a :class:`Spec` per leaf through a
  :class:`ShardingRules` mapping of logical axes onto mesh axes, and
  :func:`placements` turns a spec into DTensor placements on a mesh.

A port of ``repro.models.meta``.  The random draws come from an explicit
``torch.Generator`` on the target device; they cannot reproduce
``jax.random``'s bits, so tests that compare the two packages carry the
reference's weights across (``repro_torch.convert.lm_params_from_jax``).
``jax.sharding.PartitionSpec`` has no torch counterpart, so :class:`Spec`
is a tuple with one entry per tensor dimension: None (replicated), a mesh
axis name, or a tuple of names (sharded over their product, the first
the outermost).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]       # logical name per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float | None = None            # stddev; default fan-in
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def _std(meta: ParamMeta) -> float:
    if meta.scale is not None:
        return meta.scale
    fan_in = meta.shape[0] if len(meta.shape) >= 2 else max(meta.shape[-1], 1)
    return float(1.0 / np.sqrt(max(fan_in, 1)))


def materialize(meta_tree, generator: torch.Generator, dtype=None):
    """Instantiate a meta tree (nested dicts and lists of
    :class:`ParamMeta`) as tensors on ``generator``'s device, drawing the
    normal leaves in tree order in float32 and casting to ``dtype`` (or
    each leaf's own)."""
    device = generator.device

    def build(node):
        if is_meta(node):
            dt = dtype or node.dtype
            if node.init == "zeros":
                return torch.zeros(node.shape, dtype=dt, device=device)
            if node.init == "ones":
                return torch.ones(node.shape, dtype=dt, device=device)
            x = torch.randn(node.shape, generator=generator, device=device)
            return (x * _std(node)).to(dt)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        raise TypeError(f"unexpected node {type(node).__name__} in a meta "
                        "tree")

    return build(meta_tree)


def abstractify(meta_tree, dtype=None, device="cpu"):
    """The meta tree's shapes as uninitialised tensors in ``dtype`` (or each
    leaf's own) on ``device``: shape-only fake tensors when called under a
    ``FakeTensorMode`` (the dry run's inputs), never an allocation there."""
    return T.tree_map(lambda m: torch.empty(m.shape, dtype=dtype or m.dtype,
                                            device=device),
                      meta_tree, is_leaf=is_meta)


class Spec(tuple):
    """A partition spec: per tensor dimension None, a mesh axis name, or a
    tuple of mesh axis names (one name stands alone, as a
    ``PartitionSpec`` writes it)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            ax[0] if isinstance(ax, (list, tuple)) and len(ax) == 1
            else tuple(ax) if isinstance(ax, list) else ax for ax in axes))

    def __repr__(self):
        return f"Spec{tuple(self)!r}"


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(ax) -> tuple:
    return tuple(ax) if isinstance(ax, (list, tuple)) else (ax,)


def _entry(ax):
    return tuple(ax) if isinstance(ax, list) else ax


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axis (or list of mesh axes, or None)."""
    rules: dict

    def spec(self, meta: ParamMeta) -> Spec:
        axes = []
        used: set = set()
        for name in meta.logical:
            ax = self.rules.get(name) if name else None
            # a mesh axis may appear only once per spec
            key = tuple(ax) if isinstance(ax, (list, tuple)) else ax
            if key is not None and key in used:
                ax = None
            elif key is not None:
                used.add(key)
            axes.append(_entry(ax))
        return Spec(*axes)

    def divisibility_ok(self, meta: ParamMeta, shape: dict[str, int]
                        ) -> bool:
        for dim, name in zip(meta.shape, meta.logical):
            ax = self.rules.get(name) if name else None
            if ax is not None and dim % int(np.prod(
                    [shape[a] for a in _axes(ax)])):
                return False
        return True


def specs_for(meta_tree, rules: ShardingRules, mesh=None):
    """A :class:`Spec` per leaf; falls back to replication of a dimension
    that does not divide its mesh axes (e.g. 2 KV heads on a 16-way model
    axis), then drops a mesh axis used twice after the fallbacks."""
    shape = mesh_shape(mesh) if mesh is not None else None

    def one(m: ParamMeta) -> Spec:
        if shape is None or rules.divisibility_ok(m, shape):
            return rules.spec(m)
        axes = []
        for dim, name in zip(m.shape, m.logical):
            ax = rules.rules.get(name) if name else None
            if ax is not None and dim % int(np.prod(
                    [shape[a] for a in _axes(ax)])):
                ax = None
            axes.append(_entry(ax))
        seen: set = set()
        final = []
        for ax in axes:
            if ax is not None and ax in seen:
                final.append(None)
            else:
                if ax is not None:
                    seen.add(ax)
                final.append(ax)
        return Spec(*final)

    return T.tree_map(one, meta_tree, is_leaf=is_meta)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension
    ``Shard(d)`` for the tensor dimension ``d`` whose entry names that axis,
    else ``Replicate()``.  A dimension over several axes is sharded over
    them outermost first in the mesh's order, which is the order the rules
    list them in.  An axis of one device shards nothing and is
    ``Replicate()``: a ``Shard`` on it would only make DTensor's layouts
    strided where that axis and another meet on one flattened dimension
    (a decode step's ``(batch x kv heads)`` on a ``(data, 1)`` mesh)."""
    where = {a: d for d, ax in enumerate(spec) if ax is not None
             for a in _axes(ax)}
    size = mesh_shape(mesh)
    return tuple(Shard(where[a]) if a in where and size[a] > 1
                 else Replicate() for a in mesh.mesh_dim_names)
