"""Elastic rescaling: resume a run on a different mesh.

A port of ``repro.runtime.elastic``.  The combination of (a) a
checkpoint restored into target placements and (b) the stateless data
pipeline makes rescaling a pure control-plane operation:

1. build the new mesh (fewer or more pods, or another (data, model)
   split),
2. recompute the partition specs from the same logical rules on the new
   mesh,
3. restore the latest checkpoint into the new placements,
4. continue from the stored step (the data pipeline is a function of the
   step).

:func:`reshard_plan` checks that the new mesh divides every dimension the
rules shard, the check a cluster controller runs before it commits to a
rescale; :func:`shardings_from_specs` gives the DTensor placements of a
spec tree on a ``DeviceMesh`` (a fake one in the dry run).  Both read a
mesh's axis names and sizes only.  Step 3 is
``CheckpointManager.restore(step, target, shardings=)``, which places
each restored leaf by those placements on the target leaves' mesh
(``launch.train`` resumes a run on another mesh so).
"""
from __future__ import annotations

from repro_torch import tree as T
from repro_torch.models.meta import (ShardingRules, Spec, is_meta,
                                     placements, specs_for)


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


def reshard_plan(meta_tree, rules: ShardingRules, new_mesh):
    """The :class:`Spec` tree on ``new_mesh`` and the leaves whose spec
    fell back to replication somewhere (a dimension the mesh does not
    divide), as ``(path, ideal spec, spec on the new mesh)`` in tree
    order."""
    specs = specs_for(meta_tree, rules, mesh=new_mesh)
    fallbacks = [
        (path, tuple(rules.spec(m)), tuple(spec))
        for (path, m), spec in zip(
            T.leaves_with_paths(meta_tree, is_leaf=is_meta),
            T.leaves(specs, is_leaf=_is_spec), strict=True)
        if tuple(rules.spec(m)) != tuple(spec)]
    return specs, fallbacks


def shardings_from_specs(spec_tree, mesh):
    """Each :class:`Spec` of ``spec_tree`` as its DTensor placements on
    ``mesh`` (``models.meta.placements``)."""
    return T.tree_map(lambda s: placements(s, mesh), spec_tree,
                      is_leaf=_is_spec)
