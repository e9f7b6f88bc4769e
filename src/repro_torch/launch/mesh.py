"""Meshes for the dry run: ``DeviceMesh``es on torch's ``fake`` process
group, whose collectives do nothing, so a step traced on fake tensors sees
the shapes and collectives of one device of a mesh that is not there.

A port of ``repro.launch.mesh``: the reference forces a host platform of
512 devices (``--xla_force_host_platform_device_count``); here the fake
group is asked for by name (``fake=True``), never chosen because cards are
missing.  This process is rank 0, so a trace follows the device at mesh
coordinate 0, which holds the largest shard of an uneven split.  A mesh of
real cards is ROADMAP queue 1 item 5.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

POD_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def fake_group(world_size: int) -> None:
    """Make this process rank 0 of a ``fake`` group of ``world_size``
    ranks, replacing a fake group of another size."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is "
                               "initialised; the dry run needs the fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=world_size, rank=0)


def _fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    fake_group(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 devices a pod; the multi-pod mesh spans 2 pods (fake)."""
    if multi_pod:
        return _fake_mesh((2, 16, 16), MULTI_POD_AXES)
    return _fake_mesh((16, 16), POD_AXES)


def make_local_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                    *, fake: bool = False) -> DeviceMesh:
    """A small mesh, (pod,) data x model, of fake devices (``fake=True``).
    Real cards would need multi-GPU sharding, which is not ported."""
    if not fake:
        raise NotImplementedError(
            f"a mesh of {(pod or 1) * data * model} real card(s) is ROADMAP "
            "queue 1 item 5 (multi-GPU sharding), not ported; one card runs "
            "with plain tensors, and fake=True gives the dry run's mesh")
    if pod:
        return _fake_mesh((pod, data, model), MULTI_POD_AXES)
    return _fake_mesh((data, model), POD_AXES)
