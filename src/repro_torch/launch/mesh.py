"""Meshes: ``DeviceMesh``es over the ranks of a real process group, and
the dry run's over torch's ``fake`` group.

A port of ``repro.launch.mesh``.  :func:`make_local_mesh` builds a
``(data, model)`` or ``(pod, data, model)`` mesh over the process group
this program runs in: every rank runs the same call (SPMD), as under
``torchrun --nproc-per-node N``, and the mesh's ranks are laid out in
row-major order (rank ``r`` sits at coordinate ``unravel(r, shape)``).

With ``fake=True`` the mesh is the dry run's: a ``fake`` group whose
collectives do nothing, so a step traced on fake tensors sees the shapes
and collectives of one device of a mesh that is not there.  The
reference forces a host platform of 512 devices
(``--xla_force_host_platform_device_count``); here the fake group is
asked for by name, never chosen because cards are missing.  This process
is rank 0, so a trace follows the device at mesh coordinate 0, which
holds the largest shard of an uneven split.
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

POD_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")

#: whether the initialised group is the one-rank group that
#: :func:`make_local_mesh` made for a mesh of one device
_ONE_RANK = False


def init_distributed(device=None) -> int:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this process's rank: ``nccl`` on ``cuda``,
    one card a rank (``LOCAL_RANK``), ``gloo`` on ``cpu``.  A group that
    is already initialised is kept."""
    if not dist.is_initialized():
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            timeout=datetime.timedelta(seconds=600))
    return dist.get_rank()


def _drop_group(replaceable: bool) -> None:
    global _ONE_RANK
    if not replaceable:
        raise RuntimeError(f"a {dist.get_backend()!r} process group of "
                           f"{dist.get_world_size()} rank(s) is initialised")
    dist.destroy_process_group()
    _ONE_RANK = False


def fake_group(world_size: int) -> None:
    """Make this process rank 0 of a ``fake`` group of ``world_size``
    ranks, replacing a fake group of another size (or the one-rank group
    of a one-device mesh)."""
    if dist.is_initialized():
        fake = dist.get_backend() == "fake"
        if fake and dist.get_world_size() == world_size:
            return
        _drop_group(fake or _ONE_RANK)
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


def _one_rank_group() -> None:
    """This process as the only rank of a ``gloo`` group on an in-memory
    store (what a mesh of one device runs on, in any process)."""
    global _ONE_RANK
    if dist.is_initialized():
        if dist.get_world_size() == 1 and dist.get_backend() != "fake":
            return
        _drop_group(dist.get_backend() == "fake")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    _ONE_RANK = True


def make_local_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                    *, fake: bool = False, device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh, or ``(pod, data, model)`` with ``pod``.

    ``fake=True`` gives the dry run's mesh of fake devices.  Otherwise the
    mesh spans the ranks of the process group this program runs in, on
    ``device``'s type (``cuda`` unless the caller names ``cpu``): a group
    already initialised, else ``torchrun``'s (:func:`init_distributed`,
    when ``WORLD_SIZE`` is set).  A mesh of one device needs no launcher:
    with no group, or a fake one, this process becomes the only rank of a
    ``gloo`` group on an in-memory store.  A world of another size than
    ``pod * data * model`` raises a ``ValueError``."""
    shape, axes = (((pod, data, model), MULTI_POD_AXES) if pod
                   else ((data, model), POD_AXES))
    if fake:
        return _fake_mesh(shape, axes)
    n = math.prod(shape)
    kind = torch.device("cuda" if device is None else device).type
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        init_distributed(kind)
    if n == 1 and (not dist.is_initialized() or dist.get_world_size() == 1
                   or dist.get_backend() == "fake"):
        _one_rank_group()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if (not dist.is_initialized() or world != n
            or dist.get_backend() == "fake"):
        raise ValueError(
            f"a mesh of {' x '.join(map(str, shape))} = {n} device(s) needs "
            f"a world of {n} process(es), not {world}: run it under "
            f"`torchrun --nproc-per-node {n}` (or join a group of {n} "
            "ranks first)")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)
