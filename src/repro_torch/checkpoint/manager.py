"""Checkpoint manager: atomic, keep-K, optionally asynchronous.

A port of ``repro.checkpoint.manager`` with the same layout:
``<dir>/step_<n>/{manifest.json, arrays.npz}``, written to a temporary
directory and renamed into place atomically, so a partly written
checkpoint is never restored.  Keys are the tree's paths
(:func:`repro_torch.tree.leaves_with_paths`).  numpy has no bfloat16, so a
bf16 leaf is stored as its ``uint16`` bits and the manifest records every
leaf's dtype.  :meth:`CheckpointManager.save` copies the leaves to the
host before it returns (the write itself may run on a thread), so the
caller may go on updating its tensors in place.  ``restore`` rebuilds the
target tree on the target leaves' devices.

On a mesh (DTensor leaves; every rank makes the same calls) ``save``
gathers each leaf's full tensor on every rank before any writer thread
starts, only rank 0 writes, and the other ranks wait for it at a barrier
(in ``save``, or in ``wait`` when the save is asynchronous).
``restore(shardings=)`` places each leaf by its placements on the target
leaf's mesh: the elastic rescale (``runtime.elastic``), which may restore
onto another mesh than the one that saved.

The trainer labels a checkpoint with the next step to run
(``repro_torch.launch.train``), so restoring step ``n`` resumes at step
``n`` with nothing run twice (ROADMAP R12).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import tree as T


def _full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a leaf (a DTensor's, gathered on every rank)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _is_placements(x) -> bool:
    from torch.distributed.tensor.placement_types import Placement
    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._pending = False       # a save the other ranks still await
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, extra: dict | None = None):
        leaves = T.leaves_with_paths(tree)
        host = {key: _to_host(_full(t)) for key, t in leaves}
        dtypes = {key: str(t.dtype).removeprefix("torch.")
                  for key, t in leaves}
        if self.async_save:
            self.wait()
            if _rank() == 0:
                self._thread = threading.Thread(
                    target=self._write,
                    args=(step, host, dtypes, extra or {}))
                self._thread.start()
            self._pending = True
        else:
            if _rank() == 0:
                self._write(step, host, dtypes, extra or {})
            _barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()

    def _write(self, step: int, host: dict, dtypes: dict, extra: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            manifest = {"step": step, "time": time.time(), "extra": extra,
                        "keys": sorted(host), "dtypes": dtypes}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, shardings=None):
        """The saved tree of ``step`` in ``target_tree``'s structure, each
        leaf cast to its template's dtype on its template's device.  A
        DTensor template's leaf is placed on the template's mesh, by the
        matching placements of ``shardings`` (a tree of placement tuples,
        ``runtime.elastic.shardings_from_specs``) when given, else by the
        template's own; each rank keeps its box of the whole leaf, which
        every rank reads."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        leaves = T.leaves_with_paths(target_tree)
        places = ([None] * len(leaves) if shardings is None
                  else T.leaves(shardings, is_leaf=_is_placements))
        manifest = self.restore_manifest(step)
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        out = []
        with np.load(path, allow_pickle=False) as data:
            for (key, template), pl in zip(leaves, places, strict=True):
                t = _from_host(data[key], manifest["dtypes"][key])
                t = t.to(device=template.device, dtype=template.dtype)
                if isinstance(template, DTensor):
                    t = distribute_tensor(
                        t, template.device_mesh,
                        template.placements if pl is None else pl,
                        src_data_rank=None)
                out.append(t)
        return T.unflatten_like(target_tree, out)

    def restore_manifest(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)
