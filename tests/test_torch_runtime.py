"""The port's data pipeline, checkpoints and fault runtime: the synthetic
batches against the reference's token for token (three seeds, steps 0, 1
and 17, shards 0 of 1 and 1 of 4, at a smoke vocab and at qwen2.5-3b's
151936), the float32 CDF against ``jnp.cumsum`` bit for bit; checkpoint
round trips of bf16, float32, int8 and int32 leaves, keep-K, no partial
directories, the asynchronous write, the refusal of ``shardings=``; the
fault injector and the straggler monitor."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticDataset as RDataset
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticDataset, xla_cumsum
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.meta import Spec
from repro_torch.runtime.elastic import shardings_from_specs
from repro_torch.runtime.fault import (FaultInjector, SimulatedFault,
                                       StepTimer, StragglerMonitor)


@pytest.fixture(autouse=True)
def _partitionable():
    # the port follows the partitionable Threefry stream (JAX >= 0.5's
    # default; CI's 0.4.37 defaults to the other)
    with jax.threefry_partitionable(True):
        yield


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 256, 4097, 32000, 151936])
def test_the_cdf_is_summed_in_xla_order(n):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = 1.0 / ranks ** 1.2
    p = (p / p.sum()).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(p)))
    np.testing.assert_array_equal(xla_cumsum(p), want)


@pytest.mark.parametrize("vocab", [256, 151936])
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_batches_equal_the_reference_token_for_token(vocab, seed):
    kw = dict(vocab=vocab, seq_len=24, global_batch=8, seed=seed)
    ref = RDataset(RDataConfig(**kw))
    port = SyntheticDataset(DataConfig(**kw), device="cpu")
    np.testing.assert_array_equal(port.probs, np.asarray(ref._probs))
    for step in (0, 1, 17):
        for shard, n_shards in ((0, 1), (1, 4)):
            want = ref.shard_batch(step, shard, n_shards)
            got = port.shard_batch(step, shard, n_shards)
            for name in ("tokens", "labels"):
                assert got[name].dtype == torch.int32
                np.testing.assert_array_equal(got[name].numpy(),
                                              np.asarray(want[name]))


def test_data_deterministic_and_shardable():
    ds = SyntheticDataset(DataConfig(vocab=1000, seq_len=32, global_batch=8,
                                     seed=5), device="cpu")
    a, b, c = ds.global_batch(3), ds.global_batch(3), ds.global_batch(4)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (8, 32)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    shards = [ds.shard_batch(3, i, 4)["tokens"] for i in range(4)]
    assert all(s.shape == (2, 32) for s in shards)
    with pytest.raises(ValueError, match="does not split"):
        ds.shard_batch(3, 0, 3)
    # on a mesh of one device the placed batch is the global batch
    placed = ds.make_global_array(3, make_local_mesh(1, 1, device="cpu"),
                                  Spec("data", None))
    assert torch.equal(placed["tokens"].full_tensor(), a["tokens"])
    assert torch.equal(placed["labels"].to_local(), a["labels"])


# -------------------------------------------------------------- checkpoint
def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"a": torch.randn(2, 3, generator=gen),
            "nested": {"b": torch.randn(4, generator=gen).to(torch.bfloat16),
                       "q": torch.randint(-127, 128, (3, 5), generator=gen,
                                          dtype=torch.int8)},
            "layers": [{"w": torch.randn(2, 2, generator=gen)}],
            "step": torch.tensor(11, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3, 4):
        mgr.save(step, tree, extra={"loss": float(step)})
    assert mgr.all_steps() == [3, 4]
    template = {"a": torch.zeros(2, 3),
                "nested": {"b": torch.zeros(4, dtype=torch.bfloat16),
                           "q": torch.zeros(3, 5, dtype=torch.int8)},
                "layers": [{"w": torch.zeros(2, 2)}],
                "step": torch.zeros((), dtype=torch.int32)}
    out = mgr.restore(4, template)
    for key in ("a", "step"):
        assert out[key].dtype == tree[key].dtype
        assert torch.equal(out[key], tree[key])
    for key in ("b", "q"):
        assert out["nested"][key].dtype == tree["nested"][key].dtype
        assert torch.equal(out["nested"][key], tree["nested"][key])
    assert torch.equal(out["layers"][0]["w"], tree["layers"][0]["w"])
    manifest = mgr.restore_manifest(4)
    assert manifest["extra"]["loss"] == 4.0
    assert manifest["dtypes"]["['nested']['b']"] == "bfloat16"
    assert "['layers'][0]['w']" in manifest["keys"]


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.zeros(3)})
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    x = torch.arange(10)
    mgr.save(7, {"x": x})
    x.add_(1)           # the leaves were copied before save returned
    mgr.wait()
    assert mgr.latest_step() == 7
    out = mgr.restore(7, {"x": torch.zeros(10, dtype=torch.int64)})
    assert torch.equal(out["x"], torch.arange(10))


def test_checkpoint_restore_with_shardings_waits_for_the_mesh(tmp_path):
    """``restore(shardings=)`` places each leaf on the target leaf's mesh
    by the given placements (the rescale across meshes of four ranks:
    ``tests/test_torch_mesh.py``)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    mgr.save(1, {"w": w})
    mesh = make_local_mesh(1, 1, device="cpu")
    target = {"w": distribute_tensor(torch.zeros(2, 3), mesh,
                                     (Replicate(), Replicate()))}
    out = mgr.restore(1, target, shardings=shardings_from_specs(
        {"w": Spec("data", "model")}, mesh))
    assert out["w"].placements == (Replicate(), Replicate())
    assert torch.equal(out["w"].full_tensor(), w)


# ------------------------------------------------------------------- fault
def test_fault_injector_fires_once():
    inj = FaultInjector(fail_at_steps=(3,))
    inj.check(2)
    with pytest.raises(SimulatedFault):
        inj.check(3)
    inj.check(3)  # second pass: already fired


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0)
    for step in range(10):
        mon.record(step, 0.1)
    assert mon.record(10, 0.5)
    assert mon.flagged and mon.flagged[0][0] == 10


def test_step_timer_reads_the_host_clock():
    with StepTimer("cpu") as t:
        sum(range(1000))
    assert t.seconds >= 0.0
