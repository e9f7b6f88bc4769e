"""Deterministic, shardable synthetic token pipeline.

A port of ``repro.data.pipeline``.  Batches are pure functions of (seed,
step, shard): every host can make exactly its slice of the global batch
with no coordination, and a restart resumes bit-identically from the step
counter.  Token statistics follow a Zipf unigram distribution, so the
embedding gathers and the power model's data statistics are not
degenerate.

The draws equal the reference's token for token.  It samples with
``jax.random.choice(key, vocab, shape, p=zipf)``, which is
``cdf = jnp.cumsum(p)``, ``r = cdf[-1] * (1 - uniform(key, shape))`` and
``searchsorted(cdf, r)`` on ``fold_in(fold_in(key(seed), step), shard)``.
The uniforms come from :mod:`repro_torch.core.threefry` (JAX's Threefry
bits).  The float32 CDF must be summed in XLA's order, since ``cdf[-1]``
scales every draw: on the CPU XLA rewrites the cumulative sum into a
blocked scan (:func:`xla_cumsum`), and a sequential ``np.cumsum`` differs
from it in most entries.  Batches are made on the host in numpy and then
moved to the device.  ``make_global_array`` places a step's batch on a
mesh as DTensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import threefry

SCAN_BASE = 16     # XLA's block length for a cumulative sum on the CPU


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2


def _row_prefix(x: np.ndarray) -> np.ndarray:
    """Sequential float32 prefix sums along the rows of ``x``."""
    out = np.empty_like(x)
    acc = np.zeros(x.shape[0], np.float32)
    for c in range(x.shape[1]):
        acc = acc + x[:, c]
        out[:, c] = acc
    return out


def xla_cumsum(x: np.ndarray, base: int = SCAN_BASE) -> np.ndarray:
    """The float32 inclusive cumulative sum of a 1-D array in the order
    XLA's CPU backend computes ``jnp.cumsum``: up to ``base`` elements
    sequentially; longer, zero-padded to rows of ``base``, each row's
    sequential prefix plus the exclusive prefix of the row totals, which
    is itself this scan (the reduce-window rewrite of a cumulative sum)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n <= base:
        return _row_prefix(x[None])[0]
    rows = -(-n // base)
    padded = np.zeros(rows * base, np.float32)
    padded[:n] = x
    within = _row_prefix(padded.reshape(rows, base))
    totals = xla_cumsum(within[:, -1], base)
    before = np.concatenate([np.zeros(1, np.float32), totals[:-1]])
    return (within + before[:, None]).reshape(-1)[:n]


class SyntheticDataset:
    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        # stationary Zipf unigram distribution over the vocab
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self.probs = (p / p.sum()).astype(np.float32)
        self.cdf = xla_cumsum(self.probs)

    def global_batch(self, step: int) -> dict:
        """The whole ``(global_batch, seq_len)`` batch of one step."""
        return self.shard_batch(step, shard=0, n_shards=1)

    def shard_batch(self, step: int, shard: int, n_shards: int) -> dict:
        """Shard ``shard`` of ``n_shards`` of step ``step``'s batch:
        ``tokens`` and ``labels`` (the tokens shifted by one), int32
        ``(global_batch / n_shards, seq_len)`` on the dataset's device."""
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {n_shards} shards")
        b_loc = cfg.global_batch // n_shards
        key = threefry.fold_in(
            threefry.fold_in(threefry.key(cfg.seed), step), shard)
        u = threefry.uniform(key, b_loc * (cfg.seq_len + 1))[0]
        r = self.cdf[-1] * (np.float32(1.0) - u)
        toks = np.searchsorted(self.cdf, r, side="left").astype(np.int32)
        toks = torch.from_numpy(toks.reshape(b_loc, cfg.seq_len + 1)).to(
            self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def make_global_array(self, step: int, mesh, pspec) -> dict:
        """Step ``step``'s whole batch as DTensors on ``mesh``, placed by
        the :class:`~repro_torch.models.meta.Spec` ``pspec``
        (``meta.placements``).  Every rank draws the same batch and keeps
        its own box of it, so no collective runs: the full tensors are
        :meth:`global_batch`'s bit for bit."""
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.models.meta import placements
        pl = placements(pspec, mesh)
        return {k: distribute_tensor(v.to(mesh.device_type), mesh, pl,
                                     src_data_rank=None)
                for k, v in self.global_batch(step).items()}
