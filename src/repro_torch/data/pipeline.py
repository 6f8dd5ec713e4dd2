"""Deterministic data pipeline with ASURA shard placement.

The training corpus is split into fixed-size shards (the paper's "data");
each shard id is placed onto an ingest host by ASURA, so

  * placement is computed locally on every host from the O(N) segment table
    (no placement service / manifest to distribute -- the paper's
    algorithm-management argument vs. table management, section "intro"),
  * hosts receive shards uniformly in proportion to their ingest capacity,
  * elastic events (host joins/leaves) move only the provably-minimal set of
    shards (paper section 2.A; re-verified in tests/test_torch_runtime.py).

Shard payloads are synthesized deterministically from the shard id (token
streams), so any host can (re)materialize any shard it owns -- which is also
how straggler backup tasks work (runtime/straggler.py).

The port's copy of the reference pipeline: ownership runs through the
cluster's port engine -- on the device backend one launch of the fused
placement kernel (B1) over every shard id and one host copy of a bool
mask.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..core import Cluster
from ..core.rng import draw_u32_np


def synthetic_shard(shard_id: int, *, tokens_per_shard: int, vocab: int) -> np.ndarray:
    """Deterministic, LEARNABLE token stream for a shard id.

    Counting sequences (t_{j+1} = t_j + 1 mod p) with a per-shard phase and
    ~6% hash noise: a model that learns the successor bigram drives CE well
    below ln(vocab), which end-to-end training tests rely on; the noise keeps
    the task non-degenerate.  O(1) state: any position is recomputable."""
    n = tokens_per_shard
    period = min(97, vocab)
    pos = np.arange(n, dtype=np.uint32)
    ids = np.full(n, shard_id, dtype=np.uint32)
    phase = draw_u32_np(ids[:1], np.uint32(6), np.zeros(1, np.uint32))[0]
    base = (phase + pos) % np.uint32(period)
    noise_draw = draw_u32_np(ids, np.uint32(7), pos)
    noisy = noise_draw % np.uint32(vocab)
    use_noise = (noise_draw >> np.uint32(16)) % np.uint32(16) == 0
    return np.where(use_noise, noisy, base).astype(np.int32)


@dataclasses.dataclass
class ShardedDataset:
    n_shards: int
    tokens_per_shard: int
    vocab: int

    def shard(self, shard_id: int) -> np.ndarray:
        if not 0 <= shard_id < self.n_shards:
            raise IndexError(shard_id)
        return synthetic_shard(
            shard_id, tokens_per_shard=self.tokens_per_shard, vocab=self.vocab
        )


class DataPipeline:
    """Per-host view: iterate (batch, seq) token batches from owned shards."""

    def __init__(
        self,
        dataset: ShardedDataset,
        cluster: Cluster,
        host_id: int,
        *,
        batch_per_host: int,
        seq_len: int,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.cluster = cluster
        # Every pipeline on a host shares the cluster's PlacementEngine, so
        # ownership recomputes (initial + refresh_membership after elastic
        # events) reuse one cached table artifact per membership version.
        self.engine = cluster.engine
        self.host_id = host_id
        self.batch_per_host = batch_per_host
        self.seq_len = seq_len
        self.seed = seed
        self._owned = self._compute_owned()

    def _compute_owned(self) -> np.ndarray:
        shard_ids = np.arange(self.dataset.n_shards, dtype=np.uint32)
        if self.engine.backend != "numpy":
            # Device path: placement, tail and node gather stay on device;
            # the only host copy is the final ownership mask (one bool
            # vector), instead of every owner id.
            owners = self.engine.place_nodes_device(shard_ids)
            return shard_ids[(owners == self.host_id).cpu().numpy()]
        owners = self.engine.place_nodes(shard_ids)
        return shard_ids[owners == self.host_id]

    def refresh_membership(self) -> tuple[np.ndarray, np.ndarray]:
        """Recompute ownership after an elastic event.  Returns
        (gained_shards, lost_shards) -- provably minimal under ASURA."""
        new = self._compute_owned()
        gained = np.setdiff1d(new, self._owned)
        lost = np.setdiff1d(self._owned, new)
        self._owned = new
        return gained, lost

    @property
    def owned_shards(self) -> np.ndarray:
        return self._owned

    def __iter__(self) -> Iterator[np.ndarray]:
        return self.batches()

    def batches(self, epoch: int = 0) -> Iterator[np.ndarray]:
        """Yield (batch_per_host, seq_len) int32 batches.

        Shard visit order is a deterministic per-epoch permutation derived
        from the counter-based hash, so restarts resume identically."""
        if self._owned.size == 0:
            return
        order_keys = draw_u32_np(
            self._owned, np.uint32(100 + epoch), np.zeros_like(self._owned)
        )
        order = self._owned[np.argsort(order_keys, kind="stable")]
        need = self.batch_per_host * self.seq_len
        buf = np.empty(0, dtype=np.int32)
        for sid in order:
            buf = np.concatenate([buf, self.dataset.shard(int(sid))])
            while buf.size >= need:
                batch, buf = buf[:need], buf[need:]
                yield batch.reshape(self.batch_per_host, self.seq_len)
