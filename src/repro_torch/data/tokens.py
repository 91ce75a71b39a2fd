"""Deterministic, shard-aware, resumable token pipeline.

A copy of ``repro.data.tokens`` (numpy only), kept here so the port
imports nothing of the reference; its batches are bit-identical to the
reference's for any (seed, step, shard, n_shards).

* **determinism** — batch t on shard s is a pure function of (seed, t, s);
  restarting from a checkpoint at step t reproduces the exact stream with no
  data-loader state to persist beyond the step counter.
* **shard-awareness** — each data shard draws only its slice of the global
  batch (no host ever materializes the global batch).
* **elasticity** — because batches are indexed functions, re-sharding to a
  different data-parallel degree keeps the global sample sequence identical
  (shards re-partition the same global index space).

The generator is a synthetic corpus (hash-mixed token ids with a
configurable unigram skew — enough structure for loss to fall); a real
tokenized corpus only needs another ``_sample``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 — stateless counter-based randomness."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    skew: float = 1.2          # zipf-ish unigram skew

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError(f"global batch {self.global_batch} is not a "
                             f"multiple of {self.n_shards} shards")
        if not 0 <= self.shard < self.n_shards:
            raise ValueError(f"shard {self.shard} not in "
                             f"[0, {self.n_shards})")

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_shards

    def _sample(self, gidx: np.ndarray) -> np.ndarray:
        """gidx: (n,) global sequence indices -> (n, seq_len+1) tokens."""
        pos = np.arange(self.seq_len + 1, dtype=np.uint64)[None, :]
        ctr = (gidx.astype(np.uint64)[:, None] << np.uint64(20)) | pos
        u = _mix(ctr + np.uint64(self.seed) * np.uint64(0x1000003))
        # zipf-ish skew: u^skew compresses toward small ids
        f = (u.astype(np.float64) / 2 ** 64) ** self.skew
        return (f * self.vocab).astype(np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """This shard's slice of global batch ``step`` (tokens+targets)."""
        base = np.uint64(step) * np.uint64(self.global_batch)
        lo = self.shard * self.local_batch
        gidx = base + np.arange(lo, lo + self.local_batch, dtype=np.uint64)
        toks = self._sample(gidx)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        """All shards' slices concatenated (tests / single-host)."""
        parts = [dataclasses.replace(self, shard=s).batch(step)
                 for s in range(self.n_shards)]
        return {k: np.concatenate([p[k] for p in parts])
                for k in parts[0]}
