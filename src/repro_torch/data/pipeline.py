"""Deterministic synthetic token pipeline — shard-aware, restart-safe.

The port's own copy of ``repro.data.pipeline`` (pure numpy, so the
batches are bit-equal to the reference's); the caller moves them to its
device.

Real deployments stream tokenized shards; the repository ships no
corpus, so the pipeline synthesizes a *deterministic* stream: batch
contents are a pure function of (seed, step, position), which gives the
two properties fault tolerance needs for free:

* **skip-on-restart**: resuming from step k just means asking for
  batch(k) — no iterator state to checkpoint;
* **shard-awareness**: a host that owns rows [lo, hi) of the global
  batch generates exactly those rows (`host_slice`), so no host ever
  materializes the global batch; a mesh rank generates its part of each
  microbatch (`batch_rows`).

The token distribution is a Zipf-ish mixture with enough sequential
structure (a noisy copy task) that a ~100M model's loss visibly drops
within a few hundred steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    copy_period: int = 64      # structure: tokens repeat with this period
    noise: float = 0.1


class SyntheticTokens:
    """batch(step) -> {"tokens": (B,S) int32, "labels": (B,S) int32}."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _row(self, step: int, row: int) -> np.ndarray:
        """One sequence, a pure function of (seed, step, absolute row) —
        the property that makes host sharding and restart-skipping
        trivially consistent."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, row]))
        base = (rng.zipf(1.5, size=cfg.copy_period) - 1) % cfg.vocab
        reps = -(-(cfg.seq_len + 1) // cfg.copy_period)
        seq = np.tile(base, reps)[: cfg.seq_len + 1]
        mask = rng.random(seq.shape) < cfg.noise
        return np.where(mask, rng.integers(0, cfg.vocab, seq.shape), seq)

    def batch(self, step: int, row_lo: int = 0,
              row_hi: Optional[int] = None) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        row_hi = cfg.global_batch if row_hi is None else row_hi
        seq = np.stack([self._row(step, r) for r in range(row_lo, row_hi)])
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def batch_rows(self, step: int, rows) -> Dict[str, np.ndarray]:
        """The rows ``[lo, hi)`` of each range of ``rows`` of batch
        ``step``, concatenated in order: a mesh rank's rows of every
        microbatch (``training.rank_rows``), each from :meth:`batch`."""
        parts = [self.batch(step, lo, hi) for lo, hi in rows]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def host_slice(self, step: int, host_id: int, n_hosts: int):
        """The rows this host owns of the global batch at `step`."""
        per = self.cfg.global_batch // n_hosts
        lo = host_id * per
        return self.batch(step, lo, lo + per)
