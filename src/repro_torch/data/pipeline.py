"""Deterministic, restartable token pipeline (numpy only; the port's
copy of the reference's ``data/pipeline.py``).

* **Stateless indexing** — batch ``i`` is a pure function of ``(seed, i)``,
  so a restart resumes exactly and any host can produce any shard.
* **Host sharding** — each host materializes only its ``(host_id,
  num_hosts)`` slice of the global batch.
* **Synthetic + file-backed sources** — the synthetic stream is a
  deterministic PRNG Zipf-ish mixture (quick-start, benchmarks); the
  file source memory-maps a flat uint32 token file.

The (tokens, labels) convention: labels are tokens shifted left, with
-1 marking positions excluded from the loss.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenDataset:
    vocab: int
    seq_len: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | file:<path>
    _tokens: np.ndarray | None = None  # file-backed flat token stream

    def __post_init__(self):
        if self.source.startswith("file:"):
            path = self.source[5:]
            self._tokens = np.memmap(path, dtype=np.uint32, mode="r")

    def _synthetic_block(self, idx: np.ndarray) -> np.ndarray:
        """Deterministic pseudo-text: per-row PRNG, Zipf-ish marginals with
        short-range repetition structure (so tiny models can learn)."""
        out = np.empty((len(idx), self.seq_len + 1), np.int32)
        for r, i in enumerate(idx):
            rng = np.random.default_rng(self.seed * 1_000_003 + int(i))
            z = rng.zipf(1.5, size=self.seq_len + 1)
            row = (z - 1) % self.vocab
            # inject copy structure: second half repeats the first half
            # with per-position noise — gives a learnable signal
            half = (self.seq_len + 1) // 2
            noise = rng.random(half) < 0.1
            seg = row[:half].copy()
            seg[noise] = rng.integers(0, self.vocab, noise.sum())
            row[half : half + half] = seg[: self.seq_len + 1 - half][: half]
            out[r] = row
        return out

    def _file_block(self, idx: np.ndarray) -> np.ndarray:
        n = len(self._tokens)
        out = np.empty((len(idx), self.seq_len + 1), np.int32)
        for r, i in enumerate(idx):
            start = (int(i) * self.seq_len) % max(n - self.seq_len - 1, 1)
            out[r] = self._tokens[start : start + self.seq_len + 1]
        return out % self.vocab

    def batch(self, step: int, batch_size: int, *, host_id: int = 0,
              num_hosts: int = 1) -> dict[str, np.ndarray]:
        """Global batch ``step``, host-local slice. Pure in (seed, step)."""
        if batch_size % num_hosts:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{num_hosts} hosts")
        local = batch_size // num_hosts
        base = step * batch_size + host_id * local
        idx = np.arange(base, base + local, dtype=np.int64)
        block = (self._file_block(idx) if self._tokens is not None
                 else self._synthetic_block(idx))
        return {"tokens": block[:, :-1].astype(np.int32),
                "labels": block[:, 1:].astype(np.int32)}


def make_batches(ds: TokenDataset, batch_size: int, start_step: int = 0):
    """Infinite iterator of (step, batch) from ``start_step`` (restartable)."""
    step = start_step
    while True:
        yield step, ds.batch(step, batch_size)
        step += 1
