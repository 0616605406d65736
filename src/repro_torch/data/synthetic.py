"""Deterministic synthetic token pipeline: the reference's
``data/synthetic.py``, kept line for line (it is pure numpy), so its
batches are bit-identical to the reference's for every (seed, step,
shard).

Properties a production loader needs and this one has:
  * deterministic as a function of (seed, step, shard) — restart-safe,
  * shard-aware: each data-parallel rank draws only its slice,
  * stateless resume: checkpoint stores just the step counter,
  * host-side numpy generation (cheap); the trainer copies each batch to
    its device.

The "dataset" is a Zipf-ish categorical over the vocab with a linear
next-token structure so loss decreases when models actually learn.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokens:
    def __init__(self, cfg: DataConfig, num_shards: int = 1, shard: int = 0):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.num_shards = num_shards
        self.shard = shard
        # fixed Zipf-ish marginal + deterministic bigram shift structure
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.shard])
        )

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Returns {"tokens", "labels"} of shape (local_batch, seq_len)."""
        rng = self._rng(step)
        b = self.cfg.global_batch // self.num_shards
        s = self.cfg.seq_len
        toks = rng.choice(self.cfg.vocab, size=(b, s + 1), p=self.probs).astype(
            np.int32
        )
        # inject learnable structure: every other token is prev+1 mod V
        toks[:, 1::2] = (toks[:, 0:-1:2] + 1) % self.cfg.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
