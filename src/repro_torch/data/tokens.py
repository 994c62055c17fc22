"""Token pipeline for the LM task.

A copy of ``repro/data/tokens.py`` (numpy only): deterministic synthetic
token streams with Zipfian unigram statistics plus a sticky bigram, so the
loss falls during smoke training.  The same seed gives the same batches as
the reference (tests/test_torch_lgc_step.py::test_token_pipeline_matches).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # sticky bigram: with p=0.5 the next token is (prev*7+3) % v
        self._sticky = 0.5

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = self._rng.choice(v, b, p=self._unigram)
        sticky = self._rng.random((b, s)) < self._sticky
        fresh = self._rng.choice(v, (b, s), p=self._unigram)
        for t in range(s):
            nxt = (toks[:, t].astype(np.int64) * 7 + 3) % v
            toks[:, t + 1] = np.where(sticky[:, t], nxt, fresh[:, t])
        return toks[:, :-1], toks[:, 1:]
