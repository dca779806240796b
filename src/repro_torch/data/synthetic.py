"""Deterministic synthetic LM corpus with learnable structure.

The paper's pretraining corpus is unavailable offline; benchmarks need data
where (a) losses are reproducible bit-for-bit across runs/restarts and (b)
routing has real signal to learn (some tokens are much easier to predict
than others — the premise of MoD). We generate a two-level process:

- a Zipfian unigram distribution over the vocab (natural-language-like
  marginals), and
- a sparse first-order Markov overlay: each token deterministically implies
  its successor with probability ``p_copy`` (easy tokens), otherwise a fresh
  Zipf draw (hard tokens).

Every sequence is generated counter-based from (seed, sequence_index) — no
global RNG state — so any shard/step can be regenerated independently,
which is what makes checkpoint-restart and elastic rescaling exact.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticLM:
    def __init__(
        self,
        vocab: int,
        seq_len: int,
        seed: int = 0,
        zipf_a: float = 1.2,
        p_copy: float = 0.5,
    ):
        self.vocab = vocab
        self.seq_len = seq_len
        self.seed = seed
        self.p_copy = p_copy
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        probs = ranks ** (-zipf_a)
        self.probs = probs / probs.sum()
        # fixed successor table: the deterministic "easy" transition
        succ_rng = np.random.default_rng(seed ^ 0x5EED)
        self.successor = succ_rng.permutation(vocab).astype(np.int64)

    def sequence(self, index: int) -> np.ndarray:
        """Deterministic sequence #index (counter-based)."""
        rng = np.random.default_rng((self.seed << 32) ^ index)
        n = self.seq_len + 1  # +1 so tokens/labels are a shifted pair
        fresh = rng.choice(self.vocab, size=n, p=self.probs)
        copy_mask = rng.random(n) < self.p_copy
        seq = np.empty(n, dtype=np.int64)
        seq[0] = fresh[0]
        for t in range(1, n):
            seq[t] = self.successor[seq[t - 1]] if copy_mask[t] else fresh[t]
        return seq

    def batch(self, step: int, batch_size: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        """Global batch `step`, restricted to this host's shard of sequences."""
        assert batch_size % n_shards == 0
        per = batch_size // n_shards
        base = step * batch_size + shard * per
        seqs = np.stack([self.sequence(base + i) for i in range(per)])
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }
