"""Deterministic LM token pipeline for the assigned architectures.

A copy of ``repro.data.tokens`` (numpy only): the same seed gives the
same batches, bit for bit.

Production framework substrate: an infinite, seeded, shardable stream of
(tokens, targets) batches with a restartable cursor — enough to drive the
train examples and smoke tests without external datasets. Sequences follow a
Zipfian unigram mixed with a repeated-motif process so the loss is learnable
(models fit the motifs) yet cheap to generate.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    motif_len: int = 16
    num_motifs: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        vocab = max(self.vocab_size - 1, 1)
        self._motifs = rng.integers(0, vocab, size=(self.num_motifs, self.motif_len))
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._zipf = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.step = 0

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, targets), each (batch, seq_len) int32; targets are
        tokens shifted left (next-token prediction)."""
        rng = np.random.default_rng((self.seed, self.step))
        b, s = self.batch_size, self.seq_len + 1
        base = rng.choice(len(self._zipf), size=(b, s), p=self._zipf)
        # Overwrite random spans with motifs => predictable structure.
        for i in range(b):
            for _ in range(max(1, s // (4 * self.motif_len))):
                m = self._motifs[rng.integers(0, self.num_motifs)]
                start = rng.integers(0, max(s - self.motif_len, 1))
                base[i, start : start + self.motif_len] = m[: s - start]
        self.step += 1
        tokens = base[:, :-1].astype(np.int32)
        targets = base[:, 1:].astype(np.int32)
        return tokens, targets
