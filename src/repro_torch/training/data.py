"""Synthetic data pipeline: deterministic, seekable, infinite (the
reference's ``repro/training/data.py``, host-side numpy, giving the same
arrays for the same seed and step).

Sequences are Zipf-distributed token streams with local n-gram structure
(so the LM loss actually decreases) rather than uniform noise.
``synthetic_batch`` gives one random batch of an arch's modality.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class TokenPipeline:
    """Markov-ish synthetic token stream with learnable structure."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, order: int = 2):
        self.v = vocab_size
        self.s = seq_len
        self.b = batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        # sparse transition table: each context maps to a few likely tokens
        self._ctx_next = rng.integers(0, vocab_size, size=(4096, 4))

    def _gen_row(self, rng) -> np.ndarray:
        out = np.empty(self.s + 1, np.int64)
        out[0] = rng.integers(0, self.v)
        for t in range(1, self.s + 1):
            ctx = int(out[t - 1]) % 4096
            if rng.random() < 0.8:  # predictable branch
                out[t] = self._ctx_next[ctx][rng.integers(0, 4)]
            else:
                out[t] = min(int(rng.zipf(1.3)), self.v - 1)
        return out

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            rng = np.random.default_rng((self.seed, step))
            toks = np.stack([self._gen_row(rng) for _ in range(self.b)])
            yield {
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, :-1].astype(np.int32),
            }
            step += 1


def synthetic_batch(cfg, shape, rng=None) -> Dict[str, np.ndarray]:
    """One random batch of ``shape`` (a ``ShapeConfig``) for ``cfg``'s
    modality: audio frames (B, S, d) float32 with frame labels, or tokens
    and labels (B, S) int32, plus mrope's (3, B, S) positions."""
    rng = rng or np.random.default_rng(0)
    b, s = shape.global_batch, shape.seq_len
    if cfg.modality == "audio":
        return {
            "frames": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        }
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
    }
    if cfg.rope_variant == "mrope":
        batch["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32), (3, b, s)).copy()
    return batch
