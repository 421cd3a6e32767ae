"""Synthetic datasets (the container is offline: FMNIST/CIFAR are replaced by
class-conditional Gaussian mixtures with the same 10-class structure, and LM
training uses a deterministic synthetic token stream).  Numpy only, drawn
exactly as the JAX package draws them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class ClassificationData:
    x: np.ndarray        # (n, dim) float32
    y: np.ndarray        # (n,) int32
    n_classes: int


def make_classification(n_samples: int = 20000, dim: int = 32, n_classes: int = 10,
                        sep: float = 2.0, seed: int = 0) -> ClassificationData:
    """Gaussian blobs: class means ~ sep * unit sphere, unit covariance."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n_classes, dim))
    means = sep * means / np.linalg.norm(means, axis=1, keepdims=True)
    y = rng.integers(0, n_classes, size=n_samples)
    x = means[y] + rng.normal(size=(n_samples, dim))
    return ClassificationData(x.astype(np.float32), y.astype(np.int32), n_classes)


def train_test_split(data: ClassificationData, test_frac: float = 0.2,
                     seed: int = 0) -> Tuple[ClassificationData, ClassificationData]:
    rng = np.random.default_rng(seed)
    n = len(data.y)
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    return (ClassificationData(data.x[tr], data.y[tr], data.n_classes),
            ClassificationData(data.x[te], data.y[te], data.n_classes))


def make_token_stream(vocab_size: int, n_tokens: int, seed: int = 0,
                      order: int = 2) -> np.ndarray:
    """Deterministic synthetic LM data: a noisy order-k Markov chain so models
    have real structure to learn (loss decreases measurably in a few steps)."""
    rng = np.random.default_rng(seed)
    out = np.empty(n_tokens, np.int32)
    state = 1
    for i in range(n_tokens):
        if rng.random() < 0.15:
            tok = rng.integers(0, vocab_size)
        else:
            tok = (state * 1103515245 + 12345) % vocab_size
        out[i] = tok
        state = (state * order + int(tok)) % (1 << 31)
    return out


def lm_batches(tokens: np.ndarray, batch: int, seq: int, seed: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        tok = np.stack([tokens[s:s + seq] for s in starts])
        lab = np.stack([tokens[s + 1:s + seq + 1] for s in starts])
        yield {"tokens": tok.astype(np.int32), "labels": lab.astype(np.int32),
               "loss_mask": np.ones((batch, seq), np.float32)}
