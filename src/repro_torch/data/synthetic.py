"""Synthetic datasets (the container is offline: FMNIST/CIFAR are replaced by
class-conditional Gaussian mixtures with the same 10-class structure).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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
