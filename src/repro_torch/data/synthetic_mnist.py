"""Synthetic MNIST-like dataset (generated from a seed, no downloads).

Deterministic class-structured 28x28 images: each digit class c has a set of
smooth prototype templates (random low-frequency blobs seeded per class);
samples are prototype + elastic jitter + pixel noise. The generator preserves
the properties the paper's experiments rely on: 10 classes, learnable with a
2-layer MLP to high accuracy, label flips measurably degrade the targeted
class.

A numpy copy of ``repro.data.synthetic_mnist``: the same seed gives the
same bytes (tests/test_torch_data.py pins it).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

N_CLASSES = 10
IMG = 28


@dataclasses.dataclass
class Dataset:
    x: np.ndarray    # (N, 784) float32 in [0,1]
    y: np.ndarray    # (N,) int32

    def __len__(self):
        return self.x.shape[0]

    def subset(self, idx: np.ndarray) -> "Dataset":
        return Dataset(self.x[idx], self.y[idx])


def _class_prototypes(rng: np.random.Generator, n_proto: int = 4) -> np.ndarray:
    """(C, n_proto, 28, 28) smooth random blobs, distinct per class."""
    protos = np.zeros((N_CLASSES, n_proto, IMG, IMG), np.float32)
    yy, xx = np.mgrid[0:IMG, 0:IMG] / (IMG - 1)
    for c in range(N_CLASSES):
        for p in range(n_proto):
            img = np.zeros((IMG, IMG), np.float32)
            # 3-5 gaussian strokes at class-consistent anchor points
            n_blobs = 3 + (c % 3)
            for b in range(n_blobs):
                cx = 0.2 + 0.6 * ((c * 7 + b * 3 + p) % 10) / 9.0
                cy = 0.2 + 0.6 * ((c * 3 + b * 5) % 10) / 9.0
                sx = 0.05 + 0.08 * rng.uniform()
                sy = 0.05 + 0.08 * rng.uniform()
                img += np.exp(-((xx - cx) ** 2 / (2 * sx ** 2)
                                + (yy - cy) ** 2 / (2 * sy ** 2)))
            protos[c, p] = img / max(img.max(), 1e-6)
    return protos


def generate(n_train: int = 50_000, n_test: int = 10_000,
             seed: int = 0, noise: float = 0.15) -> Tuple[Dataset, Dataset]:
    """Paper §V-A sizes: 50,000 train / 10,000 test."""
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng)
    n_proto = protos.shape[1]

    def make(n):
        y = rng.integers(0, N_CLASSES, size=n).astype(np.int32)
        p = rng.integers(0, n_proto, size=n)
        base = protos[y, p]                                  # (n, 28, 28)
        shift = rng.integers(-2, 3, size=(n, 2))
        imgs = np.empty_like(base)
        for i in range(n):                                   # cheap roll jitter
            imgs[i] = np.roll(np.roll(base[i], shift[i, 0], 0), shift[i, 1], 1)
        imgs = imgs + noise * rng.standard_normal(imgs.shape).astype(np.float32)
        x = np.clip(imgs, 0.0, 1.0).reshape(n, IMG * IMG).astype(np.float32)
        return Dataset(x, y)

    return make(n_train), make(n_test)
