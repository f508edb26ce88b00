"""Synthetic dataset generators (NumPy), the same functions and streams as
the JAX package's `ocaml_hnsw_tpu/bench/datasets.py`, so a seed gives both
packages the same rows."""

from __future__ import annotations

import numpy as np


def clustered(n: int, dim: int, n_clusters: int = 100, seed: int = 0,
              spread: float = 0.15) -> np.ndarray:
    """Gaussian-mixture data, the shape real embedding datasets take."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, dim).astype(np.float32)
    assign = rng.randint(0, n_clusters, size=n)
    return (centers[assign] + spread * rng.randn(n, dim)).astype(np.float32)


def queries_like(data: np.ndarray, n_queries: int, seed: int = 1,
                 jitter: float = 0.1) -> np.ndarray:
    """Queries drawn near dataset points (ann-benchmarks train/test style)."""
    rng = np.random.RandomState(seed)
    picks = rng.randint(0, data.shape[0], size=n_queries)
    q = data[picks] + jitter * rng.randn(n_queries, data.shape[1]).astype(np.float32)
    return q.astype(np.float32)
