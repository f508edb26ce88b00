"""Synthetic dataset generators for the benchmark configs, the port of
`ocaml_hnsw_tpu/bench/datasets.py`.

The NumPy generators are the same functions and streams as the JAX
package's, so a seed gives both packages the same rows.  `clustered_device`
draws on the device from a `torch.Generator`: the same mixture (centres,
`spread`, `jitter`) but not the JAX package's random bits, deterministic for
a seed on a device.  No real dataset is read: every config is a synthetic
stand-in of matching shape and metric, clustered so that recall is not
trivial (uniform random data is too easy for HNSW).
"""

from __future__ import annotations

import numpy as np
import torch


def random_uniform(n: int, dim: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.rand(n, dim).astype(np.float32)


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


def _shaped(n: int, dim: int, n_queries: int, seed: int):
    data = clustered(n, dim, n_clusters=max(64, n // 2500), seed=seed)
    return data, queries_like(data, n_queries, seed=seed + 1)


def sift_shaped(n: int = 1_000_000, n_queries: int = 10_000, seed: int = 7):
    """SIFT1M-shaped stand-in: 128-d, clustered, L2."""
    return _shaped(n, 128, n_queries, seed)


def glove_shaped(n: int = 1_183_514, n_queries: int = 10_000, seed: int = 11):
    """GloVe-1.2M-shaped stand-in: 100-d, angular/cosine."""
    return _shaped(n, 100, n_queries, seed)


def deep_shaped(n: int = 10_000_000, n_queries: int = 10_000, seed: int = 13):
    """Deep10M-shaped stand-in: 96-d, L2, for int8 quantization."""
    return _shaped(n, 96, n_queries, seed)


def laion_shaped(n: int = 5_000_000, n_queries: int = 10_000, seed: int = 17):
    """LAION-5M CLIP-shaped stand-in: 768-d, cosine, streaming."""
    return _shaped(n, 768, n_queries, seed)


#: rows per slab of `clustered_device`'s slab path
DEVICE_SLAB = 1 << 19


def clustered_device(n: int, dim: int, n_clusters: int = 100, seed: int = 0,
                     spread: float = 0.15, dtype=None,
                     device: torch.device | str = "cuda"):
    """Clustered data and queries made on `device` (a 1M-scale dataset is
    gigabytes: it is drawn where it is used, not copied from the host).
    Returns (data [n, dim] on the device, make_queries).

    dtype: storage dtype of the dataset (default float32).  torch.bfloat16
    is for configs where memory is short; the data is then drawn slab by
    slab in f32 and stored as bf16, so the peak transient is one slab, not a
    full-size f32 copy (f32 datasets over 4 GiB go the same way)."""
    dtype = dtype or torch.float32
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn((n_clusters, dim), generator=gen, device=dev)

    def draw(rows: int):
        assign = torch.randint(0, n_clusters, (rows,), generator=gen,
                               device=dev)
        return centers[assign] + spread * torch.randn(
            (rows, dim), generator=gen, device=dev)

    if dtype == torch.float32 and n * dim * 4 <= (4 << 30):
        data = draw(n)
    else:
        data = torch.empty((n, dim), dtype=dtype, device=dev)
        for lo in range(0, n, DEVICE_SLAB):
            rows = min(DEVICE_SLAB, n - lo)
            data[lo:lo + rows] = draw(rows).to(dtype)

    def make_queries(n_queries: int, qseed: int = 1, jitter: float = 0.1):
        qgen = torch.Generator(device=dev).manual_seed(qseed)
        picks = torch.randint(0, n, (n_queries,), generator=qgen, device=dev)
        return data[picks].float() + jitter * torch.randn(
            (n_queries, dim), generator=qgen, device=dev)

    return data, make_queries
