"""The deployments' rows and query pools, made on the card from the seed.

`clustered_device` is a frozen copy of
`ocaml_hnsw_tpu_torch/bench/datasets.py::clustered_device` (a Gaussian
mixture drawn by a `torch.Generator` on the device, queries jittered from
rows), cut to its float32 path.  `make` returns the host arrays that both
the port and the reference are given.
"""

from __future__ import annotations

import numpy as np
import torch

#: rows per draw, so that the mixture's temporaries stay small
SLAB = 1 << 19
#: added to the run's seed for the query pool's generator
QUERY_SEED_OFFSET = 1


def clustered_device(n: int, dim: int, n_clusters: int, seed: int,
                     spread: float, device):
    """(rows f32[n, dim] on `device`, make_queries(n_queries, qseed,
    jitter)): centres ~ N(0, 1), each row a centre plus spread · N(0, 1);
    each query a row picked at random plus jitter · N(0, 1)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn((n_clusters, dim), generator=gen, device=dev)
    data = torch.empty((n, dim), dtype=torch.float32, device=dev)
    for lo in range(0, n, SLAB):
        rows = min(SLAB, n - lo)
        assign = torch.randint(0, n_clusters, (rows,), generator=gen,
                               device=dev)
        data[lo:lo + rows] = centers[assign] + spread * torch.randn(
            (rows, dim), generator=gen, device=dev)

    def make_queries(n_queries: int, qseed: int, jitter: float):
        qgen = torch.Generator(device=dev).manual_seed(qseed)
        picks = torch.randint(0, n, (n_queries,), generator=qgen, device=dev)
        return data[picks] + jitter * torch.randn(
            (n_queries, dim), generator=qgen, device=dev)

    return data, make_queries


def make(cfg: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(rows f32[n, dim], query pool f32[n_queries, dim]) as host arrays, as
    a user holds them, for the configuration `cfg` and the run's seed."""
    gen = cfg["generator"]
    if gen["kind"] != "clustered":
        raise ValueError(f"unknown generator {gen['kind']!r}")
    data, make_queries = clustered_device(
        cfg["n"], cfg["dim"], gen["n_clusters"], seed, gen["spread"], device)
    pool = make_queries(cfg["n_queries"], seed + QUERY_SEED_OFFSET,
                        gen["jitter"])
    rows_host, pool_host = data.cpu().numpy(), pool.cpu().numpy()
    del data, pool
    return rows_host, pool_host
