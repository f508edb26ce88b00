"""Metric registry of the torch port — the same contract as the JAX package's
`ocaml_hnsw_tpu/ops/metrics.py`, kept separate because that package's `ops`
imports jax.

A metric supplies:

  pair_dist(rows, q) -> d          REQUIRED.  rows f32[..., K, D], q
      f32[..., D] (broadcast against rows' leading dims) -> f32[..., K].
      Written with operators and methods only, so the same function runs on
      torch tensors and on NumPy arrays.  If that's not possible, pass a
      separate ``np_pair_dist`` for the NumPy side (`Metric.pair_dist_np`).

  matmul_score(dot, x_norms) -> s  OPTIONAL.  Rank-equivalent scores from one
      matrix product: dot f32[B, N] = q·xᵀ, x_norms f32[N] = ‖x‖².  Enables
      the flat scan, the seed-scan entry and the packed engine.

  normalize_add / normalize_query  OPTIONAL.  Pre-normalize vectors at add /
      query time (how "cosine" reduces to "ip").

  needs_norms                      OPTIONAL.  Store per-row ‖x‖² (required
      when matmul_score consumes x_norms, as l2's does).

The CUDA gather-distance kernel covers the built-in metrics only; a
registered metric runs its `pair_dist` on the gathered rows, on the device
the tensors are on (`ops/kernels/gather_dist.py::gather_dists`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    pair_dist: Callable
    matmul_score: Callable | None = None
    np_pair_dist: Callable | None = None
    normalize_add: bool = False
    normalize_query: bool = False
    needs_norms: bool = False

    def pair_dist_np(self, rows, q):
        """NumPy-side pair distance: `np_pair_dist` when given, else
        `pair_dist`."""
        fn = self.np_pair_dist or self.pair_dist
        return fn(rows, q)


_REGISTRY: dict[str, Metric] = {}


def register_metric(
    name: str,
    pair_dist: Callable,
    *,
    matmul_score: Callable | None = None,
    np_pair_dist: Callable | None = None,
    normalize_add: bool = False,
    normalize_query: bool = False,
    needs_norms: bool = False,
    overwrite: bool = False,
) -> Metric:
    """Register a user metric under `name` (see module docstring).  Built-in
    names cannot be overwritten unless overwrite=True."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"metric {name!r} already registered")
    m = Metric(
        name=name,
        pair_dist=pair_dist,
        matmul_score=matmul_score,
        np_pair_dist=np_pair_dist,
        normalize_add=normalize_add,
        normalize_query=normalize_query,
        needs_norms=needs_norms,
    )
    _REGISTRY[name] = m
    return m


def unregister_metric(name: str) -> None:
    """Remove a user-registered metric (built-ins are permanent)."""
    if name in _BUILTINS:
        raise ValueError(f"built-in metric {name!r} cannot be unregistered")
    _REGISTRY.pop(name, None)


def get_metric(name: str) -> Metric:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; registered: {sorted(_REGISTRY)} "
            "(register_metric() adds new ones)"
        ) from None


def is_metric(name: str) -> bool:
    return name in _REGISTRY


def registered_metrics() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------- built-ins
# l2 is *squared* Euclidean; ip/cosine are 1 - dot with cosine rows/queries
# pre-normalized (the hnswlib conventions).


def _l2_pair(rows, q):
    diff = rows - q[..., None, :]
    return (diff * diff).sum(-1)


def _dot_pair(rows, q):
    return 1.0 - (rows * q[..., None, :]).sum(-1)


register_metric(
    "l2",
    _l2_pair,
    matmul_score=lambda dot, x_norms: x_norms - 2.0 * dot,  # +‖q‖² rank-inv.
    needs_norms=True,
)
register_metric("ip", _dot_pair, matmul_score=lambda dot, x_norms: -dot)
register_metric(
    "cosine",
    _dot_pair,
    matmul_score=lambda dot, x_norms: -dot,
    normalize_add=True,
    normalize_query=True,
)

_BUILTINS = frozenset(_REGISTRY)
