"""Frozen configuration for an HNSW index — the JAX package's `HnswConfig`
(`ocaml_hnsw_tpu/config.py`), validated against this package's metric
registry so that importing it pulls in no jax.

Defaults follow the hnswlib surface (M=16, ef_construction=200,
random_seed=100, ef=10) and the paper's derived constants (M_max0 = 2*M at
layer 0, mL = 1/ln(M); arXiv:1603.09320 §4.1, Alg 1).
"""

from __future__ import annotations

import dataclasses
import math

#: built-in metrics; user metrics join via ops.metrics.register_metric
METRICS = ("l2", "ip", "cosine")
STORAGES = ("f32", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """All build/search-time hyperparameters of an HNSW index (the field
    meanings are those of the JAX package's HnswConfig)."""

    dim: int
    metric: str = "l2"
    M: int = 16
    M_max0: int | None = None
    ef_construction: int = 200
    ef: int = 10
    seed: int = 100
    extend_candidates: bool = False
    keep_pruned_connections: bool = False
    select: str = "heuristic"
    max_level_cap: int | None = None
    storage: str = "f32"

    def __post_init__(self):
        from ocaml_hnsw_tpu_torch.ops.metrics import (
            is_metric, registered_metrics,
        )

        if not is_metric(self.metric):
            raise ValueError(
                f"metric must be one of {registered_metrics()} (see "
                f"ops.metrics.register_metric), got {self.metric!r}"
            )
        if self.storage not in STORAGES:
            raise ValueError(
                f"storage must be one of {STORAGES}, got {self.storage!r}"
            )
        if self.select not in ("heuristic", "simple"):
            raise ValueError(
                f"select must be 'heuristic' or 'simple', got {self.select!r}"
            )
        if self.M < 2:
            raise ValueError("M must be >= 2")
        if self.M_max0 is None:
            object.__setattr__(self, "M_max0", 2 * self.M)

    @property
    def mL(self) -> float:
        """Level-sampling multiplier mL = 1/ln(M) (Alg 1)."""
        return 1.0 / math.log(self.M)

    def derived_max_level(self, max_elements: int) -> int:
        """Static cap on layer index: P(level > L) = M^-L; pick L with expected
        count < 1 node above it, plus slack."""
        if self.max_level_cap is not None:
            return self.max_level_cap
        if max_elements <= 1:
            return 1
        return max(1, int(math.ceil(math.log(max_elements) / math.log(self.M))) + 1)
