"""Tensor ops of the torch port: metrics, quantization, dedup, bitonic
networks, distances, and the CUDA kernels under `ops/kernels`.  Re-exports
the JAX package's `ops` names."""

from ocaml_hnsw_tpu_torch.ops.distance import (
    dists_to_ids, query_norms, pairwise_dists,
)
from ocaml_hnsw_tpu_torch.ops.bitset import (
    bitset_new,
    bitset_test,
    bitset_set,
    first_occurrence_mask,
)

__all__ = [
    "dists_to_ids",
    "query_norms",
    "pairwise_dists",
    "bitset_new",
    "bitset_test",
    "bitset_set",
    "first_occurrence_mask",
]
