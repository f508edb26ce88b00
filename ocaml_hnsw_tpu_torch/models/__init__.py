"""Graph state, flat scan, bulk constructor, seed entry and the packed
query engine of the torch port.  Re-exports the JAX package's `models`
names."""

from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, from_oracle, empty_graph,
)
from ocaml_hnsw_tpu_torch.models.search import (
    knn_search,
    SeedIndex,
    build_seed_index,
)

__all__ = [
    "GraphTensors",
    "from_oracle",
    "empty_graph",
    "knn_search",
    "SeedIndex",
    "build_seed_index",
]
