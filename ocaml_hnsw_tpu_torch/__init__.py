"""ocaml_hnsw_tpu_torch — the HNSW index of `ocaml_hnsw_tpu` ported to PyTorch,
with hand-written CUDA kernels for Hopper (`csrc/`).

The JAX package `ocaml_hnsw_tpu` is the reference: this package mirrors its
module names (config, ops/, models/, api) and is held against it by the
`tests/test_torch_*.py` parity tests.  It imports torch and numpy only —
never jax, and nothing of the JAX package.
"""

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.api import BFIndex, FlatIndex, Index

__version__ = "0.1.0"

__all__ = ["BFIndex", "FlatIndex", "HnswConfig", "Index", "__version__"]
