"""Hand-written Hopper kernels and their plain torch versions.

Each wrapper launches its CUDA kernel for CUDA tensors (built from `csrc/` at
first use) and runs its plain version for CPU tensors, and counts its kernel
launches in `<wrapper>.launches`.

- `payload_score.packed_score` — `csrc/payload_score.cu`; replaces the TPU
  kernel `ocaml_hnsw_tpu/ops/pallas/payload_score.py::payload_score`.
- `gather_dist.gather_dists` — `csrc/gather_dist.cu`; replaces the TPU
  kernel `ocaml_hnsw_tpu/ops/pallas/gather_dist.py::gather_l2`.
- `scan_topk.scan_topk` — `csrc/scan_topk.cu`; replaces the flat scan the
  JAX package leaves to XLA on the TPU (`ocaml_hnsw_tpu/models/flat.py`:
  the MXU `dot_general` fused with `approx_min_k`).
"""
