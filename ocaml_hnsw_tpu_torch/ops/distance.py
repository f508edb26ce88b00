"""Batched distance computation, the port of `ocaml_hnsw_tpu/ops/distance.py`.

Metric conventions match the JAX package: "l2" = squared Euclidean, "ip" =
1 - <q, x>, "cosine" = 1 - <q̂, x̂> with vectors normalized at add/query time.
`dists_to_ids` goes through the gather-distance kernel (K2); the all-pairs
blocks of Alg 4 stay a batched f32 `torch.matmul`, as the JAX package leaves
them to XLA.  float32 matmuls must run in full f32 (TF32 off, torch's
default), or neighbour order scrambles.
"""

from __future__ import annotations

import torch

from ocaml_hnsw_tpu_torch.ops.metrics import get_metric
from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import gather_dists
from ocaml_hnsw_tpu_torch.ops.quantize import dequantize_gathered

INF = float("inf")


def require_full_f32_matmul(device) -> None:
    """Raise unless float32 matrix products on `device` run in full f32: an
    exact scan and the ground truth need true f32 products, and TF32 rounds
    the operands to 10 mantissa bits.  The CPU always does."""
    if torch.device(device).type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmuls are set to run in TF32; set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def query_norms(q: torch.Tensor, metric: str) -> torch.Tensor:
    """Per-query ||q||² for norm-consuming metrics (l2); zeros otherwise. [B]"""
    if get_metric(metric).needs_norms:
        return torch.sum(q * q, dim=-1)
    return torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)


def dists_to_ids(vectors, scales, norms, q, qn, ids, metric: str):
    """Distances d(q_b, x_{ids[b,k]}) as f32[B, K]; +inf at sentinel slots.

    vectors [N_cap, D] stored rows (f32 / bf16 / int8), scales f32[N_cap],
    q f32[B, D], ids i32[B, K] (-1 = sentinel).  norms/qn are unused (kept
    for the JAX signature)."""
    del norms, qn
    return gather_dists(vectors, scales, q, ids, metric)


def gather_dequant(vectors, scales, ids):
    """Gather rows by id and dequantize to f32[B, K, D] (sentinels → row 0)."""
    safe = ids.clamp_min(0).long()
    return dequantize_gathered(vectors[safe], scales[safe])


def pairwise_dists(x, x_norms, metric: str):
    """All-pairs distances within each row's candidate set: f32[B, K, K]
    (x f32[B, K, D], x_norms f32[B, K] ‖x‖², zeros for ip/cosine)."""
    if metric == "l2":
        dot = torch.matmul(x, x.transpose(1, 2))
        d = x_norms[:, :, None] - 2.0 * dot + x_norms[:, None, :]
        return torch.clamp_min(d, 0.0)
    if metric in ("ip", "cosine"):
        return 1.0 - torch.matmul(x, x.transpose(1, 2))
    m = get_metric(metric)
    # d[b, k, j] = dist(query=x[b, k], row=x[b, j]) per pair_dist convention
    return m.pair_dist(x[:, None, :, :], x)
