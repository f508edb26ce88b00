"""Vector-store quantization (f32 / bf16 / symmetric per-vector int8), the
port of `ocaml_hnsw_tpu/ops/quantize.py`.  Same rounding as the JAX package:
round-half-to-even, division by the per-row scale."""

from __future__ import annotations

import torch


def storage_dtype(storage: str) -> torch.dtype:
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[storage]


def quantize_rows(x: torch.Tensor, storage: str):
    """f32[B, D] → (stored rows, scales f32[B], dequant norms f32[B]).

    norms are of the *dequantized* values so matmul-form l2 stays consistent
    with what the gather path reconstructs."""
    x = x.float()
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    if storage == "f32":
        return x, ones, torch.sum(x * x, dim=1)
    if storage == "bf16":
        xb = x.to(torch.bfloat16)
        xd = xb.float()
        return xb, ones, torch.sum(xd * xd, dim=1)
    if storage != "int8":
        raise ValueError(f"unknown storage {storage!r}")
    amax = torch.amax(torch.abs(x), dim=1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    xd = q.float() * scale[:, None]
    return q, scale, torch.sum(xd * xd, dim=1)


def dequantize_gathered(rows: torch.Tensor, scales: torch.Tensor
                        ) -> torch.Tensor:
    """[B, K, D] stored rows + f32[B, K] scales → f32[B, K, D]."""
    if rows.dtype == torch.int8:
        return rows.float() * scales[:, :, None]
    return rows.float()
