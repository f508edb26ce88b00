"""Roofline arithmetic: the least time one kernel call could take on one
NVIDIA H100, from the work of the call.

Frozen copy of `chip_smoke.py`'s peaks, `bound` and `k1_cost`, and of
`k3_cost` with the work counted as the scan's: every live row once (not
the padded capacity), each query once, each top-k entry written once.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12


def least_seconds(nbytes: int, ops: int, peak: float) -> float:
    """max(bytes / memory rate, operations / peak): `chip_smoke.bound`."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def k1_cost(nodes, slots: int, d_pad: int, bits: int = 8
            ) -> tuple[int, int, float]:
    """(bytes, ops, peak) of one packed_score (K1) call on `nodes`
    i32[B, E] (-1 = no node): each distinct node's first `slots` slab rows
    of d_pad bytes and their ids and norms, each query row and node id,
    each output (id, distance).  bits=8: int8 multiply-adds; bits=4: f32
    multiply-adds, two components per byte."""
    import torch

    live = nodes[nodes >= 0]
    b, e = nodes.shape
    q_bytes = d_pad if bits == 8 else 4 * d_pad
    nbytes = (int(torch.unique(live).numel()) * (slots * d_pad + 8 * slots)
              + b * (q_bytes + 4) + b * e * 4 + b * e * slots * 8)
    comps = d_pad if bits == 8 else 2 * d_pad
    return (nbytes, 2 * int(live.numel()) * slots * comps,
            INT8_OPS_PER_S if bits == 8 else F32_FLOPS_PER_S)


def k3_cost(live_rows: int, dim: int, itemsize: int, b: int, k: int
            ) -> tuple[int, int, float]:
    """(bytes, ops, peak) of a scan-and-select (K3) over `live_rows` rows of
    `dim` elements of `itemsize` bytes (2: bf16, 1: int8 with an f32 scale
    a row): each row with its f32 norm and tombstone byte read once, each
    f32 query read once, each (f32 score, i64 id) written once, and
    2·B·N·D operations on the tensor cores."""
    int8 = itemsize == 1
    row = dim * itemsize + 5 + (4 if int8 else 0)
    return (live_rows * row + b * dim * 4 + b * k * 12,
            2 * b * live_rows * dim,
            INT8_OPS_PER_S if int8 else BF16_FLOPS_PER_S)
