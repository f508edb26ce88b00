"""Visited sets and row-wise deduplication, the port of
`ocaml_hnsw_tpu/ops/bitset.py`.

The classic engine's two bitset modes: **exact** (one bit per node slot,
[B, N_cap/32] words) and **hashed** (a fixed 2^b-bit bitmap per query,
Knuth multiplicative hash, high bits).  Words are int32 holding the same 32
bits as the JAX package's uint32 words (`.view(np.uint32)` of the numpy
array compares them); bit 31 is the sign bit, and the shifts below mask
with & 1 so the arithmetic right shift reads it correctly.

Setting bits by scatter-add equals bitwise OR iff every masked (word, bit)
pair is distinct and currently 0; callers guarantee it by deduplicating on
the test index and pre-filtering with bitset_test, as in the JAX package.
"""

from __future__ import annotations

import torch

KNUTH = 2654435761  # 2^32 / golden ratio


def hash_ids(ids: torch.Tensor, bits_log2: int) -> torch.Tensor:
    """Multiplicative hash into [0, 2^bits_log2): high bits of the low 32
    bits of id * KNUTH (uint32 arithmetic, done in int64)."""
    h = (ids.clamp_min(0).to(torch.int64) * KNUTH) & 0xFFFFFFFF
    return (h >> (32 - bits_log2)).to(torch.int32)


def bitset_new(batch: int, n_bits: int, device=None) -> torch.Tensor:
    """Fresh all-zeros bitset: int32[batch, n_bits/32]."""
    assert n_bits % 32 == 0, "bitset size must be a multiple of 32"
    return torch.zeros((batch, n_bits // 32), dtype=torch.int32, device=device)


def bitset_test(bits: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """bool[B, K]: whether each index's bit is set (False where not valid)."""
    safe = idx.clamp_min(0)
    w = torch.gather(bits, 1, (safe >> 5).long())
    hit = ((w >> (safe & 31)) & 1) != 0
    return hit & valid


def bitset_set(bits: torch.Tensor, idx: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Set bits of `idx[b, k]` where `mask[b, k]` (OR via add, see above).
    Word indices repeat, so this is an accumulating scatter-add; int32
    addition wraps, so adding bit 31 sets the sign bit as OR would."""
    safe = idx.clamp_min(0)
    word = torch.where(mask, safe >> 5, 0).long()
    val = torch.where(mask, torch.ones_like(safe, dtype=torch.int64)
                      << (safe & 31).to(torch.int64), 0)
    # 1 << 31 wraps to int32's sign bit
    val = torch.where(val >= (1 << 31), val - (1 << 32), val).to(torch.int32)
    return bits.scatter_add(1, word, val)


def first_occurrence_mask(ids: torch.Tensor) -> torch.Tensor:
    """bool[B, K]: True on the first occurrence of each value within its row.
    K is small, so the O(K²) comparison is cheap."""
    k = ids.shape[1]
    eq = ids[:, :, None] == ids[:, None, :]  # [B, K, K]
    earlier = torch.ones((k, k), dtype=torch.bool, device=ids.device).tril(-1)
    return ~torch.any(eq & earlier, dim=2)
