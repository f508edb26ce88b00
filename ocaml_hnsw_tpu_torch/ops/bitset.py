"""Row-wise deduplication, the part of `ocaml_hnsw_tpu/ops/bitset.py` that the
packed engine and the bulk constructor use.  (The visited bitsets serve the
classic engine's non-default modes and are not ported yet.)"""

from __future__ import annotations

import torch


def first_occurrence_mask(ids: torch.Tensor) -> torch.Tensor:
    """bool[B, K]: True on the first occurrence of each value within its row.
    K is small, so the O(K²) comparison is cheap."""
    k = ids.shape[1]
    eq = ids[:, :, None] == ids[:, None, :]  # [B, K, K]
    earlier = torch.ones((k, k), dtype=torch.bool, device=ids.device).tril(-1)
    return ~torch.any(eq & earlier, dim=2)
