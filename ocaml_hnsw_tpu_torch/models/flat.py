"""Flat-scan index, the port of `ocaml_hnsw_tpu/models/flat.py` on the path
the bulk constructor's kNN table uses: a bf16 scan over every row, top
`rerank_k` candidates, then an exact f32 rerank through the gather-distance
kernel (K2).

The scan multiplies the bf16-rounded operands upcast to f32 (bf16×bf16
products are exact in f32), which is what the JAX package's bf16 dot with
f32 output computes; TF32 must be off.  Its `approx_min_k` becomes exact
`torch.topk`.  The int8 scan, the exact (BFIndex) scan and the chunked
registry-metric scan are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ocaml_hnsw_tpu_torch.ops.distance import INF
from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import gather_dists
from ocaml_hnsw_tpu_torch.utils import round_up


@dataclasses.dataclass
class FlatTensors:
    """Flat index state.  scan: bf16[N_cap, D]; scales: f32[N_cap] (ones);
    rerank: f32[N_cap, D] exact rows; norms: f32[N_cap] ‖x‖² (+inf on empty
    slots so padding never scores); n: 0-d int32 count; deleted: tombstones."""

    scan: torch.Tensor
    scales: torch.Tensor
    rerank: torch.Tensor
    norms: torch.Tensor
    n: torch.Tensor
    deleted: torch.Tensor

    @property
    def n_cap(self) -> int:
        return self.scan.shape[0]


def empty_flat(dim: int, max_elements: int,
               device: torch.device | str = "cpu") -> FlatTensors:
    # same 4096-row capacity alignment as the JAX package, so both scan the
    # same padded shapes
    n_cap = round_up(max(max_elements, 4096), 4096)
    return FlatTensors(
        scan=torch.zeros((n_cap, dim), dtype=torch.bfloat16, device=device),
        scales=torch.ones((n_cap,), dtype=torch.float32, device=device),
        rerank=torch.zeros((n_cap, dim), dtype=torch.float32, device=device),
        norms=torch.full((n_cap,), INF, dtype=torch.float32, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
        deleted=torch.zeros((n_cap,), dtype=torch.bool, device=device),
    )


def flat_add(flat: FlatTensors, rows, start: int, count: int) -> FlatTensors:
    """Write the first `count` of `rows` at slots [start, start+count).
    Updates `flat` in place (no second copy of the index) and returns it."""
    count = max(0, min(int(count), rows.shape[0], flat.n_cap - start))
    if count == 0:
        return flat
    rows = rows[:count].float()
    sl = slice(start, start + count)
    flat.scan[sl] = rows.to(flat.scan.dtype)
    flat.rerank[sl] = rows
    flat.norms[sl] = torch.sum(rows * rows, dim=1)
    flat.n += count
    return flat


@torch.no_grad()
def flat_search(flat: FlatTensors, queries, k: int, metric: str,
                rerank_k: int = 32):
    """Returns (ids i32[B, k], dists f32[B, k]) ascending, -1/+inf padded:
    bf16 scan + exact top-rerank_k + exact f32 rerank."""
    from ocaml_hnsw_tpu_torch.models.search import preprocess_queries
    from ocaml_hnsw_tpu_torch.ops.metrics import get_metric

    m = get_metric(metric)
    if m.matmul_score is None:
        raise NotImplementedError(
            f"flat scan: metric {metric!r} has no matmul_score (the chunked "
            "exact scan is not ported yet)")
    q = preprocess_queries(queries, metric)
    rerank_k = max(k, min(rerank_k, flat.n_cap))
    dot = torch.matmul(q.to(torch.bfloat16).float(), flat.scan.float().T)
    # rank-equivalent scores from the one product (e.g. l2 drops +‖q‖²)
    scores = m.matmul_score(dot, flat.norms[None, :])
    del dot
    scores.masked_fill_(flat.deleted[None, :], INF)
    # empty slots carry norms=+inf (l2-style metrics consume them); for
    # norm-free metrics mask unoccupied slots explicitly
    if not m.needs_norms:
        occupied = torch.arange(flat.n_cap, device=q.device) < flat.n
        scores.masked_fill_(~occupied[None, :], INF)
    ids = torch.topk(scores, rerank_k, dim=1, largest=False).indices
    del scores
    ids = ids.to(torch.int32)
    # exact rerank of the candidates through the gather-distance kernel
    d = gather_dists(flat.rerank, flat.scales, q, ids, metric)
    # mask tombstones and unoccupied slots (zero rows would score finite)
    safe = ids.long()
    d = torch.where(flat.deleted[safe] | (ids >= flat.n), INF, d)
    # stable sort = lax.top_k's order: equal distances keep the lower column
    out_d, idx = torch.sort(d, dim=1, stable=True)
    out_d = out_d[:, :k]
    out_ids = torch.gather(ids, 1, idx[:, :k])
    out_ids = torch.where(torch.isinf(out_d), -1, out_ids)
    return out_ids, out_d
