"""Flat-scan index, the port of `ocaml_hnsw_tpu/models/flat.py`: one scan over
every row, the top `rerank_k` candidates, then an exact rerank of those
through the gather-distance kernel (K2) and the final top-k.

Four scans, as in the JAX package:

  * bf16 (default) and int8 (`scan_dtype="int8"`: rows and queries
    quantized per row, an exact integer dot, one f32 rescale by the outer
    product of the scales) go to the scan-and-select kernel (K3,
    `ops/kernels/scan_topk.py`), which takes the product on the tensor
    cores and keeps each query's top `rerank_k` without writing the score
    block, as the JAX package's MXU product fused with `approx_min_k` does
    on the TPU (here the top-k is exact);
  * exact (`exact=True`, the BFIndex semantics): the rerank rows in full
    f32 (TF32 must be off: checked), a library product and `torch.topk`
    (the JAX package's HIGHEST einsum with an exact top_k);
  * a registered metric without a matmul form: `pair_dist` over 4096-row
    chunks of the rerank rows with a running top-k.

The exact scan never holds a score block of more than SCORE_BUDGET_BYTES:
queries go in blocks, and when one block's scores over all rows would pass
the budget, the rows go in slabs with a running top-`rerank_k` merge.  The
candidates are put in id order before the rerank, so results do not depend
on the tiling (nor on which of two equal distances a top-k met first: the
lower id wins).
"""

from __future__ import annotations

import dataclasses

import torch

from ocaml_hnsw_tpu_torch.ops.distance import INF, require_full_f32_matmul
from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import gather_dists
from ocaml_hnsw_tpu_torch.ops.kernels.scan_topk import (
    quantize_int8, scan_topk,
)
from ocaml_hnsw_tpu_torch.utils import round_up
from ocaml_hnsw_tpu_torch.utils.profiling import annotate

#: bytes of one f32 score block [query block, row slab]; the exact scan
#: holds up to two such blocks at a time (product, scores)
SCORE_BUDGET_BYTES = 4 << 30
#: queries per block once the rows go in slabs
Q_BLOCK = 1024
#: rows per chunk of the registry-metric scan (the JAX package's)
METRIC_CHUNK = 4096

_SCAN_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}
_RERANK_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass
class FlatTensors:
    """Flat index state.  scan: bf16[N_cap, D] (or int8: quantized
    distances, a quarter of the f32 rows' memory) operand of the scan;
    scales: f32[N_cap] per-row dequant scales (ones for bf16); rerank: exact
    rows (f32, or bf16 where memory is short); norms: f32[N_cap] ‖x‖² (+inf
    on empty slots so padding never scores); n: 0-d int32 count; deleted:
    tombstones."""

    scan: torch.Tensor
    scales: torch.Tensor
    rerank: torch.Tensor
    norms: torch.Tensor
    n: torch.Tensor
    deleted: torch.Tensor

    @property
    def n_cap(self) -> int:
        return self.scan.shape[0]

    @property
    def device(self) -> torch.device:
        return self.scan.device


def empty_flat(dim: int, max_elements: int, scan_dtype: str = "bf16",
               rerank_dtype: str = "f32",
               device: torch.device | str = "cuda") -> FlatTensors:
    # same 4096-row capacity alignment as the JAX package, so both scan the
    # same padded shapes
    n_cap = round_up(max(max_elements, 4096), 4096)
    return FlatTensors(
        scan=torch.zeros((n_cap, dim), dtype=_SCAN_DTYPES[scan_dtype],
                         device=device),
        scales=torch.ones((n_cap,), dtype=torch.float32, device=device),
        rerank=torch.zeros((n_cap, dim), dtype=_RERANK_DTYPES[rerank_dtype],
                           device=device),
        norms=torch.full((n_cap,), INF, dtype=torch.float32, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
        deleted=torch.zeros((n_cap,), dtype=torch.bool, device=device),
    )


@torch.no_grad()
def flat_add(flat: FlatTensors, rows, start: int, count: int) -> FlatTensors:
    """Write the first `count` of `rows` at slots [start, start+count).
    Updates `flat` in place (no second copy of the index) and returns it."""
    count = max(0, min(int(count), rows.shape[0], flat.n_cap - start))
    if count == 0:
        return flat
    rows = rows[:count].float()
    sl = slice(start, start + count)
    if flat.scan.dtype == torch.int8:
        flat.scan[sl], flat.scales[sl] = quantize_int8(rows)
    else:
        flat.scan[sl] = rows.to(flat.scan.dtype)
    flat.rerank[sl] = rows.to(flat.rerank.dtype)
    flat.norms[sl] = torch.sum(rows * rows, dim=1)
    flat.n += count
    return flat


def scan_tiles(b: int, n_cap: int) -> tuple[int, int]:
    """(queries per block, rows per slab) under SCORE_BUDGET_BYTES: whole
    when it fits; else query blocks over all rows while a block of Q_BLOCK
    queries fits; else Q_BLOCK queries against slabs of rows."""
    elems = max(1, SCORE_BUDGET_BYTES // 4)
    if b * n_cap <= elems:
        return b, n_cap
    qb = min(b, Q_BLOCK)
    if qb * n_cap <= elems:
        return elems // n_cap, n_cap
    return qb, max(1, elems // qb)


def _exact_candidates(flat: FlatTensors, q, rerank_k: int, m):
    """Ids i64[B, rerank_k] of the lowest scores per query over the rerank
    rows in full f32, tombstones and empty slots masked, tiled by
    `scan_tiles`."""
    require_full_f32_matmul(q.device)
    b, n_cap = q.shape[0], flat.n_cap
    qb, slab = scan_tiles(b, n_cap)
    slab = max(slab, rerank_k)  # every slab but the last fills a top-k
    dead = flat.deleted
    if not m.needs_norms:
        # empty slots carry norms=+inf, which l2-style metrics consume; for
        # norm-free metrics mask unoccupied slots explicitly
        dead = dead | (torch.arange(n_cap, device=q.device) >= flat.n)
    out = []
    for q0 in range(0, b, qb):
        best_s = best_i = None
        for n0 in range(0, n_cap, slab):
            sl = slice(n0, min(n0 + slab, n_cap))
            dot = torch.matmul(q[q0:q0 + qb], flat.rerank[sl].float().T)
            # rank-equivalent scores from the one product (l2 drops +‖q‖²)
            scores = m.matmul_score(dot, flat.norms[None, sl])
            del dot
            scores.masked_fill_(dead[None, sl], INF)
            s, i = torch.topk(scores, min(rerank_k, scores.shape[1]), dim=1,
                              largest=False)
            del scores
            i += n0
            if best_s is not None:
                s, pick = torch.topk(torch.cat([best_s, s], dim=1), rerank_k,
                                     dim=1, largest=False)
                i = torch.gather(torch.cat([best_i, i], dim=1), 1, pick)
            best_s, best_i = s, i
        out.append(best_i)
    return out[0] if len(out) == 1 else torch.cat(out)


def _chunked_exact_candidates(flat: FlatTensors, q, rerank_k: int, m):
    """Top-rerank_k candidate ids under a registry metric that has no matmul
    form: `pair_dist` over METRIC_CHUNK-row chunks of the exact rows with a
    running top-k.  Correct for any registered metric; linear in N with no
    matrix product, so much slower than the scans."""
    b, dim = q.shape
    n_cap = flat.n_cap
    dev = q.device
    # pair_dist holds a [queries, chunk, D] block
    qb = max(1, min(b, SCORE_BUDGET_BYTES // (4 * METRIC_CHUNK * dim)))
    out = []
    for q0 in range(0, b, qb):
        qc = q[q0:q0 + qb]
        best_d = torch.full((qc.shape[0], rerank_k), INF, device=dev)
        best_i = torch.zeros((qc.shape[0], rerank_k), dtype=torch.int64,
                             device=dev)
        for n0 in range(0, n_cap, METRIC_CHUNK):
            sl = slice(n0, min(n0 + METRIC_CHUNK, n_cap))
            d = m.pair_dist(flat.rerank[sl].float()[None], qc)  # [qb, chunk]
            ids = torch.arange(sl.start, sl.stop, device=dev)
            live = (ids < flat.n) & ~flat.deleted[sl]
            d = torch.where(live[None, :], d, INF)
            cat_d = torch.cat([best_d, d], dim=1)
            cat_i = torch.cat([best_i, ids[None, :].expand(qc.shape[0], -1)],
                              dim=1)
            best_d, pick = torch.topk(cat_d, rerank_k, dim=1, largest=False)
            best_i = torch.gather(cat_i, 1, pick)
        out.append(best_i)
    return out[0] if len(out) == 1 else torch.cat(out)


@torch.no_grad()
def flat_search(flat: FlatTensors, queries, k: int, metric: str,
                rerank_k: int = 32, exact: bool = False):
    """Returns (ids i32[B, k], dists f32[B, k]) ascending, -1/+inf padded.

    exact=True scans the rerank rows in full f32 (slower; the hnswlib-parity
    BFIndex semantics).  Default: the bf16 or int8 scan, top `rerank_k`
    candidates, exact rerank (near-exact, much faster)."""
    from ocaml_hnsw_tpu_torch.models.search import preprocess_queries
    from ocaml_hnsw_tpu_torch.ops.metrics import get_metric

    m = get_metric(metric)
    rerank_k = max(k, min(rerank_k, flat.n_cap))
    with annotate("hnsw.flat.scan"):
        q = preprocess_queries(queries, metric)
        if m.matmul_score is None:
            ids = _chunked_exact_candidates(flat, q, rerank_k, m)
        elif exact:
            ids = _exact_candidates(flat, q, rerank_k, m)
        else:
            # the bf16 or int8 scan: the scan-and-select kernel (K3)
            ids = scan_topk(flat.scan, flat.scales, flat.norms, flat.deleted,
                            flat.n, q, rerank_k, metric)[1]
    with annotate("hnsw.flat.rerank"):
        ids = torch.sort(ids, dim=1).values.to(torch.int32)
        # exact rerank of the candidates (f32 rows, or bf16 rows upcast)
        # through the gather-distance kernel
        d = gather_dists(flat.rerank, flat.scales, q, ids, metric)
        # mask tombstones and unoccupied slots (zero rows would score
        # finite)
        d = torch.where(flat.deleted[ids.long()] | (ids >= flat.n), INF, d)
        # stable sort: equal distances keep the lower id
        out_d, idx = torch.sort(d, dim=1, stable=True)
        out_d = out_d[:, :k]
        out_ids = torch.gather(ids, 1, idx[:, :k])
        out_ids = torch.where(torch.isinf(out_d), -1, out_ids)
        return out_ids, out_d
