"""Flat-scan index, the port of `ocaml_hnsw_tpu/models/flat.py`: one scan over
every row, the top `rerank_k` candidates, then an exact rerank of those
through the gather-distance kernel (K2) and the final top-k.

Four scans, as in the JAX package:

  * bf16 (default): the bf16-rounded operands upcast to f32 and multiplied
    (bf16×bf16 products are exact in f32), which is what the JAX package's
    bf16 dot with f32 output computes;
  * int8 (`scan_dtype="int8"`): rows and queries quantized per row, an
    exact integer dot, one f32 rescale by the outer product of the scales;
  * exact (`exact=True`, the BFIndex semantics): the rerank rows in full
    f32 (TF32 must be off: checked);
  * a registered metric without a matmul form: `pair_dist` over 4096-row
    chunks of the rerank rows with a running top-k.

The scans are library matrix products, as the JAX package leaves them to
XLA.  Its `approx_min_k` becomes exact `torch.topk`.  No scan ever holds a
score block of more than SCORE_BUDGET_BYTES: queries go in blocks, and when
one block's scores over all rows would pass the budget, the rows go in slabs
with a running top-`rerank_k` merge.  The candidates are put in id order
before the rerank, so results do not depend on the tiling (nor on which of
two equal distances a top-k met first: the lower id wins).
"""

from __future__ import annotations

import dataclasses

import torch

from ocaml_hnsw_tpu_torch.ops.distance import INF, require_full_f32_matmul
from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import gather_dists
from ocaml_hnsw_tpu_torch.utils import round_up

#: bytes of one f32 score block [query block, row slab]; a scan holds up to
#: three such blocks at a time (product, scores, the int8 scan's scale
#: block).  4 GiB keeps the kNN table's [1024, 1M] block whole.
SCORE_BUDGET_BYTES = 4 << 30
#: queries per block once the rows go in slabs
Q_BLOCK = 1024
#: rows per chunk of the registry-metric scan (the JAX package's)
METRIC_CHUNK = 4096
#: an f32 sum of products of int8 values is exact up to this many terms
#: (127² · 1040 < 2²⁴)
_EXACT_INT8_TERMS = 1040

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


def quantize_int8(rows):
    """Symmetric per-row int8 as the JAX package's compiled flat_add and
    flat_search compute it: (int8 rows, f32 scales).  The scale is amax
    times the f32 constant 1/127 (XLA folds a division by a constant into
    that product; a true division differs in the last bit of 3% of the
    scales), the rows are round(rows / scale), a true division."""
    amax = torch.amax(torch.abs(rows), dim=1)
    inv127 = float(torch.tensor(1.0) / torch.tensor(127.0))
    scale = torch.where(amax > 0, amax * inv127, 1.0)
    q = torch.clamp(torch.round(rows / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


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


def int8_dot(qi, rows):
    """Exact integer dot products of int8 queries [B, D] and int8 rows
    [N, D], as f32[B, N].  On the CPU an int32 product; on the card an f32
    product of the upcast operands, exact while every partial sum stays an
    integer below 2²⁴, so D goes in pieces of 1040 summed in int32."""
    if not qi.is_cuda:
        return torch.matmul(qi.to(torch.int32), rows.to(torch.int32).T).float()
    d = qi.shape[1]
    if d <= _EXACT_INT8_TERMS:
        return torch.matmul(qi.float(), rows.float().T)
    acc = None
    for lo in range(0, d, _EXACT_INT8_TERMS):
        hi = lo + _EXACT_INT8_TERMS
        part = torch.matmul(qi[:, lo:hi].float(),
                            rows[:, lo:hi].float().T).to(torch.int32)
        acc = part if acc is None else acc.add_(part)
    return acc.float()


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


def _scan_candidates(flat: FlatTensors, q, rerank_k: int, m, exact: bool):
    """Ids i64[B, rerank_k] of the lowest scan scores per query, tombstones
    and empty slots masked, tiled by `scan_tiles`."""
    b, n_cap = q.shape[0], flat.n_cap
    qb, slab = scan_tiles(b, n_cap)
    slab = max(slab, rerank_k)  # every slab but the last fills a top-k
    int8 = not exact and flat.scan.dtype == torch.int8
    if exact:
        require_full_f32_matmul(q.device)
        qq = q
    elif int8:
        qq, qs = quantize_int8(q)
    else:
        qq = q.to(torch.bfloat16).float()
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
            if exact:
                dot = torch.matmul(qq[q0:q0 + qb], flat.rerank[sl].float().T)
            elif int8:
                dot = int8_dot(qq[q0:q0 + qb], flat.scan[sl])
                dot *= qs[q0:q0 + qb, None] * flat.scales[None, sl]
            else:
                dot = torch.matmul(qq[q0:q0 + qb], flat.scan[sl].float().T)
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
    q = preprocess_queries(queries, metric)
    rerank_k = max(k, min(rerank_k, flat.n_cap))
    if m.matmul_score is None:
        ids = _chunked_exact_candidates(flat, q, rerank_k, m)
    else:
        ids = _scan_candidates(flat, q, rerank_k, m, exact)
    ids = torch.sort(ids, dim=1).values.to(torch.int32)
    # exact rerank of the candidates (f32 rows, or bf16 rows upcast) through
    # the gather-distance kernel
    d = gather_dists(flat.rerank, flat.scales, q, ids, metric)
    # mask tombstones and unoccupied slots (zero rows would score finite)
    d = torch.where(flat.deleted[ids.long()] | (ids >= flat.n), INF, d)
    # stable sort: equal distances keep the lower id
    out_d, idx = torch.sort(d, dim=1, stable=True)
    out_d = out_d[:, :k]
    out_ids = torch.gather(ids, 1, idx[:, :k])
    out_ids = torch.where(torch.isinf(out_d), -1, out_ids)
    return out_ids, out_d
