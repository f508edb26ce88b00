"""Bulk graph construction, ported from `ocaml_hnsw_tpu/models/bulk.py`: build
the whole layered graph from the complete dataset in a few full-dataset
passes instead of insert rounds.

  1. exact-rerank kNN of every node through the flat scan (`knn_table`);
  2. Alg-4 heuristic selection of M forward edges from each node's kNN
     (`_select_rounds`);
  3. reverse edges by one stable sort over all edges (`reverse_scatter`);
  4. per-node union of forward and reverse edges, heuristic shrink only on
     over-full rows (`_merge_rounds`);
  5. upper layers ℓ = 1..L: the same passes on the level-ℓ node subset
     (`_upper_level`), written into the compact arena.

Same level stream, same passes and the same tie order as the JAX package,
so from the same kNN table both produce the same adjacency.  Slab and batch
sizes bound the transient memory of each pass; they do not change results.
"""

from __future__ import annotations

import contextlib
import logging
import time

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models.build import (
    compact_by_mask, heuristic_admit, sample_levels,
)
from ocaml_hnsw_tpu_torch.models.flat import empty_flat, flat_add, flat_search
from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, arena_capacity, capacity,
)
from ocaml_hnsw_tpu_torch.models.search import normalize_rows
from ocaml_hnsw_tpu_torch.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu_torch.ops.distance import (
    INF, gather_dequant, pairwise_dists,
)
from ocaml_hnsw_tpu_torch.ops.sortmerge import bitonic_sort, next_pow2
from ocaml_hnsw_tpu_torch.utils import round_up
from ocaml_hnsw_tpu_torch.utils.profiling import annotate

log = logging.getLogger(__name__)

#: rows per slab of the select/merge passes: bounds the [slab, K, D]
#: candidate gather and the [slab, K, K] pairwise block (1 GB and 0.5 GB of
#: f32 at K=64, D=128)
SLAB_ROWS = 32768


def bulk_workspace_bytes(n_cap: int, dim: int, m: int, m_max0: int,
                         knn_k: int = 64) -> int:
    """The JAX package's estimate of the bulk passes' transient workspace
    beyond the graph tensors, which `BuildState._bulk_eligible` compares
    with BULK_BUDGET_BYTES (the same formula, so both packages take the bulk
    path for the same adds)."""
    d_pad = round_up(dim, 128)
    rev_cap = m_max0 + m
    per_row = (
        d_pad * (4 + 2 + 4)
        + knn_k * 8
        + m * 8
        + rev_cap * 8
        + m * 12 * 2
    )
    return n_cap * per_row


# --------------------------------------------------------------- flat loader
#: rows one flat_add call takes while a flat is loaded for the kNN passes
FLAT_CHUNK = 262144


def _load_flat(flat, rows, n: int, chunk: int):
    """Write rows [0, n) into `flat`, `chunk` rows per flat_add call (each
    call makes its own f32 copy of the rows it quantizes)."""
    chunk = max(1, min(chunk, flat.n_cap))
    for i in range(0, n, chunk):
        flat_add(flat, rows[i:i + chunk], i, min(chunk, n - i))
    return flat


def flat_from_rows(rows, metric: str, scan_dtype: str = "bf16",
                   n_valid=None, chunk: int = FLAT_CHUNK):
    """Rows -> FlatTensors for the kNN passes (rerank rows f32, cosine rows
    normalized).  `rows` may carry padding; n_valid caps the occupied count.
    scan_dtype: the flat engine's scan ("bf16", or "int8": the exact int8
    dot of per-row quantized operands); `chunk` bounds the rows one
    flat_add call quantizes."""
    from ocaml_hnsw_tpu_torch.ops.metrics import get_metric

    n = int(rows.shape[0]) if n_valid is None else int(n_valid)
    if get_metric(metric).normalize_add:
        rows = normalize_rows(rows.float())
    flat = empty_flat(rows.shape[1], max(int(rows.shape[0]), n, 1),
                      scan_dtype=scan_dtype, device=rows.device)
    return _load_flat(flat, rows, n, chunk)


# ------------------------------------------------------------------ base kNN
def knn_table(flat, rows, k: int, metric: str, batch: int = 8192,
              rerank_pad: int = 32):
    """Top-k neighbor ids+dists of every row against the flat index, self
    excluded: (ids i32[n_rows, k], d f32[n_rows, k]) ascending.  Each batch
    asks for k+1 (k+1+rerank_pad candidates before the exact rerank) and
    drops the self column.  Each row's candidates are exact per row, so the
    table does not depend on `batch`."""
    n_rows = rows.shape[0]
    dev = rows.device
    ids_out = torch.full((n_rows, k), -1, dtype=torch.int32, device=dev)
    d_out = torch.full((n_rows, k), INF, dtype=torch.float32, device=dev)
    for start in range(0, n_rows, batch):
        q = rows[start:start + batch].float()
        ids, d = flat_search(flat, q, k=k + 1, metric=metric,
                             rerank_k=k + 1 + rerank_pad)
        own = start + torch.arange(q.shape[0], dtype=torch.int32, device=dev)
        not_self = ids != own[:, None]
        ids2, d2 = compact_by_mask(ids, d, not_self & (ids >= 0), k)
        ids_out[start:start + batch] = ids2
        d_out[start:start + batch] = d2
    return ids_out, d_out


# ------------------------------------------------------ forward selection
def _select_rounds(vectors, scales, norms, cand_ids, cand_d, m: int,
                   metric: str, slab: int, keep_pruned: bool):
    """Alg-4 heuristic selection of m forward edges per node from its
    (ascending) candidate list, slab by slab.  Returns (ids i32[n_rows, m],
    d f32[n_rows, m])."""
    n_rows = cand_ids.shape[0]
    dev = cand_ids.device
    out = torch.full((n_rows, m), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((n_rows, m), INF, dtype=torch.float32, device=dev)
    for start in range(0, n_rows, slab):
        ids = cand_ids[start:start + slab]
        d = cand_d[start:start + slab]
        valid = ids >= 0
        cvec = gather_dequant(vectors, scales, ids)
        cnorm = norms[ids.clamp_min(0).long()]
        pair = pairwise_dists(cvec, cnorm, metric)
        del cvec
        sel = heuristic_admit(d, pair, valid, m, keep_pruned)
        out[start:start + slab], out_d[start:start + slab] = compact_by_mask(
            ids, d, sel & valid, m)
    return out, out_d


# ------------------------------------------------------- reverse scatter
def reverse_scatter(fwd_ids, fwd_d, n_rows: int, rev_cap: int):
    """Deterministic capped reverse-edge table from forward edges.

    fwd_ids i32[R, M] (-1 padded), fwd_d f32[R, M].  Returns (rev i32[n_rows,
    rev_cap], rev_d f32) where row u collects the sources v with u ∈ fwd[v],
    ascending by edge distance; capped drops shed the farthest incoming edges.

    The JAX package sorts all R·M edges by the key (target, distance, source);
    two stable sorts give the same order — by distance, then by target —
    because the edges start in ascending source order.  The in-run rank is
    (position − run start) via a cummax, and the kept (target, rank) pairs
    are unique, so one plain scatter places them."""
    r, m = fwd_ids.shape
    e = r * m
    dev = fwd_ids.device
    tgt = fwd_ids.reshape(e)
    d = fwd_d.reshape(e)
    src = torch.arange(r, dtype=torch.int32, device=dev).repeat_interleave(m)
    live = tgt >= 0
    sink = n_rows  # dead edges sort to the sink row, dropped at the end
    tgt = torch.where(live, tgt, sink)
    d = torch.where(live, d, INF)
    order = torch.sort(d, stable=True).indices
    order = order[torch.sort(tgt[order], stable=True).indices]
    st, sd, ss = tgt[order], d[order], src[order]
    idx = torch.arange(e, device=dev)
    is_start = torch.ones(e, dtype=torch.bool, device=dev)
    is_start[1:] = st[1:] != st[:-1]
    run_start = torch.where(is_start, idx, 0)
    rank = idx - torch.cummax(run_start, dim=0).values
    keep = (st < n_rows) & (rank < rev_cap)
    rev = torch.full((n_rows, rev_cap), -1, dtype=torch.int32, device=dev)
    rev_d = torch.full((n_rows, rev_cap), INF, dtype=torch.float32,
                       device=dev)
    row, col = st[keep].long(), rank[keep]
    rev[row, col] = ss[keep]
    rev_d[row, col] = sd[keep]
    return rev, rev_d


# ------------------------------------------------------------ shrink merge
def _merge_rounds(vectors, scales, norms, fwd_ids, fwd_d, rev, rev_d,
                  m_cap: int, metric: str, slab: int, keep_pruned: bool):
    """Final per-node rows: forward edges ∪ incoming reverse edges, with
    sequential Alg 1 semantics: reverse edges APPEND while the row fits
    m_cap; only over-full rows get the heuristic shrink re-prune."""
    n_rows = fwd_ids.shape[0]
    k2 = fwd_ids.shape[1] + rev.shape[1]
    p2 = next_pow2(k2)
    out = torch.full((n_rows, m_cap), -1, dtype=torch.int32,
                     device=fwd_ids.device)
    for start in range(0, n_rows, slab):
        sl = slice(start, start + slab)
        ids = torch.cat([fwd_ids[sl], rev[sl]], dim=1)
        d = torch.cat([fwd_d[sl], rev_d[sl]], dim=1)
        valid = (ids >= 0) & first_occurrence_mask(ids)
        d = torch.where(valid, d, INF)
        ids = torch.where(valid, ids, -1)
        overflow = torch.sum(valid, dim=1) > m_cap
        # append path: forward slots first, then reverse, packed left
        app_ids, _ = compact_by_mask(ids, d, valid, m_cap)
        # shrink path: Alg 4 over the distance-sorted union (the bitonic
        # network, so equal distances keep the JAX package's order)
        ds = torch.nn.functional.pad(d, (0, p2 - k2), value=INF)
        idss = torch.nn.functional.pad(ids, (0, p2 - k2), value=-1)
        sd, (sids,) = bitonic_sort(ds, [idss])
        svalid = torch.isfinite(sd)
        cvec = gather_dequant(vectors, scales, sids)
        cnorm = norms[sids.clamp_min(0).long()]
        pair = pairwise_dists(cvec, cnorm, metric)
        del cvec
        sel = heuristic_admit(sd, pair, svalid, m_cap, keep_pruned,
                              scan_limit=k2)
        heur_ids, _ = compact_by_mask(sids, sd, sel & svalid, m_cap)
        out[sl] = torch.where(overflow[:, None], heur_ids, app_ids)
    return out


# ------------------------------------------------------------- upper level
def _upper_level(dataf, vectors, scales, norms, row_ids, n_sub: int, *,
                 cap: int, m: int, m_max: int, metric: str,
                 keep_pruned: bool, scan_dtype: str, knn_k: int, batch: int):
    """One upper layer over its node subset: flat load, kNN, Alg-4 select,
    reverse scatter, shrink merge.  row_ids i32[cap] holds the subset's
    global ids, -1 padded; returns the layer's rows i32[cap, m_max] in
    row_ids order."""
    n_cap = vectors.shape[0]
    dim = dataf.shape[1]
    dev = dataf.device
    pad_row = row_ids < 0
    safe = row_ids.clamp_min(0).long()
    # dataf arrives normalized (cosine-style metrics), so rows are used as-is
    rows = torch.where(pad_row[:, None], 0.0, dataf[safe])
    flat = _load_flat(empty_flat(dim, cap, scan_dtype=scan_dtype, device=dev),
                      rows, n_sub, FLAT_CHUNK)
    # kNN of every bucket row (self excluded)
    kk = max(1, min(knn_k, cap - 1 - 32))
    knn_ids, knn_d = knn_table(flat, rows, kk, metric,
                               batch=min(batch, 4096, cap))
    del flat
    g_knn = torch.where((knn_ids >= 0) & ~pad_row[:, None],
                        row_ids[knn_ids.clamp_min(0).long()], -1)
    knn_ld = torch.where(g_knn >= 0, knn_d, INF)
    slab = min(SLAB_ROWS, cap)
    fwd_u, fwd_ud = _select_rounds(vectors, scales, norms, g_knn, knn_ld, m,
                                   metric, slab, keep_pruned)
    # global -> subset-local ids (real rows only; every edge targets one)
    inv = torch.full((n_cap,), -1, dtype=torch.int32, device=dev)
    real = ~pad_row
    inv[safe[real]] = torch.arange(cap, dtype=torch.int32, device=dev)[real]
    l_fwd = torch.where(fwd_u >= 0, inv[fwd_u.clamp_min(0).long()], -1)
    rev_u, rev_ud = reverse_scatter(l_fwd, fwd_ud, cap, m_max + m)
    g_rev = torch.where(rev_u >= 0, row_ids[rev_u.clamp_min(0).long()], -1)
    return _merge_rounds(vectors, scales, norms, fwd_u, fwd_ud, g_rev,
                         rev_ud, m_max, metric, slab, keep_pruned)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ----------------------------------------------------------------- bulk build
@torch.no_grad()
def bulk_build(
    data,
    config: HnswConfig,
    max_elements: int | None = None,
    knn_k: int = 64,
    batch: int = 8192,
    scan_dtype: str = "bf16",
    levels=None,
    verbose: bool = False,
    device: torch.device | str | None = None,
) -> GraphTensors:
    """Construct a full GraphTensors from the complete dataset (module
    docstring).  `data`: [n, dim] numpy array or tensor; `device` defaults
    to the tensor's own, and to "cuda" for a host array (raising when there
    is no CUDA device).  Deterministic for a fixed (data, config).
    `levels`: optional pre-sampled per-node levels (BuildState passes them
    from its own stream).  `scan_dtype` is the flat scan of every kNN table
    (layer 0 and each upper level): "bf16", or "int8", whose candidates are
    reranked in exact f32 (K2) as the bf16 scan's are.  `batch` is the
    queries per kNN-table batch (the JAX package's 8192; it does not change
    results).  Stage times go to this module's logger at INFO, and
    are printed with verbose=True (timed with a device sync only then).
    Each stage also runs in an `hnsw.bulk.*` span (`utils/profiling.py::
    annotate`), closed before the stage's sync (a level of one node has
    none: it only clears its row)."""
    from ocaml_hnsw_tpu_torch.ops.metrics import get_metric
    from ocaml_hnsw_tpu_torch.ops.quantize import quantize_rows

    timed = verbose or log.isEnabledFor(logging.INFO)
    t_all = t0 = time.perf_counter()

    from ocaml_hnsw_tpu_torch.api import _resolve_device

    def report(msg: str) -> None:
        log.info(msg)
        if verbose:
            print(msg, flush=True)

    @contextlib.contextmanager
    def stage(span: str, msg: str):
        """One stage: its span, closed before the sync and line that
        follow it when timed."""
        nonlocal t0
        with annotate(span):
            yield
        if timed:
            _sync(dev)
            now = time.perf_counter()
            report(f"bulk {msg}: {now - t0:.3f} s")
            t0 = now

    with annotate("hnsw.bulk.prepare"):
        if isinstance(data, torch.Tensor):
            dev = _resolve_device(device if device is not None
                                  else data.device)
            data = data.to(dev)
        else:
            dev = _resolve_device(device if device is not None else "cuda")
            data = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
        n, dim = int(data.shape[0]), int(data.shape[1])
        if dim != config.dim:
            raise ValueError(f"expected dim {config.dim}, got {dim}")
        max_elements = max_elements or n
        n_cap = capacity(max_elements)
        l_max = config.derived_max_level(max_elements)
        m, m_max, m_max0 = config.M, config.M, config.M_max0
        metric = config.metric
        keep_pruned = config.keep_pruned_connections

        # ---- levels: same formula/stream as the incremental builder
        if levels is None:
            rng = np.random.RandomState(config.seed)
            levels = sample_levels(rng, n, config.mL, l_max)
        levels_np = np.asarray(levels)
        if levels_np.shape != (n,):
            raise ValueError(f"levels must have shape ({n},)")
        max_level = int(levels_np.max(initial=0))
        entry = int(np.argmax(levels_np))  # lowest id at the top level

        # ---- storage rows (quantized per config), norms
        dataf = data.float()
        if get_metric(metric).normalize_add:
            dataf = normalize_rows(dataf)
        src = torch.zeros((n_cap, dim), dtype=torch.float32, device=dev)
        src[:n] = dataf
        vectors, scales, norms_all = quantize_rows(src, config.storage)
        del src
        norms = norms_all if get_metric(metric).needs_norms \
            else torch.zeros((n_cap,), dtype=torch.float32, device=dev)

    # ---- layer 0: kNN over everything, select, reverse, shrink
    with stage("hnsw.bulk.layer0_knn", f"layer0 kNN (k={knn_k})"):
        flat = flat_from_rows(dataf, metric, scan_dtype=scan_dtype)
        knn_ids, knn_d = knn_table(flat, dataf, knn_k, metric, batch=batch)
        del flat
        knn_ids = torch.nn.functional.pad(knn_ids, (0, 0, 0, n_cap - n),
                                          value=-1)
        knn_d = torch.nn.functional.pad(knn_d, (0, 0, 0, n_cap - n),
                                        value=INF)
    slab = min(SLAB_ROWS, n_cap)
    with stage("hnsw.bulk.layer0_select", "layer0 forward select"):
        fwd, fwd_d = _select_rounds(vectors, scales, norms, knn_ids, knn_d,
                                    m, metric, slab, keep_pruned)
        del knn_ids, knn_d
    with stage("hnsw.bulk.layer0_reverse", "layer0 reverse scatter"):
        rev, rev_d = reverse_scatter(fwd, fwd_d, n_cap, m_max0 + m)
    with stage("hnsw.bulk.layer0_merge", "layer0 shrink merge"):
        adj0 = _merge_rounds(vectors, scales, norms, fwd, fwd_d, rev, rev_d,
                             m_max0, metric, slab, keep_pruned)
        del fwd, fwd_d, rev, rev_d

    # ---- upper layers into the compact arena
    t_cap = arena_capacity(max_elements, m)
    adj_up = torch.full((t_cap, m), -1, dtype=torch.int32, device=dev)
    up_base_np = np.full((n_cap,), -1, np.int32)
    upper = np.nonzero(levels_np >= 1)[0]
    up_base_np[upper] = np.cumsum(
        np.concatenate([[0], levels_np[upper][:-1]])).astype(np.int32)
    up_n = int(levels_np[upper].sum()) if upper.size else 0
    if up_n >= t_cap:
        raise RuntimeError(f"arena overflow: {up_n} rows > capacity {t_cap}")

    for lvl in range(1, max_level + 1):
        sub = np.nonzero(levels_np >= lvl)[0].astype(np.int32)
        n_sub = sub.size
        if n_sub == 0:
            break
        arows = torch.from_numpy((up_base_np[sub] + (lvl - 1)).astype(
            np.int64)).to(dev)
        if n_sub == 1:
            adj_up[arows] = -1
            continue
        with stage("hnsw.bulk.upper", f"layer {lvl} ({n_sub} nodes)"):
            # the same power-of-two subset bucket (min 4096) as the JAX
            # package
            n_sub_cap = max(4096, next_pow2(n_sub))
            row_ids = torch.from_numpy(
                np.pad(sub, (0, n_sub_cap - n_sub),
                       constant_values=-1)).to(dev)
            adj_l = _upper_level(
                dataf, vectors, scales, norms, row_ids, n_sub,
                cap=n_sub_cap, m=m, m_max=m_max, metric=metric,
                keep_pruned=keep_pruned, scan_dtype=scan_dtype, knn_k=knn_k,
                batch=batch,
            )
            adj_up[arows] = adj_l[:n_sub]

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    g = GraphTensors(
        vectors=vectors,
        scales=scales,
        norms=norms,
        adj0=adj0,
        adj_up=adj_up,
        up_base=torch.from_numpy(up_base_np).to(dev),
        up_n=scalar(up_n),
        levels=torch.from_numpy(
            np.pad(levels_np.astype(np.int32), (0, n_cap - n),
                   constant_values=-1)).to(dev),
        entry=scalar(entry if n else -1),
        max_level=scalar(max_level if n else -1),
        n=scalar(n),
        deleted=torch.zeros((n_cap,), dtype=torch.bool, device=dev),
        l_max_static=l_max,
    )
    if timed:
        _sync(dev)
        total = time.perf_counter() - t_all
        report(f"bulk total {total:.3f} s = {n / total:.0f} vectors/s")
    return g
