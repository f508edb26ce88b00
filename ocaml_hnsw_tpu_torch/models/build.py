"""Index construction, ported from `ocaml_hnsw_tpu/models/build.py`.

Construction runs as rounds of R simultaneous inserts against the pre-round
graph: greedy descent above each point's level, an ef_construction beam per
layer (the classic engine's `beam_search_layer`, or the packed engine's beam
at layer 0 of a large index), the Alg-4 select, and deterministic edge
application (`apply_edges`).  Levels come from the same NumPy stream as the
JAX package and the oracle, and the round schedule (doubling up to
`round_size`) is the JAX package's, so a build visits the same rounds.  A
first add that fills most of an empty index goes to `models/bulk.py`.

What changes against the JAX package, and why the results do not:

- The host knows every round's levels and the graph's max level, so the
  `fori_loop`s over levels are Python loops over the levels that hold
  points, and `jnp.nonzero(size=...)` is a device sort of slot keys; no
  device scalar is read to drive a round.
- Reverse-edge slots: the JAX package ranks duplicate targets with an
  [R·G, R·G] comparison block per group of columns.  The rank is the number
  of earlier entries with the same target in column-major order, which one
  stable sort computes (`_dup_rank`); kept (target, slot) pairs are unique,
  so a plain scatter places them.
- Rows that several new points touch compute the same merged row; only the
  first copy is scattered (the others go to the all -1 sink), so the write
  is deterministic by construction.
- The seed bank's append slots are computed on the host.
- Packed builds quantize the round's new rows onto the payload grid as
  `pack_graph` does (x·(1/s)) for the payload by-product, so the maintained
  payload equals a fresh `pack_graph(..., with_dist=True)` byte for byte.
  (The JAX package reuses the beam's query rounding x/s there, which
  differs at rare half-way points.)
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, UpperView, adj_take, capacity, empty_graph,
)
from ocaml_hnsw_tpu_torch.models.search import beam_search_layer, _greedy_level
from ocaml_hnsw_tpu_torch.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu_torch.ops.distance import (
    INF, dists_to_ids, gather_dequant, pairwise_dists, query_norms,
)
from ocaml_hnsw_tpu_torch.ops.metrics import get_metric
from ocaml_hnsw_tpu_torch.ops.quantize import quantize_rows
from ocaml_hnsw_tpu_torch.ops.sortmerge import bitonic_sort, next_pow2
from ocaml_hnsw_tpu_torch.utils import round_up
from ocaml_hnsw_tpu_torch.utils.profiling import annotate


def upper_round_width(r: int, m: int, level: int) -> int:
    """Static row capacity of the upper-level connect stage: level 1 gets 2x
    the binomial expectation r/M (floor 128), levels >= 2 4x r/M^level
    (floor 64), rounded up to a power of two and capped at r.  BuildState
    raises if a sampled round ever exceeds it."""
    if level <= 1:
        want = max(128, (2 * r) // m)
    else:
        want = max(64, (4 * r) // (m ** level))
    p = 1
    while p < want:
        p *= 2
    return min(p, r)


def seed_capacity(n_cap: int, m: int) -> int:
    """Capacity of the build-time seed bank (ids of level>=1 nodes): 3x the
    expected n/M, a power of two, capped at n_cap."""
    want = max(128, (3 * n_cap) // max(m, 2))
    p = 1
    while p < want:
        p *= 2
    return min(p, round_up(n_cap, 128))


# --------------------------------------------------------------------- levels
def sample_levels(rng: np.random.RandomState, n: int, m_l: float, cap: int):
    """level = ⌊−ln(U(0,1))·mL⌋ (Alg 1), same RNG stream as the oracle."""
    u = rng.uniform(size=n)
    return np.minimum((-np.log(1.0 - u) * m_l).astype(np.int32), cap)


# ------------------------------------------------------- heuristic (Alg 4)
def heuristic_admit(cand_d, pair_d, valid, m: int, keep_pruned: bool,
                    scan_limit: int | None = None):
    """Vectorized SELECT-NEIGHBORS-HEURISTIC admit loop.

    cand_d: f32[B, K] distances to the query point, sorted ascending.
    pair_d: f32[B, Ke, Ke] pairwise distances among the first Ke candidates.
    Admit candidate j iff it is strictly closer to the query than to every
    already-admitted candidate, in sequential candidate order.  scan_limit
    caps the candidate rank eligible for admission; the keep_pruned backfill
    still sees all K candidates.  Returns bool[B, K]."""
    b, k = cand_d.shape
    ke = pair_d.shape[1]
    depth = ke if scan_limit is None else min(ke, scan_limit)
    sel = torch.zeros((b, ke), dtype=torch.bool, device=cand_d.device)
    cnt = torch.zeros((b,), dtype=torch.int32, device=cand_d.device)
    for j in range(depth):
        dmin = torch.amin(torch.where(sel, pair_d[:, j, :], INF), dim=1)
        admit = valid[:, j] & (cnt < m) & (cand_d[:, j] < dmin)
        sel[:, j] = admit
        cnt += admit.to(torch.int32)
    if ke < k:
        sel = torch.nn.functional.pad(sel, (0, k - ke))
    if keep_pruned:  # Alg 4 keepPrunedConnections: backfill nearest rejected
        free = m - cnt
        rej = valid & ~sel
        rank = torch.cumsum(rej.to(torch.int32), dim=1)
        sel = sel | (rej & (rank <= free[:, None]))
    return sel


def compact_by_mask(ids, d, mask, m: int):
    """Pack masked entries left (stable) and truncate/pad to width m.

    The JAX package runs this as a bitonic network keyed by column index;
    the keys of kept entries are distinct, so any stable compaction gives
    the same result, and a stable sort is one launch instead of ~28 stages."""
    k = ids.shape[1]
    key = torch.where(mask, torch.arange(k, device=ids.device)[None, :], k + 1)
    order = torch.sort(key, dim=1, stable=True).indices
    w = min(m, k)
    order = order[:, :w]
    ok = torch.gather(mask, 1, order)
    out_ids = torch.where(ok, torch.gather(ids, 1, order), -1)
    out_d = torch.where(ok, torch.gather(d, 1, order), INF)
    if m > k:
        out_ids = torch.nn.functional.pad(out_ids, (0, m - k), value=-1)
        out_d = torch.nn.functional.pad(out_d, (0, m - k), value=INF)
    return out_ids, out_d


def select_neighbors(vectors, scales, norms, w_ids, w_d, m: int, metric: str,
                     keep_pruned: bool, heuristic: bool = True,
                     scan_limit: int | None = None):
    """Neighbor selection over beam results (sorted ascending): Alg 4
    diversity pruning (default) or Alg 3 plain nearest-M (heuristic=False).
    scan_limit: only the first `scan_limit` candidates are eligible for
    admission, so only they are gathered and paired (the keep_pruned
    backfill reads w_d alone).  Returns ids/d [B, m]."""
    valid = w_ids >= 0
    if not heuristic:  # Alg 3: the beam is distance-ascending already
        return compact_by_mask(w_ids, w_d, valid, m)
    k = w_ids.shape[1]
    ke = k if scan_limit is None else min(k, scan_limit)
    ids_e = w_ids[:, :ke]
    cvec = gather_dequant(vectors, scales, ids_e)
    cnorm = norms[ids_e.clamp_min(0).long()]
    pair = pairwise_dists(cvec, cnorm, metric)
    del cvec
    sel = heuristic_admit(w_d, pair, valid, m, keep_pruned,
                          scan_limit=scan_limit)
    return compact_by_mask(w_ids, w_d, sel, m)


def extend_candidates(vectors, scales, norms, adj_l, q, qn, w_ids, w_d,
                      ef_l: int, metric: str):
    """Alg 4's extendCandidates, batched: widen the pool with the beam
    members' own neighbours at this layer, keep the nearest ef_l distinct.
    The JAX package's `lax.top_k` puts the lower index first among equal
    distances; a stable ascending sort does the same."""
    r = w_ids.shape[0]
    nb = adj_take(adj_l, w_ids.clamp_min(0))  # [R, ef_l, deg]
    nb = torch.where((w_ids >= 0)[:, :, None], nb, -1).reshape(r, -1)
    all_ids = torch.cat([w_ids, nb], dim=1)
    d_all = dists_to_ids(vectors, scales, norms, q, qn, all_ids, metric)
    kk = min(2 * ef_l, all_ids.shape[1])
    idx = torch.sort(d_all, dim=1, stable=True).indices[:, :kk]
    t_ids = torch.gather(all_ids, 1, idx)
    t_d = torch.gather(d_all, 1, idx)
    uniq = first_occurrence_mask(t_ids) & (t_ids >= 0)
    return compact_by_mask(t_ids, t_d, uniq, ef_l)


# ------------------------------------------------------------- edge updates
def _dup_rank(x):
    """For each position of a 1-D tensor, the number of earlier positions
    holding the same value (0 = first occurrence)."""
    n = x.shape[0]
    order = torch.sort(x, stable=True).indices
    s = x[order]
    idx = torch.arange(n, device=x.device)
    is_start = torch.ones(n, dtype=torch.bool, device=x.device)
    is_start[1:] = s[1:] != s[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start
    return rank


def apply_edges(
    adj,  # i32[N_cap, m_cap] dense layer-0 table, OR an UpperView
    vectors,
    scales,
    norms,
    p_ids,  # i32[R] new point ids (unique)
    sel_ids,  # i32[R, M] chosen neighbours (-1 padded)
    sel_d,  # f32[R, M]
    mask,  # bool[R] point participates at this layer
    m_cap: int,
    rev_cap: int,
    metric: str,
    keep_pruned: bool,
    heuristic: bool = True,
    pack_dist=None,  # f32[N_rows, m_cap] stored d(node, neighbour) per slot
    packed_ctx=None,  # (pay, meta, scale, y8, y8n, start) — see below
):
    """Forward + reverse edge application with deterministic conflict
    handling, in place on the layer's table.

    Reverse edges targeting the same row get slots in column-major order
    (columns of sel_ids are distance-ascending, so nearest first), capped at
    rev_cap per round, then merge into the row: plain append when it fits,
    heuristic re-prune (Alg 1's shrink) when over-full.  The table's last
    row is the all -1 sink that masked writes land on.

    pack_dist (packed builds): old slots' distances are read from it and
    the new reverse edges' carried through the slot scatter (d(e, p) =
    sel_d), instead of re-gathering vectors.  packed_ctx (packed builds):
    (pay, meta, scale, y8, y8n, start) with y8/y8n the round's rows on the
    payload grid and their int32 norms; the shrink's pairwise block is then
    computed from int8 rows (exact in f32), and the affected rows' new
    payload comes out as a by-product.

    Returns the table, or (table, (dst, ids, d, pay8, norms8)) with
    packed_ctx: the payload rows to scatter, duplicates routed to the sink
    with sentinel values."""
    r, m = sel_ids.shape
    is_view = isinstance(adj, UpperView)
    table = adj.table if is_view else adj
    n_rows = table.shape[0]
    sink = n_rows - 1
    dev = table.device

    def rows_of(ids, valid):
        safe = ids.clamp_min(0).long()
        rows = adj.rows_of(safe) if is_view else safe
        return torch.where(valid, rows, sink).long()

    # ---- forward rows (unique p_ids ⇒ conflict-free scatter)
    p_rows = rows_of(p_ids, mask)
    fwd = torch.nn.functional.pad(sel_ids, (0, m_cap - m), value=-1)
    table[p_rows] = torch.where(mask[:, None], fwd, table[p_rows])

    # ---- reverse pairs (e ← p): slot = rank among entries with the same
    # target row in column-major order
    pair_valid = mask[:, None] & (sel_ids >= 0)
    e_rows = rows_of(sel_ids, pair_valid)  # [R, M], sink on invalid
    er = e_rows.T.reshape(-1)
    live = er != sink
    pos = _dup_rank(er)
    keep = live & (pos < rev_cap)
    srow = torch.where(keep, er, sink)
    spos = torch.where(keep, pos, 0)
    rev = torch.full((n_rows, rev_cap), -1, dtype=torch.int32, device=dev)
    rev[srow, spos] = torch.where(keep, p_ids.repeat(m), -1)
    carry_d = pack_dist is not None
    if carry_d:  # d(e ← p) = d(p → e) = sel_d (metrics are symmetric)
        rev_d = torch.full((n_rows, rev_cap), INF, device=dev)
        rev_d[srow, spos] = torch.where(keep, sel_d.T.reshape(-1), INF)

    # ---- affected target rows (with duplicates; sink on invalid)
    aff = e_rows.reshape(-1)
    old = table[aff]  # [A, m_cap]
    new_ps = rev[aff]  # [A, rev_cap]
    combined = torch.cat([old, new_ps], dim=1)  # [A, K2]
    cvalid = combined >= 0
    overflow = torch.sum(cvalid, dim=1) > m_cap
    if carry_d:
        dcomb = torch.cat([pack_dist[aff], rev_d[aff]], dim=1)
        dcomb = torch.where(cvalid, dcomb, INF)
    else:
        e_ids = torch.where(pair_valid, sel_ids, 0).reshape(-1)
        evec = gather_dequant(vectors, scales, e_ids[:, None])[:, 0, :]
        dcomb = dists_to_ids(vectors, scales, norms, evec, None,
                             torch.where(cvalid, combined, -1), metric)
        del evec
    app_ids, app_d = compact_by_mask(combined, dcomb, cvalid, m_cap)

    a_rows, k2 = combined.shape
    if packed_ctx is not None:
        pay, pmeta, pscale, y8q, y8n, start = packed_ctx
        deg_full = pmeta.shape[1] // 2
        old8 = pay[aff]  # [A, deg, d_pad]: the row's own payload
        old_n = pmeta[aff][:, deg_full:]  # int32 ‖x8‖² per old slot
        q_rows = (new_ps - start).clamp(0, y8q.shape[0] - 1).long()
        y8 = torch.cat([old8, y8q[q_rows]], dim=1)  # [A, K2, d_pad]
        yn = torch.cat([old_n, y8n[q_rows]], dim=1)  # int32[A, K2]

    # ---- shrink path: re-prune over old ∪ new sorted by distance (the
    # bitonic network, for the JAX package's tie order); the combined
    # position rides along to permute the int8 block
    p2 = next_pow2(k2)
    sd_in = torch.where(cvalid, dcomb, INF)
    pos_in = torch.arange(k2, dtype=torch.int32, device=dev).expand(a_rows, k2)
    pad = p2 - k2
    sc_d, (sc_ids, sc_pos) = bitonic_sort(
        torch.nn.functional.pad(sd_in, (0, pad), value=INF),
        [torch.nn.functional.pad(combined, (0, pad), value=-1),
         torch.nn.functional.pad(pos_in, (0, pad), value=0)])
    sc_d, sc_ids, sc_pos = sc_d[:, :k2], sc_ids[:, :k2], sc_pos[:, :k2]
    sc_valid = sc_ids >= 0
    if heuristic and packed_ctx is not None:
        d_pad = y8.shape[2]
        y8s = torch.gather(y8, 1, sc_pos[:, :, None].long().expand(-1, -1, d_pad))
        yns = torch.gather(yn, 1, sc_pos.long()).float()
        y8f = y8s.float()
        # int8 products summed in f32 are exact integers (< 2^24 for
        # d_pad <= 1024), as the JAX package's bf16 products are
        dot = torch.matmul(y8f, y8f.transpose(1, 2))
        del y8f, y8s
        s2 = pscale * pscale
        if get_metric(metric).needs_norms:
            pair2 = torch.clamp_min(
                s2 * (yns[:, :, None] - 2.0 * dot + yns[:, None, :]), 0.0)
        else:
            pair2 = 1.0 - s2 * dot
        sel2 = heuristic_admit(sc_d, pair2, sc_valid, m_cap, keep_pruned)
    elif heuristic:
        svec = gather_dequant(vectors, scales, sc_ids)
        snorm = norms[sc_ids.clamp_min(0).long()]
        pair2 = pairwise_dists(svec, snorm, metric)
        del svec
        sel2 = heuristic_admit(sc_d, pair2, sc_valid, m_cap, keep_pruned)
    else:
        sel2 = sc_valid
    heur_ids, heur_d = compact_by_mask(sc_ids, sc_d, sel2, m_cap)

    new_rows = torch.where(overflow[:, None], heur_ids, app_ids)
    # each distinct row is written once (its first copy); the rest, and the
    # sink's own entries, write -1 into the sink
    first = (_dup_rank(aff) == 0) & (aff != sink)
    dst = torch.where(first, aff, sink)
    table[dst] = torch.where(first[:, None], new_rows, -1)
    if packed_ctx is None:
        return table

    # payload by-product: each output slot's int8 row / norm is a
    # permutation of y8/yn (valid ids are unique within a row, so the
    # first matching position is exact).  Empty slots hold node 0's row,
    # as pack_graph fills them, and dist +inf.
    from ocaml_hnsw_tpu_torch.models.packed import quantize_payload_rows

    new_d = torch.where(overflow[:, None], heur_d, app_d)
    eq = new_rows[:, :, None] == torch.where(cvalid, combined, -2)[:, None, :]
    src = torch.argmax(eq.to(torch.uint8), dim=2)  # [A, m_cap]
    d_pad = y8.shape[2]
    row_pay8 = torch.gather(y8, 1, src[:, :, None].expand(-1, -1, d_pad))
    row_norms = torch.gather(yn, 1, src)
    pad8, padn = quantize_payload_rows(
        gather_dequant(vectors, scales, torch.zeros((1, 1), dtype=torch.int64,
                                                    device=dev))[0], pscale)
    empty = new_rows < 0
    row_pay8 = torch.where(empty[:, :, None], pad8, row_pay8)
    row_norms = torch.where(empty, padn, row_norms)
    f2 = first[:, None]
    return table, (dst,
                   torch.where(f2, new_rows, -1),
                   torch.where(f2, new_d, INF),
                   torch.where(f2[:, :, None], row_pay8, 0),
                   torch.where(f2, row_norms, 0))


# ------------------------------------------------------------- seed bank
@dataclasses.dataclass
class SeedBank:
    """Build-time seed-scan state: ids of level>=1 nodes (i32[U_cap], -1
    past `n`), their stored vectors dequantized to bf16 (the scan's
    precision; winners are re-scored exactly) and ‖x‖² (zeros for
    ip/cosine).  `n` is the live count, kept on the host."""

    ids: torch.Tensor
    vecs: torch.Tensor
    norms: torch.Tensor
    n: int = 0

    @classmethod
    def empty(cls, cap: int, dim: int, device) -> "SeedBank":
        return cls(
            ids=torch.full((cap,), -1, dtype=torch.int32, device=device),
            vecs=torch.zeros((cap, dim), dtype=torch.bfloat16, device=device),
            norms=torch.zeros((cap,), dtype=torch.float32, device=device),
        )

    def append(self, ids, vecs, norms) -> None:
        """Append rows while capacity lasts (the rest are dropped: they
        only stop seeding entries; add() warns once)."""
        keep = min(ids.shape[0], self.ids.shape[0] - self.n)
        sl = slice(self.n, self.n + keep)
        self.ids[sl] = ids[:keep]
        self.vecs[sl] = vecs[:keep]
        self.norms[sl] = norms[:keep]
        self.n += keep


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A small host array onto the device without waiting for queued work
    (pageable memory is staged at once)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


# ------------------------------------------------------------- insert round
@torch.no_grad()
def insert_round(
    graph: GraphTensors,
    new_vecs,  # f32[R, D] on the graph's device (already metric-prepped)
    new_levels,  # i32[R] host array: levels of the rows (0 past count)
    start: int,  # first slot id for this round (== graph.n)
    count: int,  # how many of the R rows are real
    max_level: int,  # host mirror of graph.max_level
    bank: SeedBank | None = None,
    packed=None,  # PackedGraph with dist: the build-maintained payload
    *,
    efc: int,
    m: int,
    m_max0: int,
    rev_cap: int,
    metric: str,
    keep_pruned: bool,
    storage: str = "f32",
    efc_upper: int | None = None,
    seed_e: int = 16,
    build_mi: int | None = None,
    build_ck: int | None = None,
    build_expand: int = 4,
    extend: bool = False,
    heuristic: bool = True,
    select_scan: int | None = None,
) -> int:
    """One batched insertion round (Alg 1 for R points against the
    pre-round graph), in place on `graph`, `bank` and `packed`; returns the
    new max level.

    With a seed bank, layer<=1 beams start from the top-seed_e upper-layer
    nodes per point (a bf16 scan of the bank, exact re-score of the
    winners) instead of the greedy-descent position.  With `packed`, the
    level-0 beam runs on the inline-int8 payload (K1), its W set is
    re-scored exactly (K2) and re-sorted, and the payload rows whose
    adjacency changed are refreshed.  select_scan caps the level-0 Alg-4
    admit scan at that many candidates (`select_neighbors`' scan_limit)."""
    r = new_vecs.shape[0]
    dev = graph.device
    sink0 = graph.n_cap - 1
    if efc_upper is None:
        efc_upper = min(efc, max(2 * m, 32))
    lv_host = np.asarray(new_levels, dtype=np.int32)
    valid_host = np.arange(r) < count
    cs_host = np.minimum(lv_host, max_level)  # first connect layer
    have_seeds = bank is not None and bank.n > 0
    needs_norms = get_metric(metric).needs_norms

    p_ids = start + torch.arange(r, dtype=torch.int32, device=dev)
    pidx = p_ids.long()
    valid = torch.arange(r, device=dev) < count
    lv = _upload(lv_host, dev)
    cs = torch.clamp(lv, max=max_level)

    with annotate("hnsw.build.place"):
        # place vectors / norms / levels (the slots are unoccupied), then
        # allocate the arena: a level-L point owns L consecutive rows from
        # up_base (exclusive prefix sum over the round)
        q = new_vecs.float()
        qn = query_norms(q, metric)
        qrows, qscales, qnorms_store = quantize_rows(q, storage)
        vectors, scales, norms = graph.vectors, graph.scales, graph.norms
        vectors[pidx] = torch.where(valid[:, None], qrows, vectors[pidx])
        scales[pidx] = torch.where(valid, qscales, scales[pidx])
        norms_store = qnorms_store if needs_norms \
            else torch.zeros_like(qnorms_store)
        norms[pidx] = torch.where(valid, norms_store, norms[pidx])
        graph.levels[pidx] = torch.where(valid, lv, -1)

        rows_needed = torch.where(valid, lv, 0)
        base = graph.up_n + torch.cumsum(rows_needed, 0, dtype=torch.int32) \
            - rows_needed
        graph.up_base[pidx] = torch.where(valid & (lv >= 1), base, -1)
        graph.up_n = graph.up_n + int(np.where(valid_host, lv_host, 0).sum())

    with annotate("hnsw.build.entry"):
        # ---- seed scan over the pre-round bank (layer<=1 entries)
        s_ids = s_d = None
        if have_seeds:
            u_cap = bank.ids.shape[0]
            # bf16 operands, exact products, f32 sums (TF32 off)
            dot = torch.matmul(q.to(torch.bfloat16).float(),
                               bank.vecs.float().T)
            mm = get_metric(metric).matmul_score
            if mm is not None:
                scores = mm(dot, bank.norms[None, :])
            else:
                scores = get_metric(metric).pair_dist(
                    bank.vecs.float()[None], q)
            del dot
            live = torch.arange(u_cap, device=dev) < bank.n
            scores = torch.where(live[None, :], scores, INF)
            # rank by bf16 scores (winners re-scored exactly below)
            ii = torch.topk(scores.to(torch.bfloat16), seed_e, dim=1,
                            largest=False).indices
            del scores
            s_ids = torch.where(live[ii], bank.ids.clamp_min(0)[ii], -1)
            s_d = dists_to_ids(vectors, scales, norms, q, qn, s_ids, metric)

        # ---- greedy descent, for the levels above each point's first
        # connect layer (points entering by the seed scan skip it)
        cur = graph.entry.expand(r).to(torch.int32)
        cur_d = dists_to_ids(vectors, scales, norms, q, qn, cur[:, None],
                             metric)[:, 0]
        need_host = (cs_host >= 2) | (not have_seeds)
        need = (cs >= 2) | (not have_seeds)
        for li in range(max_level, 0, -1):
            if not (valid_host & (li > cs_host) & need_host).any():
                continue
            view = UpperView(table=graph.adj_up, up_base=graph.up_base,
                             levels=graph.levels, level=li)
            cur, cur_d = _greedy_level(vectors, scales, norms, view, q, qn,
                                       cur, cur_d, valid & (li > cs) & need,
                                       metric)

    def first_entries(cur_v, cur_dv, sids_v, sdv, width, at_seed_level):
        """Entry block for a point's first connect layer: the descent
        position, or the seed-scan top-E at layers <= 1."""
        n = cur_v.shape[0]
        if have_seeds and at_seed_level:
            ids, d = sids_v, sdv
        else:
            ids, d = cur_v[:, None], cur_dv[:, None]
        pad = width - ids.shape[1]
        return (torch.nn.functional.pad(ids, (0, pad), value=-1),
                torch.nn.functional.pad(d, (0, pad), value=INF))

    ep_ids = torch.full((r, efc_upper), -1, dtype=torch.int32, device=dev)
    ep_d = torch.full((r, efc_upper), INF, device=dev)
    ar = torch.arange(r, dtype=torch.int32, device=dev)

    def up_stage(level: int, width: int):
        nonlocal ep_ids, ep_d
        # the rows of points at this level, padded to `width` with r
        key = torch.where(valid & (cs >= level), ar, r)
        idx = torch.sort(key).values[:width]
        on = idx < r
        safe_idx = idx.clamp(max=r - 1).long()
        q_l, qn_l = q[safe_idx], qn[safe_idx]
        f_ids, f_d = first_entries(
            cur[safe_idx], cur_d[safe_idx],
            s_ids[safe_idx] if have_seeds else None,
            s_d[safe_idx] if have_seeds else None, efc_upper, level <= 1)
        seeding = (cs[safe_idx] == level)[:, None]
        entry_ids = torch.where(seeding, f_ids, ep_ids[safe_idx])
        entry_d = torch.where(seeding, f_d, ep_d[safe_idx])
        entry_ids = torch.where(on[:, None], entry_ids, -1)
        entry_d = torch.where(on[:, None], entry_d, INF)
        adj_l = UpperView(table=graph.adj_up, up_base=graph.up_base,
                          levels=graph.levels, level=level)
        w_ids, w_d, _ = beam_search_layer(
            vectors, scales, norms, adj_l, q_l, qn_l, entry_ids, entry_d,
            efc_upper, metric, expand=4, visited_bits=0)
        # W is the next-lower layer's entry set for these points; fill rows
        # scatter into a dump row (index r)
        dump = torch.where(on, safe_idx, r)
        ep_ids = torch.nn.functional.pad(ep_ids, (0, 0, 0, 1))
        ep_d = torch.nn.functional.pad(ep_d, (0, 0, 0, 1))
        ep_ids[dump] = w_ids
        ep_d[dump] = w_d
        ep_ids, ep_d = ep_ids[:r], ep_d[:r]
        if extend:
            c_ids, c_d = extend_candidates(vectors, scales, norms, adj_l, q_l,
                                           qn_l, w_ids, w_d, efc_upper, metric)
        else:
            c_ids, c_d = w_ids, w_d
        sel_ids, sel_d = select_neighbors(
            vectors, scales, norms, c_ids, c_d, m, metric, keep_pruned,
            heuristic=heuristic)
        apply_edges(adj_l, vectors, scales, norms, p_ids[safe_idx], sel_ids,
                    sel_d, on, m, rev_cap, metric, keep_pruned,
                    heuristic=heuristic)

    # ---- upper-level connect: levels round_top..2 at the narrow width,
    # then level 1 at its own (a level no point reaches changes nothing)
    round_top = int(cs_host[valid_host].max()) if count else 0
    for level in range(round_top, 0, -1):
        with annotate("hnsw.build.upper"):
            up_stage(level, upper_round_width(r, m, min(level, 2)))

    with annotate("hnsw.build.beam"):
        # ---- level 0: full-width connect for every valid point
        seeding = (cs == 0)[:, None]
        f_ids, f_d = first_entries(cur, cur_d, s_ids, s_d, efc_upper, True)
        entry_ids = torch.where(seeding, f_ids, ep_ids)
        entry_d = torch.where(seeding, f_d, ep_d)
        entry_ids = torch.where(valid[:, None], entry_ids, -1)
        entry_d = torch.where(valid[:, None], entry_d, INF)
        adj0 = graph.adj0
        if packed is not None:
            # packed construction beam (K1 per iteration); the W set is
            # then exactly re-scored (K2) and re-sorted so selection and
            # apply_edges see true f32 distances
            from ocaml_hnsw_tpu_torch.models.packed import (
                beam_search_layer_packed, quantize_queries,
            )

            q8 = quantize_queries(q, packed.scale)
            if packed.d_pad > q8.shape[1]:
                q8 = torch.nn.functional.pad(
                    q8, (0, packed.d_pad - q8.shape[1]))
            mi_eff = build_mi if build_mi is not None \
                else 2 * efc // build_expand
            w_ids, _, _ = beam_search_layer_packed(
                packed, q8, qn, entry_ids, entry_d, efc,
                needs_norms=needs_norms, max_iters=mi_eff,
                expand=build_expand)
            w_d = dists_to_ids(vectors, scales, norms, q, qn, w_ids, metric)
            p2 = next_pow2(efc)
            w_d, (w_ids,) = bitonic_sort(
                torch.nn.functional.pad(w_d, (0, p2 - efc), value=INF),
                [torch.nn.functional.pad(w_ids, (0, p2 - efc), value=-1)])
            w_d, w_ids = w_d[:, :efc], w_ids[:, :efc]
        else:
            w_ids, w_d, _ = beam_search_layer(
                vectors, scales, norms, adj0, q, qn, entry_ids, entry_d, efc,
                metric, expand=build_expand, visited_bits=0,
                max_iters=build_mi, compact_k=build_ck)

    with annotate("hnsw.build.select"):
        if extend:
            c_ids, c_d = extend_candidates(vectors, scales, norms, adj0, q, qn,
                                           w_ids, w_d, efc, metric)
        else:
            c_ids, c_d = w_ids, w_d
        sel_ids, sel_d = select_neighbors(
            vectors, scales, norms, c_ids, c_d, m, metric, keep_pruned,
            heuristic=heuristic, scan_limit=select_scan)

    with annotate("hnsw.build.edges"):
        if packed is not None:
            from ocaml_hnsw_tpu_torch.models.packed import (
                quantize_payload_rows, refresh_payload_rows,
            )

            # the round's stored rows on the payload grid, as pack_graph
            # rounds them
            own = gather_dequant(vectors, scales, pidx[:, None])[:, 0]
            y8q, y8n = quantize_payload_rows(own, packed.scale)
            _, (dst, ids_new, d_new, pay8, nrm8) = apply_edges(
                adj0, vectors, scales, norms, p_ids, sel_ids, sel_d, valid,
                m_max0, rev_cap, metric, keep_pruned, heuristic=heuristic,
                pack_dist=packed.dist,
                packed_ctx=(packed.pay, packed.meta, packed.scale, y8q, y8n,
                            start))
            packed.pay[dst] = pay8
            packed.meta[dst] = torch.cat([ids_new, nrm8], dim=1)
            packed.dist[dst] = d_new
            # the R forward rows, the classic way (their neighbours are
            # arbitrary graph nodes)
            refresh_payload_rows(packed, vectors, scales, adj0,
                                 torch.where(valid, p_ids, sink0),
                                 metric=metric)
        else:
            apply_edges(adj0, vectors, scales, norms, p_ids, sel_ids, sel_d,
                        valid, m_max0, rev_cap, metric, keep_pruned,
                        heuristic=heuristic)

        # ---- entry point / max level (first max ⇒ sequential tie order)
        lv_valid = np.where(valid_host, lv_host, -1)
        best = int(lv_valid.max()) if r else -1
        if best > max_level:
            graph.entry.fill_(start + int(np.argmax(lv_valid)))
            graph.max_level.fill_(best)
            max_level = best
        graph.n += count

        # ---- append this round's new upper nodes to the seed bank
        if bank is not None:
            up = np.nonzero(valid_host & (lv_host >= 1))[0]
            if up.size:
                rows = _upload(up.astype(np.int64), dev)
                deq = (qrows[rows].float() * qscales[rows][:, None]).to(
                    torch.bfloat16)
                bank.append(p_ids[rows], deq, norms_store[rows])
    return max_level


# ---------------------------------------------------------------- bootstrap
@torch.no_grad()
def bootstrap(graph: GraphTensors, vec, level: int, metric: str,
              storage: str = "f32") -> None:
    """Insert the very first point (no search needed — empty graph), in
    place."""
    q = vec.float()[None, :]
    qrows, qscales, qnorms = quantize_rows(q, storage)
    if not get_metric(metric).needs_norms:
        qnorms = torch.zeros_like(qnorms)
    graph.vectors[0] = qrows[0]
    graph.scales[0] = qscales[0]
    graph.norms[0] = qnorms[0]
    graph.levels[0] = level
    graph.up_base[0] = 0 if level >= 1 else -1
    graph.up_n.fill_(level)
    graph.entry.fill_(0)
    graph.max_level.fill_(level)
    graph.n.fill_(1)


# ---------------------------------------------------------------- BuildState
class BuildState:
    """Host-side build state: owns the RNG stream (level sampling is the
    only randomness), the doubling round schedule, the seed bank and, on
    large indexes, the build-maintained payload."""

    # first add() of at least this many rows into an EMPTY index takes the
    # bulk constructor (models/bulk.py); the same policy as the JAX package
    BULK_THRESHOLD = 100_000
    #: transient-workspace budget for the bulk passes (the JAX package's
    #: value, whose formula `bulk_workspace_bytes` is shared)
    BULK_BUDGET_BYTES = 8 << 30
    #: packed construction switches on at this index capacity ...
    PACKED_BUILD_THRESHOLD = 100_000
    #: ... and only while the payload fits this many bytes
    PACKED_BUILD_BUDGET_BYTES = 6 << 30

    def __init__(self, config: HnswConfig, max_elements: int,
                 round_size: int = 1024,
                 device: torch.device | str = "cuda"):
        self.config = config
        self.round_size = round_size
        self.device = torch.device(device)
        # headroom as in the JAX package: one padded round may run past
        # max_elements, and the last row is the scatter sink
        self.max_elements = max_elements
        self.graph = empty_graph(config, max_elements + round_size + 1,
                                 self.device)
        self.l_max = self.graph.l_max
        self.rng = np.random.RandomState(config.seed)
        # reverse-edge candidates kept per target row per round
        self.rev_cap = 8
        self.bank = SeedBank.empty(seed_capacity(self.graph.n_cap, config.M),
                                   config.dim, self.device)
        # host mirrors: the round loop never reads a device scalar
        self.host_n = 0
        self.host_max_level = -1
        self.host_upper_count = 0
        self.host_up_n = 0
        # packed construction: None = undecided, False = decided off
        self.packed = None
        self._packed_build: bool | None = None
        self._pack_covered: float | None = None  # range the scale covers
        # level-0 build-beam knobs, the JAX package's public attributes and
        # defaults: the iteration cap and expansion width ("auto" resolves
        # per path in _round_kwargs), the candidate compaction (3/4 of the
        # 4·M_max0 ids a step expands, once those reach 128), the Alg-4
        # admit-scan cap (None: the whole beam) and the opt-out of the bulk
        # first add (False keeps incremental rounds for any first add)
        self.build_mi: int | str | None = "auto"
        self.build_expand: int | str = "auto"
        self.build_ck: int | None = (
            (3 * 4 * config.M_max0) // 4 if 4 * config.M_max0 >= 128 else None
        )
        self.select_scan: int | None = None
        self.bulk_first_add: bool = True
        self._warned_seed_drop = False

    def _bulk_eligible(self, n_new: int) -> bool:
        cfg = self.config
        if not self.bulk_first_add:
            return False
        if self.host_n or n_new < self.BULK_THRESHOLD:
            return False
        # bulk passes run at index capacity: a sparse first add would pay
        # ~capacity/n_new extra compute
        if 2 * n_new < self.max_elements:
            return False
        if cfg.select != "heuristic" or cfg.extend_candidates:
            return False
        from ocaml_hnsw_tpu_torch.models.bulk import bulk_workspace_bytes

        n_cap = capacity(self.max_elements + self.round_size + 1)
        need = bulk_workspace_bytes(n_cap, cfg.dim, m=cfg.M,
                                    m_max0=cfg.M_max0)
        return need < self.BULK_BUDGET_BYTES

    @torch.no_grad()
    def adopt_graph(self, graph: GraphTensors) -> None:
        """Take over an existing graph (bulk build, load_index, resize):
        rebuild every host mirror and the seed bank (ids of all level>=1
        nodes with their bf16 rows and norms), and drop any build payload
        (it mirrors the old adjacency; the next add re-decides)."""
        self.graph = graph
        self.packed = None
        self._packed_build = None
        self._pack_covered = None
        with annotate("hnsw.sync.adopt_n"):
            n = int(graph.n)
        with annotate("hnsw.sync.adopt_levels"):
            lv = graph.levels[:n].cpu().numpy()
        self.host_n = n
        self.host_max_level = int(lv.max()) if n else -1
        upper = np.nonzero(lv >= 1)[0]
        self.host_upper_count = int(upper.size)
        with annotate("hnsw.sync.adopt_up_n"):
            self.host_up_n = int(graph.up_n)
        cap = self.bank.ids.shape[0]
        self.bank = SeedBank.empty(cap, self.config.dim, self.device)
        if upper.size:
            ids = _upload(upper.astype(np.int32), self.device)
            vecs = gather_dequant(graph.vectors, graph.scales, ids[None, :])[0]
            if get_metric(self.config.metric).needs_norms:
                nrm = torch.sum(vecs * vecs, dim=1)
            else:
                nrm = torch.zeros_like(vecs[:, 0])
            self.bank.append(ids, vecs.to(torch.bfloat16), nrm)

    def prep(self, data):
        """Normalize at add time (cosine-style metrics).  A bf16 tensor
        stays bf16, as the JAX package normalizes a device-resident source
        in its own dtype (`_normalize_rows_donated`): the rows quantized
        into the graph are the bf16-rounded unit rows."""
        normalize = get_metric(self.config.metric).normalize_add
        if isinstance(data, torch.Tensor):
            if normalize:
                from ocaml_hnsw_tpu_torch.models.search import normalize_rows

                unit = normalize_rows(data.float())
                data = (unit.to(torch.bfloat16)
                        if data.dtype == torch.bfloat16 else unit)
            return data
        data = np.asarray(data, dtype=np.float32)
        if normalize:
            nrm = np.linalg.norm(data, axis=1, keepdims=True)
            data = data / np.where(nrm == 0, 1.0, nrm)
        return data

    # ------------------------------------------------ packed-build upkeep
    def _maybe_init_packed(self, data) -> None:
        """Decide once, on the first incremental add: keep a payload when
        the index is large, the metric has a matmul form and the payload
        fits the budget.  Later adds grow the scale when a batch exceeds
        the range it covers (one repack)."""
        from ocaml_hnsw_tpu_torch.models.packed import (
            empty_packed, pack_d_pad, pack_graph,
        )

        if self._packed_build is not None:
            if self.packed is not None:
                self._grow_scale_if_needed(float(torch.amax(torch.abs(data))))
            return
        cfg = self.config
        g = self.graph
        deg = g.adj0.shape[1]
        fits = (g.n_cap * deg * pack_d_pad(cfg.dim)
                <= self.PACKED_BUILD_BUDGET_BYTES)
        on = (g.n_cap >= self.PACKED_BUILD_THRESHOLD and fits
              and get_metric(cfg.metric).matmul_score is not None)
        self._packed_build = on
        if not on:
            return
        if self.host_n == 0:
            scale = torch.clamp_min(torch.amax(torch.abs(data)) / 127.0,
                                    1e-30)
            self.packed = empty_packed(g.n_cap, deg, cfg.dim, scale,
                                       self.device)
            return
        # adopted graph: pack what exists, on a grid covering this batch
        mx = float(torch.amax(torch.abs(data)))
        pk = pack_graph(g, cfg.metric, with_dist=True)
        cov = float(pk.scale)
        if mx / 127.0 > cov:
            pk = pack_graph(g, cfg.metric, scale=mx / 127.0, with_dist=True)
            cov = mx / 127.0
        self._pack_covered = cov * 127.0
        self.packed = pk

    def _grow_scale_if_needed(self, mx: float) -> None:
        if self.packed is None:
            return
        if self._pack_covered is None:
            self._pack_covered = float(self.packed.scale) * 127.0
        if mx <= self._pack_covered:
            return
        from ocaml_hnsw_tpu_torch.models.packed import pack_graph

        self.packed = pack_graph(self.graph, self.config.metric,
                                 scale=mx / 127.0, with_dist=True)
        self._pack_covered = mx

    def packed_graph(self):
        """The build-maintained payload (a PackedGraph with dist), or None:
        what pack_graph(graph, with_dist=True) would give, for free."""
        return self.packed

    def _round_kwargs(self) -> dict:
        """insert_round's knobs, from the public attributes.  "auto" is the
        JAX package's per-path value: the level-0 beam's iteration cap and
        expansion width are 24 / 8 on the packed build, 48 / 4 on the
        classic one."""
        cfg = self.config
        packed = bool(self._packed_build)
        build_mi = self.build_mi
        build_expand = self.build_expand
        if build_mi == "auto":
            build_mi = 24 if packed else 48
        if build_expand == "auto":
            build_expand = 8 if packed else 4
        return dict(
            efc=cfg.ef_construction,
            m=cfg.M,
            m_max0=cfg.M_max0,
            rev_cap=self.rev_cap,
            metric=cfg.metric,
            keep_pruned=cfg.keep_pruned_connections,
            storage=cfg.storage,
            build_mi=build_mi,
            build_ck=self.build_ck,
            build_expand=build_expand,
            extend=cfg.extend_candidates,
            heuristic=cfg.select == "heuristic",
            select_scan=self.select_scan,
        )

    def schedule(self, levels: np.ndarray, done: int) -> list:
        """Round list [(offset, count)] for inserting rows done.. of an add:
        doubling (a round never inserts more points than the pre-round graph
        holds) up to round_size, each round checked against the upper
        stages' widths."""
        cfg = self.config
        rs = self.round_size
        w_1 = upper_round_width(rs, cfg.M, 1)
        w_2 = upper_round_width(rs, cfg.M, 2)
        rounds = []
        n_cur = self.host_n
        n_new = levels.shape[0]
        while done < n_new:
            count = min(rs, n_new - done, max(n_cur, 1))
            lv_r = levels[done:done + count]
            c_1 = int((lv_r >= 1).sum())
            c_2 = int((lv_r >= 2).sum())
            if c_1 > w_1 or c_2 > w_2:
                raise RuntimeError(
                    f"round has {c_1} points at level>=1 / {c_2} at "
                    f"level>=2, packed widths {w_1}/{w_2} — astronomically "
                    f"unlikely at default mL; raise upper_round_width's "
                    f"margin if hit"
                )
            rounds.append((done, count))
            n_cur += count
            done += count
        return rounds

    @torch.no_grad()
    def add(self, data) -> None:
        """Insert `data` (host numpy or a tensor): the bulk constructor for
        a first add that fills most of an empty index, else padded rounds
        of `insert_round`."""
        cfg = self.config
        rs = self.round_size
        n_new = data.shape[0]
        if self.host_n + n_new > self.max_elements:
            raise RuntimeError(
                f"index is full: {self.host_n} + {n_new} > "
                f"max_elements {self.max_elements}"
            )
        data = self.prep(data)
        levels = sample_levels(self.rng, n_new, cfg.mL, self.l_max)
        if self._bulk_eligible(n_new):
            # levels come from THIS state's stream, so the stream position
            # after the call matches the incremental path
            from ocaml_hnsw_tpu_torch.models.bulk import bulk_build

            graph = bulk_build(
                data, cfg, max_elements=self.max_elements + rs + 1,
                levels=levels, device=self.device,
            )
            self.adopt_graph(graph)
            return
        # arena-capacity pre-check, exact (the last arena row is the sink)
        need = self.host_up_n + int(levels.sum())
        if need > self.graph.t_cap - 1:
            raise RuntimeError(
                f"upper-arena overflow: need {need} rows, capacity "
                f"{self.graph.t_cap - 1} — astronomically unlikely at "
                f"default mL; raise arena_capacity's margin if hit"
            )
        if n_new == 0:
            return
        self.host_up_n = need
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        data = data.to(self.device, torch.float32)  # one copy per add
        self._maybe_init_packed(data)
        done = 0
        if self.host_n == 0:
            lvl0 = int(levels[0])
            bootstrap(self.graph, data[0], lvl0, cfg.metric,
                      storage=cfg.storage)
            if lvl0 >= 1:
                g0 = self.graph
                v0 = g0.vectors[:1].float() * g0.scales[:1, None]
                self.bank.append(torch.zeros(1, dtype=torch.int32,
                                             device=self.device),
                                 v0.to(torch.bfloat16), g0.norms[:1])
                self.host_upper_count = 1
            self.host_max_level = lvl0
            self.host_n = 1
            done = 1
        rounds = self.schedule(levels, done)
        kw = self._round_kwargs()
        ar = torch.arange(rs, device=self.device)
        for d, count in rounds:
            with annotate("hnsw.build.round"):
                vecs = data[(d + ar).clamp(max=n_new - 1)]
                lv = np.zeros(rs, np.int32)
                lv[:count] = levels[d:d + count]
                self.host_max_level = insert_round(
                    self.graph, vecs, lv, self.host_n, count,
                    self.host_max_level, self.bank, self.packed, **kw)
            self.host_n += count
        if rounds:
            tail = levels[rounds[0][0]:]
            self.host_upper_count += int((tail >= 1).sum())
            cap = self.bank.ids.shape[0]
            if self.host_upper_count > cap and not self._warned_seed_drop:
                warnings.warn(
                    f"seed bank full: {self.host_upper_count} upper nodes > "
                    f"capacity {cap}; newest upper nodes won't seed entry "
                    "scans (recall may need slightly higher ef)",
                    RuntimeWarning, stacklevel=2,
                )
                self._warned_seed_drop = True



def build(data, config: HnswConfig, max_elements: int | None = None,
          round_size: int = 1024,
          device: torch.device | str = "cuda") -> GraphTensors:
    """Build a full index over `data` (host array or tensor) with one
    `BuildState.add` on `device`, and return its graph."""
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data, dtype=np.float32)
    state = BuildState(config, max_elements or data.shape[0],
                       round_size=round_size, device=device)
    state.add(data)
    return state.graph
