"""The classic query engine and the layer-0 entry, ported from
`ocaml_hnsw_tpu/models/search.py`: the lockstep beam (`beam_search_layer`,
with beam-only, exact-bitset and hashed-bitset dedup and `compact_k`),
`knn_search`, the seed scan (`SeedIndex`, `build_seed_index`,
`seed_entries`), greedy descent (`descend`, `_greedy_level`) and query
preprocessing.  Every candidate block is scored by `dists_to_ids`, i.e. by
the gather-distance kernel (K2) on the card.  With beam-only dedup (the
default) the rest of a beam iteration is one launch on the card: the
classic step of `ops/kernels/beam_update.py` (merge, select, expand, dedup,
compact).

The seed scan is one scan-and-select (K3, `ops/kernels/scan_topk.py`) of
the queries against every level>=1 node's bf16 vector: the bf16 product on
the tensor cores and each query's lowest E f32 scores kept on chip, no
[B, U] score block.  Then the E winners are re-scored exactly by the
gather-distance kernel.  The JAX package ranks by bf16-rounded scores with
`approx_min_k`; ties and near-ties among those may pick other seeds, so
seeded searches agree with the JAX package at recall level.

The JAX `while_loop`s become host loops.  The beam loop asks the device
whether any beam member is unexpanded only every CONVERGE_CHECK iterations:
once every member is expanded an iteration selects no node, scores no
candidate and leaves the beam as it was, so the extra iterations change
nothing, and `max_iters` still bounds the count exactly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, adj_take, upper_view,
)
from ocaml_hnsw_tpu_torch.ops.bitset import (
    bitset_new, bitset_set, bitset_test, first_occurrence_mask, hash_ids,
)
from ocaml_hnsw_tpu_torch.ops.distance import (
    INF, dists_to_ids, gather_dequant, query_norms,
)
from ocaml_hnsw_tpu_torch.ops.kernels.scan_topk import (
    launches_kernel, scan_topk,
)
from ocaml_hnsw_tpu_torch.ops.kernels.beam_update import (
    beam_step_classic, beam_update, select_unexpanded,
)
from ocaml_hnsw_tpu_torch.ops.metrics import get_metric
from ocaml_hnsw_tpu_torch.ops.sortmerge import (
    entries_to_beam, merge_into_beam, topk_ascending,
)
from ocaml_hnsw_tpu_torch.utils.profiling import annotate

#: beam loops read "any member unexpanded?" on the host every this many
#: iterations (module docstring)
CONVERGE_CHECK = 4


def _visit_idx(ids, visited_bits: int | None):
    """Index into the visited bitmap for each id (identity or hashed)."""
    if visited_bits is None:
        return ids.clamp_min(0)
    return hash_ids(ids, visited_bits)


def _greedy_level(vectors, scales, norms, adj, q, qn, cur, cur_d, enabled,
                  metric):
    """One layer of greedy ef=1 descent for B queries (Alg 5 upper loop)."""
    active = enabled
    while True:
        with annotate("hnsw.sync.greedy"):
            if not bool(torch.any(active)):
                break
        nbrs = adj_take(adj, cur.clamp_min(0))  # [B, deg]
        nbrs = torch.where(active[:, None], nbrs, -1)
        d = dists_to_ids(vectors, scales, norms, q, qn, nbrs, metric)
        bi = torch.argmin(d, dim=1, keepdim=True)
        bd = torch.gather(d, 1, bi)[:, 0]
        bid = torch.gather(nbrs, 1, bi)[:, 0]
        better = active & (bd < cur_d)
        cur = torch.where(better, bid, cur)
        cur_d = torch.where(better, bd, cur_d)
        active = better
    return cur, cur_d


@torch.no_grad()
def beam_search_layer(
    vectors,
    scales,
    norms,
    adj,  # i32[N_cap, deg] layer table, or an UpperView
    q,  # f32[B, D]
    qn,  # f32[B]
    entry_ids,  # i32[B, E0]  (-1 padded)
    entry_d,  # f32[B, E0]  (+inf at sentinel)
    ef: int,
    metric: str,
    max_iters: int | None = None,
    expand: int = 1,
    visited_bits: int | None = None,
    compact_k: int | None = None,
):
    """Beam search one layer for B queries; returns (ids, d, iters):
    i32/f32[B, ef] sorted ascending by distance (-1/+inf padded) plus the
    number of loop iterations in which some beam still had an unexpanded
    member (a 0-d device tensor, the JAX loop's count).

    visited_bits: 0 = beam-only dedup (candidates dedup against the current
    beam), None = exact bitset over N_cap, b = hashed 2^b-bit bitset.
    compact_k (beam-only dedup): pack the fresh candidates left and score
    only the first compact_k of the expand·deg slots."""
    b = q.shape[0]
    dev = q.device
    expand = max(1, min(expand, ef))
    beam_only = visited_bits == 0
    if compact_k is not None and not beam_only:
        raise ValueError(
            "compact_k requires beam-only dedup (visited_bits=0): a bitset "
            "would mark compacted-away candidates visited and never revisit"
        )
    n_bits = vectors.shape[0] if visited_bits is None else 1 << visited_bits

    # dedup entries on the visit index so the scatter-OR stays exact
    vidx = _visit_idx(entry_ids, None if beam_only else visited_bits)
    uniq = first_occurrence_mask(vidx) & (entry_ids >= 0)
    entry_ids = torch.where(uniq, entry_ids, -1)
    entry_d = torch.where(uniq, entry_d, INF)
    visited = None
    if not beam_only:
        visited = bitset_set(bitset_new(b, n_bits, dev), vidx, uniq)

    # beam state packs (id, expanded) into one int32: pk = 2·id + exp
    beam_ids, beam_d = entries_to_beam(entry_ids, entry_d, ef)
    beam_pk = torch.where(beam_ids < 0, -1, beam_ids * 2)
    if beam_only:
        return _beam_only_loop(vectors, scales, norms, adj, q, qn, beam_pk,
                               beam_d, metric, max_iters, expand, compact_k)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while max_iters is None or it < max_iters:
        live = torch.any((beam_pk & 1) == 0)
        if it % CONVERGE_CHECK == 0:
            with annotate("hnsw.sync.converge"):
                if not bool(live):
                    break
        iters += live.to(torch.int32)
        # 1. the E nearest unexpanded members
        beam_pk, nodes = select_unexpanded(beam_pk, expand)
        # 2. frontier expansion: adjacency gather
        nbrs = adj_take(adj, nodes.clamp_min(0))  # [B, E, deg]
        nbrs = torch.where((nodes >= 0)[:, :, None], nbrs, -1).reshape(b, -1)
        # 3. visited filter + mark on the visit index
        ok = nbrs >= 0
        nvidx = _visit_idx(nbrs, visited_bits)
        fresh = (ok & ~bitset_test(visited, nvidx, ok)
                 & first_occurrence_mask(torch.where(ok, nvidx, -1)))
        visited = bitset_set(visited, nvidx, fresh)
        cand_ids = torch.where(fresh, nbrs, -1)
        # 4. distance block (K2), 5. bitonic merge into the beam
        cand_d = dists_to_ids(vectors, scales, norms, q, qn, cand_ids, metric)
        cand_pk = torch.where(cand_ids < 0, -1, cand_ids * 2)
        beam_d, (beam_pk,) = merge_into_beam(
            beam_d, [(beam_pk, -1)], cand_d, [(cand_pk, -1)], ef)
        it += 1
    return beam_pk >> 1, beam_d, iters


def _beam_only_loop(vectors, scales, norms, adj, q, qn, beam_pk, beam_d,
                    metric: str, max_iters: int | None, expand: int,
                    compact_k: int | None):
    """The beam-only loop, two launches an iteration: the classic step
    (`beam_step_classic`: merge the last scored block, select, expand,
    dedup against the beam, compact) and K2 on its block; after the last
    K2, one merge-only `beam_update`.  Each step sets its flag in `live`
    when some beam had an unexpanded member after the merge, so the flags
    sum to the eager loop's `iters`, and the convergence check reads one
    flag.  The step that finds every beam expanded selects nothing and
    leaves an all -1 block, so the loop ends on its merged beam."""
    dev = beam_pk.device
    live = torch.zeros((max_iters or 64,), dtype=torch.int32, device=dev)
    cand_ids = cand_d = None
    it = 0
    while max_iters is None or it < max_iters:
        if it == live.shape[0]:  # max_iters None: the flags grow
            live = torch.cat([live, torch.zeros_like(live)])
        beam_pk, beam_d, block = beam_step_classic(
            beam_pk, beam_d, cand_ids, cand_d, adj, live[it], expand=expand,
            compact_k=compact_k)
        if it % CONVERGE_CHECK == 0:
            with annotate("hnsw.sync.converge"):
                if not bool(live[it]):
                    cand_ids = None
                    break
        cand_ids = block
        cand_d = dists_to_ids(vectors, scales, norms, q, qn, cand_ids, metric)
        it += 1
    if cand_ids is not None:
        beam_pk, beam_d, _ = beam_update(beam_pk, beam_d, cand_ids, cand_d,
                                         expand=expand, select_next=False)
    return beam_pk >> 1, beam_d, live[:it].sum(dtype=torch.int32)


@dataclasses.dataclass
class SeedIndex:
    """Coarse entry-point index: a dense copy of every level>=1 node's vector,
    held as the operands of K3's scan (`scan_topk`), made once.

    ids:    i32[U_cap]     global node id per row (padding repeats a real row)
    vecs:   bf16[U_cap, D] that node's stored vector (dequantized, bf16)
    norms:  f32[U_cap]     ||x||² for l2 scoring (zeros for ip/cosine)
    dead:   bool[U_cap]    rows never returned: padding, unfilled bank slots
    n:      i32[]          live rows, which are the first n
    scales: f32[U_cap]     K3's per-row int8 scales; its bf16 scan reads none
    """

    ids: torch.Tensor
    vecs: torch.Tensor
    norms: torch.Tensor
    dead: torch.Tensor
    n: torch.Tensor
    scales: torch.Tensor


def _seed_index(ids, vecs, live, metric: str) -> SeedIndex:
    """SeedIndex of rows `ids` with f32 `vecs`, the rows where `live` holds
    (a prefix) returnable."""
    u_cap = ids.shape[0]
    if get_metric(metric).needs_norms:
        norms = torch.sum(vecs * vecs, dim=1)
    else:
        norms = torch.zeros((u_cap,), dtype=torch.float32, device=ids.device)
    return SeedIndex(ids=ids, vecs=vecs.to(torch.bfloat16), norms=norms,
                     dead=~live, n=live.sum(dtype=torch.int32),
                     scales=torch.ones((u_cap,), dtype=torch.float32,
                                       device=ids.device))


@torch.no_grad()
def build_seed_index(graph: GraphTensors, metric: str,
                     cap: int | None = None) -> SeedIndex | None:
    """Extract the level>=1 node set from a built graph.  Returns None when
    the graph has no upper nodes.  cap: serve the scan from at most `cap`
    rows — highest levels first, the level-1 remainder subsampled evenly
    (the same selection as the JAX package)."""
    with annotate("hnsw.sync.seed_levels"):
        lv = graph.levels.cpu().numpy()
    upper = np.nonzero(lv >= 1)[0].astype(np.int32)
    if upper.size == 0:
        return None
    if cap is not None and upper.size > cap:
        order = np.argsort(-lv[upper], kind="stable")
        ranked = upper[order]
        hi = ranked[lv[ranked] >= 2]
        lo = ranked[lv[ranked] == 1]
        take = max(0, cap - hi.size)
        if take and lo.size:
            idx = np.linspace(0, lo.size - 1, take).astype(np.int64)
            lo = lo[idx]
        else:
            lo = lo[:take]
        upper = np.sort(np.concatenate([hi, lo]).astype(np.int32))
    u_cap = max(128, 1 << int(math.ceil(math.log2(upper.size))))
    pad = np.full(u_cap, upper[0], np.int32)
    pad[: upper.size] = upper
    ids = torch.from_numpy(pad).to(graph.device)
    vecs = gather_dequant(graph.vectors, graph.scales, ids[None, :])[0]
    # the padding repeats a real row: dead, or l2 would score it
    live = torch.arange(u_cap, device=ids.device) < upper.size
    return _seed_index(ids, vecs, live, metric)


def seed_index_from_bank(graph: GraphTensors, bank, n_live,
                         metric: str) -> SeedIndex:
    """SeedIndex view of a build-time seed bank (i32[U_cap] ids, -1 past
    the live count `n_live`), on the graph's device: the sharded engine's
    entry, where each shard keeps its own bank.  Slots past `n_live` are
    dead."""
    safe = bank.clamp_min(0)
    vecs = gather_dequant(graph.vectors, graph.scales, safe[None, :])[0]
    live = torch.arange(bank.shape[0], device=bank.device) < n_live
    return _seed_index(safe, vecs, live, metric)


def seed_entries(graph: GraphTensors, seeds: SeedIndex, q, qn, e: int,
                 metric: str):
    """Top-E upper-layer nodes per query: one scan-and-select over the seed
    rows (`scan_topk`: K3 on the card, its plain version on the CPU and
    for registry metrics), then an exact re-score of the E winners (K2).
    Returns (ids i32[B, E], d f32[B, E]), -1 / +inf where fewer than E
    rows are live.  `seed_entries.kernel_scans` and `.plain_scans` count
    the calls each of K3's routes served."""
    if get_metric(metric).matmul_score is None:
        raise ValueError(
            f"metric {metric!r} has no matmul_score; seed-scan entry needs "
            "one — pass seeds=None to use greedy descent"
        )
    _, ii = scan_topk(seeds.vecs, seeds.scales, seeds.norms, seeds.dead,
                      seeds.n, q, e, metric)
    if launches_kernel(seeds.vecs, metric):
        seed_entries.kernel_scans += 1
    else:
        seed_entries.plain_scans += 1
    # K3 gives -1 past the live rows; its plain version, dead rows at +inf
    safe = ii.clamp_min(0)
    live = (ii >= 0) & ~seeds.dead[safe]
    sids = torch.where(live, seeds.ids[safe], -1).to(torch.int32)
    sd = dists_to_ids(graph.vectors, graph.scales, graph.norms, q, qn, sids,
                      metric)
    return sids, sd


seed_entries.kernel_scans = 0  # seed scans K3 launched for
seed_entries.plain_scans = 0  # seed scans its plain version served


def descend(graph: GraphTensors, q, qn, metric: str, stop_level: int = 0):
    """Greedy descent from the top layer down to stop_level+1 (Alg 5 upper
    part).  Returns (cur, cur_d): the per-query entry point for layer
    `stop_level`; layers above the live max_level are masked out."""
    b = q.shape[0]
    cur = graph.entry.expand(b).to(torch.int32)
    cur_d = dists_to_ids(graph.vectors, graph.scales, graph.norms, q, qn,
                         cur[:, None], metric)[:, 0]
    for li in range(graph.l_max, stop_level, -1):
        enabled = (graph.max_level >= li).expand(b)
        cur, cur_d = _greedy_level(
            graph.vectors, graph.scales, graph.norms, upper_view(graph, li),
            q, qn, cur, cur_d, enabled, metric,
        )
    return cur, cur_d


@torch.no_grad()
def knn_search(
    graph: GraphTensors,
    queries,  # f32[B, D]
    k: int,
    ef: int,
    metric: str,
    max_iters: int | None = None,
    expand: int | None = None,
    visited_bits: int | None = None,
    seeds: SeedIndex | None = None,
    seed_e: int = 16,
    compact_k: int | None = None,
):
    """Full Alg 5 on the classic engine: entry into layer 0 (greedy descent,
    or the seed scan when `seeds` is given), then an ef-wide beam; returns
    (ids i32[B, k], dists f32[B, k]) ascending, -1/+inf padded, tombstoned
    nodes traversed but filtered.  Defaults as in the JAX package: expand 4,
    beam-only dedup, and max_iters=None capped at max(64, 8·ef/expand) so
    tie churn terminates."""
    ef = max(ef, k)
    if expand is None:
        expand = 4
    if visited_bits is None:
        visited_bits = 0  # beam-only dedup: the same trajectory, faster
    if max_iters is None:
        max_iters = max(64, (8 * ef) // max(1, expand))
    if seeds is not None and get_metric(metric).matmul_score is None:
        seeds = None  # registry metric without a matmul form: descent
    with annotate("hnsw.classic.seed"):
        q = preprocess_queries(queries, metric)
        qn = query_norms(q, metric)
        if seeds is not None:
            entry_ids, entry_d = seed_entries(graph, seeds, q, qn, seed_e,
                                              metric)
        else:
            cur, cur_d = descend(graph, q, qn, metric, stop_level=0)
            entry_ids, entry_d = cur[:, None], cur_d[:, None]
    with annotate("hnsw.classic.beam"):
        ids, d, _ = beam_search_layer(
            graph.vectors, graph.scales, graph.norms, graph.adj0, q, qn,
            entry_ids, entry_d, ef, metric, max_iters, expand=expand,
            visited_bits=visited_bits, compact_k=compact_k,
        )
    with annotate("hnsw.classic.final"):
        # tombstone filter, then the final top-k (masking reorders the beam)
        dead = graph.deleted[ids.clamp_min(0).long()] | (ids < 0)
        d = torch.where(dead, INF, d)
        out_d, out_ids = topk_ascending(d, torch.where(dead, -1, ids), k)
        out_ids = torch.where(torch.isinf(out_d), -1, out_ids)
    return out_ids, out_d


def preprocess_queries(q, metric: str):
    """Match the oracle's query prep (e.g. cosine normalizes at query time)."""
    q = q.float()
    if get_metric(metric).normalize_query:
        q = normalize_rows(q)
    return q


def normalize_rows(x):
    """x / ‖x‖ per row (zero rows stay zero), ‖x‖ = sqrt(Σ x²) as the JAX
    package's jnp.linalg.norm computes it."""
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.where(n == 0, 1.0, n)
