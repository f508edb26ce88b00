"""Packed inline-neighbor query engine, ported from
`ocaml_hnsw_tpu/models/packed.py`.

Per node, the payload stores its deg neighbours' vectors on ONE global
scale s (x8 = round(x/s)), so expanding a node reads one contiguous
[deg, d_pad] slab instead of deg scattered rows.  Queries are quantized on
the same grid, and

    d = s²·(‖x8‖² − 2·x8·q8) + ‖q‖²           (l2)
    d = 1 − s²·(x8·q8)                         (ip / cosine)

where ‖x8‖² is a precomputed exact int32.  Each beam iteration is two
launches: the gather → score of the expanded nodes' neighbours (K1,
`ops/kernels/payload_score.py`), whose bits=8 dot is exact int32 (the JAX
engine rounds each product to bf16), then the dedup against the beam, the
merge and the next iteration's select (K4, `ops/kernels/beam_update.py`).
Beam state stays in the f32 distance domain, merged by the same bitonic
networks as the JAX package, and a final exact f32 rerank (K2) makes the
returned order exact.

The JAX package's options, all served by K1:

- `bits=4`: grid ±7, two components per byte (`_nibble_pack`), so a slab
  is [deg, d_pad/2] bytes; the query rides as fractional bf16 q/s, and K1
  sums nibble × query in f32.
- `deg_limit`: score only the first slots of each node's slab (adjacency
  rows are distance-ascending).  The JAX package fetches whole chunk rows
  of W bytes, so the count rounds up to a chunk boundary (`packed_slots`);
  K1 copies that prefix of the slab.
- `fused=True`: the JAX package inlines the meta row into each chunk row;
  K1 already reads meta and slab in one pass, so the port keeps the plain
  layout and makes JAX's checks.

Layout: the JAX package stores the payload as [N_cap·C, W] chunk rows (a
TPU gather choice); this port stores the same bytes as [N_cap, deg, d_pad],
the same row-major order, so `packed_from_numpy` is a reshape.  W
(`PackedGraph.chunk_w`) travels with the pack, since `deg_limit` rounds by
it.

Build-time upkeep (`empty_packed`, `refresh_payload_rows`, `pack_graph(...,
with_dist=True)`): a build into a large index keeps the payload in step with
the adjacency round by round (models/build.py), plus `dist`, the exact f32
distance of every adjacency slot.  Those distances are computed by
`dists_to_ids` (K2 on the card) everywhere they arise, so that the
maintained table equals a fresh `pack_graph(..., with_dist=True)` bit for
bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.models.graph import GraphTensors
from ocaml_hnsw_tpu_torch.models.search import (
    SeedIndex, descend, preprocess_queries, seed_entries,
)
from ocaml_hnsw_tpu_torch.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu_torch.ops.distance import (
    INF, dists_to_ids, gather_dequant, query_norms,
)
from ocaml_hnsw_tpu_torch.ops.kernels.beam_update import beam_update
from ocaml_hnsw_tpu_torch.ops.kernels.payload_score import packed_score
from ocaml_hnsw_tpu_torch.ops.metrics import get_metric
from ocaml_hnsw_tpu_torch.ops.sortmerge import entries_to_beam, topk_ascending
from ocaml_hnsw_tpu_torch.utils import round_up
from ocaml_hnsw_tpu_torch.utils.profiling import annotate

#: node rows per slab of pack_graph (bounds the [slab, deg, D] f32 gather:
#: 1 GB at deg=32, D=128)
PACK_SLAB_ROWS = 65536
#: bytes of per-node meta in the JAX package's fused chunk rows (32 int32
#: ids + 32 int32 norms), split evenly across a node's chunk rows
FUSED_META_TOTAL = 256


def _chunk_width(total: int, max_chunk: int = 2048) -> int:
    """The JAX package's chunk width W for a node's `total` payload bytes:
    the whole row if it fits in max_chunk, else the first preferred width
    <= max_chunk that divides it, else the largest divisor <= max_chunk
    (ValueError if that is under 32)."""
    if total <= max_chunk:
        return total
    for w in (4096, 3584, 3072, 2560, 2048, 1536, 1280, 1024, 512, 256, 128):
        if w <= max_chunk and total % w == 0 and total // w >= 1:
            return w
    best = max((w for w in range(1, max_chunk + 1) if total % w == 0),
               default=None)
    if best is None or best < 32:
        raise ValueError(
            f"no payload chunk width <= {max_chunk} divides row size {total}"
        )
    return best


@dataclasses.dataclass
class PackedGraph:
    """Inline-neighbor payload tensors.

    pay:   int8[N_cap, deg, d_pad]  node i's neighbours' vectors: int8, or
                                    (bits=4) two nibbles per byte
    meta:  int32[N_cap, 2·deg]      [adjacency ids | int32 norms ‖x8‖²];
                                    ids are -1 sentinels as in adj0
    scale: f32[]                    the global quantization scale s
    dist:  f32[N_cap, deg] or None  build-maintained packs only: exact
                                    d(node, neighbour) per slot, +inf on
                                    empty slots
    chunk_w: int                    the JAX package's W: payload bytes per
                                    chunk row, fused meta excluded (None:
                                    its default, `_chunk_width(deg·d_pad)`)
    """

    pay: torch.Tensor
    meta: torch.Tensor
    scale: torch.Tensor
    dist: torch.Tensor | None = None
    chunk_w: int | None = None

    def __post_init__(self):
        if self.chunk_w is None:
            self.chunk_w = _chunk_width(self.deg * self.d_pad)

    @property
    def deg(self) -> int:
        return self.meta.shape[1] // 2

    @property
    def n_cap(self) -> int:
        return self.meta.shape[0]

    @property
    def chunks(self) -> int:
        """The JAX package's C: chunk rows of `chunk_w` bytes per node."""
        return self.deg * self.d_pad // self.chunk_w

    @property
    def d_pad(self) -> int:
        """Stored BYTES per neighbour (d_pad/2 under bits=4), as the JAX
        package's `PackedGraph.d_pad`."""
        return self.pay.shape[2]


def packed_from_numpy(pay, meta, scale, device: torch.device | str,
                      dist=None, fused: bool = False) -> PackedGraph:
    """PackedGraph from the JAX package's arrays (`np.asarray` of its pay
    [N_cap·C, W], meta, scale and optional dist): the payload bytes are
    row-major per node, so [N_cap·C, W] reshapes to [N_cap, deg, d_pad].
    A fused pack's chunk rows lead with 256/C meta bytes; those are
    stripped (`meta` holds the same ids and norms)."""
    meta = np.asarray(meta)
    n_cap, deg = meta.shape[0], meta.shape[1] // 2
    pay = np.asarray(pay)
    w = pay.shape[1]
    if fused:
        mpc = FUSED_META_TOTAL // (pay.shape[0] // n_cap)
        pay, w = pay[:, mpc:], w - mpc
    pay = pay.reshape(n_cap, deg, -1)

    def put(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return PackedGraph(
        pay=put(pay), meta=put(meta),
        scale=torch.tensor(float(np.asarray(scale)), dtype=torch.float32,
                           device=device),
        dist=None if dist is None else put(np.asarray(dist)),
        chunk_w=w,
    )


def pack_d_pad(dim: int) -> int:
    """Payload inner dim, padded to 128 as in the JAX package (whole 16-byte
    vector loads per row on the card)."""
    return round_up(dim, 128)


def _int8_sqnorm(y):
    """Exact ‖y‖² of int8 rows as int32."""
    yi = y.to(torch.int32)
    return torch.sum(yi * yi, dim=-1, dtype=torch.int32)


def _nibble_pack(y):
    """int8 values in [-8, 7] -> nibble-packed int8, two per byte along the
    last axis: byte j = (y[2j+1] << 4) | (y[2j] & 0xF).  The inverse is
    `ops/kernels/payload_score.py::nibble_unpack`."""
    lo = y[..., 0::2].to(torch.int32)
    hi = y[..., 1::2].to(torch.int32)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


@torch.no_grad()
def pack_graph(graph: GraphTensors, metric: str, scale=None,
               with_dist: bool = False, max_chunk: int = 2048, bits: int = 8,
               fused: bool = False) -> PackedGraph:
    """Build the inline-neighbor payload from a built graph, in slabs of
    nodes.  The global scale is max |component| of the stored vectors
    (dequantized) over the grid (127, or 7 for bits=4) — or the caller's
    `scale` — so integer-grid data quantizes exactly.  Bytes, norms and
    scale equal the JAX package's `pack_graph` (which multiplies by 1/s, as
    here).  `max_chunk` sets `chunk_w` only; a fused pack makes JAX's
    checks and stores the plain layout (JAX's bytes, meta stripped)."""
    if get_metric(metric).matmul_score is None:
        raise ValueError(
            f"metric {metric!r} has no matmul_score; the packed engine's "
            "int8 dot path needs one"
        )
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    vectors, scales, adj0 = graph.vectors, graph.scales, graph.adj0
    dev = vectors.device
    n_cap, deg = adj0.shape
    d = graph.dim
    d_pad = pack_d_pad(d)
    stored = d_pad if bits == 8 else d_pad // 2  # bytes per neighbour
    w = _chunk_width(deg * stored, max_chunk)
    if fused:
        c = (deg * stored) // w
        if deg > 32 or FUSED_META_TOTAL % c or with_dist:
            raise ValueError(
                "fused meta layout supports deg<=32, chunk counts dividing "
                "256, and query-only packs (no with_dist)"
            )
    qmax = 127 if bits == 8 else 7
    if scale is None:
        vmax = torch.amax(torch.abs(vectors.float()))
        if vectors.dtype == torch.int8:
            vmax = torch.amax(torch.abs(vectors.float()) * scales[:, None])
        s = torch.clamp_min(vmax / float(qmax), 1e-30)
    else:
        s = torch.clamp_min(torch.as_tensor(scale, dtype=torch.float32,
                                            device=dev), 1e-30)
    inv_s = 1.0 / s
    pay = torch.zeros((n_cap, deg, stored), dtype=torch.int8, device=dev)
    meta = torch.zeros((n_cap, 2 * deg), dtype=torch.int32, device=dev)
    dist = (torch.full((n_cap, deg), INF, device=dev) if with_dist
            else None)
    for start in range(0, n_cap, PACK_SLAB_ROWS):
        a = adj0[start:start + PACK_SLAB_ROWS]  # [S, deg]
        rows = gather_dequant(vectors, scales, a)  # [S, deg, D] f32
        y = torch.clamp(torch.round(rows * inv_s), -qmax, qmax).to(
            torch.int8)
        if bits == 8:
            pay[start:start + PACK_SLAB_ROWS, :, :d] = y
        else:
            pay[start:start + PACK_SLAB_ROWS] = _nibble_pack(
                torch.nn.functional.pad(y, (0, d_pad - d)))
        meta[start:start + PACK_SLAB_ROWS, :deg] = a
        meta[start:start + PACK_SLAB_ROWS, deg:] = _int8_sqnorm(y)
        if with_dist:
            own = torch.arange(start, start + a.shape[0], device=dev)
            dist[start:start + PACK_SLAB_ROWS] = _slot_dists(
                vectors, scales, own, a, metric)
    return PackedGraph(pay=pay, meta=meta, scale=s.to(torch.float32),
                       dist=dist, chunk_w=w)


def _slot_dists(vectors, scales, own, adj_rows, metric: str):
    """Exact d(node, neighbour) for each slot of `adj_rows` (i32[A, deg],
    the adjacency rows of nodes `own`), +inf on empty slots — through K2,
    the same arithmetic as every other distance of a build."""
    q = gather_dequant(vectors, scales, own[:, None])[:, 0]  # [A, D]
    return dists_to_ids(vectors, scales, None, q, None, adj_rows, metric)


def quantize_queries(q, scale):
    """Round preprocessed queries onto the payload's s-grid (int8[B, D])."""
    return torch.clamp(torch.round(q / scale), -127, 127).to(torch.int8)


def packed_slots(packed: PackedGraph, deg_limit: int | None,
                 fused: bool = False) -> int:
    """Neighbours K1 scores per expanded node: deg, or for deg_limit < deg
    the JAX package's whole-chunk count (`_packed_layout`): chunk rows of
    W bytes hold W // stored neighbours each, and ceil(deg_limit / that)
    chunk rows are fetched.  Raises ValueError where the JAX engine cannot
    reshape those chunk rows into whole neighbours (c·W != slots·stored),
    and for deg_limit on a fused pack."""
    if fused and deg_limit is not None:
        raise ValueError("deg_limit is unsupported on fused payloads")
    deg, stored, w = packed.deg, packed.d_pad, packed.chunk_w
    if deg_limit is None or deg_limit >= deg:
        return deg
    per_chunk = max(1, w // stored)
    c = max(1, -(-deg_limit // per_chunk))
    slots = min(deg, c * per_chunk)
    if c * w != slots * stored:
        raise ValueError(
            f"deg_limit={deg_limit}: {c} chunk rows of {w} B do not hold "
            f"{slots} whole neighbours of {stored} B")
    return slots


# --------------------------------------------------- build-time maintenance
def empty_packed(n_cap: int, deg: int, dim: int, scale,
                 device: torch.device | str = "cuda") -> PackedGraph:
    """All-sentinel payload for an empty graph (meta ids -1, zero norms,
    dists +inf).  Build-maintained packs always carry `dist`."""
    from ocaml_hnsw_tpu_torch.api import _resolve_device

    device = _resolve_device(device)
    meta = torch.zeros((n_cap, 2 * deg), dtype=torch.int32, device=device)
    meta[:, :deg] = -1
    return PackedGraph(
        pay=torch.zeros((n_cap, deg, pack_d_pad(dim)), dtype=torch.int8,
                        device=device),
        meta=meta,
        scale=torch.as_tensor(scale, dtype=torch.float32).to(device),
        dist=torch.full((n_cap, deg), INF, device=device),
    )


def quantize_payload_rows(v, scale):
    """Stored f32 rows onto the payload's grid, as `pack_graph` rounds them
    (multiply by 1/s), padded to d_pad: (int8[..., d_pad], int32 ‖y‖²)."""
    y = torch.clamp(torch.round(v * (1.0 / scale)), -127, 127).to(torch.int8)
    nrm = _int8_sqnorm(y)
    d = v.shape[-1]
    d_pad = pack_d_pad(d)
    if d_pad > d:
        y = torch.nn.functional.pad(y, (0, d_pad - d))
    return y, nrm


def refresh_payload_rows(packed: PackedGraph, vectors, scales, adj0, rows,
                         metric: str = "l2") -> PackedGraph:
    """Recompute pay/meta (and dist, when maintained) in place for node ids
    `rows` (i32[A]; duplicates compute identical values; the sink row
    recomputes to all-sentinel).  `vectors` must already hold the current
    rows.  Returns `packed`."""
    rows = rows.long()
    a = adj0[rows]  # [A, deg]
    y, nrm = quantize_payload_rows(gather_dequant(vectors, scales, a),
                                   packed.scale)
    packed.pay[rows] = y
    packed.meta[rows] = torch.cat([a, nrm], dim=1)
    if packed.dist is not None:
        packed.dist[rows] = _slot_dists(vectors, scales, rows, a, metric)
    return packed


def _beam_body(packed: PackedGraph, q8, qn, ef: int, needs_norms: bool,
               expand: int, slots: int | None = None, bits: int = 8):
    """The packed beam loop over this (sub)batch's query tensors, as two
    closures: `select(pk, d) -> (pk, d, nodes)` takes the first iteration's
    nodes, and `body(pk, d, nodes, select_next) -> (pk, d, nodes)` runs one
    iteration: K1 scores the first `slots` neighbours (all when None) of
    each of `nodes`, then K4 (`beam_update`) merges the fresh ones into the
    beam and, if `select_next`, takes the next iteration's nodes (else
    nodes is None and the expanded flags stay as the iteration left
    them)."""
    expand = max(1, min(expand, ef))

    def select(beam_pk, beam_d):
        return beam_update(beam_pk, beam_d, expand=expand)

    def body(beam_pk, beam_d, nodes, select_next):
        with annotate("hnsw.packed.beam_iter"):
            # gather + score of the E·slots inlined neighbours (K1)
            cand_ids, cand_d = packed_score(nodes, packed.meta, packed.pay,
                                            q8, qn, packed.scale, needs_norms,
                                            slots, bits)
            # dedup against the beam, merge, next nodes (K4)
            return beam_update(beam_pk, beam_d, cand_ids, cand_d,
                               expand=expand, select_next=select_next)

    return select, body


def _entries_to_packed_beam(entry_ids, entry_d, ef: int):
    """Dedup entries and build the sorted (pk, d) beam state.  pk = 2·id +
    expanded packs both into one int32; sentinel -1 decodes to (id=-1,
    expanded) with an arithmetic shift."""
    uniq = first_occurrence_mask(entry_ids) & (entry_ids >= 0)
    entry_ids = torch.where(uniq, entry_ids, -1)
    entry_d = torch.where(uniq, entry_d, INF)
    beam_ids, beam_d = entries_to_beam(entry_ids, entry_d, ef)
    beam_pk = torch.where(beam_ids < 0, -1, beam_ids * 2)
    return beam_pk, beam_d


def beam_search_layer_packed_duo(packed: PackedGraph, q8, qn, entry_ids,
                                 entry_d, ef: int, needs_norms: bool,
                                 max_iters: int, expand: int = 2,
                                 bits: int = 8, fused: bool = False,
                                 ways: int = 2):
    """Interleaved loop: the batch splits into `ways` independent
    sub-batches, each run for exactly `max_iters` iterations (no early
    exit, as in the JAX package).  Results equal running each sub-batch
    through `beam_search_layer_packed` with early_exit=False.  `fused`
    names the pack's layout, as in JAX; K1 reads either the same way."""
    del fused
    b = q8.shape[0]
    h = b // ways
    slices = [slice(i * h, (i + 1) * h) for i in range(ways)]
    loops = [_beam_body(packed, q8[s], qn[s], ef, needs_norms, expand,
                        bits=bits)
             for s in slices]
    state = [_entries_to_packed_beam(entry_ids[s], entry_d[s], ef)
             for s in slices]
    if max_iters > 0:
        state = [select(pk, d) for (select, _), (pk, d) in zip(loops, state)]
    for it in range(max_iters):
        state = [body(pk, d, nodes, it + 1 < max_iters)
                 for (_, body), (pk, d, nodes) in zip(loops, state)]
    ids = torch.cat([st[0] for st in state], dim=0) >> 1
    d = torch.cat([st[1] for st in state], dim=0)
    return ids, d, max_iters


def beam_search_layer_packed(packed: PackedGraph, q8, qn, entry_ids, entry_d,
                             ef: int, needs_norms: bool, max_iters: int,
                             expand: int = 4, deg_limit: int | None = None,
                             early_exit: bool = True, bits: int = 8,
                             fused: bool = False, init_pk=None, init_d=None,
                             raw_state: bool = False,
                             slots: int | None = None):
    """The packed layer-0 beam loop: per iteration, expand the E nearest
    unexpanded beam nodes and score their inlined neighbours (K1), dedup
    against the beam, merge.  Returns (ids, d, iters).

    early_exit=True stops when every beam is fully expanded (one host sync
    per iteration); False runs exactly max_iters.  init_pk/init_d resume
    from a previous phase's raw (pk, d) state; raw_state=True returns it.
    bits: the payload width; q8 is int8[B, d_pad] for bits=8, bf16[B,
    2·d_pad] q/s for 4.  K1 scores `slots` neighbours per node: given
    directly (the port's own argument), or resolved from the JAX package's
    `deg_limit` / `fused` by `packed_slots` (ValueError where JAX's engine
    cannot run that pair, and when both `slots` and `deg_limit` are given)."""
    if slots is None:
        slots = packed_slots(packed, deg_limit, fused)
    elif deg_limit is not None:
        raise ValueError("pass slots or deg_limit, not both")
    select, step = _beam_body(packed, q8, qn, ef, needs_norms, expand, slots,
                              bits)
    if init_pk is not None:
        beam_pk, beam_d = init_pk, init_d
    else:
        beam_pk, beam_d = _entries_to_packed_beam(entry_ids, entry_d, ef)
    it = 0
    if max_iters > 0:
        beam_pk, beam_d, nodes = select(beam_pk, beam_d)
    while it < max_iters:
        if early_exit:
            # no node selected <=> the beam was fully expanded
            with annotate("hnsw.sync.exit_check"):
                done = not bool(torch.any(nodes >= 0))
            if done:
                break
        beam_pk, beam_d, nodes = step(beam_pk, beam_d, nodes,
                                      it + 1 < max_iters)
        it += 1
    if raw_state:
        return beam_pk, beam_d, it
    return beam_pk >> 1, beam_d, it


@torch.no_grad()
def knn_search_packed(
    graph: GraphTensors,
    packed: PackedGraph,
    queries,  # f32[B, D]
    k: int,
    ef: int,
    metric: str,
    max_iters: int | None = None,
    expand: int = 4,
    seeds: SeedIndex | None = None,
    seed_e: int = 16,
    rerank_k: int | None = None,
    deg_limit: int | None = None,
    early_exit: bool = True,
    bits: int = 8,
    expand_schedule: tuple | None = None,
    fused: bool = False,
    interleave: int = 1,
):
    """Alg 5 on the packed engine: seed-scan (or greedy) entry, packed
    beam at layer 0, then an exact-f32 rerank of the top `rerank_k` beam
    entries.  Returns (ids i32[B, k], d f32[B, k]) ascending, -1/+inf
    padded, tombstones filtered — the JAX package's contract.  `bits` and
    `fused` must be those the pack was made with; `deg_limit` rounds as
    `packed_slots` says, and skips the interleaved loop, as in JAX."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    slots = packed_slots(packed, deg_limit, fused)
    width = packed.d_pad * (1 if bits == 8 else 2)  # logical query width
    if width != pack_d_pad(graph.dim):
        raise ValueError(f"a {packed.d_pad}-byte payload row is not a "
                         f"bits={bits} pack of {graph.dim}-d vectors")
    ef = max(ef, k)
    if max_iters is None:
        max_iters = max(64, (8 * ef) // max(1, expand))
    if rerank_k is None:
        rerank_k = min(ef, max(2 * k, 16))
    rerank_k = max(k, min(rerank_k, ef))
    needs_norms = get_metric(metric).needs_norms
    with annotate("hnsw.packed.seed"):
        q = preprocess_queries(queries, metric)
        qn = query_norms(q, metric)
        if seeds is not None:
            entry_ids, entry_d = seed_entries(graph, seeds, q, qn, seed_e,
                                              metric)
        else:
            cur, cur_d = descend(graph, q, qn, metric, stop_level=0)
            entry_ids, entry_d = cur[:, None], cur_d[:, None]
        if bits == 8:
            q8 = quantize_queries(q, packed.scale)
        else:
            # fractional bf16 on the payload's s-grid (a true division, as
            # in the JAX engine, where the scale is a traced value)
            q8 = (q / packed.scale).to(torch.bfloat16)
        if width > q8.shape[1]:
            q8 = torch.nn.functional.pad(q8, (0, width - q8.shape[1]))
    with annotate("hnsw.packed.beam"):
        if expand_schedule is not None:
            # phased beam, e.g. ((8, 2), (2, 26)): wide expansions fill the
            # beam, then it cruises narrow; expanded flags carry across
            # phases
            state = (None, None)
            for e_p, mi_p in expand_schedule:
                state = beam_search_layer_packed(
                    packed, q8, qn, entry_ids, entry_d, ef,
                    needs_norms=needs_norms, max_iters=mi_p, expand=e_p,
                    early_exit=False, init_pk=state[0], init_d=state[1],
                    raw_state=True, slots=slots, bits=bits,
                )[:2]
            ids, d = state[0] >> 1, state[1]
        elif (interleave > 1 and queries.shape[0] % interleave == 0
              and deg_limit is None):
            # independent sub-batches, fixed max_iters (early_exit ignored)
            ids, d, _ = beam_search_layer_packed_duo(
                packed, q8, qn, entry_ids, entry_d, ef,
                needs_norms=needs_norms, max_iters=max_iters, expand=expand,
                ways=interleave, bits=bits,
            )
        else:
            ids, d, _ = beam_search_layer_packed(
                packed, q8, qn, entry_ids, entry_d, ef,
                needs_norms=needs_norms, max_iters=max_iters, expand=expand,
                early_exit=early_exit, slots=slots, bits=bits,
            )
    with annotate("hnsw.packed.rerank"):
        # tombstone filter on the approx beam, keep top rerank_k live
        # candidates
        dead = graph.deleted[ids.clamp_min(0).long()] | (ids < 0)
        d = torch.where(dead, INF, d)
        _, top_ids = topk_ascending(d, torch.where(dead, -1, ids), rerank_k)
        # exact f32 rerank (K2) -> exact final ordering
        d_exact = dists_to_ids(graph.vectors, graph.scales, graph.norms, q,
                               qn, top_ids, metric)
        out_d, out_ids = topk_ascending(d_exact, top_ids, k)
        out_ids = torch.where(torch.isinf(out_d), -1, out_ids)
        return out_ids, out_d
