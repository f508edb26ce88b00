"""Query-graph distillation, ported from `ocaml_hnsw_tpu/models/refine.py`:
re-select a smaller, uniform out-degree adjacency for serving, so the packed
engine reads half the payload bytes per expansion while keeping the Alg-4
diversity that a plain `deg_limit` truncation drops.

For each node, take its M_max0 build edges (optionally plus the adjacency
rows of its `hops` nearest neighbours, a 2-hop extension), sort them by
distance, and admit `out_deg` of them with the build's Alg-4 rule (closer to
the node than to any admitted candidate), backfilling the nearest rejected
to a full row.  The distilled adjacency is for queries only: pack it with
`pack_graph(refined_graph(...), ...)`; the build graph keeps its rows.

Rows are independent (a node's output depends on its own row only), so the
port walks fixed slabs of `slab` nodes with a ragged last slab; the JAX
package takes the largest power of two dividing N_cap, which at 1,000,064
slots is 128 nodes, thousands of eager slab steps.  The candidate distances
go through `dists_to_ids` (K2 on the card).
"""

from __future__ import annotations

import torch

from ocaml_hnsw_tpu_torch.models.build import compact_by_mask, heuristic_admit
from ocaml_hnsw_tpu_torch.models.graph import GraphTensors
from ocaml_hnsw_tpu_torch.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu_torch.ops.distance import (
    dists_to_ids, gather_dequant, pairwise_dists,
)
from ocaml_hnsw_tpu_torch.ops.sortmerge import bitonic_sort, next_pow2


def _refine_slab(graph: GraphTensors, start: int, stop: int, out_deg: int,
                 metric: str, hops: int):
    """Distilled rows of nodes [start, stop): i32[stop - start, out_deg]."""
    vectors, scales, norms, adj0 = (graph.vectors, graph.scales, graph.norms,
                                    graph.adj0)
    dev = adj0.device
    k = adj0.shape[1]
    kt = k + hops * k  # candidate width after the 2-hop extension
    a = adj0[start:stop]  # [S, K]
    s = a.shape[0]
    own_ids = torch.arange(start, stop, dtype=torch.int32, device=dev)
    if hops:
        # the `hops` nearest neighbours' rows join the pool (adjacency rows
        # are distance-ascending, so columns 0..hops-1 are the nearest)
        ext = adj0[a[:, :hops].clamp_min(0).long()]  # [S, hops, K]
        ext = torch.where((a[:, :hops] >= 0)[:, :, None], ext, -1)
        cand = torch.cat([a, ext.reshape(s, hops * k)], dim=1)  # [S, Kt]
    else:
        cand = a
    # self-edges and duplicates are invalid candidates
    valid = ((cand >= 0) & (cand != own_ids[:, None])
             & first_occurrence_mask(cand))
    cand = torch.where(valid, cand, -1)
    own = gather_dequant(vectors, scales, own_ids[:, None])[:, 0]  # [S, D]
    d = dists_to_ids(vectors, scales, norms, own, norms[start:stop], cand,
                     metric)
    cvec = gather_dequant(vectors, scales, cand)  # [S, Kt, D]
    cnorm = norms[cand.clamp_min(0).long()]
    # ascending-distance candidate order; the vectors follow by permutation
    p2 = next_pow2(kt)
    perm0 = torch.arange(kt, dtype=torch.int32, device=dev).expand(s, kt)
    if p2 > kt:
        pad = (0, p2 - kt)
        d = torch.nn.functional.pad(d, pad, value=float("inf"))
        cand = torch.nn.functional.pad(cand, pad, value=-1)
        perm0 = torch.nn.functional.pad(perm0, pad, value=0)
    sd, (sids, perm) = bitonic_sort(d, [cand, perm0])
    svalid = torch.isfinite(sd)
    perm = perm.long()
    cvec = torch.gather(cvec, 1, perm[:, :, None].expand(-1, -1,
                                                         cvec.shape[2]))
    cnorm = torch.gather(cnorm, 1, perm)
    pair = pairwise_dists(cvec, cnorm, metric)  # [S, P2, P2]
    sel = heuristic_admit(sd, pair, svalid, out_deg, keep_pruned=True,
                          scan_limit=kt)
    new_ids, _ = compact_by_mask(sids, sd, sel & svalid, out_deg)
    return new_ids


@torch.no_grad()
def refine_adjacency(graph: GraphTensors, out_deg: int, metric: str,
                     slab: int = 4096, hops: int = 0) -> torch.Tensor:
    """Distill graph.adj0 down to `out_deg` columns (module docstring).

    hops > 0 also pools each node's `hops` nearest neighbours' adjacency
    rows before re-selection.  Returns a fresh i32[N_cap, out_deg]
    adjacency (rows distance-ascending, -1 padded; unoccupied slots all
    -1), or graph.adj0 itself when out_deg >= M_max0 and hops == 0.  The
    result does not depend on `slab` (nodes per step)."""
    n_cap, k = graph.adj0.shape
    if out_deg >= k and not hops:
        return graph.adj0
    slab = max(1, min(slab, n_cap))
    return torch.cat([
        _refine_slab(graph, start, min(start + slab, n_cap), out_deg, metric,
                     hops)
        for start in range(0, n_cap, slab)])


def refined_graph(graph: GraphTensors, out_deg: int, metric: str,
                  slab: int = 4096, hops: int = 0) -> GraphTensors:
    """graph with adj0 replaced by the distilled serving adjacency (for
    pack_graph and the packed engine; upper layers untouched)."""
    return graph._replace(
        adj0=refine_adjacency(graph, out_deg, metric, slab=slab, hops=hops))
