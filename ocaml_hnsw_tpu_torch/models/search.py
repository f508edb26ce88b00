"""Layer-0 entry for the packed engine, ported from
`ocaml_hnsw_tpu/models/search.py`: the seed scan (`SeedIndex`,
`build_seed_index`, `seed_entries`), greedy descent (`descend`,
`_greedy_level`) and query preprocessing.

The seed scan is one matrix product of the queries against every level>=1
node's bf16 vector, top-E by bf16 score, then an exact re-score of the E
winners through the gather-distance kernel.  The JAX package's
`approx_min_k` becomes exact `torch.topk`; ties among bf16 scores may pick
other seeds, so seeded searches agree with the JAX package at recall level.
The classic beam engine (`beam_search_layer`, `knn_search`) is not ported
yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, adj_take, upper_view,
)
from ocaml_hnsw_tpu_torch.ops.distance import dists_to_ids, gather_dequant
from ocaml_hnsw_tpu_torch.ops.metrics import get_metric


def _greedy_level(vectors, scales, norms, adj, q, qn, cur, cur_d, enabled,
                  metric):
    """One layer of greedy ef=1 descent for B queries (Alg 5 upper loop)."""
    active = enabled
    while bool(torch.any(active)):
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


@dataclasses.dataclass
class SeedIndex:
    """Coarse entry-point index: a dense copy of every level>=1 node's vector.

    ids:   i32[U_cap]     global node id per row (padding repeats a real row)
    vecs:  bf16[U_cap, D] that node's stored vector (dequantized, bf16)
    norms: f32[U_cap]     ||x||² for l2 scoring (zeros for ip/cosine)
    bias:  f32[U_cap]     additive score bias: 0 on live rows, +inf on
                          masked padding
    """

    ids: torch.Tensor
    vecs: torch.Tensor
    norms: torch.Tensor
    bias: torch.Tensor


@torch.no_grad()
def build_seed_index(graph: GraphTensors, metric: str,
                     cap: int | None = None) -> SeedIndex | None:
    """Extract the level>=1 node set from a built graph.  Returns None when
    the graph has no upper nodes.  cap: serve the scan from at most `cap`
    rows — highest levels first, the level-1 remainder subsampled evenly
    (the same selection as the JAX package)."""
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
    dev = graph.device
    ids = torch.from_numpy(pad).to(dev)
    vecs = gather_dequant(graph.vectors, graph.scales, ids[None, :])[0]
    if get_metric(metric).needs_norms:
        norms = torch.sum(vecs * vecs, dim=1)
    else:
        norms = torch.zeros((u_cap,), dtype=torch.float32, device=dev)
    return SeedIndex(ids=ids, vecs=vecs.to(torch.bfloat16), norms=norms,
                     bias=torch.zeros((u_cap,), dtype=torch.float32,
                                      device=dev))


def seed_entries(graph: GraphTensors, seeds: SeedIndex, q, qn, e: int,
                 metric: str):
    """Top-E upper-layer nodes per query: one scan + top-E, then exact
    re-scoring of the E winners.  Returns (ids i32[B, E], d f32[B, E])."""
    mm = get_metric(metric).matmul_score
    if mm is None:
        raise ValueError(
            f"metric {metric!r} has no matmul_score; seed-scan entry needs "
            "one — pass seeds=None to use greedy descent"
        )
    # bf16 operands, f32 products and sums (TF32 off)
    dot = torch.matmul(q.to(torch.bfloat16).float(), seeds.vecs.float().T)
    scores = mm(dot, seeds.norms[None, :]) + seeds.bias[None, :]
    # rank by bf16 scores, as the JAX package does
    ii = torch.topk(scores.to(torch.bfloat16), e, dim=1, largest=False).indices
    live = (seeds.bias == 0.0)[ii]
    sids = torch.where(live, seeds.ids[ii], -1).to(torch.int32)
    sd = dists_to_ids(graph.vectors, graph.scales, graph.norms, q, qn, sids,
                      metric)
    return sids, sd


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
