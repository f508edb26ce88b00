"""The classic beam loop's one-launch step (`ops/kernels/beam_update.py::
beam_step_classic`, its plain version on the CPU) and the loop around it
(`models/search.py::beam_search_layer` with beam-only dedup).

The loop was eager: per iteration a cumsum selection, the adjacency gather,
the dedup against the beam and within the row, the compaction, K2 and the
bitonic merge.  It now merges each scored block at the start of the next
step, and once more after the last K2.  `_frozen_beam_only` below is that
eager loop as it was; the restructured one must return the same (ids, d,
iters) bit for bit, ties included, on a dense layer-0 table and on an
upper layer's arena view, with and without compaction, at the shapes the
build and the queries use.  The CUDA kernel is held to the plain version on
the card by `chip_smoke.py --beam-update`.
"""

import numpy as np
import pytest
import torch

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import search as tsearch
from ocaml_hnsw_tpu_torch.models.build import BuildState
from ocaml_hnsw_tpu_torch.models.graph import UpperView, adj_take, upper_view
from ocaml_hnsw_tpu_torch.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu_torch.ops.distance import INF, dists_to_ids
from ocaml_hnsw_tpu_torch.ops.kernels.beam_update import (
    beam_step_classic, beam_step_classic_plain, classic_width,
)
from ocaml_hnsw_tpu_torch.ops.sortmerge import entries_to_beam, merge_into_beam

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

N, DIM, B = 1200, 8, 16


@torch.no_grad()
def _frozen_beam_only(vectors, scales, norms, adj, q, qn, entry_ids, entry_d,
                      ef, metric, max_iters=None, expand=1, compact_k=None):
    """`beam_search_layer` with visited_bits=0 as the eager loop ran it
    (the parent of the one-launch step), kept verbatim as the yardstick."""
    b = q.shape[0]
    dev = q.device
    expand = max(1, min(expand, ef))
    uniq = first_occurrence_mask(entry_ids.clamp_min(0)) & (entry_ids >= 0)
    entry_ids = torch.where(uniq, entry_ids, -1)
    entry_d = torch.where(uniq, entry_d, INF)
    beam_ids, beam_d = entries_to_beam(entry_ids, entry_d, ef)
    beam_pk = torch.where(beam_ids < 0, -1, beam_ids * 2)
    ar = torch.arange(1, expand + 1, dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while max_iters is None or it < max_iters:
        unexp = (beam_pk & 1) == 0
        live = torch.any(unexp)
        if it % tsearch.CONVERGE_CHECK == 0:
            if not bool(live):
                break
        iters += live.to(torch.int32)
        slot = torch.cumsum(unexp.to(torch.int32), dim=1, dtype=torch.int32)
        sel_mask = unexp & (slot <= expand)
        beam_pk = torch.where(sel_mask, beam_pk | 1, beam_pk)
        oh = sel_mask[:, None, :] & (slot[:, None, :] == ar[None, :, None])
        pos = torch.argmax(oh.to(torch.uint8), dim=2)
        active = torch.any(oh, dim=2)
        nodes = torch.where(active, torch.gather(beam_pk, 1, pos) >> 1, -1)
        nbrs = adj_take(adj, nodes.clamp_min(0))
        nbrs = torch.where((nodes >= 0)[:, :, None], nbrs, -1).reshape(b, -1)
        in_beam = torch.any(
            nbrs[:, :, None] == (beam_pk >> 1)[:, None, :], dim=2)
        fresh = (nbrs >= 0) & ~in_beam & first_occurrence_mask(nbrs)
        cand_ids = torch.where(fresh, nbrs, -1)
        if compact_k is not None and compact_k < cand_ids.shape[1]:
            kk = cand_ids.shape[1]
            slots = torch.arange(kk, dtype=torch.int32, device=dev)
            key = torch.where(fresh, slots[None, :], kk)
            skey, order = torch.sort(key, dim=1, stable=True)
            cand_ids = torch.where(skey[:, :compact_k] < kk,
                                   torch.gather(cand_ids, 1,
                                                order[:, :compact_k]), -1)
        cand_d = dists_to_ids(vectors, scales, norms, q, qn, cand_ids, metric)
        cand_pk = torch.where(cand_ids < 0, -1, cand_ids * 2)
        beam_d, (beam_pk,) = merge_into_beam(
            beam_d, [(beam_pk, -1)], cand_d, [(cand_pk, -1)], ef)
        it += 1
    return beam_pk >> 1, beam_d, iters


@pytest.fixture(scope="module")
def graph():
    """An M=16 graph (level-0 degree 32, upper degree 16, as the laion
    cell's) on integer-valued rows, so that distances tie."""
    data = np.round(clustered(N, DIM, n_clusters=6, seed=4) * 2)
    st = BuildState(HnswConfig(dim=DIM, M=16, ef_construction=48), N,
                    round_size=256, device="cpu")
    st.add(data.astype(np.float32))
    q = np.round(queries_like(data, B, seed=5) * 2).astype(np.float32)
    return st.graph, torch.from_numpy(q)


def _entries(g, q, upper: bool):
    """Eight entries a row: the descent's entry, nodes of the layer,
    repeats and -1; row 0 all -1, row 1 a single entry repeated."""
    rng = np.random.default_rng(6)
    qn = torch.sum(q * q, dim=1)
    cur, _ = tsearch.descend(g, q, qn, "l2", stop_level=1 if upper else 0)
    if upper:
        pool = np.nonzero(g.levels.numpy() >= 1)[0]
    else:
        pool = np.arange(int(g.n))
    ids = rng.choice(pool, size=(B, 8)).astype(np.int32)
    ids[:, 0] = cur.numpy()
    ids[:, 3] = ids[:, 2]  # a repeat
    ids[:, 5] = -1
    ids[0] = -1
    ids[1] = ids[1, 0]
    e = torch.from_numpy(ids)
    d = dists_to_ids(g.vectors, g.scales, g.norms, q, qn, e, "l2")
    return qn, e, d


ADJ = ("dense", "upper")
CASES = [(adj, ck, ef, expand, mi)
         for adj in ADJ for ck in (None, 96) for ef in (32, 128, 200)
         for expand, mi in ((1, 24), (4, None), (8, 48))]


@pytest.mark.parametrize("adj,compact_k,ef,expand,max_iters", CASES)
def test_loop_equals_eager(graph, adj, compact_k, ef, expand, max_iters):
    """(ids, d, iters) of the restructured loop equal the eager loop's bit
    for bit: dense table or upper arena, compaction on or off, every ef and
    expansion of the build and query paths, capped and uncapped."""
    g, q = graph
    view = upper_view(g, 1) if adj == "upper" else g.adj0
    qn, e, d = _entries(g, q, adj == "upper")
    args = (g.vectors, g.scales, g.norms, view, q, qn, e, d, ef, "l2")
    ids, dist, iters = tsearch.beam_search_layer(
        *args, max_iters, expand=expand, visited_bits=0, compact_k=compact_k)
    f_ids, f_d, f_iters = _frozen_beam_only(
        *args, max_iters, expand=expand, compact_k=compact_k)
    assert torch.equal(ids, f_ids)
    assert torch.equal(dist.view(torch.int32), f_d.view(torch.int32))
    assert iters.dtype == torch.int32 and int(iters) == int(f_iters)
    if adj == "upper" and expand == 8:
        assert int(iters) < max_iters  # the layer is small: it converges


def _toy(expanded=(), ef=6):
    """A 10-node dense table of degree 3 and one beam row over it."""
    adj = torch.tensor([[1, 2, 3], [0, 2, 4], [5, 6, -1], [7, 4, 1],
                        [8, 9, 0], [-1, -1, -1], [2, 3, 4], [0, 1, 2],
                        [9, 8, 7], [4, 5, 6]], dtype=torch.int32)
    ids = [0, 2, -1, -1, -1, -1][:ef]
    pk = torch.tensor([[-1 if i < 0 else 2 * i + (i in expanded)
                        for i in ids]], dtype=torch.int32)
    d = torch.tensor([[1.0 if i == 0 else 2.0 if i == 2 else INF
                       for i in ids]])
    return adj, pk, d


def test_step_rules():
    """One step by hand: the block (1, -1, 3) merged, live set, the two
    nearest unexpanded members (1 and 3) selected, and of their rows' ids
    (0, 2, 4 and 7, 4, 1) the fresh ones (4, 7: the rest are in the beam
    or repeat) packed left, or left in their slots."""
    adj, pk, d = _toy(expanded=(0, 2))
    live = torch.zeros((), dtype=torch.int32)
    block = torch.tensor([[1, -1, 3]], dtype=torch.int32)
    block_d = torch.tensor([[0.5, INF, 3.0]])
    out_pk, out_d, cand = beam_step_classic(
        pk, d, block, block_d, adj, live, expand=2, compact_k=4)
    # merged: 1 (0.5), 0 (1.0, expanded), 2 (2.0, expanded), 3 (3.0)
    assert out_d[0].tolist()[:4] == [0.5, 1.0, 2.0, 3.0]
    assert out_pk[0].tolist() == [3, 1, 5, 7, -1, -1]  # 1 and 3 selected
    assert int(live) == 1
    assert cand[0].tolist() == [4, 7, -1, -1]
    # in place, not compacted: the slot layout kept
    live.zero_()
    _, _, full = beam_step_classic(pk, d, block, block_d, adj, live,
                                   expand=2)
    assert full[0].tolist() == [-1, -1, 4, 7, -1, -1]
    assert classic_width(2, 3, 4) == 4 and classic_width(2, 3, None) == 6
    assert classic_width(2, 3, 8) == 6


def test_step_converged_leaves_live():
    """A fully expanded beam: live untouched, nothing selected, an all -1
    block; the first step (no block) merges nothing."""
    adj, pk, d = _toy(expanded=(0, 2))
    live = torch.zeros((), dtype=torch.int32)
    out_pk, out_d, cand = beam_step_classic_plain(pk, d, None, None, adj,
                                                  live, expand=3)
    assert int(live) == 0 and torch.equal(out_pk, pk)
    assert torch.equal(out_d, d) and (cand == -1).all()


def test_step_upper_view_sink():
    """An UpperView: nodes without a row at the level read the sink row."""
    table = torch.tensor([[3, 4], [5, -1], [-1, -1]], dtype=torch.int32)
    up_base = torch.tensor([0, -1, -1, 1, -1, -1], dtype=torch.int32)
    levels = torch.tensor([1, 0, 0, 1, 0, 0], dtype=torch.int32)
    view = UpperView(table=table, up_base=up_base, levels=levels, level=1)
    pk = torch.tensor([[0, 2, 6]], dtype=torch.int32)  # 0, 1, 3 unexpanded
    d = torch.tensor([[1.0, 2.0, 3.0]])
    live = torch.zeros((), dtype=torch.int32)
    out_pk, _, cand = beam_step_classic(pk, d, None, None, view, live,
                                        expand=3)
    assert out_pk[0].tolist() == [1, 3, 7]
    # 0 -> [3, 4]: 3 in the beam; 1 -> the sink; 3 -> [5, -1]
    assert cand[0].tolist() == [-1, 4, -1, -1, 5, -1]


BAD = ["pk_dtype", "d_dtype", "cand_dtype", "adj_dtype", "live_dtype",
       "shape", "cand_rows", "cand_alone", "adj_shape", "live_numel",
       "device", "too_wide", "too_many_slots", "expand_low", "expand_high",
       "compact_k", "upper_level"]


@pytest.mark.parametrize("bad", BAD)
def test_wrapper_raises(bad):
    """Wrong dtype, shape, device or width: the wrapper raises before any
    launch, on the CPU as on the card."""
    pk = torch.zeros((4, 8), dtype=torch.int32)
    d = torch.zeros((4, 8))
    ci = torch.zeros((4, 6), dtype=torch.int32)
    cd = torch.zeros((4, 6))
    adj = torch.zeros((20, 3), dtype=torch.int32)
    live = torch.zeros((), dtype=torch.int32)
    kw = dict(expand=2)
    err = ValueError
    if bad == "pk_dtype":
        pk, err = pk.long(), TypeError
    elif bad == "d_dtype":
        d, err = d.double(), TypeError
    elif bad == "cand_dtype":
        cd, err = cd.half(), TypeError
    elif bad == "adj_dtype":
        adj, err = adj.long(), TypeError
    elif bad == "live_dtype":
        live, err = live.bool(), TypeError
    elif bad == "shape":
        d = d[:, :7]
    elif bad == "cand_rows":
        ci, cd = ci[:3], cd[:3]
    elif bad == "cand_alone":
        cd = None
    elif bad == "adj_shape":
        adj = adj[:, 0]
    elif bad == "live_numel":
        live = torch.zeros((2,), dtype=torch.int32)
    elif bad == "device":
        ci = ci.to("meta")
    elif bad == "too_wide":
        ci = torch.zeros((4, 4097), dtype=torch.int32)
        cd = torch.zeros((4, 4097))
    elif bad == "too_many_slots":
        adj = torch.zeros((20, 2049), dtype=torch.int32)
    elif bad == "expand_low":
        kw["expand"] = 0
    elif bad == "expand_high":
        kw["expand"] = 9
    elif bad == "compact_k":
        kw["compact_k"] = 0
    elif bad == "upper_level":
        adj = UpperView(table=adj, up_base=torch.zeros(20, dtype=torch.int32),
                        levels=torch.zeros(20, dtype=torch.int32), level=0)
    with pytest.raises(err):
        beam_step_classic(pk, d, ci, cd, adj, live, **kw)
