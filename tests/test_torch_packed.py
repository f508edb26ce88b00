"""Packed inline-int8 engine of the torch port against the JAX package's
(`ocaml_hnsw_tpu/models/packed.py`).

  * `pack_graph` on one graph in both packages (built by the port, which
    is faster here — tests/test_torch_bulk.py holds that build to the JAX
    package's — and carried across with `graph_to_numpy` /
    `graph_from_numpy`): payload bytes, meta (ids + int32 norms) and scale
    are bit-identical to the JAX `pack_graph`.
  * `knn_search_packed` with seeds=None on integer-grid vectors and queries
    (|x| <= 15, scale 1.0): every int8 product is exact in bf16 and every
    distance an exact f32 integer, so the port's exact int32 dot and the
    JAX bf16 products agree, and with the same bitonic tie order ids and
    distances must be EXACTLY equal — for the while-loop, fori, interleaved
    and expand-schedule loops.  Here the graph goes the other way: built by
    the port, carried into the JAX package.
  * With seeds on real-valued clustered data the entry differs legitimately
    (exact top-k vs approx_min_k over bf16 scores), so recall@10 must be
    within 0.01 of the JAX engine's, and distances of shared ids equal to
    1e-5 (both are exact f32 reranks)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.models.graph import GraphTensors as JaxGraph
from ocaml_hnsw_tpu.models import packed as jpacked
from ocaml_hnsw_tpu.models.search import build_seed_index as jax_seed_index
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn, recall

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models.bulk import bulk_build
from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, graph_from_numpy, graph_to_numpy,
)
from ocaml_hnsw_tpu_torch.models import packed as tpacked
from ocaml_hnsw_tpu_torch.models.search import build_seed_index

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA; the port's
# tests are small, and the lane runs about 2.5x faster this way.
torch.set_num_threads(1)


def jax_to_port(g):
    return graph_from_numpy({f: np.asarray(getattr(g, f))
                             for f in GraphTensors._fields},
                            g.l_max_static, "cpu")


def port_to_jax(g):
    arrays = graph_to_numpy(g)
    return JaxGraph(**{f: jnp.asarray(a) for f, a in arrays.items()},
                    l_max_static=g.l_max_static)


@pytest.fixture(scope="module")
def clustered_graphs():
    data = clustered(4000, 24, n_clusters=32, seed=1)
    tg = bulk_build(data, HnswConfig(dim=24, M=12, ef_construction=80),
                    knn_k=24, batch=1024, device="cpu")
    return data, port_to_jax(tg), tg


@pytest.fixture(scope="module")
def grid_graphs():
    """Integer-grid vectors and queries, |x| <= 15, built by the port."""
    rng = np.random.RandomState(11)
    centers = rng.randint(-10, 11, size=(16, 16))
    data = np.clip(centers[rng.randint(0, 16, size=2000)]
                   + rng.randint(-4, 5, size=(2000, 16)), -15, 15)
    data = data.astype(np.float32)
    q = np.clip(data[rng.randint(0, 2000, size=64)]
                + rng.randint(-2, 3, size=(64, 16)), -15, 15)
    tg = bulk_build(data, HnswConfig(dim=16, M=8), knn_k=16, batch=512,
                    device="cpu")
    return data, q.astype(np.float32), tg, port_to_jax(tg)


class TestPackGraph:
    @pytest.mark.parametrize("scale", [None, 0.5])
    def test_bit_identical_to_jax(self, clustered_graphs, scale):
        _, jg, tg = clustered_graphs
        jp = jpacked.pack_graph(jg, "l2", scale=scale)
        tp = tpacked.pack_graph(tg, "l2", scale=scale)
        np.testing.assert_array_equal(
            tp.pay.numpy(), np.asarray(jp.pay).reshape(tp.pay.shape))
        np.testing.assert_array_equal(tp.meta.numpy(), np.asarray(jp.meta))
        assert tp.scale.numpy().tobytes() == np.asarray(jp.scale).tobytes()
        fp = tpacked.packed_from_numpy(jp.pay, jp.meta, jp.scale, "cpu")
        assert torch.equal(fp.pay, tp.pay) and torch.equal(fp.meta, tp.meta)
        assert (tp.n_cap, tp.deg, tp.d_pad) == (4096, 24, 128)

    @pytest.mark.parametrize("storage,metric", [("int8", "l2"),
                                                ("bf16", "cosine")])
    def test_bit_identical_other_storage(self, storage, metric):
        """Port-built graph carried into the JAX package: int8 rows are
        dequantized by their per-row scale before the global grid."""
        data = clustered(1000, 24, n_clusters=8, seed=2)
        tg = bulk_build(data, HnswConfig(dim=24, M=6, metric=metric,
                                         storage=storage),
                        knn_k=12, batch=512, device="cpu")
        jp = jpacked.pack_graph(port_to_jax(tg), metric)
        tp = tpacked.pack_graph(tg, metric)
        np.testing.assert_array_equal(
            tp.pay.numpy(), np.asarray(jp.pay).reshape(tp.pay.shape))
        np.testing.assert_array_equal(tp.meta.numpy(), np.asarray(jp.meta))
        assert tp.scale.numpy().tobytes() == np.asarray(jp.scale).tobytes()

    def test_graph_bridge_roundtrip(self, clustered_graphs):
        _, jg, tg = clustered_graphs
        back = graph_to_numpy(jax_to_port(jg))  # port -> JAX -> port
        for f in GraphTensors._fields:
            np.testing.assert_array_equal(back[f], np.asarray(getattr(jg, f)))
            np.testing.assert_array_equal(back[f], getattr(tg, f).numpy())

    def test_off_path_options_raise(self, clustered_graphs):
        """pack_graph's checks, where the JAX package raises ValueError:
        bits other than 8 / 4, and a fused layout with deg > 32 or with
        with_dist."""
        _, jg, tg = clustered_graphs
        wide = tg._replace(adj0=torch.cat([tg.adj0, tg.adj0[:, :10]], 1))
        jwide = jg._replace(adj0=jnp.asarray(wide.adj0.numpy()))
        for g, pack in ((tg, tpacked.pack_graph), (jg, jpacked.pack_graph)):
            with pytest.raises(ValueError, match="bits"):
                pack(g, "l2", bits=2)
            with pytest.raises(ValueError, match="fused"):
                pack(g, "l2", fused=True, with_dist=True)
        for g, pack in ((wide, tpacked.pack_graph),
                        (jwide, jpacked.pack_graph)):
            with pytest.raises(ValueError, match="fused"):
                pack(g, "l2", fused=True)

    @pytest.mark.parametrize("scale", [None, 0.5])
    def test_with_dist_equals_jax(self, clustered_graphs, scale):
        """with_dist=True: payload and meta bit-identical to JAX's, the
        per-slot distances equal to rtol 1e-6 (f32 summation order), +inf
        on the same empty slots."""
        _, jg, tg = clustered_graphs
        jp = jpacked.pack_graph(jg, "l2", scale=scale, with_dist=True)
        tp = tpacked.pack_graph(tg, "l2", scale=scale, with_dist=True)
        np.testing.assert_array_equal(
            tp.pay.numpy(), np.asarray(jp.pay).reshape(tp.pay.shape))
        np.testing.assert_array_equal(tp.meta.numpy(), np.asarray(jp.meta))
        jd = np.asarray(jp.dist)
        np.testing.assert_array_equal(np.isinf(tp.dist.numpy()), np.isinf(jd))
        np.testing.assert_allclose(tp.dist.numpy(), jd, rtol=1e-6)
        assert tpacked.pack_graph(tg, "l2").dist is None


GRID_CASES = {
    "while_early_exit": dict(expand=2),
    "fori_capped": dict(expand=2, early_exit=False, max_iters=12),
    "interleave2": dict(expand=2, interleave=2, max_iters=10),
    "expand_schedule": dict(expand_schedule=((4, 2), (2, 8))),
}


class TestSearchParity:
    @pytest.mark.parametrize("case", sorted(GRID_CASES))
    def test_integer_grid_exact(self, grid_graphs, case):
        data, q, tg, jg = grid_graphs
        kw = dict(k=10, ef=32, metric="l2", seeds=None, **GRID_CASES[case])
        jp = jpacked.pack_graph(jg, "l2", scale=1.0)
        tp = tpacked.pack_graph(tg, "l2", scale=1.0)
        j_ids, j_d = jpacked.knn_search_packed(jg, jp, jnp.asarray(q), **kw)
        t_ids, t_d = tpacked.knn_search_packed(tg, tp, torch.from_numpy(q),
                                               **kw)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        assert (t_ids.numpy() >= 0).all()

    def test_seeded_recall_matches_jax(self, clustered_graphs):
        data, jg, tg = clustered_graphs
        q = queries_like(data, 256, seed=5)
        gt, _ = bruteforce_knn(data, q, 10)
        kw = dict(k=10, ef=64, metric="l2", expand=2, seed_e=8)
        j_ids, j_d = jpacked.knn_search_packed(
            jg, jpacked.pack_graph(jg, "l2"), jnp.asarray(q),
            seeds=jax_seed_index(jg, "l2"), **kw)
        t_ids, t_d = tpacked.knn_search_packed(
            tg, tpacked.pack_graph(tg, "l2"), torch.from_numpy(q),
            seeds=build_seed_index(tg, "l2"), **kw)
        r_j = recall(np.asarray(j_ids), gt)
        r_t = recall(t_ids.numpy(), gt)
        assert r_t >= 0.9 and abs(r_t - r_j) <= 0.01, (r_t, r_j)
        j_ids, j_d = np.asarray(j_ids), np.asarray(j_d)
        for i in range(len(q)):
            jd = dict(zip(j_ids[i].tolist(), j_d[i].tolist()))
            for tid, td in zip(t_ids[i].tolist(), t_d[i].tolist()):
                if tid in jd:
                    assert abs(td - jd[tid]) <= 1e-5 * max(1.0, abs(td))

    def test_seeded_cosine_recall_matches_jax(self):
        """ip/cosine scoring (no norms) through the same engines, on a graph
        the port built and carried into the JAX package."""
        data = clustered(3000, 24, n_clusters=24, seed=3)
        tg = bulk_build(data, HnswConfig(dim=24, M=12, metric="cosine"),
                        knn_k=24, batch=1024, device="cpu")
        jg = port_to_jax(tg)
        q = queries_like(data, 256, seed=7)
        gt, _ = bruteforce_knn(data, q, 10, metric="cosine")
        kw = dict(k=10, ef=64, metric="cosine", expand=2, seed_e=8,
                  max_iters=24, interleave=2)
        j_ids, _ = jpacked.knn_search_packed(
            jg, jpacked.pack_graph(jg, "cosine"), jnp.asarray(q),
            seeds=jax_seed_index(jg, "cosine"), **kw)
        t_ids, t_d = tpacked.knn_search_packed(
            tg, tpacked.pack_graph(tg, "cosine"), torch.from_numpy(q),
            seeds=build_seed_index(tg, "cosine"), **kw)
        r_j, r_t = recall(np.asarray(j_ids), gt), recall(t_ids.numpy(), gt)
        assert r_t >= 0.9 and abs(r_t - r_j) <= 0.01, (r_t, r_j)
        assert (t_d.numpy() >= -1e-6).all() and (t_d.numpy() <= 2.0).all()

    def test_seed_index_equals_jax(self, clustered_graphs):
        _, jg, tg = clustered_graphs
        for cap in (None, 64):
            js, ts = jax_seed_index(jg, "l2", cap=cap), \
                build_seed_index(tg, "l2", cap=cap)
            np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
            np.testing.assert_array_equal(
                ts.vecs.float().numpy(), np.asarray(js.vecs.astype(jnp.float32)))

    def test_off_path_options_raise(self, clustered_graphs):
        """knn_search_packed's checks, each a ValueError: bits=2, bits=4
        against an int8 pack (the port's own check: JAX scores such a pair
        without complaint), deg_limit on a fused pack (JAX
        `_packed_layout`), and a deg_limit whose whole
        chunk rows hold no whole neighbours (JAX fails to reshape them:
        d=768, deg=32 gives W=2048 of 768-byte neighbours)."""
        _, _, tg = clustered_graphs
        q = torch.zeros((8, 24))
        kw = dict(k=5, ef=16, metric="l2")
        tp = tpacked.pack_graph(tg, "l2")
        with pytest.raises(ValueError, match="bits"):
            tpacked.knn_search_packed(tg, tp, q, bits=2, **kw)
        with pytest.raises(ValueError, match="bits=4 pack"):
            tpacked.knn_search_packed(tg, tp, q, bits=4, **kw)
        fp = tpacked.pack_graph(tg, "l2", fused=True)
        with pytest.raises(ValueError, match="fused"):
            tpacked.knn_search_packed(tg, fp, q, fused=True, deg_limit=8,
                                      **kw)
        wide = tpacked.PackedGraph(
            pay=torch.zeros((tg.n_cap, 32, 768), dtype=torch.int8),
            meta=torch.zeros((tg.n_cap, 64), dtype=torch.int32),
            scale=torch.tensor(1.0))
        assert wide.chunk_w == 2048
        with pytest.raises(ValueError, match="whole neighbours"):
            tpacked.knn_search_packed(tg, wide, q, deg_limit=16, **kw)


# ------------------------------------------------- the beam update (K4)
def _eager_loop(packed, q8, qn, entry_ids, entry_d, ef, needs_norms,
               max_iters, expand, early_exit=True, bits=8, slots=None,
               init=None):
    """The packed beam loop as it stood before K4: a body of eager ops
    (select, K1, membership, first occurrence, merge_into_beam) per
    iteration, frozen here as the reference of the new loop shape.
    Returns the raw (pk, d, iters)."""
    from ocaml_hnsw_tpu_torch.ops.bitset import first_occurrence_mask
    from ocaml_hnsw_tpu_torch.ops.kernels.payload_score import (
        packed_score_plain,
    )
    from ocaml_hnsw_tpu_torch.ops.sortmerge import merge_into_beam

    expand = max(1, min(expand, ef))
    ar = torch.arange(1, expand + 1, dtype=torch.int32)

    def body(beam_pk, beam_d):
        unexp = (beam_pk & 1) == 0
        slot = torch.cumsum(unexp.to(torch.int32), dim=1, dtype=torch.int32)
        sel_mask = unexp & (slot <= expand)
        beam_pk = torch.where(sel_mask, beam_pk | 1, beam_pk)
        oh = sel_mask[:, None, :] & (slot[:, None, :] == ar[None, :, None])
        pos = torch.argmax(oh.to(torch.uint8), dim=2)
        active = torch.any(oh, dim=2)
        nodes = torch.where(active, torch.gather(beam_pk, 1, pos) >> 1, -1)
        cand_ids, cand_d = packed_score_plain(
            nodes, packed.meta, packed.pay, q8, qn, packed.scale,
            needs_norms, slots, bits)
        in_beam = torch.any(
            cand_ids[:, :, None] == (beam_pk >> 1)[:, None, :], dim=2)
        fresh = ((cand_ids >= 0) & ~in_beam
                 & first_occurrence_mask(cand_ids))
        cand_pk = torch.where(fresh, cand_ids * 2, -1)
        cand_d = torch.where(fresh, cand_d, float("inf"))
        beam_d, (beam_pk,) = merge_into_beam(
            beam_d, [(beam_pk, -1)], cand_d, [(cand_pk, -1)], ef)
        return beam_pk, beam_d

    pk, d = init if init is not None else tpacked._entries_to_packed_beam(
        entry_ids, entry_d, ef)
    it = 0
    while it < max_iters:
        if early_exit and not bool(torch.any((pk & 1) == 0)):
            break
        pk, d = body(pk, d)
        it += 1
    return pk, d, it


def _synthetic_pack(n=400, deg=8, d_pad=128, b=24, e0=6, bits=8, seed=0):
    """A random pack (some empty slots, many repeated neighbours), queries
    and seed entries (repeats and -1s among them)."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, n // 4, (n, deg), generator=g, dtype=torch.int32)
    ids = ids * 4 + torch.randint(0, 4, (n, 1), generator=g,
                                  dtype=torch.int32)
    ids[torch.rand((n, deg), generator=g) < 0.15] = -1
    norms = torch.randint(0, 1 << 16, (n, deg), generator=g,
                          dtype=torch.int32)
    pay = torch.randint(-127, 128, (n, deg, d_pad), generator=g,
                        dtype=torch.int8)
    packed = tpacked.PackedGraph(pay=pay, meta=torch.cat([ids, norms], 1),
                                 scale=torch.tensor(0.05))
    if bits == 8:
        q8 = torch.randint(-127, 128, (b, d_pad), generator=g,
                           dtype=torch.int8)
    else:
        q8 = (torch.randn((b, 2 * d_pad), generator=g) * 3).to(
            torch.bfloat16)
    qn = torch.rand(b, generator=g) * 100
    entry_ids = torch.randint(-1, n, (b, e0), generator=g, dtype=torch.int32)
    entry_ids[:, 1] = entry_ids[:, 0]
    entry_d = torch.rand((b, e0), generator=g) * 1e4
    return packed, q8, qn, entry_ids, entry_d


LOOP_CASES = {
    "early_exit": dict(ef=12, expand=2, max_iters=60),
    "fixed": dict(ef=16, expand=3, max_iters=7, early_exit=False),
    "slots_bits4": dict(ef=20, expand=2, max_iters=9, early_exit=False,
                        slots=5, bits=4),
    "no_iters": dict(ef=12, expand=2, max_iters=0),
}


class TestBeamUpdate:
    """The loop shape of K4 (one selection, then K1 + `beam_update` per
    iteration, no selection after the last) through `beam_update_plain`,
    against the eager body it replaced; the plain version on edge rows;
    the wrapper's checks.  The kernel itself is held to the plain version
    on the card by `chip_smoke.py --beam-update`."""

    @pytest.mark.parametrize("case", sorted(LOOP_CASES))
    def test_loop_equals_eager_body(self, case):
        kw = dict(LOOP_CASES[case])
        bits = kw.pop("bits", 8)
        packed, q8, qn, e_ids, e_d = _synthetic_pack(bits=bits)
        pk, d, it = tpacked.beam_search_layer_packed(
            packed, q8, qn, e_ids, e_d, needs_norms=True, raw_state=True,
            bits=bits, **kw)
        r_pk, r_d, r_it = _eager_loop(packed, q8, qn, e_ids, e_d,
                                     needs_norms=True, bits=bits, **kw)
        assert torch.equal(pk, r_pk) and torch.equal(d, r_d) and it == r_it
        if case == "early_exit":
            assert 0 < it < kw["max_iters"]  # the exit check ended it

    @pytest.mark.parametrize("ways", [1, 2])
    def test_schedule_and_interleave_equal_eager_body(self, ways):
        """expand_schedule's phases carry raw state (expanded flags) from
        one to the next; the interleaved loop runs each half for exactly
        max_iters."""
        packed, q8, qn, e_ids, e_d = _synthetic_pack(seed=1)
        ef, phases = 16, ((4, 2), (2, 5), (1, 3))
        if ways == 1:
            state = ref = None
            for e_p, mi_p in phases:
                state = tpacked.beam_search_layer_packed(
                    packed, q8, qn, e_ids, e_d, ef, True, mi_p, expand=e_p,
                    early_exit=False, raw_state=True,
                    init_pk=None if state is None else state[0],
                    init_d=None if state is None else state[1])
                ref = _eager_loop(packed, q8, qn, e_ids, e_d, ef, True, mi_p,
                                 e_p, early_exit=False,
                                 init=None if ref is None else ref[:2])
                assert all(torch.equal(a, b) for a, b in zip(state[:2],
                                                             ref[:2]))
            return
        ids, d, it = tpacked.beam_search_layer_packed_duo(
            packed, q8, qn, e_ids, e_d, ef, True, 6, expand=2, ways=2)
        h = q8.shape[0] // 2
        for s in (slice(0, h), slice(h, None)):
            r_pk, r_d, r_it = _eager_loop(packed, q8[s], qn[s], e_ids[s],
                                         e_d[s], ef, True, 6, 2,
                                         early_exit=False)
            assert torch.equal(ids[s], r_pk >> 1) and torch.equal(d[s], r_d)
        assert it == 6

    @staticmethod
    def _edge_batch(case):
        """(beam_pk, beam_d, cand_ids, cand_d, expand) of one edge case,
        ef not a power of two, C neither."""
        inf = float("inf")
        ef, c = 6, 5
        ids = torch.tensor([[10, 11, 12, 13, -1, -1]], dtype=torch.int32)
        flags = torch.tensor([[1, 0, 1, 0, 1, 1]], dtype=torch.int32)
        beam_d = torch.tensor([[1.0, 2.0, 3.0, 4.0, inf, inf]])
        cand = torch.tensor([[20, 21, 22, 23, 24]], dtype=torch.int32)
        cand_d = torch.tensor([[2.5, 0.5, 9.0, 3.5, 1.5]])
        if case == "all_empty":
            cand = torch.full((1, c), -1, dtype=torch.int32)
            cand_d = torch.full((1, c), inf)
        elif case == "repeats":  # the first of an id keeps its distance
            cand = torch.tensor([[20, 21, 20, 21, 20]], dtype=torch.int32)
            cand_d = torch.tensor([[2.5, 0.5, 0.1, 0.2, 0.3]])
        elif case == "in_beam":
            cand = torch.tensor([[11, 10, 20, 13, 12]], dtype=torch.int32)
        elif case == "ties":
            cand_d = torch.tensor([[2.0, 2.0, 1.0, 2.0, 9.0]])
        elif case == "expanded":
            flags = torch.ones_like(flags)
            cand = torch.tensor([[10, 11, -1, 13, 12]], dtype=torch.int32)
        beam_pk = torch.where(ids < 0, -1, ids * 2 + flags)
        assert beam_pk.shape == (1, ef) and cand.shape == (1, c)
        return beam_pk, beam_d, cand, cand_d, 3

    @pytest.mark.parametrize("case", ["all_empty", "repeats", "in_beam",
                                      "ties", "expanded", "plain"])
    def test_edge_rows(self, case):
        """Against a direct reading of the rules: the beam's entries and
        the fresh candidates (id >= 0, not in the beam, first of its id),
        the best ef ascending (ties: as a set, the order is the network's);
        then the first E unexpanded entries selected in beam order."""
        from ocaml_hnsw_tpu_torch.ops.kernels.beam_update import (
            beam_update, beam_update_plain,
        )

        beam_pk, beam_d, cand, cand_d, e = self._edge_batch(case)
        ef = beam_pk.shape[1]
        pk0, d0, none = beam_update(beam_pk, beam_d, cand, cand_d, expand=e,
                                    select_next=False)
        assert none is None
        entries = [(d, p) for d, p in zip(beam_d[0].tolist(),
                                          beam_pk[0].tolist()) if p >= 0]
        seen = {p >> 1 for _, p in entries}
        for i, d in zip(cand[0].tolist(), cand_d[0].tolist()):
            if i >= 0 and i not in seen:
                entries.append((d, 2 * i))
                seen.add(i)
        entries = sorted(entries, key=lambda t: t[0])[:ef]
        entries += [(float("inf"), -1)] * (ef - len(entries))
        assert d0[0].tolist() == [d for d, _ in entries]
        if case == "ties":
            assert sorted(zip(d0[0].tolist(), pk0[0].tolist())) \
                == sorted(entries)
        else:
            assert pk0[0].tolist() == [p for _, p in entries]
        pk1, d1, nodes = beam_update_plain(beam_pk, beam_d, cand, cand_d,
                                           expand=e)
        assert torch.equal(d1, d0)
        unexp = [i for i, p in enumerate(pk0[0].tolist())
                 if p >= 0 and not p & 1][:e]
        want = pk0.clone()
        want[0, unexp] |= 1
        assert torch.equal(pk1, want)
        assert nodes[0].tolist() == ([int(pk0[0, i]) >> 1 for i in unexp]
                                     + [-1] * (e - len(unexp)))
        if case == "expanded":
            assert nodes[0].tolist() == [-1] * e
        # the selection alone: the same nodes, the distances untouched
        pk2, d2, nodes2 = beam_update(pk0, d0, expand=e)
        assert torch.equal(pk2, pk1) and d2 is d0
        assert torch.equal(nodes2, nodes)

    @pytest.mark.parametrize("bad", ["pk_dtype", "d_dtype", "cand_dtype",
                                     "shape", "cand_rows", "device",
                                     "too_wide", "no_select", "expand"])
    def test_wrapper_raises(self, bad):
        from ocaml_hnsw_tpu_torch.ops.kernels.beam_update import beam_update

        pk = torch.zeros((4, 8), dtype=torch.int32)
        d = torch.zeros((4, 8))
        ci = torch.zeros((4, 6), dtype=torch.int32)
        cd = torch.zeros((4, 6))
        kw = dict(expand=2)
        err = ValueError
        if bad == "pk_dtype":
            pk, err = pk.long(), TypeError
        elif bad == "d_dtype":
            d, err = d.double(), TypeError
        elif bad == "cand_dtype":
            cd, err = cd.half(), TypeError
        elif bad == "shape":
            d = d[:, :7]
        elif bad == "cand_rows":
            ci, cd = ci[:3], cd[:3]
        elif bad == "device":
            ci = ci.to("meta")
        elif bad == "too_wide":
            ci = torch.zeros((4, 4097), dtype=torch.int32)
            cd = torch.zeros((4, 4097))
        elif bad == "no_select":
            ci = cd = None
            kw["select_next"] = False
        elif bad == "expand":
            kw["expand"] = 0
        with pytest.raises(err):
            beam_update(pk, d, ci, cd, **kw)
