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
