"""Query-graph distillation of the torch port (`models/refine.py`) against
the JAX package's (`ocaml_hnsw_tpu/models/refine.py`).

  * Integer-grid data (|x| <= 7): every distance, pairwise distance and
    admit comparison is exact in f32 in both packages, and the bitonic
    networks order ties alike, so the distilled ids are EXACTLY equal, for
    hops 0 and 1.
  * Clustered real-valued data: >= 99% of rows identical (R7: f32
    summation order in the distances moves a near-tie now and then); both
    JAX calls share one compile with the grid case (same shapes).
  * The port alone mirrors tests/test_refine.py: no duplicates or
    self-edges, -1 padding at the tail, hops=0 rows a subset of the build
    rows, rows distance-ascending, full rows where the source row was
    full, and the half-degree packed engine's recall within 0.03 of the
    full-degree one's.
  * The result does not depend on the slab size (the port walks fixed
    slabs with a ragged last one; JAX divides N_cap into power-of-two
    slabs).
Graphs are built by the port and carried into the JAX package with
`graph_to_numpy`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocaml_hnsw_tpu.models.graph import GraphTensors as JaxGraph
from ocaml_hnsw_tpu.models.refine import refine_adjacency as jax_refine
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn, recall

from ocaml_hnsw_tpu_torch.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models.bulk import bulk_build
from ocaml_hnsw_tpu_torch.models.graph import graph_to_numpy
from ocaml_hnsw_tpu_torch.models.packed import knn_search_packed, pack_graph
from ocaml_hnsw_tpu_torch.models.refine import refine_adjacency, refined_graph
from ocaml_hnsw_tpu_torch.models.search import build_seed_index

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA; the port's
# tests are small, and the lane runs about 2.5x faster this way.
torch.set_num_threads(1)

N, DIM, OUT = 2000, 16, 8  # M=8: M_max0 = 16 build edges -> 8


def port_to_jax(g):
    arrays = graph_to_numpy(g)
    return JaxGraph(**{f: jnp.asarray(a) for f, a in arrays.items()},
                    l_max_static=g.l_max_static)


def _build(data):
    return bulk_build(data, HnswConfig(dim=DIM, M=8), knn_k=16, batch=512,
                      device="cpu")


@pytest.fixture(scope="module")
def grid_graph():
    rng = np.random.RandomState(21)
    centers = rng.randint(-4, 5, size=(12, DIM))
    data = np.clip(centers[rng.randint(0, 12, size=N)]
                   + rng.randint(-3, 4, size=(N, DIM)), -7, 7)
    return _build(data.astype(np.float32))


@pytest.fixture(scope="module")
def real_graph():
    return _build(clustered(N, DIM, n_clusters=16, seed=4))


@pytest.fixture(scope="module")
def std_graph():
    """tests/test_refine.py's configuration: 4000 x 24, M=12."""
    data = clustered(4000, 24, n_clusters=32, seed=1)
    g = bulk_build(data, HnswConfig(dim=24, M=12, ef_construction=80),
                   knn_k=24, batch=1024, device="cpu")
    return data, g


class TestAgainstJax:
    @pytest.mark.parametrize("hops", [0, 1])
    def test_integer_grid_exact(self, grid_graph, hops):
        got = refine_adjacency(grid_graph, OUT, "l2", slab=512, hops=hops)
        want = np.asarray(jax_refine(port_to_jax(grid_graph), OUT, "l2",
                                     slab=512, hops=hops))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy()[:N] >= 0).sum() > 0.5 * N * OUT  # not empty

    def test_real_data_rows_agree(self, real_graph):
        got = refine_adjacency(real_graph, OUT, "l2", slab=512).numpy()
        want = np.asarray(jax_refine(port_to_jax(real_graph), OUT, "l2",
                                     slab=512))
        same = (got == want).all(axis=1)
        assert same.mean() >= 0.99, same.mean()

    def test_early_return(self, grid_graph):
        assert refine_adjacency(grid_graph, 16, "l2") is grid_graph.adj0
        assert refine_adjacency(grid_graph, 20, "l2", hops=0) \
            is grid_graph.adj0


class TestPortInvariants:
    """tests/test_refine.py's checks, on the port's own graph."""

    @pytest.mark.parametrize("hops", [0, 1])
    def test_invariants(self, std_graph, hops):
        _, g = std_graph
        out_deg = 12
        refined = refine_adjacency(g, out_deg, "l2", slab=512,
                                   hops=hops).numpy()
        n = int(g.n)
        adj = g.adj0.numpy()
        assert refined.shape == (g.n_cap, out_deg)
        for i in range(0, n, 97):
            row = refined[i]
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live)
            assert i not in live
            assert (live < n).all()
            if hops == 0:
                assert set(live.tolist()) <= set(adj[i][adj[i] >= 0].tolist())
            if len(live) < out_deg:
                assert (row[len(live):] == -1).all()
        assert (refined[n:] == -1).all()

    def test_rows_distance_ascending_and_full(self, std_graph):
        _, g = std_graph
        refined = refine_adjacency(g, 12, "l2", slab=512).numpy()
        vecs = g.vectors.numpy()
        for i in range(0, int(g.n), 211):
            live = refined[i][refined[i] >= 0]
            d = ((vecs[live] - vecs[i]) ** 2).sum(-1)
            assert (np.diff(d) >= -1e-5).all()
        n = int(g.n)
        src_deg = (g.adj0.numpy()[:n] >= 0).sum(1)
        ref_deg = (refined[:n] >= 0).sum(1)
        assert (ref_deg[src_deg >= 12] == 12).all()

    def test_distilled_half_degree_recall(self, std_graph):
        data, g = std_graph
        queries = queries_like(data, 200, seed=5)
        gt, _ = bruteforce_knn(data, queries, 10)
        seeds = build_seed_index(g, "l2")
        q = torch.from_numpy(queries)
        ids_full, _ = knn_search_packed(g, pack_graph(g, "l2"), q, k=10,
                                        ef=64, metric="l2", max_iters=24,
                                        seeds=seeds, seed_e=8)
        half = refined_graph(g, 12, "l2", slab=512)
        assert half.adj0.shape == (g.n_cap, 12) and half.adj_up is g.adj_up
        hp = pack_graph(half, "l2")
        assert hp.pay.shape[1] == 12
        ids_half, _ = knn_search_packed(half, hp, q, k=10, ef=64,
                                        metric="l2", max_iters=30,
                                        seeds=seeds, seed_e=8)
        r_full = recall(ids_full.numpy(), gt)
        r_half = recall(ids_half.numpy(), gt)
        assert r_full >= 0.9
        assert r_half >= r_full - 0.03, (r_half, r_full)

    def test_refined_graph_crosses_packages(self, real_graph):
        """A half-width adj0 goes through graph_to_numpy / graph_from_numpy,
        and the JAX pack_graph of it has the port's bytes."""
        from ocaml_hnsw_tpu.models.packed import pack_graph as jax_pack
        from ocaml_hnsw_tpu_torch.models.graph import graph_from_numpy
        from ocaml_hnsw_tpu_torch.models.packed import packed_from_numpy

        half = refined_graph(real_graph, OUT, "l2")
        back = graph_from_numpy(graph_to_numpy(half), half.l_max_static,
                                "cpu")
        assert torch.equal(back.adj0, half.adj0)
        jp = jax_pack(port_to_jax(half), "l2")
        tp = pack_graph(half, "l2")
        fp = packed_from_numpy(jp.pay, jp.meta, jp.scale, "cpu")
        assert tp.deg == OUT and torch.equal(tp.pay, fp.pay)
        assert torch.equal(tp.meta, fp.meta) and tp.chunk_w == fp.chunk_w

    def test_slab_size_does_not_matter(self, real_graph):
        want = refine_adjacency(real_graph, OUT, "l2", slab=4096, hops=1)
        for slab in (512, 1000, 777):
            got = refine_adjacency(real_graph, OUT, "l2", slab=slab, hops=1)
            assert torch.equal(got, want), slab
