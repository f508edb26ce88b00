"""Bulk constructor of the torch port against the JAX package's
(`ocaml_hnsw_tpu/models/bulk.py`) at the shapes `tests/test_bulk.py` uses
(n=4000, dim=24, M=12, knn_k=24, batch=1024).

The kNN table is the one input where the packages may legitimately differ
(exact torch top-k vs `approx_min_k`, summation order of the rerank), so
the construction passes are held against the JAX package on the JAX kNN
table: with it, select → reverse → merge must give the same adjacency.
The Alg-4 pairwise distances are f32 matmuls summed in another order, so a
near-tie may flip one admit; up to 0.1% of rows may differ for that reason
alone."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu.bench.datasets import clustered
from ocaml_hnsw_tpu.config import HnswConfig as JaxConfig
from ocaml_hnsw_tpu.models import bulk as jbulk
from ocaml_hnsw_tpu.models.build import sample_levels as jax_sample_levels

from ocaml_hnsw_tpu_torch.bench.datasets import queries_like
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import bulk as tbulk
from ocaml_hnsw_tpu_torch.models.graph import GraphTensors, graph_from_numpy
from ocaml_hnsw_tpu_torch.models.search import knn_search

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA; the port's
# tests are small, and the lane runs about 2.5x faster this way.
torch.set_num_threads(1)

N, DIM, M, KNN_K, BATCH = 4000, 24, 12, 24, 1024
ROW_FLIP_SHARE = 1e-3  # f32 near-tie admits (module docstring)


def _reverse_reference(fwd, d, n, cap):
    """Row t: the sources of its `cap` nearest incoming edges, ascending."""
    out = []
    for t in range(n):
        inc = sorted((d[v, j], v) for v in range(fwd.shape[0])
                     for j in range(fwd.shape[1]) if fwd[v, j] == t)[:cap]
        out.append(inc)
    return out


class TestReverseScatter:
    def test_matches_numpy_reference(self):
        rng = np.random.RandomState(0)
        r, m, n, cap = 500, 6, 40, 5
        fwd = rng.randint(-1, n, size=(r, m)).astype(np.int32)
        d = rng.rand(r, m).astype(np.float32)
        rev, rev_d = tbulk.reverse_scatter(torch.from_numpy(fwd),
                                           torch.from_numpy(d), n, cap)
        rev, rev_d = rev.numpy(), rev_d.numpy()
        assert rev.shape == (n, cap)
        for t, inc in enumerate(_reverse_reference(fwd, d, n, cap)):
            got = [(rev_d[t, i], rev[t, i]) for i in range(cap)
                   if rev[t, i] >= 0]
            assert [(float(a), int(b)) for a, b in inc] == \
                [(float(a), int(b)) for a, b in got]

    @pytest.mark.parametrize("levels", [None, 4])
    def test_equals_jax_including_ties(self, levels):
        """Exact equality with the JAX sort-scatter, also when distances
        tie (then the source id orders, as the JAX key does)."""
        rng = np.random.RandomState(3)
        fwd = rng.randint(-1, 64, size=(256, 4)).astype(np.int32)
        d = rng.rand(256, 4).astype(np.float32)
        if levels:
            d = (rng.randint(0, levels, size=d.shape) / levels).astype(np.float32)
        j = jbulk.reverse_scatter(jnp.asarray(fwd), jnp.asarray(d), 64, 6)
        t = tbulk.reverse_scatter(torch.from_numpy(fwd), torch.from_numpy(d),
                                  64, 6)
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))


def _jax_knn_table(flat, rows, k, metric, batch=1024, rerank_pad=32):
    """Stand-in for the port's knn_table: the JAX package's kNN table over
    the same rows and occupied count (what the port's flat holds)."""
    rows_np = rows.numpy()
    jflat = jbulk.flat_from_rows(jnp.asarray(rows_np), metric,
                                 n_valid=int(flat.n))
    ids, d = jbulk.knn_table(jflat, jnp.asarray(rows_np), k, metric,
                             batch=batch, rerank_pad=rerank_pad)
    return torch.from_numpy(np.array(ids)), torch.from_numpy(np.array(d))


@pytest.fixture(scope="module")
def data():
    return clustered(N, DIM, n_clusters=32, seed=1)


@pytest.fixture(scope="module")
def jax_build(data):
    """The JAX reference graph, and the layer-0 kNN table it was built on
    (kept, so the tests below need not compute it again)."""
    tables = []

    def recording(*args, **kwargs):
        tables.append(real(*args, **kwargs))
        return tables[-1]

    real = jbulk.knn_table
    mp = pytest.MonkeyPatch()
    mp.setattr(jbulk, "knn_table", recording)
    try:
        g = jbulk.bulk_build(data, JaxConfig(dim=DIM, M=M,
                                             ef_construction=80),
                             knn_k=KNN_K, batch=BATCH)
    finally:
        mp.undo()
    ids, d = tables[0]
    return g, (torch.from_numpy(np.array(ids)), torch.from_numpy(np.array(d)))


@pytest.fixture(scope="module")
def jax_graph(jax_build):
    return jax_build[0]


@pytest.fixture(scope="module")
def port_on_jax_knn(data, jax_build):
    """The port's build on the JAX kNN tables: layer 0's as the JAX build
    made it, the upper levels' through `_jax_knn_table`."""
    layer0 = jax_build[1]

    def jax_tables(flat, rows, k, metric, batch=1024, rerank_pad=32):
        if rows.shape[0] == N and k == KNN_K:
            return layer0[0].clone(), layer0[1].clone()
        return _jax_knn_table(flat, rows, k, metric, batch, rerank_pad)

    mp = pytest.MonkeyPatch()
    mp.setattr(tbulk, "knn_table", jax_tables)
    try:
        return tbulk.bulk_build(data, HnswConfig(dim=DIM, M=M,
                                                 ef_construction=80),
                                knn_k=KNN_K, batch=BATCH, device="cpu")
    finally:
        mp.undo()


class TestConstructionParity:
    def test_same_levels_and_arena(self, jax_graph, port_on_jax_knn):
        j, t = jax_graph, port_on_jax_knn
        for f in ("levels", "up_base", "up_n", "entry", "max_level", "n"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), err_msg=f)
        assert t.l_max_static == j.l_max_static
        rng = np.random.RandomState(100)
        want = jax_sample_levels(rng, N, JaxConfig(dim=DIM, M=M).mL,
                                 j.l_max_static)
        np.testing.assert_array_equal(t.levels.numpy()[:N], want)

    def test_same_stored_rows(self, jax_graph, port_on_jax_knn):
        for f in ("vectors", "scales", "deleted"):
            np.testing.assert_array_equal(
                getattr(port_on_jax_knn, f).numpy(),
                np.asarray(getattr(jax_graph, f)), err_msg=f)
        # ‖x‖² sums 24 squares in another order: a few ulp
        np.testing.assert_allclose(port_on_jax_knn.norms.numpy(),
                                   np.asarray(jax_graph.norms), rtol=1e-6)

    def test_adj0_equals_jax(self, jax_graph, port_on_jax_knn):
        a = port_on_jax_knn.adj0.numpy()
        b = np.asarray(jax_graph.adj0)
        diff = (a != b).any(axis=1).sum()
        assert diff <= ROW_FLIP_SHARE * N, f"{diff} of {N} rows differ"

    def test_adj_up_equals_jax(self, jax_graph, port_on_jax_knn):
        a = port_on_jax_knn.adj_up.numpy()
        b = np.asarray(jax_graph.adj_up)
        rows = int(np.asarray(jax_graph.up_n))
        diff = (a != b).any(axis=1).sum()
        assert diff <= max(1, ROW_FLIP_SHARE * rows), \
            f"{diff} of {rows} arena rows differ"


class TestOwnKnnTable:
    def test_knn_table_agrees_with_jax(self, data, jax_build):
        x = torch.from_numpy(data)
        flat = tbulk.flat_from_rows(x, "l2")
        ids, d = tbulk.knn_table(flat, x, KNN_K, "l2", batch=BATCH)
        j_ids, j_d = jax_build[1]
        agree = (ids.numpy() == j_ids.numpy()).mean()
        assert agree >= 0.995, agree
        assert (ids.numpy() != np.arange(N)[:, None]).all()  # self excluded
        np.testing.assert_allclose(d.numpy(), j_d.numpy(), rtol=1e-4,
                                   atol=1e-4)

    def test_own_build_structure(self, data):
        g = tbulk.bulk_build(data, HnswConfig(dim=DIM, M=M), knn_k=KNN_K,
                             batch=BATCH, device="cpu")
        adj0 = g.adj0.numpy()
        assert adj0.shape == (4096, 2 * M)
        for i in range(0, N, 97):
            row = adj0[i][adj0[i] >= 0]
            assert len(set(row.tolist())) == len(row) and i not in row
            assert (row < N).all()
        levels = g.levels.numpy()[:N]
        assert levels[int(g.entry)] == int(g.max_level)
        g2 = tbulk.bulk_build(data, HnswConfig(dim=DIM, M=M), knn_k=KNN_K,
                              batch=BATCH, device="cpu")
        assert torch.equal(g.adj0, g2.adj0) and torch.equal(g.adj_up,
                                                             g2.adj_up)

    def test_own_build_recall_matches_jax_build(self, data, jax_graph):
        """The port's build on its own kNN table serves queries as well as
        the graph the JAX package built from the same rows: recall@10 of
        one search (the port's classic engine, ef=64) over either graph,
        against exact neighbours, within 0.01."""
        own = tbulk.bulk_build(data, HnswConfig(dim=DIM, M=M,
                                                ef_construction=80),
                               knn_k=KNN_K, batch=BATCH, device="cpu")
        ref = graph_from_numpy(
            {f: getattr(jax_graph, f) for f in GraphTensors._fields},
            jax_graph.l_max_static, "cpu")
        q = queries_like(data, 300, seed=5)
        d = ((q * q).sum(1)[:, None] - 2.0 * q @ data.T
             + (data * data).sum(1)[None, :])
        gt = np.argsort(d, axis=1)[:, :10]

        def recall(graph):
            ids = knn_search(graph, torch.from_numpy(q), k=10, ef=64,
                             metric="l2")[0].numpy()
            return np.mean([len(set(a) & set(b)) / 10
                            for a, b in zip(ids.tolist(), gt.tolist())])

        r_own, r_ref = recall(own), recall(ref)
        assert r_own >= 0.9 and abs(r_own - r_ref) <= 0.01, (r_own, r_ref)


def test_host_data_builds_on_the_card_by_default():
    """A host array with no device given goes to "cuda", which raises when
    there is no CUDA device: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    data = clustered(300, 8, n_clusters=4, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbulk.bulk_build(data, HnswConfig(dim=8, M=4), knn_k=8)
