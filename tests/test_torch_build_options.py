"""The port's build options against the JAX package's builds: the int8-scan
bulk build (`bulk_build(scan_dtype="int8")`) and `models/build.py::build`.
These are the two JAX reference builds of the module.

  * int8 bulk build, 2000 x 32 clustered rows, L2, M=8, knn_k=32, node 0
    at level 0 (R8: JAX's upper levels drop node 0's reverse edges).  The
    levels and arena must be equal.  The port's build runs on the JAX
    layer-0 kNN table (its upper levels on its own int8 tables, which
    rerank every candidate of a few hundred nodes exactly).  Its pairwise
    f32 distances are summed in another order than XLA's, so an admit at
    a near-tie may flip (one does here, at a relative margin of 6e-6), and
    a flipped forward edge also moves reverse edges in other rows: edge
    agreement must be >= 99.9% on both layers (R10's tolerance is 99%),
    and recall equal to JAX's within 0.01.  The port's own
    int8 kNN table must agree with JAX's on >= 99.5% of ids and its
    distances to 1e-4, as the bf16 table does.
  * `build()`, 1000 x 24, M=8, efC=60, round 128: the port visits the same
    rounds with the same levels; the stated tolerance is that of
    `tests/test_torch_incremental.py` (seed-scan ties, R10): edge agreement
    >= 99% and recall within 0.01 of the JAX graph's.
"""

import numpy as np
import pytest
import torch

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.config import HnswConfig as JaxConfig
from ocaml_hnsw_tpu.models import build as jbuild
from ocaml_hnsw_tpu.models import bulk as jbulk

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import build as tbuild
from ocaml_hnsw_tpu_torch.models import bulk as tbulk
from ocaml_hnsw_tpu_torch.models.graph import GraphTensors, graph_from_numpy
from ocaml_hnsw_tpu_torch.models.search import knn_search

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

N, DIM, M, KNN_K, BATCH = 2000, 32, 8, 32, 512
EDGE_AGREEMENT = 0.999
B_N, B_DIM, B_RS = 1000, 24, 128
B_CFG = dict(dim=B_DIM, M=8, ef_construction=60)


def _as_port(jg):
    return graph_from_numpy({f: np.asarray(getattr(jg, f))
                             for f in GraphTensors._fields},
                            jg.l_max_static, "cpu")


def _recall(graph, data, q, ef=64):
    d = ((q * q).sum(1)[:, None] - 2.0 * q @ data.T
         + (data * data).sum(1)[None, :])
    gt = np.argsort(d, axis=1)[:, :10]
    ids = knn_search(graph, torch.from_numpy(q), k=10, ef=ef,
                     metric="l2")[0].numpy()
    return np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(ids.tolist(), gt.tolist())])


def _edge_agreement(a, b):
    out = []
    for x, y in zip(a, b):
        sx, sy = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(sx & sy) / len(sx) if sx else float(not sy))
    return float(np.mean(out))


# ------------------------------------------------- int8-scan bulk build
@pytest.fixture(scope="module")
def data():
    return clustered(N, DIM, n_clusters=16, seed=3)


@pytest.fixture(scope="module")
def levels():
    rng = np.random.RandomState(100)
    lv = jbuild.sample_levels(rng, N, JaxConfig(dim=DIM, M=M).mL,
                              JaxConfig(dim=DIM, M=M).derived_max_level(N))
    lv[0] = 0  # R8
    return lv


@pytest.fixture(scope="module")
def jax_int8(data, levels):
    """JAX's int8 bulk graph and the layer-0 kNN table it was built on."""
    tables = []
    real = jbulk.knn_table

    def recording(*args, **kwargs):
        tables.append(real(*args, **kwargs))
        return tables[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(jbulk, "knn_table", recording)
    try:
        g = jbulk.bulk_build(data, JaxConfig(dim=DIM, M=M), knn_k=KNN_K,
                             batch=BATCH, scan_dtype="int8", levels=levels)
    finally:
        mp.undo()
    ids, d = tables[0]
    return g, (torch.from_numpy(np.array(ids)), torch.from_numpy(np.array(d)))


@pytest.fixture(scope="module")
def port_int8_on_jax_knn(data, levels, jax_int8):
    layer0 = jax_int8[1]
    real = tbulk.knn_table
    flats = []

    def tables(flat, rows, k, metric, batch=1024, rerank_pad=32):
        flats.append(flat.scan.dtype)
        if rows.shape[0] == N and k == KNN_K:
            return layer0[0].clone(), layer0[1].clone()
        return real(flat, rows, k, metric, batch, rerank_pad)

    mp = pytest.MonkeyPatch()
    mp.setattr(tbulk, "knn_table", tables)
    try:
        g = tbulk.bulk_build(data, HnswConfig(dim=DIM, M=M), knn_k=KNN_K,
                             batch=BATCH, scan_dtype="int8", levels=levels,
                             device="cpu")
    finally:
        mp.undo()
    return g, flats


class TestInt8BulkBuild:
    def test_every_knn_table_scans_int8(self, port_int8_on_jax_knn):
        g, flats = port_int8_on_jax_knn
        lv = g.levels.numpy()[:N]
        # layer 0, and each upper level of two nodes or more
        assert len(flats) == 1 + sum(int((lv >= l).sum() >= 2)
                                     for l in range(1, int(lv.max()) + 1))
        assert all(dt == torch.int8 for dt in flats)

    def test_same_levels_and_arena(self, jax_int8, port_int8_on_jax_knn):
        j, t = jax_int8[0], port_int8_on_jax_knn[0]
        assert int(t.levels[0]) == 0 and int(t.max_level) >= 2
        for f in ("levels", "up_base", "up_n", "entry", "max_level", "n",
                  "vectors", "scales"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f)

    def test_adjacency_equals_jax(self, jax_int8, port_int8_on_jax_knn):
        j, t = jax_int8[0], port_int8_on_jax_knn[0]
        assert _edge_agreement(t.adj0.numpy()[:N],
                               np.asarray(j.adj0)[:N]) >= EDGE_AGREEMENT
        rows = int(np.asarray(j.up_n))
        assert _edge_agreement(t.adj_up.numpy()[:rows],
                               np.asarray(j.adj_up)[:rows]) >= EDGE_AGREEMENT

    def test_int8_knn_table_agrees_with_jax(self, data, jax_int8):
        x = torch.from_numpy(data)
        flat = tbulk.flat_from_rows(x, "l2", scan_dtype="int8")
        assert flat.scan.dtype == torch.int8
        ids, d = tbulk.knn_table(flat, x, KNN_K, "l2", batch=BATCH)
        j_ids, j_d = jax_int8[1]
        agree = (ids.numpy() == j_ids.numpy()).mean()
        assert agree >= 0.995, agree
        assert (ids.numpy() != np.arange(N)[:, None]).all()
        np.testing.assert_allclose(d.numpy(), j_d.numpy(), rtol=1e-4,
                                   atol=1e-4)

    def test_own_int8_build_serves_as_jax_graph(self, data, levels,
                                                jax_int8, capsys):
        own = tbulk.bulk_build(data, HnswConfig(dim=DIM, M=M), knn_k=KNN_K,
                               batch=BATCH, scan_dtype="int8", levels=levels,
                               device="cpu", verbose=True)
        out = capsys.readouterr().out
        assert "bulk layer0 kNN" in out and "bulk total" in out
        q = queries_like(data, 200, seed=5)
        r_own, r_ref = _recall(own, data, q), _recall(_as_port(jax_int8[0]),
                                                       data, q)
        assert r_own >= 0.9 and abs(r_own - r_ref) <= 0.01, (r_own, r_ref)


def test_flat_from_rows_chunks_change_nothing(data):
    x = torch.from_numpy(data)
    whole = tbulk.flat_from_rows(x, "l2", scan_dtype="int8")
    pieces = tbulk.flat_from_rows(x, "l2", scan_dtype="int8", chunk=300)
    for f in ("scan", "scales", "rerank", "norms", "n"):
        assert torch.equal(getattr(whole, f), getattr(pieces, f)), f


# --------------------------------------------------------------- build()
@pytest.fixture(scope="module")
def build_data():
    return clustered(B_N, B_DIM, n_clusters=24, seed=0)


@pytest.fixture(scope="module")
def jax_built(build_data):
    mp = pytest.MonkeyPatch()
    # per-round dispatch: one compiled program, not the lax.scan chunks too
    mp.setattr(jbuild.BuildState, "SCAN_CHUNKS", ())
    try:
        return jbuild.build(build_data, JaxConfig(**B_CFG), round_size=B_RS)
    finally:
        mp.undo()


def test_build_matches_jax(build_data, jax_built):
    t = tbuild.build(build_data, HnswConfig(**B_CFG), round_size=B_RS,
                     device="cpu")
    j = jax_built
    for f in ("levels", "up_base", "up_n", "n"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert int(t.n) == B_N
    assert _edge_agreement(t.adj0.numpy()[:B_N],
                           np.asarray(j.adj0)[:B_N]) >= 0.99
    assert _edge_agreement(t.adj_up.numpy(), np.asarray(j.adj_up)) >= 0.99
    q = queries_like(build_data, 200, seed=2)
    r_t, r_j = _recall(t, build_data, q), _recall(_as_port(j), build_data, q)
    assert r_t >= 0.95 and abs(r_t - r_j) <= 0.01, (r_t, r_j)
    t2 = tbuild.build(torch.from_numpy(build_data), HnswConfig(**B_CFG),
                      round_size=B_RS, device="cpu")
    assert torch.equal(t.adj0, t2.adj0) and torch.equal(t.adj_up, t2.adj_up)
