"""The public names the torch port adds to match the JAX package, held to
the JAX package function by function on seeded NumPy inputs (no JAX build):
the metric record's `np_pair_dist` (P7), `config.METRICS`,
`dequantize_gathered`, the package re-exports, `UpperView.deg`,
`PackedGraph.chunks`, the device defaults of `empty_graph` /
`empty_packed`, the packed beam's `deg_limit` / `fused` keywords,
`select_neighbors(scan_limit=)` and BuildState's build knobs.

Tolerances: exact everywhere.  `select_neighbors` sums its pairwise f32
products in another order than XLA, which could flip an admit only at a
near-tie; the seeded inputs here have none."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ocaml_hnsw_tpu.config as jconfig
import ocaml_hnsw_tpu.models as jmodels
import ocaml_hnsw_tpu.ops as jops
from ocaml_hnsw_tpu.config import HnswConfig as JaxConfig
from ocaml_hnsw_tpu.models import build as jbuild
from ocaml_hnsw_tpu.models import graph as jgraph
from ocaml_hnsw_tpu.models import packed as jpacked
from ocaml_hnsw_tpu.ops import distance as jdist
from ocaml_hnsw_tpu.ops import metrics as jmetrics
from ocaml_hnsw_tpu.ops import quantize as jquant

import ocaml_hnsw_tpu_torch.config as tconfig
import ocaml_hnsw_tpu_torch.models as tmodels
import ocaml_hnsw_tpu_torch.ops as tops
from ocaml_hnsw_tpu_torch.bench.datasets import clustered
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import build as tbuild
from ocaml_hnsw_tpu_torch.models import bulk as tbulk
from ocaml_hnsw_tpu_torch.models import graph as tgraph
from ocaml_hnsw_tpu_torch.models import packed as tpacked
from ocaml_hnsw_tpu_torch.ops import distance as tdist
from ocaml_hnsw_tpu_torch.ops import metrics as tmetrics
from ocaml_hnsw_tpu_torch.ops import quantize as tquant

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="a CUDA device is present: nothing to "
                                    "refuse")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _l1(rows, q):
    return abs(rows - q[..., None, :]).sum(-1)


def _l1_np(rows, q):
    return np.abs(rows - q[..., None, :]).sum(-1) + 0.5  # tells them apart


# ------------------------------------------------------------ P7, METRICS
class TestMetricRecord:
    def test_np_pair_dist_is_stored_and_used(self):
        rows = np.random.RandomState(0).rand(3, 5, 4).astype(np.float32)
        q = np.random.RandomState(1).rand(3, 4).astype(np.float32)
        m = tmetrics.register_metric("l1_p7", _l1, np_pair_dist=_l1_np)
        try:
            assert m.np_pair_dist is _l1_np
            assert tmetrics.get_metric("l1_p7") is m
            np.testing.assert_array_equal(m.pair_dist_np(rows, q),
                                          _l1_np(rows, q))
        finally:
            tmetrics.unregister_metric("l1_p7")
        m = tmetrics.register_metric("l1_p7", _l1)
        try:
            assert m.np_pair_dist is None
            np.testing.assert_array_equal(m.pair_dist_np(rows, q),
                                          _l1(rows, q))
        finally:
            tmetrics.unregister_metric("l1_p7")

    @pytest.mark.parametrize("np_fn", [None, _l1_np])
    def test_record_equals_jax(self, np_fn):
        kw = dict(np_pair_dist=np_fn, needs_norms=True, normalize_query=True)
        try:
            t = tmetrics.register_metric("l1_p7_rec", _l1, **kw)
            j = jmetrics.register_metric("l1_p7_rec", _l1, **kw)
            assert [f.name for f in dataclasses.fields(t)] == \
                [f.name for f in dataclasses.fields(j)]
            assert dataclasses.astuple(t) == dataclasses.astuple(j)
        finally:
            tmetrics.unregister_metric("l1_p7_rec")
            jmetrics.unregister_metric("l1_p7_rec")

    def test_builtin_metric_names_equal_jax(self):
        assert tconfig.METRICS == jconfig.METRICS
        assert set(tconfig.METRICS) <= set(tmetrics.registered_metrics())


# ------------------------------------------------------- dequantization
@pytest.mark.parametrize("storage", ["int8", "f32", "bf16"])
def test_dequantize_gathered_equals_jax(storage):
    rng = np.random.RandomState(2)
    x = rng.randn(50, 12).astype(np.float32) * 3.0
    x[7] = 0.0
    jr, js, _ = jquant.quantize_rows(jnp.asarray(x), storage)
    tr, ts, _ = tquant.quantize_rows(_t(x), storage)
    ids = rng.randint(-1, 50, size=(6, 9)).astype(np.int32)
    safe = np.maximum(ids, 0)
    j = jquant.dequantize_gathered(jr[safe], js[safe])
    t = tquant.dequantize_gathered(tr[_t(safe).long()], ts[_t(safe).long()])
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        tdist.gather_dequant(tr, ts, _t(ids)).numpy(),
        np.asarray(jdist.gather_dequant(jr, js, jnp.asarray(ids))))


# ----------------------------------------------------------- re-exports
@pytest.mark.parametrize("jpkg,tpkg", [(jmodels, tmodels), (jops, tops)],
                         ids=["models", "ops"])
def test_package_reexports(jpkg, tpkg):
    assert tpkg.__all__ == jpkg.__all__
    for name in jpkg.__all__:
        obj = getattr(tpkg, name)
        assert obj.__module__.startswith(tpkg.__name__), (name, obj)
        assert obj.__name__ == name


def test_reexports_are_the_module_objects():
    from ocaml_hnsw_tpu_torch.models import knn_search, empty_graph
    from ocaml_hnsw_tpu_torch.models.search import knn_search as ks
    from ocaml_hnsw_tpu_torch.ops import first_occurrence_mask, dists_to_ids

    assert knn_search is ks and empty_graph is tgraph.empty_graph
    assert dists_to_ids is tdist.dists_to_ids
    ids = _t(np.array([[3, 1, 3, -1, 1]], np.int32))
    assert first_occurrence_mask(ids).tolist() == [[True, True, False, True,
                                                    False]]


# -------------------------------------------------- graph / packed shapes
class TestGraphAndPackShapes:
    @NO_CARD
    def test_constructors_default_to_cuda(self):
        with pytest.raises(RuntimeError, match="CUDA"):
            tgraph.empty_graph(HnswConfig(dim=8, M=4), 100)
        with pytest.raises(RuntimeError, match="CUDA"):
            tpacked.empty_packed(128, 8, 8, 0.1)
        with pytest.raises(RuntimeError, match="CUDA"):
            tbuild.build(np.zeros((4, 8), np.float32), HnswConfig(dim=8, M=4))

    @pytest.mark.parametrize("storage", ["f32", "int8"])
    def test_empty_graph_and_upper_view_equal_jax(self, storage):
        t = tgraph.empty_graph(HnswConfig(dim=8, M=6, storage=storage), 300,
                               "cpu")
        j = jgraph.empty_graph(JaxConfig(dim=8, M=6, storage=storage), 300)
        for f in ("vectors", "scales", "adj0", "adj_up", "up_base", "levels"):
            a, b = getattr(t, f), np.asarray(getattr(j, f))
            assert tuple(a.shape) == b.shape, f
            np.testing.assert_array_equal(a.float().numpy(),
                                          b.astype(np.float32), err_msg=f)
        assert tgraph.upper_view(t, 2).deg == jgraph.upper_view(j, 2).deg == 6

    @pytest.mark.parametrize("deg,dim", [(32, 128), (16, 128), (32, 768),
                                         (24, 96)])
    def test_packed_chunks_equal_jax(self, deg, dim):
        t = tpacked.empty_packed(256, deg, dim, 0.5, device="cpu")
        j = jpacked.empty_packed(256, deg, dim, 0.5)
        assert t.chunks == j.chunks
        assert t.chunk_w * t.chunks == t.deg * t.d_pad
        np.testing.assert_array_equal(t.meta.numpy(), np.asarray(j.meta))


@pytest.fixture(scope="module")
def small_pack():
    """A 1200-row port graph, packed in 512-byte chunk rows (4 neighbours
    of 128 bytes each), with entries and quantized queries for the beam."""
    data = clustered(1200, 16, n_clusters=12, seed=4)
    g = tbulk.bulk_build(data, HnswConfig(dim=16, M=8), knn_k=16, batch=512,
                         device="cpu")
    pk = tpacked.pack_graph(g, "l2", max_chunk=512)
    q = _t(data[:64] + 0.01)
    qn = tdist.query_norms(q, "l2")
    q8 = torch.nn.functional.pad(tpacked.quantize_queries(q, pk.scale),
                                 (0, pk.d_pad - 16))
    entry = _t(np.random.RandomState(5).randint(0, 1200, size=(64, 1))
               .astype(np.int32))
    entry_d = tdist.dists_to_ids(g.vectors, g.scales, g.norms, q, qn, entry,
                                 "l2")
    return pk, q8, qn, entry, entry_d


class TestPackedBeamKeywords:
    def test_deg_limit_resolves_through_packed_slots(self, small_pack):
        pk, q8, qn, entry, entry_d = small_pack
        args = (pk, q8, qn, entry, entry_d, 24)
        kw = dict(needs_norms=True, max_iters=12, expand=2)
        slots = tpacked.packed_slots(pk, 6)
        assert slots == 8 < pk.deg
        by_limit = tpacked.beam_search_layer_packed(*args, deg_limit=6, **kw)
        by_slots = tpacked.beam_search_layer_packed(*args, slots=slots, **kw)
        full = tpacked.beam_search_layer_packed(*args, **kw)
        for a, b in zip(by_limit[:2], by_slots[:2]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert not torch.equal(by_limit[0], full[0])
        fused = tpacked.beam_search_layer_packed(*args, fused=True, **kw)
        np.testing.assert_array_equal(fused[0].numpy(), full[0].numpy())

    def test_conflicting_keywords_raise(self, small_pack):
        pk, q8, qn, entry, entry_d = small_pack
        args = (pk, q8, qn, entry, entry_d, 24)
        with pytest.raises(ValueError, match="not both"):
            tpacked.beam_search_layer_packed(*args, True, 4, slots=8,
                                             deg_limit=6)
        with pytest.raises(ValueError, match="fused"):
            tpacked.beam_search_layer_packed(*args, True, 4, deg_limit=6,
                                             fused=True)

    def test_duo_takes_fused(self, small_pack):
        pk, q8, qn, entry, entry_d = small_pack
        args = (pk, q8, qn, entry, entry_d, 24, True, 6)
        a = tpacked.beam_search_layer_packed_duo(*args, fused=True)
        b = tpacked.beam_search_layer_packed_duo(*args)
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


# ------------------------------------------------------ select_neighbors
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("keep_pruned", [False, True])
@pytest.mark.parametrize("scan_limit", [None, 10])
def test_select_neighbors_scan_limit_equals_jax(metric, keep_pruned,
                                                scan_limit):
    rng = np.random.RandomState(11)
    n, dim, b, k, m = 300, 8, 24, 20, 6
    x = rng.randn(n, dim).astype(np.float32)
    if metric == "ip":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    norms = (x * x).sum(1) if metric == "l2" else np.zeros(n, np.float32)
    q = x[rng.randint(0, n, size=b)] + 0.05 * rng.randn(b, dim).astype(
        np.float32)
    w_ids = np.stack([rng.choice(n, k, replace=False) for _ in range(b)])
    w_ids = w_ids.astype(np.int32)
    w_ids[:, -3:] = -1
    if metric == "l2":
        w_d = ((x[np.maximum(w_ids, 0)] - q[:, None]) ** 2).sum(-1)
    else:
        w_d = 1.0 - (x[np.maximum(w_ids, 0)] * q[:, None]).sum(-1)
    w_d = np.where(w_ids >= 0, w_d, np.inf).astype(np.float32)
    order = np.argsort(w_d, axis=1, kind="stable")
    w_ids = np.take_along_axis(w_ids, order, 1)
    w_d = np.take_along_axis(w_d, order, 1)
    scales = np.ones(n, np.float32)
    j = jbuild.select_neighbors(jnp.asarray(x), jnp.asarray(scales),
                                jnp.asarray(norms), jnp.asarray(w_ids),
                                jnp.asarray(w_d), m, metric, keep_pruned,
                                scan_limit=scan_limit)
    t = tbuild.select_neighbors(_t(x), _t(scales), _t(norms), _t(w_ids),
                                _t(w_d), m, metric, keep_pruned,
                                scan_limit=scan_limit)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    if scan_limit is not None and not keep_pruned:
        # nothing past the eligible prefix is admitted
        prefix = set(w_ids[:, :scan_limit].ravel().tolist())
        assert set(t[0].numpy().ravel().tolist()) <= prefix | {-1}


# ---------------------------------------------------- BuildState's knobs
KNOB_CASES = {
    "defaults": {},
    "pinned": dict(build_mi=30, build_expand=2, build_ck=None,
                   select_scan=40),
    "pinned ck": dict(build_mi=None, build_ck=12, select_scan=8),
}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", sorted(KNOB_CASES))
@pytest.mark.parametrize("m", [8, 16])
def test_round_kwargs_equal_jax(case, packed, m):
    t = tbuild.BuildState(HnswConfig(dim=8, M=m, ef_construction=40), 500,
                          round_size=64, device="cpu")
    j = jbuild.BuildState(JaxConfig(dim=8, M=m, ef_construction=40), 500,
                          round_size=64)
    for st in (t, j):
        st._packed_build = packed
        for k, v in KNOB_CASES[case].items():
            setattr(st, k, v)
    for k in ("build_mi", "build_expand", "build_ck", "select_scan",
              "bulk_first_add"):
        assert getattr(t, k) == getattr(j, k), k
    assert t._round_kwargs() == j._round_kwargs()


def test_pinned_knobs_reach_insert_round(monkeypatch):
    seen = []
    real = tbuild.insert_round

    def recording(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tbuild, "insert_round", recording)
    st = tbuild.BuildState(HnswConfig(dim=8, M=6, ef_construction=24), 200,
                           round_size=32, device="cpu")
    st.build_mi, st.build_expand, st.build_ck = 7, 3, 16
    st.select_scan = 9
    st.add(clustered(200, 8, n_clusters=4, seed=6))
    assert seen and all(
        (kw["build_mi"], kw["build_expand"], kw["build_ck"],
         kw["select_scan"]) == (7, 3, 16, 9) for kw in seen)


def test_select_scan_at_the_beam_width_changes_nothing():
    """A cap at ef_construction admits from the whole beam: the graph is
    the uncapped one.  A cap below it still builds a sound graph."""
    data = clustered(400, 8, n_clusters=4, seed=7)
    graphs = {}
    for cap in (None, 24, 6):
        st = tbuild.BuildState(HnswConfig(dim=8, M=6, ef_construction=24),
                               400, round_size=64, device="cpu")
        st.select_scan = cap
        st.add(data)
        graphs[cap] = st.graph
    for f in ("adj0", "adj_up"):
        assert torch.equal(getattr(graphs[None], f), getattr(graphs[24], f))
    adj0 = graphs[6].adj0.numpy()[:400]
    assert ((adj0 >= 0).sum(1) >= 1).all()
    assert not np.array_equal(adj0, graphs[None].adj0.numpy()[:400])


class TestBulkFirstAdd:
    def test_opt_out_keeps_rounds(self):
        """The port's mirror of the JAX package's
        tests/test_bulk.py::test_small_or_nondefault_modes_stay_incremental."""
        st = tbuild.BuildState(HnswConfig(dim=16, M=8, ef_construction=40),
                               200_001, round_size=256, device="cpu")
        assert st.bulk_first_add is True
        assert not st._bulk_eligible(st.BULK_THRESHOLD - 1)
        assert st._bulk_eligible(st.BULK_THRESHOLD + 1)
        st.host_n = 5
        assert not st._bulk_eligible(st.BULK_THRESHOLD + 1)
        st.host_n = 0
        st.bulk_first_add = False
        assert not st._bulk_eligible(st.BULK_THRESHOLD + 1)

    @pytest.mark.parametrize("bulk_first_add", [True, False])
    def test_add_takes_the_chosen_path(self, monkeypatch, bulk_first_add):
        calls = []
        real = tbulk.bulk_build

        def counting(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        monkeypatch.setattr(tbulk, "bulk_build", counting)
        monkeypatch.setattr(tbuild.BuildState, "BULK_THRESHOLD", 100)
        st = tbuild.BuildState(HnswConfig(dim=8, M=6, ef_construction=24),
                               300, round_size=64, device="cpu")
        st.bulk_first_add = bulk_first_add
        st.add(clustered(300, 8, n_clusters=4, seed=8))
        assert len(calls) == int(bulk_first_add)
        assert st.host_n == int(st.graph.n) == 300
