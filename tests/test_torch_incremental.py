"""The incremental build of the torch port against the JAX package's
(`ocaml_hnsw_tpu/models/build.py`, build-time upkeep of
`ocaml_hnsw_tpu/models/packed.py`).

One JAX `BuildState.add` from empty (600 x 16 clustered rows, M=8,
ef_construction=32, round_size=64) is the module's reference; every other
JAX call reuses its compiled round.

  * A whole add from empty: the port visits the same rounds with the same
    levels.  The only approximate step is the seed scan's top-16 of bf16
    scores (`approx_min_k` against `torch.topk`), which may break ties
    otherwise, so the stated tolerance is edge agreement >= 99% and recall
    within 0.01 of JAX's.
  * One `insert_round` from the same graph, bank and inputs: with fewer than
    16 nodes in the seed bank the winner set cannot differ, so every tensor
    must be equal; with a larger bank, edge agreement >= 99%.
  * select="simple" and extend_candidates: the functions equal JAX's on the
    same beam output, and a build with each is held to the sequential
    oracle with the JAX package's own bands for these modes.
  * An add on top of a bulk build leaves the level stream where JAX's does.
  * Packed-build upkeep: `empty_packed`, `refresh_payload_rows` and
    `pack_graph(with_dist=True)` give JAX's payload bytes and norms (dist to
    rtol = atol = 1e-6: f32 summation order), and after packed rounds the maintained
    payload equals a fresh pack byte for byte.
  * One packed add (PACKED_BUILD_THRESHOLD lowered on both instances): the
    graph, seed bank and payload against JAX's, with the same split into an
    exact case (bank under 16) and an edge-agreement case as above.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.config import HnswConfig as JaxConfig
from ocaml_hnsw_tpu.models import build as jbuild
from ocaml_hnsw_tpu.models import packed as jpacked
from ocaml_hnsw_tpu.models.graph import GraphTensors as JaxGraph
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn, recall
from ocaml_hnsw_tpu.oracle.hnsw import OracleHNSW

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import build as tbuild
from ocaml_hnsw_tpu_torch.models import packed as tpacked
from ocaml_hnsw_tpu_torch.models.graph import graph_from_numpy, graph_to_numpy
from ocaml_hnsw_tpu_torch.models.search import build_seed_index, knn_search

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

N, DIM, RS = 600, 16, 64
CFG = dict(dim=DIM, M=8, ef_construction=32)
FIELDS = ("levels", "up_base", "up_n", "entry", "max_level", "n", "adj0",
          "adj_up")


def port_to_jax(g):
    arrays = graph_to_numpy(g)
    return JaxGraph(**{f: jnp.asarray(a) for f, a in arrays.items()},
                    l_max_static=g.l_max_static)


def edge_agreement(a, b):
    """Mean over rows of |edges(a) ∩ edges(b)| / |edges(a)|."""
    out = []
    for x, y in zip(a, b):
        sx, sy = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(sx & sy) / len(sx) if sx else float(not sy))
    return float(np.mean(out))


def port_state(data, **kw):
    st = tbuild.BuildState(HnswConfig(**{**CFG, **kw}), N, round_size=RS,
                           device="cpu")
    st.add(data)
    return st


@pytest.fixture(scope="module")
def data():
    return clustered(N, DIM, n_clusters=8, seed=1)


@pytest.fixture(scope="module")
def jax_state(data):
    st = jbuild.BuildState(JaxConfig(**CFG), N, round_size=RS)
    st.SCAN_CHUNKS = ()  # per-round dispatch: one compiled program, not two
    st.add(data)
    return st


@pytest.fixture(scope="module")
def port400(data):
    """A port build of the first 400 rows; tests that add to it copy it."""
    return port_state(data[:400])


def _copy_state(st):
    """A fresh state that adopted a copy of st's graph."""
    cp = tbuild.BuildState(st.config, N, round_size=RS, device="cpu")
    cp.adopt_graph(st.graph.clone())
    return cp


def _knn_recall(graph, data, q, ef=32):
    gt, _ = bruteforce_knn(data, q, 10)
    ids, _ = knn_search(graph, torch.from_numpy(q), 10, ef, "l2")
    return recall(ids.numpy(), gt)


class TestWholeBuild:
    def test_add_from_empty_matches_jax(self, data, jax_state):
        ts = port_state(data)
        jg = jax_state.graph
        for f in ("levels", "up_base", "up_n", "n"):
            np.testing.assert_array_equal(getattr(ts.graph, f).numpy(),
                                          np.asarray(getattr(jg, f)))
        assert edge_agreement(ts.graph.adj0.numpy()[:N],
                              np.asarray(jg.adj0)[:N]) >= 0.99
        assert edge_agreement(ts.graph.adj_up.numpy(),
                              np.asarray(jg.adj_up)) >= 0.99
        assert ts.host_n == N and ts.host_up_n == int(jg.up_n)
        assert ts.host_max_level == int(jg.max_level)
        assert ts.bank.n == int(jax_state.seed_n)
        # both graphs searched by the port's engine (held to JAX's in
        # tests/test_torch_classic.py), so only the builds differ
        q = queries_like(data, 100, seed=2)
        r_t = _knn_recall(ts.graph, data, q)
        r_j = _knn_recall(graph_from_numpy(
            {f: np.asarray(getattr(jg, f)) for f in FIELDS + (
                "vectors", "scales", "norms", "deleted")},
            jg.l_max_static, "cpu"), data, q)
        assert r_t >= 0.95 and abs(r_t - r_j) <= 0.01, (r_t, r_j)

    @pytest.mark.parametrize("kw,band,floor", [
        (dict(select="simple"), 0.09, 0.7),
        (dict(extend_candidates=True), 0.03, 0.9)], ids=["simple", "extend"])
    def test_other_selectors_build(self, kw, band, floor):
        """Against the sequential oracle, with the JAX package's bands for
        these modes (tests/test_build.py TestSelectionModes) on 400 rows of
        its data; the selectors themselves are held to JAX's in
        TestOneRound.test_select_and_extend_equal_jax."""
        cfg = dict(dim=16, M=8, ef_construction=60, **kw)
        data = clustered(400, 16, n_clusters=18, seed=0)
        q = queries_like(data, 80, seed=1)
        gt, _ = bruteforce_knn(data, q, 10)
        o = OracleHNSW(JaxConfig(**cfg))
        o.add_items(data)
        r_o = recall(o.knn_query(q, k=10, ef=48)[0], gt)
        st = tbuild.BuildState(HnswConfig(**cfg), 400, round_size=RS,
                               device="cpu")
        st.add(data)
        ids, _ = knn_search(st.graph, torch.from_numpy(q), 10, 48, "l2")
        r_t = recall(ids.numpy(), gt)
        assert r_t >= r_o - band and r_t >= floor, (r_t, r_o)


class TestOneRound:
    @pytest.mark.parametrize("n0", [100, 400], ids=["bank<16", "bank>16"])
    def test_insert_round_matches_jax(self, data, jax_state, port400, n0):
        """Both packages adopt the same port-built graph (rebuilding their
        seed banks) and add one round of 64 rows from the same RNG state."""
        built = port_state(data[:n0]) if n0 != 400 else port400
        ts = _copy_state(built)
        assert (ts.bank.n < 16) == (n0 == 100)
        js = jbuild.BuildState(JaxConfig(**CFG), N, round_size=RS)
        js.adopt_graph(port_to_jax(ts.graph))
        for st in (ts, js):
            st.rng = np.random.RandomState(7)
        vecs = data[n0:n0 + RS]
        js.add(vecs)
        ts.add(vecs)
        assert ts.bank.n == int(js.seed_n) and ts.host_n == n0 + RS
        np.testing.assert_array_equal(ts.bank.ids.numpy(),
                                      np.asarray(js.seed_bank))
        np.testing.assert_array_equal(
            ts.bank.vecs.float().numpy(),
            np.asarray(js.seed_vecs.astype(jnp.float32)))
        exact = n0 == 100
        for f in FIELDS:
            a, b = getattr(ts.graph, f).numpy(), np.asarray(getattr(js.graph, f))
            if exact or f not in ("adj0", "adj_up"):
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                assert edge_agreement(a, b) >= 0.99, f

    def test_select_and_extend_equal_jax(self, data, port400):
        """select_neighbors (both selectors) and extend_candidates on the
        same graph and beam output."""
        ts = port400
        g, jg = ts.graph, port_to_jax(ts.graph)
        q = queries_like(data, 32, seed=4)
        tq = torch.from_numpy(q)
        tqn = torch.sum(tq * tq, 1)
        ids, d = knn_search(g, tq, 24, 24, "l2")
        jv = dict(vectors=jg.vectors, scales=jg.scales, norms=jg.norms)
        tv = (g.vectors, g.scales, g.norms)
        for heur in (True, False):
            t_s = tbuild.select_neighbors(*tv, ids, d, 8, "l2", False,
                                          heuristic=heur)
            j_s = jbuild.select_neighbors(
                jv["vectors"], jv["scales"], jv["norms"],
                jnp.asarray(ids.numpy()), jnp.asarray(d.numpy()), 8, "l2",
                False, heuristic=heur)
            np.testing.assert_array_equal(t_s[0].numpy(), np.asarray(j_s[0]))
        t_e = tbuild.extend_candidates(*tv, g.adj0, tq, tqn, ids, d, 24, "l2")
        j_e = jbuild.extend_candidates(
            jv["vectors"], jv["scales"], jv["norms"], jg.adj0, jnp.asarray(q),
            jnp.asarray(tqn.numpy()), jnp.asarray(ids.numpy()),
            jnp.asarray(d.numpy()), 24, "l2")
        np.testing.assert_array_equal(t_e[0].numpy(), np.asarray(j_e[0]))
        np.testing.assert_allclose(t_e[1].numpy(), np.asarray(j_e[1]),
                                   rtol=1e-5)


class TestAfterBulk:
    def test_level_stream_continues(self, data):
        st = tbuild.BuildState(HnswConfig(**CFG), N, round_size=RS,
                               device="cpu")
        st.BULK_THRESHOLD = 300
        st.add(data[:400])  # bulk: 2·400 >= 600
        assert st.bank.n == st.host_upper_count > 0
        st.add(data[400:])  # incremental on top
        ref = np.random.RandomState(CFG.get("seed", 100))
        cfg = JaxConfig(**CFG)
        l_max = st.l_max
        lv = np.concatenate([jbuild.sample_levels(ref, 400, cfg.mL, l_max),
                             jbuild.sample_levels(ref, 200, cfg.mL, l_max)])
        np.testing.assert_array_equal(st.graph.levels.numpy()[:N], lv)
        a, b = st.rng.get_state(), ref.get_state()
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
        assert _knn_recall(st.graph, data, queries_like(data, 100, 5)) >= 0.95


class TestPackedUpkeep:
    def test_empty_packed_equals_jax(self):
        t = tpacked.empty_packed(256, 16, 24, 0.25, "cpu")
        j = jpacked.empty_packed(256, 16, 24, 0.25)
        np.testing.assert_array_equal(t.pay.numpy().reshape(-1),
                                      np.asarray(j.pay).reshape(-1))
        np.testing.assert_array_equal(t.meta.numpy(), np.asarray(j.meta))
        np.testing.assert_array_equal(t.dist.numpy(), np.asarray(j.dist))
        assert float(t.scale) == float(j.scale)

    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    def test_pack_and_refresh_equal_jax(self, data, port400, metric):
        ts = port400 if metric == "l2" else port_state(data[:400],
                                                       metric=metric)
        g, jg = ts.graph, port_to_jax(ts.graph)
        tp = tpacked.pack_graph(g, metric, with_dist=True)
        jp = jpacked.pack_graph(jg, metric, with_dist=True)
        self._same(tp, jp)
        # refresh some rows (duplicates and the sink included) of a pack
        # whose rows were zeroed, in both packages
        rows = np.array([0, 5, 5, 17, 399, g.n_cap - 1], np.int32)
        tz = tpacked.empty_packed(g.n_cap, tp.deg, DIM, tp.scale, "cpu")
        jz = jpacked.empty_packed(g.n_cap, tp.deg, DIM, jp.scale)
        tr = tpacked.refresh_payload_rows(tz, g.vectors, g.scales, g.adj0,
                                          torch.from_numpy(rows), metric)
        jr = jpacked.refresh_payload_rows(jz, jg.vectors, jg.scales, jg.adj0,
                                          jnp.asarray(rows), metric)
        self._same(tr, jr)

    @staticmethod
    def _same(t, j):
        np.testing.assert_array_equal(t.pay.numpy(),
                                      np.asarray(j.pay).reshape(t.pay.shape))
        np.testing.assert_array_equal(t.meta.numpy(), np.asarray(j.meta))
        np.testing.assert_allclose(t.dist.numpy(), np.asarray(j.dist),
                                   rtol=1e-6, atol=1e-6)

    def test_maintained_payload_equals_fresh_pack(self, data):
        st = tbuild.BuildState(HnswConfig(**{**CFG, "dim": DIM}), N,
                               round_size=RS, device="cpu")
        st.PACKED_BUILD_THRESHOLD = 1  # the packed path at this size
        st.add(data[:300])
        st.add(data[300:] * 1.5)  # a wider batch grows the scale
        pk = st.packed_graph()
        assert st._packed_build and pk is not None
        assert st._round_kwargs()["build_expand"] == 8
        fresh = tpacked.pack_graph(st.graph, "l2", with_dist=True)
        n = st.host_n
        assert torch.equal(pk.scale, fresh.scale)
        assert torch.equal(pk.pay[:n], fresh.pay[:n])
        assert torch.equal(pk.meta[:n], fresh.meta[:n])
        assert torch.equal(pk.dist[:n], fresh.dist[:n])
        x = np.concatenate([data[:300], data[300:] * 1.5])
        seeds = build_seed_index(st.graph, "l2")
        gt, _ = bruteforce_knn(x, queries_like(x, 100, seed=6), 10)
        ids, _ = knn_search(st.graph,
                            torch.from_numpy(queries_like(x, 100, seed=6)),
                            10, 32, "l2", seeds=seeds)
        assert recall(ids.numpy(), gt) >= 0.95

    @pytest.mark.parametrize("n0", [100, 400], ids=["bank<16", "bank>16"])
    def test_packed_round_matches_jax(self, data, port400, n0):
        """One packed add (K1 construction beam, exact W re-score, int8
        shrink, payload by-product) in both packages, from the same adopted
        graph, data and RNG state, with PACKED_BUILD_THRESHOLD lowered on
        both instances.  Levels, arena bookkeeping and the seed bank are
        equal; the graph and the payload's neighbour ids are equal with a
        seed bank under 16 (no seed-scan ties) and agree on >= 99% of
        edges otherwise.  Payload bytes and int8 norms are equal away from
        the slots where the port rounds the round's own rows as pack_graph
        does (x·(1/s), not the beam query's x/s): there they differ by at
        most one step.  Empty slots are not compared: the port fills them
        with node 0's row as pack_graph does, the JAX by-product does not,
        and no search reads them."""
        built = port_state(data[:n0]) if n0 != 400 else port400
        ts = _copy_state(built)
        js = jbuild.BuildState(JaxConfig(**CFG), N, round_size=RS)
        js.SCAN_CHUNKS = ()
        js.adopt_graph(port_to_jax(ts.graph))
        for st in (ts, js):
            st.rng = np.random.RandomState(7)
            st.PACKED_BUILD_THRESHOLD = 1
        vecs = data[n0:n0 + RS]
        js.add(vecs)
        ts.add(vecs)
        assert ts._packed_build and js._packed_build
        assert ts.bank.n == int(js.seed_n) and ts.host_n == n0 + RS
        np.testing.assert_array_equal(ts.bank.ids.numpy(),
                                      np.asarray(js.seed_bank))
        exact = n0 == 100
        for f in FIELDS:
            a, b = getattr(ts.graph, f).numpy(), np.asarray(getattr(js.graph, f))
            if exact or f not in ("adj0", "adj_up"):
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                assert edge_agreement(a, b) >= 0.99, f
        tp, jp = ts.packed_graph(), js.packed_graph()
        assert float(tp.scale) == float(jp.scale)
        deg = tp.deg
        t_ids, j_ids = tp.meta.numpy()[:, :deg], np.asarray(jp.meta)[:, :deg]
        if exact:
            np.testing.assert_array_equal(t_ids, j_ids)
        else:
            assert edge_agreement(t_ids[:n0 + RS], j_ids[:n0 + RS]) >= 0.99
        # slots of old rows that hold one of the round's rows: the rounding
        # differs there by design
        new = (t_ids >= n0) & (t_ids < n0 + RS)
        new[n0:n0 + RS] = False  # forward rows: refreshed by pack_graph's
        same = (t_ids == j_ids) & (t_ids >= 0)  # rounding in both packages
        t_pay = tp.pay.numpy().astype(np.int32)
        j_pay = np.asarray(jp.pay).reshape(tp.pay.shape).astype(np.int32)
        away = same & ~new
        np.testing.assert_array_equal(t_pay[away], j_pay[away])
        np.testing.assert_array_equal(tp.meta.numpy()[:, deg:][away],
                                      np.asarray(jp.meta)[:, deg:][away])
        np.testing.assert_allclose(tp.dist.numpy()[away],
                                   np.asarray(jp.dist)[away], rtol=1e-6,
                                   atol=1e-6)
        assert np.abs(t_pay[same & new] - j_pay[same & new]).max(
            initial=0) <= 1
        assert same.sum() >= 0.99 * (t_ids >= 0).sum()
        # both graphs searched by the port's engine
        x = data[:n0 + RS]
        q = queries_like(x, 100, seed=6)
        r_t = _knn_recall(ts.graph, x, q)
        r_j = _knn_recall(graph_from_numpy(
            {f: np.asarray(getattr(js.graph, f)) for f in FIELDS + (
                "vectors", "scales", "norms", "deleted")},
            js.graph.l_max_static, "cpu"), x, q)
        assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
