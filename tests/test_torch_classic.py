"""The classic query engine of the torch port against the JAX package's
(`ocaml_hnsw_tpu/models/search.py`, `ocaml_hnsw_tpu/ops/bitset.py`).

The graph is built once by the port (600 x 16 clustered rows, M=8) and
carried into the JAX package with `graph_to_numpy`.

  * `hash_ids` and the bitsets are integer arithmetic: equal outputs (words
    compared as uint32).
  * `beam_search_layer` in all three dedup modes and with `compact_k`, and
    `knn_search` with greedy-descent entry (seeds=None): the distances are
    real-valued, so ties are absent and the bitonic networks are ported as
    networks; ids must be equal and distances equal to rtol 1e-5 (f32
    summation order differs).
  * `knn_search` with the seed scan: the JAX package ranks bf16-rounded
    seed scores with `approx_min_k` and the port f32 scores in K3's
    `scan_topk`, which may order near-ties otherwise, so recall@10 must be
    within 0.01 of JAX's and distances of shared ids equal to 1e-5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.models import search as jsearch
from ocaml_hnsw_tpu.models.graph import GraphTensors as JaxGraph
from ocaml_hnsw_tpu.models.graph import upper_view as jax_upper_view
from ocaml_hnsw_tpu.ops import bitset as jbitset
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn, recall

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import search as tsearch
from ocaml_hnsw_tpu_torch.models.build import BuildState
from ocaml_hnsw_tpu_torch.models.graph import graph_to_numpy, upper_view
from ocaml_hnsw_tpu_torch.ops import bitset as tbitset

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

N, DIM = 600, 16


def port_to_jax(g):
    arrays = graph_to_numpy(g)
    return JaxGraph(**{f: jnp.asarray(a) for f, a in arrays.items()},
                    l_max_static=g.l_max_static)


@pytest.fixture(scope="module")
def graphs():
    data = clustered(N, DIM, n_clusters=8, seed=1)
    st = BuildState(HnswConfig(dim=DIM, M=8, ef_construction=32), N,
                    round_size=64, device="cpu")
    st.add(data)
    q = queries_like(data, 64, seed=2)
    return data, q, st.graph, port_to_jax(st.graph)


def _entry(tg, jg, q):
    """Greedy-descent entries for layer 0, from each package."""
    tq = torch.from_numpy(q)
    tqn = torch.sum(tq * tq, dim=1)
    t_cur, t_d = tsearch.descend(tg, tq, tqn, "l2")
    jq = jnp.asarray(q)
    j_cur, j_d = jsearch.descend(jg, jq, jnp.sum(jq * jq, axis=1), "l2")
    np.testing.assert_array_equal(t_cur.numpy(), np.asarray(j_cur))
    return (tq, tqn, t_cur[:, None], t_d[:, None],
            jq, jnp.sum(jq * jq, axis=1), j_cur[:, None], j_d[:, None])


class TestBitset:
    def test_hash_ids_equal(self):
        ids = np.random.RandomState(0).randint(-1, 1 << 30, size=(8, 64))
        ids = ids.astype(np.int32)
        for bits in (10, 18, 31):
            np.testing.assert_array_equal(
                tbitset.hash_ids(torch.from_numpy(ids), bits).numpy(),
                np.asarray(jbitset.hash_ids(jnp.asarray(ids), bits)))

    def test_set_and_test_equal(self):
        rng = np.random.RandomState(1)
        ids = rng.randint(-1, 256, size=(4, 48)).astype(np.int32)
        # dedup on the index, as the callers do, so add equals OR
        mask = np.asarray(jbitset.first_occurrence_mask(jnp.asarray(ids))) \
            & (ids >= 0)
        jb = jbitset.bitset_set(jbitset.bitset_new(4, 256), jnp.asarray(ids),
                                jnp.asarray(mask))
        tb = tbitset.bitset_set(tbitset.bitset_new(4, 256),
                                torch.from_numpy(ids), torch.from_numpy(mask))
        np.testing.assert_array_equal(tb.numpy().view(np.uint32),
                                      np.asarray(jb))
        probe = rng.randint(-1, 256, size=(4, 96)).astype(np.int32)
        np.testing.assert_array_equal(
            tbitset.bitset_test(tb, torch.from_numpy(probe),
                                torch.from_numpy(probe >= 0)).numpy(),
            np.asarray(jbitset.bitset_test(jb, jnp.asarray(probe),
                                           jnp.asarray(probe >= 0))))
        assert (tb.numpy() < 0).any()  # bit 31 is in play


BEAM_CASES = {
    "beam_only": dict(visited_bits=0, expand=4),
    "exact_bitset": dict(visited_bits=None, expand=2),
    "hashed_bitset": dict(visited_bits=12, expand=4),
    "compact_k": dict(visited_bits=0, expand=4, compact_k=40),
    "max_iters": dict(visited_bits=0, expand=1, max_iters=5),
}


class TestBeam:
    @pytest.mark.parametrize("case", sorted(BEAM_CASES))
    def test_layer0_equals_jax(self, graphs, case):
        _, q, tg, jg = graphs
        tq, tqn, te, ted, jq, jqn, je, jed = _entry(tg, jg, q)
        kw = BEAM_CASES[case]
        t_ids, t_d, t_it = tsearch.beam_search_layer(
            tg.vectors, tg.scales, tg.norms, tg.adj0, tq, tqn, te, ted, 24,
            "l2", **kw)
        j_ids, j_d, j_it = jsearch.beam_search_layer(
            jg.vectors, jg.scales, jg.norms, jg.adj0, jq, jqn, je, jed, 24,
            "l2", **kw)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=1e-5)
        assert int(t_it) == int(j_it)

    def test_upper_layer_view_equals_jax(self, graphs):
        """The same beam over an upper layer (arena view) from node 0."""
        _, q, tg, jg = graphs
        tq = torch.from_numpy(q)
        jq = jnp.asarray(q)
        top = int(tg.max_level)
        e = np.full((q.shape[0], 1), int(tg.entry), np.int32)
        t_ids, t_d, _ = tsearch.beam_search_layer(
            tg.vectors, tg.scales, tg.norms, upper_view(tg, top), tq,
            torch.sum(tq * tq, 1), torch.from_numpy(e),
            torch.zeros(e.shape), 8, "l2", expand=4, visited_bits=0)
        j_ids, j_d, _ = jsearch.beam_search_layer(
            jg.vectors, jg.scales, jg.norms, jax_upper_view(jg, top), jq,
            jnp.sum(jq * jq, 1), jnp.asarray(e), jnp.zeros(e.shape), 8,
            "l2", expand=4, visited_bits=0)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))

    def test_compact_k_needs_beam_only(self, graphs):
        _, q, tg, _ = graphs
        e = torch.zeros((2, 1), dtype=torch.int32)
        with pytest.raises(ValueError):
            tsearch.beam_search_layer(
                tg.vectors, tg.scales, tg.norms, tg.adj0,
                torch.from_numpy(q[:2]), torch.zeros(2), e, torch.zeros(2, 1),
                8, "l2", visited_bits=None, compact_k=8)


class TestKnnSearch:
    def test_descent_entry_exact(self, graphs):
        _, q, tg, jg = graphs
        t_ids, t_d = tsearch.knn_search(tg, torch.from_numpy(q), 10, 32, "l2")
        j_ids, j_d = jsearch.knn_search(jg, jnp.asarray(q), 10, 32, "l2")
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=1e-5)

    def test_tombstones_filtered(self, graphs):
        _, q, tg, jg = graphs
        first, _ = tsearch.knn_search(tg, torch.from_numpy(q), 10, 32, "l2")
        dead = np.unique(first.numpy()[:, 0])
        tg2 = tg._replace(deleted=tg.deleted.clone())
        tg2.deleted[torch.from_numpy(dead).long()] = True
        jdel = np.zeros(jg.deleted.shape, bool)
        jdel[dead] = True
        jg2 = jg._replace(deleted=jnp.asarray(jdel))
        t_ids, t_d = tsearch.knn_search(tg2, torch.from_numpy(q), 10, 32, "l2")
        j_ids, j_d = jsearch.knn_search(jg2, jnp.asarray(q), 10, 32, "l2")
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=1e-5)
        assert not np.isin(t_ids.numpy(), dead).any()

    def test_seeded_recall_matches_jax(self, graphs):
        data, q, tg, jg = graphs
        gt, _ = bruteforce_knn(data, q, 10)
        t_ids, t_d = tsearch.knn_search(
            tg, torch.from_numpy(q), 10, 32, "l2",
            seeds=tsearch.build_seed_index(tg, "l2"), compact_k=40)
        j_ids, j_d = jsearch.knn_search(
            jg, jnp.asarray(q), 10, 32, "l2",
            seeds=jsearch.build_seed_index(jg, "l2"), compact_k=40)
        j_ids, j_d = np.asarray(j_ids), np.asarray(j_d)
        r_t, r_j = recall(t_ids.numpy(), gt), recall(j_ids, gt)
        assert r_t >= 0.9 and abs(r_t - r_j) <= 0.01, (r_t, r_j)
        for i in range(len(q)):
            jd = dict(zip(j_ids[i].tolist(), j_d[i].tolist()))
            for tid, td in zip(t_ids[i].tolist(), t_d[i].tolist()):
                if tid in jd:
                    assert abs(td - jd[tid]) <= 1e-5 * max(1.0, abs(td))
