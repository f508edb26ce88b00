"""The sharded index of the torch port against the JAX package's
(`ocaml_hnsw_tpu/parallel/sharded.py`), at `tests/test_sharded.py`'s shapes:
800 x 16 clustered rows, M=8, ef_construction=40, round_size=64,
max_level_cap=2, eight shards, all on the CPU.

The JAX package builds no sharded graph here (a sharded build compiles per
mesh size for minutes); the port builds, and:

  * the JAX `ShardedIndex` on its 8-device CPU mesh loads the port's file
    and answers the same queries on the classic path: ids equal, distances
    to rtol 1e-5 (one JAX query compile);
  * the sharded `.npz` round-trips array for array both ways (names,
    dtypes, bytes);
  * the host side of `add_items` (round-robin split, per-shard level
    streams, bootstrap rows, seed-bank rows, the doubling round schedule,
    host mirrors, RNG state) equals the JAX package's own host code, run
    with its device round steps replaced by recorders, after a two-phase
    add; each round's graph update is `insert_round`, which
    tests/test_torch_incremental.py holds to the JAX package's;
  * `seed_index_from_bank` equals JAX's on one shard's graph, and the merge
    breaks distance ties as `lax.top_k` does (lower flat index first);
  * `tests/test_sharded.py`'s cases, on the port alone.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.models.graph import GraphTensors as JaxGraph
from ocaml_hnsw_tpu.models.search import (
    seed_index_from_bank as jax_seed_index_from_bank,
)
from ocaml_hnsw_tpu.oracle import bruteforce_knn, recall
from ocaml_hnsw_tpu.parallel import sharded as jsharded

from ocaml_hnsw_tpu_torch.models.graph import graph_to_numpy
from ocaml_hnsw_tpu_torch.models.search import seed_index_from_bank
from ocaml_hnsw_tpu_torch.parallel import ShardedIndex
from ocaml_hnsw_tpu_torch.parallel import sharded as tsharded
from ocaml_hnsw_tpu_torch.parallel.sharded import make_mesh

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

INIT = dict(max_elements=1000, M=8, ef_construction=40, round_size=64,
            max_level_cap=2)


def cpu_index(space: str, dim: int, shards: int = 8) -> ShardedIndex:
    return ShardedIndex(space, dim, mesh=make_mesh(shards, "cpu"))


@pytest.fixture(scope="module")
def sharded():
    data = clustered(800, 16, n_clusters=32, seed=0)
    idx = cpu_index("l2", 16)
    idx.init_index(**INIT)
    idx.add_items(data)
    return data, idx


def assert_same_files(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].shape == b[name].shape, name
            assert a[name].tobytes() == b[name].tobytes(), name


class TestAgainstJax:
    def test_jax_loads_port_file_and_answers_alike(self, sharded, tmp_path):
        data, idx = sharded
        path = tmp_path / "port.idx"
        idx.save_index(path)
        j = jsharded.ShardedIndex("l2", 16, mesh=jsharded.make_mesh(8))
        j.load_index(path)
        q = queries_like(data, 100, seed=1)
        t_lab, t_d = idx.knn_query(q, k=10, ef=48)
        j_lab, j_d = j.knn_query(q, k=10, ef=48)
        np.testing.assert_array_equal(t_lab, j_lab)
        np.testing.assert_allclose(t_d, j_d, rtol=1e-5)

    @pytest.mark.parametrize("storage", ["f32", "int8"])
    def test_checkpoint_round_trip_both_ways(self, sharded, storage,
                                             tmp_path):
        """Port file → JAX load → JAX save → port load → port save: all
        three files equal array for array."""
        data, idx = sharded
        if storage != "f32":
            idx = cpu_index("l2", 16)
            idx.init_index(**INIT, storage=storage)
            idx.add_items(data[:200])
        first, via_jax, back = (tmp_path / n for n in ("a", "b", "c"))
        idx.save_index(first)
        j = jsharded.ShardedIndex("l2", 16, mesh=jsharded.make_mesh(8))
        j.load_index(first)
        j.save_index(via_jax)
        assert_same_files(first, via_jax)
        t = cpu_index("l2", 16)
        t.load_index(via_jax)
        t.save_index(back)
        assert_same_files(first, back)

    def test_bf16_checkpoint_round_trip(self, sharded, tmp_path):
        """bf16 rows are written as their raw 2-byte values, as the JAX
        package's np.save writes them (its loader cannot read them back:
        ROADMAP.md R9), and come back bit for bit."""
        data, _ = sharded
        idx = cpu_index("l2", 16)
        idx.init_index(**INIT, storage="bf16")
        idx.add_items(data[:200])
        idx.save_index(tmp_path / "a")
        with np.load(tmp_path / "a") as z:
            assert z["g_vectors"].dtype == np.dtype("V2")
        t = cpu_index("l2", 16)
        t.load_index(tmp_path / "a")
        t.save_index(tmp_path / "b")
        assert_same_files(tmp_path / "a", tmp_path / "b")
        q = queries_like(data[:200], 20, seed=3)
        np.testing.assert_array_equal(idx.knn_query(q, k=5)[0],
                                      t.knn_query(q, k=5)[0])

    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    def test_host_side_add_matches_jax(self, metric, monkeypatch):
        """Two adds through both packages' `add_items` with every device
        round replaced by a recorder (JAX: the per-round and scan steps;
        the port: `insert_round`): the rounds (shard, start, count,
        levels), the bootstrap rows of every shard's graph and seed bank,
        the host mirrors, labels and RNG states are equal."""
        data = clustered(400, 8, n_clusters=16, seed=3)
        init = dict(max_elements=500, M=8, ef_construction=32, round_size=8,
                    max_level_cap=2)
        j = jsharded.ShardedIndex(metric, 8, mesh=jsharded.make_mesh(8))
        j.init_index(**init)
        t = cpu_index(metric, 8)
        t.init_index(**init)
        j_rounds, t_rounds = [], []

        def jax_round(mesh, stacked, vecs, levels, start, count, bank, bn,
                      bvec, bnrm, **kw):
            lv, st, ct = map(np.asarray, (levels, start, count))
            for i in np.nonzero(ct)[0]:
                j_rounds.append((int(i), int(st[i]), int(ct[i]),
                                 lv[i, :ct[i]].tolist()))
            return stacked, bank, bn, bvec, bnrm

        def jax_scan(mesh, stacked, dat, levels, dones, counts, bank, bn,
                     bvec, bnrm, **kw):
            lv, dn, ct = map(np.asarray, (levels, dones, counts))
            for c in range(ct.shape[1]):
                for i in np.nonzero(ct[:, c])[0]:
                    d0, n = int(dn[i, c]), int(ct[i, c])
                    j_rounds.append((int(i), int(j._shard_n[i]) + d0, n,
                                     lv[i, d0:d0 + n].tolist()))
            return stacked, bank, bn, bvec, bnrm

        def port_round(g, vecs, levels, start, count, max_level, bank,
                       packed, **kw):
            shard = next(i for i, x in enumerate(t._graphs) if x is g)
            t_rounds.append((shard, start, count, levels[:count].tolist()))
            return max(max_level, int(levels[:count].max()))

        monkeypatch.setattr(jsharded, "sharded_insert_round", jax_round)
        monkeypatch.setattr(jsharded, "sharded_insert_rounds_scan", jax_scan)
        monkeypatch.setattr(tsharded, "insert_round", port_round)
        for part, labels in ((data[:250], None),
                             (data[250:], np.arange(1000, 1150))):
            j.add_items(part, ids=labels)
            t.add_items(part, ids=labels)
            assert t_rounds == j_rounds
        assert len(j_rounds) > 8 * 8  # the scan chunks ran too

        for name in ("_shard_n", "_host_max_level", "_host_upper",
                     "_labels"):
            np.testing.assert_array_equal(getattr(t, name),
                                          getattr(j, name))
        for rt, rj in zip(t._rngs, j._rngs):
            st, sj = rt.get_state(), rj.get_state()
            np.testing.assert_array_equal(st[1], sj[1])
            assert st[2:] == sj[2:]
        # with every round a recorder, each graph holds its bootstrap row
        for name in JaxGraph._fields:
            got = np.stack([graph_to_numpy(g)[name] for g in t._graphs])
            np.testing.assert_array_equal(
                got, np.asarray(getattr(j._stacked, name), got.dtype), name)
        np.testing.assert_array_equal([b.n for b in t._banks],
                                      np.asarray(j._seed_n))
        for i, bank in enumerate(t._banks):
            np.testing.assert_array_equal(bank.ids.numpy(),
                                          np.asarray(j._seed_bank[i]))
            np.testing.assert_array_equal(
                bank.vecs.float().numpy(),
                np.asarray(j._seed_vecs[i], np.float32))
            np.testing.assert_array_equal(bank.norms.numpy(),
                                          np.asarray(j._seed_norms[i]))

    @pytest.mark.parametrize("metric", ["l2", "ip"])
    def test_seed_index_from_bank_matches_jax(self, sharded, metric):
        """On shard 0's graph with its bank padded past the live count."""
        _, idx = sharded
        g, bank = idx._graphs[0], idx._banks[0]
        n_live = bank.n - 2
        t = seed_index_from_bank(g, bank.ids, n_live, metric)
        jg = JaxGraph(**{f: jnp.asarray(a)
                         for f, a in graph_to_numpy(g).items()},
                      l_max_static=g.l_max_static)
        j = jax_seed_index_from_bank(jg, jnp.asarray(bank.ids.numpy()),
                                     n_live, metric)
        np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
        np.testing.assert_array_equal(t.vecs.float().numpy(),
                                      np.asarray(j.vecs, np.float32))
        np.testing.assert_allclose(t.norms.numpy(), np.asarray(j.norms),
                                   rtol=1e-6)
        np.testing.assert_array_equal(t.dead.numpy(),
                                      np.isinf(np.asarray(j.bias)))
        assert t.dead.numpy()[n_live:].all() and int(t.n) == n_live

    def test_merge_ties_match_lax_top_k(self):
        """Per-shard results with many equal distances (and -1 / +inf
        padding): the port's merge equals the JAX step's all-gather and
        `lax.top_k(-d)` on the same inputs."""
        rng = np.random.RandomState(4)
        s, b, k = 5, 64, 6
        ids = rng.randint(-1, 50, size=(s, b, k)).astype(np.int32)
        d = rng.randint(0, 4, size=(s, b, k)).astype(np.float32)
        d[ids < 0] = np.inf
        t_ids, t_d = tsharded._merge([torch.from_numpy(x) for x in ids],
                                     [torch.from_numpy(x) for x in d], k)
        gids = np.where(ids >= 0, ids * s + np.arange(s)[:, None, None], -1)
        flat_ids = jnp.moveaxis(jnp.asarray(gids), 0, 1).reshape(b, -1)
        flat_d = jnp.moveaxis(jnp.asarray(d), 0, 1).reshape(b, -1)
        neg, idx = jax.lax.top_k(-flat_d, k)
        np.testing.assert_array_equal(
            t_ids.numpy(), np.asarray(jnp.take_along_axis(flat_ids, idx, 1)))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(-neg))

    def test_duplicate_rows_resolve_to_the_lower_shard(self):
        """Every row stored twice, the copies on different shards: a query
        at a row gets both copies at distance 0, the lower shard's first."""
        base = clustered(151, 8, n_clusters=8, seed=6)
        idx = cpu_index("l2", 8, shards=2)
        idx.init_index(max_elements=302, M=8, ef_construction=32,
                       round_size=32)
        idx.add_items(np.concatenate([base, base]))
        rows = np.arange(0, 151, 10)
        labels, dists = idx.knn_query(base[rows], k=2, ef=32)
        np.testing.assert_array_equal(dists, 0.0)
        first = np.where(rows % 2 == 0, rows, rows + 151)
        np.testing.assert_array_equal(labels[:, 0], first)
        np.testing.assert_array_equal(labels[:, 1], rows + 151 + rows - first)


class TestShardedQuery:
    def test_recall(self, sharded):
        data, idx = sharded
        assert idx.get_current_count() == 800
        q = queries_like(data, 100, seed=1)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        labels, dists = idx.knn_query(q, k=10, ef=48)
        assert recall(labels, gt) >= 0.95
        assert (np.diff(dists, axis=1) >= -1e-6).all()

    def test_exact_self_hits(self, sharded):
        data, idx = sharded
        labels, dists = idx.knn_query(data[:32], k=1, ef=32)
        assert (labels[:, 0] == np.arange(32)).all()
        np.testing.assert_allclose(dists[:, 0], 0.0, atol=1e-4)

    def test_merge_is_global(self, sharded):
        data, idx = sharded
        q = queries_like(data, 20, seed=2)
        labels, _ = idx.knn_query(q, k=10, ef=64)
        assert (np.ptp(labels % 8, axis=1) > 0).any()

    def test_mark_deleted(self, sharded):
        data, idx = sharded
        labels, _ = idx.knn_query(data[5], k=1, ef=32)
        assert labels[0, 0] == 5
        idx.mark_deleted(5)
        labels, _ = idx.knn_query(data[5], k=1, ef=32)
        assert labels[0, 0] != 5
        idx.unmark_deleted(5)


class TestShardedPacked:
    def test_packed_query_matches_classic(self, sharded, monkeypatch):
        data, idx = sharded
        q = queries_like(data, 60, seed=11)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        monkeypatch.setattr(ShardedIndex, "PACKED_THRESHOLD", 100)
        idx._packed_cache = None
        assert idx._packed_shards() is not None
        lp, dp = idx.knn_query(q, k=10, ef=48)
        rp = recall(lp, gt)
        assert (np.diff(dp, axis=1) >= -1e-6).all()
        monkeypatch.setattr(ShardedIndex, "PACKED_THRESHOLD", 10**9)
        idx._packed_cache = None
        lc, _ = idx.knn_query(q, k=10, ef=48)
        assert rp >= recall(lc, gt) - 0.02, (rp, recall(lc, gt))

    def test_packed_respects_tombstones(self, sharded, monkeypatch):
        data, idx = sharded
        monkeypatch.setattr(ShardedIndex, "PACKED_THRESHOLD", 100)
        idx._packed_cache = None
        labels, _ = idx.knn_query(data[7], k=1, ef=32)
        assert labels[0, 0] == 7
        idx.mark_deleted(7)
        labels, _ = idx.knn_query(data[7], k=1, ef=32)
        assert labels[0, 0] != 7
        idx.unmark_deleted(7)
        idx._packed_cache = None


class TestShardedIncremental:
    def test_two_phase(self):
        data = clustered(400, 8, n_clusters=16, seed=3)
        idx = cpu_index("l2", 8)
        idx.init_index(max_elements=500, M=8, ef_construction=32,
                       round_size=32, max_level_cap=2)
        idx.add_items(data[:250])
        idx.add_items(data[250:])
        assert idx.get_current_count() == 400
        q = queries_like(data, 60, seed=4)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        labels, _ = idx.knn_query(q, k=10, ef=48)
        assert recall(labels, gt) >= 0.9


class TestMeshSizes:
    @pytest.mark.parametrize("n_dev", [1, 2])
    def test_small_meshes(self, n_dev):
        data = clustered(120, 8, n_clusters=6, seed=5)
        idx = cpu_index("l2", 8, shards=n_dev)
        idx.init_index(max_elements=200, M=4, ef_construction=16,
                       round_size=16, max_level_cap=1)
        idx.add_items(data)
        labels, _ = idx.knn_query(data[:10], k=1, ef=16)
        assert (labels[:, 0] == np.arange(10)).all()

    def test_no_cuda_device_raises(self):
        """Without a CUDA device, the default mesh and a "cuda" mesh raise:
        nothing falls back to the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: nothing to refuse")
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedIndex("l2", 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedIndex("l2", 8, mesh=[torch.device("cuda", 0)])
        assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
        with pytest.raises(ValueError, match="metric"):
            ShardedIndex("hamming", 8, mesh=make_mesh(2, "cpu"))


class TestShardedLifecycle:
    def test_save_load_roundtrip(self, sharded, tmp_path):
        data, idx = sharded
        q = queries_like(data, 40, seed=9)
        l1, d1 = idx.knn_query(q, k=10, ef=48)
        p = str(tmp_path / "sharded.bin")
        idx.save_index(p)
        idx2 = cpu_index("l2", 16)
        idx2.load_index(p)
        assert idx2.get_current_count() == idx.get_current_count()
        for built, loaded in zip(idx._banks, idx2._banks):
            assert torch.equal(built.vecs, loaded.vecs)
            assert torch.equal(built.norms, loaded.norms)
        l2, d2 = idx2.knn_query(q, k=10, ef=48)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(d1, d2)

    def test_load_then_incremental_add(self, sharded, tmp_path):
        data, idx = sharded
        p = str(tmp_path / "s2.bin")
        idx.save_index(p)
        idx2 = cpu_index("l2", 16)
        idx2.load_index(p, max_elements=1400)
        assert idx2.get_max_elements() == 1400
        extra = clustered(100, 16, n_clusters=4, seed=77)
        idx2.add_items(extra)
        base = idx.get_current_count()
        assert idx2.get_current_count() == base + 100
        assert idx2.get_ids_list() == list(range(base + 100))
        labels, _ = idx2.knn_query(extra[:5], k=1, ef=48)
        np.testing.assert_array_equal(labels[:, 0], base + np.arange(5))

    def test_get_items_and_unmark(self, sharded):
        data, idx = sharded
        got = idx.get_items([3, 17, 10])
        np.testing.assert_array_equal(got, data[[3, 17, 10]])
        idx.mark_deleted(3)
        l, _ = idx.knn_query(data[3], k=1, ef=32)
        assert l[0, 0] != 3
        idx.unmark_deleted(3)
        l, _ = idx.knn_query(data[3], k=1, ef=32)
        assert l[0, 0] == 3
        with pytest.raises(KeyError):
            idx.get_items([5000])

    def test_shard_count_mismatch_rejected(self, sharded, tmp_path):
        _, idx = sharded
        p = str(tmp_path / "s3.bin")
        idx.save_index(p)
        with pytest.raises(ValueError, match="shard"):
            cpu_index("l2", 16, shards=4).load_index(p)
        with pytest.raises(ValueError, match="metric/dim"):
            cpu_index("ip", 16).load_index(p)


class TestShardedStorage:
    def test_int8_build_query_saveload(self, tmp_path):
        data = clustered(400, 16, n_clusters=16, seed=21)
        idx = cpu_index("l2", 16)
        idx.init_index(max_elements=500, M=8, ef_construction=40,
                       round_size=64, max_level_cap=2, storage="int8")
        assert idx.config.storage == "int8"
        idx.add_items(data)
        q = queries_like(data, 60, seed=22)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        labels, _ = idx.knn_query(q, k=10, ef=48)
        assert recall(labels, gt) >= 0.9  # int8 quantization headroom

        p = str(tmp_path / "int8.bin")
        idx.save_index(p)
        idx2 = cpu_index("l2", 16)
        idx2.load_index(p)
        assert idx2.config.storage == "int8"
        l2_, _ = idx2.knn_query(q, k=10, ef=48)
        np.testing.assert_array_equal(labels, l2_)
