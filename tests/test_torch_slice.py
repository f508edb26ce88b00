"""The port's public API end to end on the CPU, against the JAX package:
`Index(..., device="cpu")` through init_index → add_items (bulk build) →
knn_query (seed scan + packed engine) on 4000 x 24 clustered data, with the
bulk, seed and packed thresholds lowered on both packages so this size
takes the path a 1M index takes (the JAX Index answers from the same graph,
loaded from the port's checkpoint file); a small index through incremental
adds, the classic engine and save/load/resize; and a registered metric.

Recall@10 against the brute-force oracle must be within 0.01 of the JAX
Index's (the packages differ legitimately in the kNN table's top-k, the
seed top-k and the beam's bf16 products), and returned distances of shared
ids equal to 1e-5 (both are exact f32 reranks)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from ocaml_hnsw_tpu.api import Index as JaxIndex
from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.models.build import BuildState as JaxBuildState
from ocaml_hnsw_tpu.models.build import sample_levels as jax_sample_levels
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn, recall

import ocaml_hnsw_tpu_torch
from ocaml_hnsw_tpu_torch import Index
from ocaml_hnsw_tpu_torch.models.build import BuildState

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA; the port's
# tests are small, and the lane runs about 2.5x faster this way.
torch.set_num_threads(1)

N, DIM = 4000, 24
KNOBS = dict(k=10, ef=64, max_iters=24, rerank_k=32, expand=2, interleave=2)
INIT = dict(max_elements=N, M=12, ef_construction=80, round_size=95)


@pytest.fixture(scope="module")
def low_thresholds():
    mp = pytest.MonkeyPatch()
    for cls in (BuildState, JaxBuildState):
        mp.setattr(cls, "BULK_THRESHOLD", 1000)
    for cls in (Index, JaxIndex):
        mp.setattr(cls, "SEED_THRESHOLD", 1000)
        mp.setattr(cls, "PACKED_THRESHOLD", 1000)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def indexes(low_thresholds, tmp_path_factory):
    """The port builds in bulk; the JAX Index loads that graph from the
    port's checkpoint file and packs and seeds it itself, so the two query
    paths are compared on one graph.  (A JAX bulk build here compiled for
    half a minute; the bulk constructor is held to JAX's pass by pass, and
    its graph's recall to that of JAX's own build, in
    tests/test_torch_bulk.py.)"""
    data = clustered(N, DIM, n_clusters=32, seed=1)
    t = Index("l2", DIM, device="cpu")
    t.init_index(**INIT)
    t.add_items(data)
    path = tmp_path_factory.mktemp("slice") / "bulk.idx"
    t.save_index(path)
    j = JaxIndex("l2", DIM)
    j.load_index(path)
    return data, t, j


class TestSlice:
    def test_recall_and_distances_match_jax(self, indexes):
        data, t, j = indexes
        q = queries_like(data, 300, seed=5)
        gt, _ = bruteforce_knn(data, q, 10)
        t_lab, t_d = t.knn_query(q, **KNOBS)
        j_lab, j_d = j.knn_query(q, **KNOBS)
        assert t_lab.shape == (300, 10) and t_d.dtype == np.float32
        r_t, r_j = recall(t_lab, gt), recall(j_lab, gt)
        assert r_t >= 0.9 and abs(r_t - r_j) <= 0.01, (r_t, r_j)
        shared = 0
        for i in range(len(q)):
            jd = dict(zip(j_lab[i].tolist(), j_d[i].tolist()))
            for lab, d in zip(t_lab[i].tolist(), t_d[i].tolist()):
                if lab in jd:
                    shared += 1
                    assert abs(d - jd[lab]) <= 1e-5 * max(1.0, abs(d))
        assert shared >= 0.9 * t_lab.size
        assert (np.diff(t_d, axis=1) >= 0).all()

    def test_tombstone_hides_nearest(self, indexes):
        data, t, _ = indexes
        q = queries_like(data, 4, seed=6)
        lab, _ = t.knn_query(q, **KNOBS)
        victim = int(lab[0, 0])
        t.mark_deleted(victim)
        try:
            lab2, _ = t.knn_query(q, **KNOBS)
            assert victim not in lab2[0].tolist()
        finally:
            t.unmark_deleted(victim)
        lab3, _ = t.knn_query(q, **KNOBS)
        assert int(lab3[0, 0]) == victim

    def test_surface(self, indexes):
        data, t, _ = indexes
        assert t.get_current_count() == N
        assert t.get_max_elements() == N
        assert t.get_ids_list() == list(range(N))
        assert t.graph.vectors.device.type == "cpu"
        t.set_ef(20)
        lab, d = t.knn_query(data[:3], k=1)  # ef from set_ef, one query pads
        assert lab[:, 0].tolist() == [0, 1, 2] and (d[:, 0] == 0).all()
        with pytest.raises(KeyError):
            t.mark_deleted(10**9)
        with pytest.raises(ValueError):
            t.add_items(np.zeros((2, DIM + 1), np.float32))


class TestNotYetPorted:
    """A user below the bulk and packed thresholds: a small first add, a
    later add, the classic engine, save/load/resize — and what the port
    refuses there (an add past capacity, the packed engine on a small index,
    a CUDA device without a card).  The class and test names date from when
    these paths raised; they are kept so that a test's history stays under
    one name, and each docstring says what it checks now."""

    @pytest.fixture(scope="class")
    def small(self):
        data = clustered(500, 8, n_clusters=8, seed=2)
        t = Index("l2", 8, device="cpu")
        t.init_index(max_elements=500, M=8, ef_construction=32,
                     round_size=64)
        t.add_items(data[:300])  # incremental from empty
        t.add_items(data[300:])  # a second add
        return data, t

    def test_small_or_second_add_raises(self, small):
        """A small first add and a second add build (the rounds themselves
        are held to the JAX package's in tests/test_torch_incremental.py):
        the levels of the JAX package's stream for both adds, and recall.
        An add past capacity raises."""
        data, t = small
        assert t.get_current_count() == 500
        rng = np.random.RandomState(100)
        cfg = t.config
        want = np.concatenate([
            jax_sample_levels(rng, 300, cfg.mL, t._state.l_max),
            jax_sample_levels(rng, 200, cfg.mL, t._state.l_max)])
        np.testing.assert_array_equal(t.graph.levels.numpy()[:500], want)
        q = queries_like(data, 50, seed=3)
        gt, _ = bruteforce_knn(data, q, 10)
        assert recall(t.knn_query(q, k=10, ef=32)[0], gt) >= 0.95
        with pytest.raises(RuntimeError, match="full"):
            t.add_items(np.zeros((1, 8), np.float32))

    def test_classic_engine_raises(self, small, indexes):
        """The classic engine serves any index; the packed engine, forced on
        a small index, raises."""
        data, t = small
        lab, d = t.knn_query(data[:4], k=3, engine="classic")
        assert lab[:, 0].tolist() == [0, 1, 2, 3] and (d[:, 0] == 0).all()
        with pytest.raises(RuntimeError, match="packed engine unavailable"):
            t.knn_query(data[:2], k=3, engine="packed")
        # the large index answers on the classic engine too when asked
        big_data, big, _ = indexes
        lab, _ = big.knn_query(big_data[:3], k=1, engine="classic",
                               compact_k=None)
        assert lab[:, 0].tolist() == [0, 1, 2]

    def test_save_load_resize(self, small, tmp_path):
        data, t = small
        t.save_index(tmp_path / "idx.bin")
        u = Index("l2", 8, device="cpu")
        u.load_index(tmp_path / "idx.bin", max_elements=600)
        assert u.get_max_elements() == 600 and u.get_current_count() == 500
        q = queries_like(data, 20, seed=4)
        a, b = t.knn_query(q, k=5, ef=32), u.knn_query(q, k=5, ef=32)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        u.add_items(q[:10], ids=np.arange(1000, 1010))
        assert u.knn_query(q[:10], k=1)[0][:, 0].tolist() == list(
            range(1000, 1010))
        np.testing.assert_array_equal(u.get_items([1000, 7]),
                                      np.stack([q[0], data[7]]))
        with pytest.raises(RuntimeError, match="full"):
            u.add_items(np.zeros((100, 8), np.float32))
        u.resize_index(700)
        u.add_items(np.zeros((100, 8), np.float32))
        assert u.get_current_count() == 610

    def test_cuda_device_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: nothing to refuse")
        with pytest.raises(RuntimeError, match="CUDA"):
            Index("l2", 8, device="cuda")
        with pytest.raises(ValueError):
            Index("hamming", 8, device="cpu")


def test_registered_metric_index_matches_jax(tmp_path):
    """A metric registered from outside (L1, no matmul form) through both
    packages' Index: the port builds, both answer (greedy-descent entry,
    `pair_dist` on the gathered rows).  The returned ids are equal and are
    the exact L1 neighbours; distances to 1e-5."""
    from ocaml_hnsw_tpu.ops import metrics as jmetrics
    from ocaml_hnsw_tpu_torch.ops import metrics as tmetrics

    def l1(rows, q):
        return abs(rows - q[..., None, :]).sum(-1)

    for reg in (jmetrics, tmetrics):
        if not reg.is_metric("l1"):
            reg.register_metric("l1", l1)
    rng = np.random.RandomState(3)
    data = rng.randn(300, 8).astype(np.float32)
    q = rng.randn(16, 8).astype(np.float32)
    init = dict(max_elements=300, M=8, ef_construction=48, random_seed=5,
                round_size=64)
    t = Index("l1", 8, device="cpu")
    t.init_index(**init)
    t.add_items(data)
    # the JAX Index serves the graph the port built (carried over by the
    # checkpoint file): a JAX build under a new metric would compile its
    # insert round for half a minute, and builds are held to JAX's in
    # tests/test_torch_incremental.py
    t.save_index(tmp_path / "l1.idx")
    j = JaxIndex("l1", 8)
    j.load_index(tmp_path / "l1.idx")
    t_lab, t_d = t.knn_query(q, k=5, ef=64)
    j_lab, j_d = j.knn_query(q, k=5, ef=64)
    np.testing.assert_array_equal(t_lab, j_lab)
    np.testing.assert_allclose(t_d, j_d, rtol=1e-5)
    gt, _ = bruteforce_knn(data, q, 5, metric="l1")
    np.testing.assert_array_equal(t_lab, gt)


def test_import_pulls_in_no_jax():
    """Importing the port (every module of it) loads neither jax nor the
    JAX package."""
    code = (
        "import pkgutil, importlib, sys, ocaml_hnsw_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'ocaml_hnsw_tpu' or "
        "m.startswith('ocaml_hnsw_tpu.'))\n"
        "print(len(bad), bad[:5])\n"
        "print(' '.join(sorted(m for m in sys.modules "
        "if m.startswith('ocaml_hnsw_tpu_torch'))))\n"
    )
    root = ocaml_hnsw_tpu_torch.__path__[0].rsplit("/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout
    loaded = set(out.stdout.splitlines()[1].split())
    for m in ("io", "api", "models.build", "models.search", "models.packed",
              "models.refine", "models.flat", "ops.bitset", "utils.profiling",
              "bench.datasets", "bench.harness", "bench.__main__",
              "parallel", "parallel.sharded"):
        assert f"ocaml_hnsw_tpu_torch.{m}" in loaded, m
