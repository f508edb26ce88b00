"""The port's main path end to end on the CPU, against the JAX package:
`Index(..., device="cpu")` through init_index → add_items (bulk build) →
knn_query (seed scan + packed engine) on 4000 x 24 clustered data, with the
bulk, seed and packed thresholds lowered on both packages so this size
takes the path a 1M index takes.

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
def indexes(low_thresholds):
    data = clustered(N, DIM, n_clusters=32, seed=1)
    t = Index("l2", DIM, device="cpu")
    t.init_index(**INIT)
    t.add_items(data)
    j = JaxIndex("l2", DIM)
    j.init_index(**INIT)
    j.add_items(data)
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
    def test_small_or_second_add_raises(self, low_thresholds):
        t = Index("l2", 8, device="cpu")
        t.init_index(max_elements=500)
        with pytest.raises(NotImplementedError, match="incremental build"):
            t.add_items(np.zeros((100, 8), np.float32))
        assert t.get_current_count() == 0

    def test_classic_engine_raises(self, indexes):
        data, t, _ = indexes
        with pytest.raises(NotImplementedError, match="classic"):
            t.knn_query(data[:2], k=3, engine="classic")

    def test_cuda_device_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: nothing to refuse")
        with pytest.raises(RuntimeError, match="CUDA"):
            Index("l2", 8, device="cuda")
        with pytest.raises(ValueError):
            Index("hamming", 8, device="cpu")


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
    )
    root = ocaml_hnsw_tpu_torch.__path__[0].rsplit("/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout
