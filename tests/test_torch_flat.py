"""The flat engine of the torch port against the JAX package's
(`ocaml_hnsw_tpu/models/flat.py`, `api.FlatIndex` / `BFIndex`), on the CPU.

One dataset (3000 x 32 normal rows in a 4096-slot index, so a quarter of the
slots are empty; 64 queries; k=10, rerank_k=32) goes through every scan mode
of both packages.  One (k, rerank_k) pair and one shape keep the JAX side to
one compiled program per mode.

  * `flat_add`: the int8 and bf16 scan bytes and the scales' bits equal
    JAX's; rerank rows equal; norms to 1e-6 (f32 summation order).
  * `flat_search`: ids equal on this tie-free data in every mode (the JAX
    package's `approx_min_k` is an exact top-k on the CPU; where the
    hardware approximates it, the port's exact candidates are no worse), distances
    at rtol = atol = 1e-5: both reranks are exact over the same stored rows,
    bf16 rerank rows included (those distances differ from the true f32
    ones by up to 1e-2 relative: checked against the rows themselves).
  * Results do not depend on the scan's tiling.
  * `FlatIndex` / `BFIndex`: the surface, resize, and files both ways.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu import api as japi
from ocaml_hnsw_tpu.models import flat as jflat
from ocaml_hnsw_tpu.ops import metrics as jmetrics
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn

from ocaml_hnsw_tpu_torch import BFIndex, FlatIndex
from ocaml_hnsw_tpu_torch.models import flat as tflat
from ocaml_hnsw_tpu_torch.ops.kernels import scan_topk as k3
from ocaml_hnsw_tpu_torch.ops import metrics as tmetrics

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

N, CAP, DIM, B, K, RK = 3000, 4096, 32, 64, 10, 32
#: mode -> (scan_dtype, rerank_dtype, metric, exact)
MODES = {
    "bf16": ("bf16", "f32", "l2", False),
    "int8": ("int8", "f32", "l2", False),
    "exact": ("bf16", "f32", "l2", True),
    "int8_bf16rerank": ("int8", "bf16", "l2", False),
    "cosine": ("bf16", "f32", "cosine", False),
    "l1": ("bf16", "f32", "l1", False),
}


def _l1_pair(rows, q):
    return abs(rows - q[..., None, :]).sum(-1)


@pytest.fixture(scope="module", autouse=True)
def l1_metric():
    for reg in (jmetrics, tmetrics):
        if not reg.is_metric("l1"):
            reg.register_metric("l1", _l1_pair)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.RandomState(0)
    return (rng.randn(N, DIM).astype(np.float32),
            rng.randn(B, DIM).astype(np.float32))


def _prep(x, metric):
    if metric == "cosine":  # both packages normalize before flat_add
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    return x


_built = {}


def built(mode, rows):
    """(port FlatTensors, JAX FlatTensors) of `mode`, built once: two adds
    (2000 rows, then 1000) in both packages."""
    if mode not in _built:
        sd, rd, metric, _ = MODES[mode]
        x = _prep(rows[0], metric)
        t = tflat.empty_flat(DIM, CAP, scan_dtype=sd, rerank_dtype=rd,
                             device="cpu")
        j = jflat.empty_flat(DIM, CAP, scan_dtype=sd, rerank_dtype=rd)
        for lo, hi in ((0, 2000), (2000, N)):
            tflat.flat_add(t, torch.from_numpy(x[lo:hi]), lo, hi - lo)
            pad = np.zeros((2048, DIM), np.float32)
            pad[:hi - lo] = x[lo:hi]
            j = jflat.flat_add(j, jnp.asarray(pad), jnp.int32(lo),
                               jnp.int32(hi - lo))
        _built[mode] = (t, j)
    return _built[mode]


def bits(a):
    """The raw bytes of a torch tensor or JAX array as a numpy integer
    array (bf16 has no numpy dtype)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(f"i{a.element_size()}")
    a = np.asarray(a)
    return a.view(f"i{a.dtype.itemsize}")


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_bf16rerank",
                                  "cosine"])
def test_flat_add_equals_jax(rows, mode):
    t, j = built(mode, rows)
    assert t.n_cap == j.n_cap == CAP and int(t.n) == int(j.n) == N
    np.testing.assert_array_equal(bits(t.scan), bits(j.scan))
    np.testing.assert_array_equal(bits(t.scales), bits(j.scales))
    np.testing.assert_array_equal(bits(t.rerank), bits(j.rerank))
    np.testing.assert_allclose(t.norms.numpy(), np.asarray(j.norms),
                               rtol=1e-6)
    assert np.isinf(t.norms.numpy()[N:]).all()
    assert t.scan.device.type == "cpu"


def _search_both(mode, rows, t, j):
    _, _, metric, exact = MODES[mode]
    t_ids, t_d = tflat.flat_search(t, torch.from_numpy(rows[1]), K, metric,
                                   rerank_k=RK, exact=exact)
    j_ids, j_d = jflat.flat_search(j, jnp.asarray(rows[1]), k=K,
                                   metric=metric, rerank_k=RK, exact=exact)
    return t_ids.numpy(), t_d.numpy(), np.asarray(j_ids), np.asarray(j_d)


@pytest.mark.parametrize("mode", list(MODES))
def test_flat_search_equals_jax(rows, mode):
    t, j = built(mode, rows)
    t_ids, t_d, j_ids, j_d = _search_both(mode, rows, t, j)
    assert t_ids.dtype == np.int32 and t_ids.shape == (B, K)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-5)
    assert (t_ids >= 0).all() and (t_ids < N).all()  # no empty slot
    _, _, metric, exact = MODES[mode]
    if exact or metric == "l1":  # the exact scans equal brute force
        gt, _ = bruteforce_knn(rows[0], rows[1], K, metric=metric)
        np.testing.assert_array_equal(t_ids, gt)
    if mode == "int8_bf16rerank":  # bf16 rows: 1e-2 of the true distances
        true = ((rows[0][t_ids] - rows[1][:, None, :]) ** 2).sum(-1)
        np.testing.assert_allclose(t_d, true, rtol=1e-2)


@pytest.mark.parametrize("mode", ["bf16", "int8", "l1"])
def test_tombstones_equal_jax(rows, mode):
    t, j = built(mode, rows)
    first = _search_both(mode, rows, t, j)[0]
    dead = np.unique(first[:, :3])  # every query's three nearest
    t.deleted[torch.from_numpy(dead).long()] = True
    try:
        j2 = j._replace(deleted=j.deleted.at[jnp.asarray(dead)].set(True))
        t_ids, t_d, j_ids, j_d = _search_both(mode, rows, t, j2)
    finally:
        t.deleted[:] = False
    assert not np.isin(t_ids, dead).any()
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "int8", "exact", "cosine", "l1"])
def test_results_do_not_depend_on_tiling(rows, mode, monkeypatch):
    """Whole, query blocks of 16 over all rows, and 16-query blocks against
    1024-row slabs: equal ids and distances."""
    t, _ = built(mode, rows)
    _, _, metric, exact = MODES[mode]
    q = torch.from_numpy(rows[1])
    want = tflat.flat_search(t, q, K, metric, rerank_k=RK, exact=exact)
    monkeypatch.setattr(tflat, "Q_BLOCK", 16)
    for budget in (4 * 16 * CAP, 4 * 16 * 1024):
        monkeypatch.setattr(tflat, "SCORE_BUDGET_BYTES", budget)
        got = tflat.flat_search(t, q, K, metric, rerank_k=RK, exact=exact)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b,n_cap,budget,q_block,want", [
    (64, 4096, 4 << 30, 1024, (64, 4096)),          # whole
    (8192, 1 << 20, 4 << 30, 1024, (1024, 1 << 20)),  # query blocks
    (8192, 10_002_432, 4 << 30, 1024, (1024, 1 << 20)),  # and row slabs
    (64, 4096, 4 * 16 * 4096, 16, (16, 4096)),
    (64, 4096, 4 * 16 * 1024, 16, (16, 1024)),
])
def test_scan_tiles(monkeypatch, b, n_cap, budget, q_block, want):
    monkeypatch.setattr(tflat, "SCORE_BUDGET_BYTES", budget)
    monkeypatch.setattr(tflat, "Q_BLOCK", q_block)
    qb, slab = tflat.scan_tiles(b, n_cap)
    assert (qb, slab) == want
    assert qb * slab * 4 <= budget


def test_int8_dot_is_exact():
    rng = np.random.RandomState(1)
    a = rng.randint(-127, 128, size=(9, 1100)).astype(np.int8)
    x = rng.randint(-127, 128, size=(50, 1100)).astype(np.int8)
    got = k3.int8_dot(torch.from_numpy(a), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  a.astype(np.int64) @ x.astype(np.int64).T)


# ------------------------------------------------------- FlatIndex, BFIndex
def test_flat_index_surface(rows):
    x, q = rows
    fi = FlatIndex("l2", DIM, device="cpu")
    with pytest.raises(RuntimeError, match="init_index"):
        fi.knn_query(q, k=1)
    fi.init_index(max_elements=N + 1)
    assert fi.get_current_count() == 0
    with pytest.raises(RuntimeError, match="empty"):
        fi.knn_query(q, k=1)
    labels = np.arange(N) * 3 + 7
    fi.add_items(x[:2000], ids=labels[:2000])
    fi.add_items(x[2000:], ids=labels[2000:])
    assert fi.get_current_count() == N
    assert fi.get_ids_list() == labels.tolist()
    lab, d = fi.knn_query(x[:5], k=1)  # 5 queries pad to a bucket of 8
    assert lab[:, 0].tolist() == labels[:5].tolist() and (d[:, 0] == 0).all()
    assert lab.dtype == np.int64 and d.dtype == np.float32
    with pytest.raises(ValueError, match="duplicate"):
        fi.add_items(x[:1], ids=[7])
    with pytest.raises(ValueError, match="dim"):
        fi.add_items(np.zeros((1, DIM + 1), np.float32))
    with pytest.raises(RuntimeError, match="full"):
        fi.add_items(x[:2], ids=[1, 2])
    fi.mark_deleted(7)
    assert fi.knn_query(x[:1], k=1)[0][0, 0] != 7
    fi.unmark_deleted(7)
    fi.delete_vector(10)
    assert fi.knn_query(x[1:2], k=1)[0][0, 0] != 10
    fi.unmark_deleted(10)
    # resize past the padded capacity: old answers stay, new rows fit
    before = fi.knn_query(q, k=K)
    with pytest.raises(ValueError, match="shrink"):
        fi.resize_index(10)
    fi.resize_index(5000)
    assert fi._flat.n_cap == 8192 and np.isinf(
        fi._flat.norms.numpy()[N:]).all()
    after = fi.knn_query(q, k=K)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    fi.add_items(q[:4], ids=[1, 2, 4, 5])
    assert fi.knn_query(q[:4], k=1)[0][:, 0].tolist() == [1, 2, 4, 5]
    # k above the live count pads with -1 / +inf
    tiny = FlatIndex("l2", DIM, device="cpu")
    tiny.init_index(max_elements=3)
    tiny.add_items(x[:3])
    lab, d = tiny.knn_query(q[:2], k=5)
    assert (lab[:, 3:] == -1).all() and np.isinf(d[:, 3:]).all()
    assert (lab[:, :3] >= 0).all()


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_bf_index_equals_bruteforce(rows, metric):
    x, q = rows
    bf = BFIndex(metric, DIM, device="cpu")
    bf.init_index(max_elements=N)
    bf.add_items(x)
    lab, d = bf.knn_query(q, k=K)
    gt, gd = bruteforce_knn(x, q, K, metric=metric)
    np.testing.assert_array_equal(lab, gt)
    np.testing.assert_allclose(d, gd, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sd,rd", [("bf16", "f32"), ("int8", "bf16")])
def test_files_cross_between_packages(rows, tmp_path, sd, rd):
    """JAX writes, the port loads and answers the same; the port writes,
    JAX loads and answers the same; a reload with max_elements resizes."""
    x, q = rows
    labels = np.arange(N) + 100
    ji = japi.FlatIndex("l2", DIM)
    ji.init_index(max_elements=CAP, rerank_k=RK, scan_dtype=sd,
                  rerank_dtype=rd)
    ji.add_items(x, ids=labels)
    ji.mark_deleted(105)
    j_lab, j_d = ji.knn_query(q, k=K)
    ji.save_index(tmp_path / "jax.bin")

    ti = FlatIndex("l2", DIM, device="cpu")
    ti.load_index(tmp_path / "jax.bin")
    assert ti._flat.scan.dtype == tflat._SCAN_DTYPES[sd]
    assert ti._flat.rerank.dtype == tflat._RERANK_DTYPES[rd]
    assert ti.get_current_count() == N and ti.max_elements == CAP
    t_lab, t_d = ti.knn_query(q, k=K)
    np.testing.assert_array_equal(t_lab, j_lab)
    np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-5)
    assert 105 not in t_lab

    ti.save_index(tmp_path / "torch.bin")
    with np.load(tmp_path / "torch.bin") as a, \
            np.load(tmp_path / "jax.bin") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in b.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    j2 = japi.FlatIndex("l2", DIM)
    j2.load_index(tmp_path / "torch.bin")
    j2_lab, j2_d = j2.knn_query(q, k=K)
    np.testing.assert_array_equal(j2_lab, t_lab)
    np.testing.assert_allclose(j2_d, t_d, rtol=1e-5, atol=1e-5)

    grown = FlatIndex("l2", DIM, device="cpu")
    grown.load_index(tmp_path / "torch.bin", max_elements=6000)
    assert grown.max_elements == 6000 and grown._flat.n_cap == 8192
    np.testing.assert_array_equal(grown.knn_query(q, k=K)[0], t_lab)
    with pytest.raises(ValueError, match="index file is l2"):
        FlatIndex("ip", DIM, device="cpu").load_index(tmp_path / "torch.bin")


def test_file_without_dtype_tags_loads(rows, tmp_path):
    """Files from before the scan/rerank split: f32 rerank rows only."""
    x, q = rows
    fi = FlatIndex("l2", DIM, device="cpu")
    fi.init_index(max_elements=N)
    fi.add_items(x)
    want = fi.knn_query(q, k=K)
    fi.save_index(tmp_path / "new.bin")
    with np.load(tmp_path / "new.bin") as z:
        old = {k: z[k] for k in z.files
               if k not in ("scan", "scan_dtype", "rerank_dtype", "scales")}
    with open(tmp_path / "old.bin", "wb") as f:
        np.savez(f, **old)
    li = FlatIndex("l2", DIM, device="cpu")
    li.load_index(tmp_path / "old.bin")
    assert li._flat.scan.dtype == torch.float32
    got = li.knn_query(q, k=K)
    np.testing.assert_array_equal(got[0], want[0])


def test_flat_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        FlatIndex("l2", DIM)
    with pytest.raises(RuntimeError, match="CUDA"):
        BFIndex("l2", DIM)
    with pytest.raises((RuntimeError, AssertionError)):
        tflat.empty_flat(DIM, 16)  # device="cuda" by default
