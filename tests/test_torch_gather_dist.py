"""Gather-distance (K2) of the torch port against the JAX package.

On the CPU the wrapper runs its plain torch version (the CUDA kernel is held
against that version on the card by chip_smoke.py).  The plain version is
checked here against the TPU kernel it replaces, `gather_l2` in Pallas
interpret mode, and against the JAX `dists_to_ids` whose wider contract it
takes (f32 / bf16 / int8 rows, l2 / ip / cosine, -1 ids).  Tolerance
rtol = atol = 1e-4: the summation order differs between the packages."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu.ops.distance import dists_to_ids as jax_dists_to_ids
from ocaml_hnsw_tpu.ops.pallas import gather_l2
from ocaml_hnsw_tpu.ops.quantize import quantize_rows as jax_quantize_rows

from ocaml_hnsw_tpu_torch.ops.distance import dists_to_ids
from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import (
    INT8_BIAS, INT8_MAGIC, PATHS, RING_MIN_ROW_BYTES, RING_WARPS, gather_dists,
    gather_dists_plain, int8_bits_to_float, launch_plan, ring_smem,
)
from ocaml_hnsw_tpu_torch.ops.quantize import quantize_rows

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA; the port's
# tests are small, and the lane runs about 2.5x faster this way.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, n, d, b, k, with_sentinels=True):
    rng = np.random.RandomState(seed)
    vecs = rng.randn(n, d).astype(np.float32)
    lo = -1 if with_sentinels else 0
    ids = rng.randint(lo, n, size=(b, k)).astype(np.int32)
    q = rng.randn(b, d).astype(np.float32)
    return vecs, ids, q


class TestAgainstPallasKernel:
    @pytest.mark.parametrize("n,d,b,k", [(256, 128, 16, 4), (64, 32, 8, 8)])
    def test_plain_matches_gather_l2_interpret(self, n, d, b, k):
        vecs, ids, q = _inputs(0, n, d, b, k, with_sentinels=False)
        ref = np.asarray(gather_l2(jnp.asarray(vecs), jnp.asarray(ids),
                                   jnp.asarray(q), tb=8, interpret=True))
        ones = torch.ones(n)
        out = gather_dists_plain(torch.from_numpy(vecs), ones,
                                 torch.from_numpy(q), torch.from_numpy(ids),
                                 "l2")
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


class TestInt8BitConstruction:
    """csrc/gather_dist.cu widens int8 rows without a conversion
    instruction: f32 bits INT8_MAGIC | (b ^ 0x80), minus INT8_BIAS.  That
    must be the float of the signed byte for every byte, and the rows the
    kernel is held to on the card (every value -128..127, scales from 0 to
    1e30) must give JAX's distances."""

    def test_every_byte_numpy(self):
        v = np.arange(-128, 128, dtype=np.int8)
        bits = np.uint32(INT8_MAGIC) | (v.view(np.uint8).astype(np.uint32)
                                        ^ np.uint32(0x80))
        got = bits.view(np.float32) - np.float32(INT8_BIAS)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, v.astype(np.float32))

    def test_mirror_every_byte(self):
        v = torch.arange(-128, 128).to(torch.int8)
        got = int8_bits_to_float(v)
        assert got.dtype == torch.float32
        assert torch.equal(got, v.float())

    @pytest.mark.parametrize("scale", [0.0, 1e-30, 1.0, 1e30])
    @pytest.mark.parametrize("metric", ["l2", "ip"])
    def test_every_byte_rows_match_jax(self, scale, metric):
        """Each row holds every int8 value once (quantize_rows never stores
        -128; a row written another way may); at scale 1e30 every l2
        distance overflows to +inf in both packages."""
        rng = np.random.RandomState(8)
        vals = np.arange(-128, 128, dtype=np.int8)
        rows = np.stack([rng.permutation(vals) for _ in range(40)])
        scales = np.full(40, scale, np.float32)
        ids = rng.randint(-1, 40, size=(6, 9)).astype(np.int32)
        q = rng.randn(6, 256).astype(np.float32)
        ref = np.asarray(jax_dists_to_ids(
            jnp.asarray(rows), jnp.asarray(scales), jnp.zeros(40),
            jnp.asarray(q), jnp.zeros(6), jnp.asarray(ids), metric))
        out = gather_dists_plain(torch.from_numpy(rows),
                                 torch.from_numpy(scales), torch.from_numpy(q),
                                 torch.from_numpy(ids), metric)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
        deq = int8_bits_to_float(torch.from_numpy(rows)) * scale
        assert torch.equal(deq, torch.from_numpy(rows).float() * scale)


class TestAgainstDistsToIds:
    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
    def test_matches_jax(self, storage, metric):
        vecs, ids, q = _inputs(1, 300, 40, 12, 24)
        if metric == "cosine":  # stored and queried normalized
            vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
        jrows, jscales, jnorms = jax_quantize_rows(jnp.asarray(vecs), storage)
        ref = np.asarray(jax_dists_to_ids(
            jrows, jscales, jnorms, jnp.asarray(q), jnp.zeros(12),
            jnp.asarray(ids), metric))
        rows, scales, norms = quantize_rows(torch.from_numpy(vecs), storage)
        out = dists_to_ids(rows, scales, norms, torch.from_numpy(q),
                           torch.zeros(12), torch.from_numpy(ids), metric)
        assert out.dtype == torch.float32 and out.shape == (12, 24)
        np.testing.assert_array_equal(np.isinf(out.numpy()), ids < 0)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    def test_cpu_wrapper_is_plain_version(self):
        vecs, ids, q = _inputs(2, 100, 16, 4, 8)
        args = (torch.from_numpy(vecs), torch.ones(100), torch.from_numpy(q),
                torch.from_numpy(ids), "l2")
        before = gather_dists.launches
        assert torch.equal(gather_dists(*args), gather_dists_plain(*args))
        assert gather_dists.launches == before  # no kernel ran

    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
    def test_plain_matches_jax_at_768(self, storage):
        """Phase B's width (laion, cosine): the plain version, which the
        kernel's ring path is held to on the card, equals JAX's
        dists_to_ids."""
        vecs, ids, q = _inputs(5, 64, 768, 3, 5)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        jrows, jscales, jnorms = jax_quantize_rows(jnp.asarray(vecs), storage)
        ref = np.asarray(jax_dists_to_ids(
            jrows, jscales, jnorms, jnp.asarray(q), jnp.zeros(3),
            jnp.asarray(ids), "cosine"))
        rows, scales, _ = quantize_rows(torch.from_numpy(vecs), storage)
        out = gather_dists_plain(rows, scales, torch.from_numpy(q),
                                 torch.from_numpy(ids), "cosine")
        np.testing.assert_array_equal(np.isinf(out.numpy()), ids < 0)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    def test_cpu_wrapper_counts_no_path(self):
        """A forced path on CPU tensors still runs the plain version, and no
        path's launch count moves."""
        vecs, ids, q = _inputs(6, 100, 768, 4, 8)
        args = (torch.from_numpy(vecs), torch.ones(100), torch.from_numpy(q),
                torch.from_numpy(ids), "cosine")
        before = dict(gather_dists.launches_by_path)
        assert set(before) == set(PATHS) == {"vector", "ring", "generic"}
        assert torch.equal(gather_dists(*args, path="ring"),
                           gather_dists_plain(*args))
        assert gather_dists.launches_by_path == before

    def test_cpu_wrapper_counts_no_dtype(self):
        """int8 rows on CPU tensors: the plain version, and no dtype's
        launch count moves (chip_smoke.py requires `gather_dists/int8`
        launches in phase B8 from the card's runs only)."""
        vecs, ids, q = _inputs(7, 100, 96, 4, 8)
        rows, scales, _ = quantize_rows(torch.from_numpy(vecs), "int8")
        args = (rows, scales, torch.from_numpy(q), torch.from_numpy(ids),
                "l2")
        before = dict(gather_dists.launches_by_dtype)
        assert set(before) == {"f32", "bf16", "int8"}
        assert torch.equal(gather_dists(*args), gather_dists_plain(*args))
        assert gather_dists.launches_by_dtype == before

    def test_registered_metric_on_cpu(self):
        from ocaml_hnsw_tpu_torch.ops import metrics

        metrics.register_metric(
            "l1_gather_test", lambda r, q: abs(r - q[..., None, :]).sum(-1))
        try:
            vecs, ids, q = _inputs(3, 50, 8, 3, 5)
            out = gather_dists(torch.from_numpy(vecs), torch.ones(50),
                               torch.from_numpy(q), torch.from_numpy(ids),
                               "l1_gather_test")
            want = np.abs(vecs[np.maximum(ids, 0)] - q[:, None]).sum(-1)
            want = np.where(ids < 0, np.inf, want)
            np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)
        finally:
            metrics.unregister_metric("l1_gather_test")

    def test_registered_metric_equals_jax_and_is_counted_apart(self):
        """A metric outside KERNEL_METRICS goes through its own pair_dist
        (on any device), equals the JAX package's dists_to_ids under the
        same registered metric, and is counted apart from kernel launches."""
        from ocaml_hnsw_tpu.ops import metrics as jmetrics
        from ocaml_hnsw_tpu_torch.ops import metrics

        def l1(r, q):
            return abs(r - q[..., None, :]).sum(-1)

        for reg in (jmetrics, metrics):
            if not reg.is_metric("l1"):
                reg.register_metric("l1", l1)
        vecs, ids, q = _inputs(4, 300, 40, 12, 24)
        for storage in ("f32", "int8"):
            jrows, jscales, jnorms = jax_quantize_rows(jnp.asarray(vecs),
                                                       storage)
            ref = np.asarray(jax_dists_to_ids(
                jrows, jscales, jnorms, jnp.asarray(q), jnp.zeros(12),
                jnp.asarray(ids), "l1"))
            rows, scales, norms = quantize_rows(torch.from_numpy(vecs),
                                                storage)
            before = gather_dists.launches, gather_dists.registry_calls
            out = dists_to_ids(rows, scales, norms, torch.from_numpy(q),
                               torch.zeros(12), torch.from_numpy(ids), "l1")
            assert (gather_dists.launches, gather_dists.registry_calls) == (
                before[0], before[1] + 1)
            np.testing.assert_array_equal(np.isinf(out.numpy()), ids < 0)
            np.testing.assert_allclose(out.numpy(), ref, **TOL)


class TestLaunchPlan:
    """How csrc/gather_dist.cu splits a call into warp tasks and rows."""

    @pytest.mark.parametrize("dim,itemsize,aligned,path", [
        (128, 4, True, "vector"), (128, 2, True, "vector"),
        (128, 1, True, "vector"), (100, 4, True, "vector"),
        (96, 1, True, "vector"), (768, 4, True, "ring"),
        (1024, 1, True, "vector"), (16, 1, True, "vector"),
        (100, 2, True, "generic"), (100, 1, True, "generic"),
        (128, 4, False, "generic"), (2048, 4, True, "ring"),
        (2304, 4, True, "ring"), (2304, 1, True, "ring"),
        (512, 4, True, "ring"), (384, 4, True, "vector"),
        (768, 4, False, "generic"), (65536, 4, True, "generic")])
    def test_path_from_width_and_alignment(self, dim, itemsize, aligned,
                                           path):
        p = launch_plan(1024, 32, dim, itemsize, aligned)
        assert p.path == path
        if path == "vector":
            chunks = dim * itemsize // 16
            lanes = 1 << p.lpr_log2
            assert lanes * p.cpl >= chunks  # every chunk has a lane
            assert lanes == 32 or lanes >= chunks
            assert p.cpl * 16 // itemsize <= 32  # query floats per lane
        if path == "ring":
            assert dim * itemsize >= RING_MIN_ROW_BYTES or dim > 1024
            assert p.rows_per_iteration <= p.stages  # a group fits the ring
            assert p.lpr_log2 >= 3  # 8 lanes of a quarter-warp on one row

    @pytest.mark.parametrize("itemsize", [4, 2, 1])
    def test_ring_smem_fits(self, itemsize):
        """Every 16-byte-multiple width up to 4096 elements has a ring whose
        block (stages x row bytes + query bytes per warp, and the
        mbarriers) fits in the shared memory one block may use."""
        step = 16 // itemsize
        for dim in range(step, 4097, step):
            p = launch_plan(4096, 96, dim, itemsize, True, path="ring")
            assert p.smem_bytes == ring_smem(dim, itemsize, p.stages,
                                             p.warps)
            barriers = -(-p.warps * (p.stages + 1) * 8 // 128) * 128
            assert p.smem_bytes == barriers + p.warps * (
                p.stages * dim * itemsize + 4 * dim)
            assert p.smem_bytes <= _lib.SMEM_LIMIT
            assert 1 <= p.warps <= RING_WARPS
            assert 32 >> p.lpr_log2 <= p.stages <= 32

    @pytest.mark.parametrize("dim,itemsize,aligned,path", [
        (768, 4, False, "ring"), (100, 2, True, "ring"),
        (2304, 4, True, "vector"), (128, 4, False, "vector"),
        (128, 4, True, "bogus")])
    def test_forced_path_the_shape_cannot_take_raises(self, dim, itemsize,
                                                      aligned, path):
        with pytest.raises(ValueError):
            launch_plan(64, 9, dim, itemsize, aligned, path=path)

    @pytest.mark.parametrize("path", ["vector", "ring", "generic"])
    def test_forced_path_is_taken(self, path):
        p = launch_plan(4096, 96, 768, 4, True, path=path)
        assert p.path == path
        assert 1 <= p.kc <= 32 and p.kc * p.nchunks >= 96

    @pytest.mark.parametrize("b,k", [(1, 1), (1000, 13), (8192, 8),
                                     (8192, 32), (1024, 97), (7, 33),
                                     (3, 200)])
    @pytest.mark.parametrize("dim,itemsize", [(128, 4), (128, 1), (100, 2),
                                              (768, 4)])
    def test_tasks_cover_ragged_k(self, b, k, dim, itemsize):
        p = launch_plan(b, k, dim, itemsize, True)
        assert 1 <= p.kc <= 32  # one id per lane
        assert p.kc * p.nchunks >= k > (p.nchunks - 1) * p.kc  # none empty

    def test_grid_fills_the_card_at_knn_table_shape(self):
        # B = 1024 queries alone would be 1024 warps; K is split instead
        p = launch_plan(1024, 97, 128, 4, True, sm_count=132)
        assert 1024 * p.nchunks >= 32 * 132


class TestKernelBuild:
    def test_library_name_hashes_sources(self):
        p = _lib.library_path()
        assert p.parent == _lib.BUILD_DIR
        assert p.name.startswith("libohnsw_kernels_") and p.suffix == ".so"
        assert p == _lib.library_path()  # stable for unchanged sources
        assert sorted(s.name for s in _lib.CSRC.glob("*.cu")) == [
            "beam_update.cu", "gather_dist.cu", "payload_score.cu",
            "scan_topk.cu", "scan_topk_wgmma.cu"]

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc"):
            _lib._nvcc()
