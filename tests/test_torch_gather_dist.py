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
    gather_dists, gather_dists_plain, launch_plan,
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

    @pytest.mark.parametrize("dim,itemsize,aligned,vector", [
        (128, 4, True, True), (128, 2, True, True), (128, 1, True, True),
        (100, 4, True, True), (96, 1, True, True), (768, 4, True, True),
        (1024, 1, True, True), (16, 1, True, True),
        (100, 2, True, False), (100, 1, True, False), (128, 4, False, False),
        (2048, 4, True, False)])
    def test_path_from_width_and_alignment(self, dim, itemsize, aligned,
                                           vector):
        p = launch_plan(1024, 32, dim, itemsize, aligned)
        assert (p.cpl > 0) == vector
        if vector:
            chunks = dim * itemsize // 16
            lanes = 1 << p.lpr_log2
            assert lanes * p.cpl >= chunks  # every chunk has a lane
            assert lanes == 32 or lanes >= chunks
            assert p.cpl * 16 // itemsize <= 32  # query floats per lane

    @pytest.mark.parametrize("b,k", [(1, 1), (1000, 13), (8192, 8),
                                     (8192, 32), (1024, 97), (7, 33),
                                     (3, 200)])
    @pytest.mark.parametrize("dim,itemsize", [(128, 4), (128, 1), (100, 2)])
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
            "gather_dist.cu", "payload_score.cu"]

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc"):
            _lib._nvcc()
