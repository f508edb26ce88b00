"""Parity of the torch port's small ops with the JAX package: bitonic
networks (same tie order), dedup, quantization, compaction, the Alg-4 admit
loop, the metric registry, config, and the dataset generators.  The same
NumPy inputs go through both packages; where the arithmetic is the same the
outputs must be equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu.bench import datasets as jds
from ocaml_hnsw_tpu.config import HnswConfig as JaxConfig
from ocaml_hnsw_tpu.models import build as jbuild
from ocaml_hnsw_tpu.ops import bitset as jbitset
from ocaml_hnsw_tpu.ops import quantize as jquant
from ocaml_hnsw_tpu.ops import sortmerge as jsm

from ocaml_hnsw_tpu_torch.bench import datasets as tds
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import build as tbuild
from ocaml_hnsw_tpu_torch.ops import bitset as tbitset
from ocaml_hnsw_tpu_torch.ops import metrics as tmetrics
from ocaml_hnsw_tpu_torch.ops import quantize as tquant
from ocaml_hnsw_tpu_torch.ops import sortmerge as tsm

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA; the port's
# tests are small, and the lane runs about 2.5x faster this way.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _n(x):
    return np.asarray(x)


def _tied(rng, shape, levels=7):
    """f32 keys drawn from few values (many exact ties) plus some +inf."""
    d = rng.randint(0, levels, size=shape).astype(np.float32)
    d[rng.rand(*shape) < 0.1] = np.inf
    return d


class TestBitonic:
    @pytest.mark.parametrize("n", [2, 8, 64, 128])
    @pytest.mark.parametrize("ascending", [True, False])
    def test_sort_equals_jax_with_ties(self, n, ascending):
        rng = np.random.RandomState(n)
        d = _tied(rng, (16, n))
        ids = rng.randint(-1, 1000, size=(16, n)).astype(np.int32)
        jd, (jp,) = jsm.bitonic_sort(jnp.asarray(d), [jnp.asarray(ids)],
                                     ascending=ascending)
        td, (tp,) = tsm.bitonic_sort(_t(d), [_t(ids)], ascending=ascending)
        np.testing.assert_array_equal(td.numpy(), _n(jd))
        np.testing.assert_array_equal(tp.numpy(), _n(jp))

    @pytest.mark.parametrize("ef,c", [(64, 64), (32, 96), (64, 24), (10, 7)])
    def test_merge_into_beam_equals_jax(self, ef, c):
        rng = np.random.RandomState(ef + c)
        beam_d = np.sort(_tied(rng, (8, ef)), axis=1)
        beam_p = rng.randint(-1, 500, size=(8, ef)).astype(np.int32)
        cand_d = _tied(rng, (8, c))
        cand_p = rng.randint(-1, 500, size=(8, c)).astype(np.int32)
        jd, (jp,) = jsm.merge_into_beam(
            jnp.asarray(beam_d), [(jnp.asarray(beam_p), -1)],
            jnp.asarray(cand_d), [(jnp.asarray(cand_p), -1)], ef)
        td, (tp,) = tsm.merge_into_beam(
            _t(beam_d), [(_t(beam_p), -1)], _t(cand_d), [(_t(cand_p), -1)],
            ef)
        np.testing.assert_array_equal(td.numpy(), _n(jd))
        np.testing.assert_array_equal(tp.numpy(), _n(jp))

    @pytest.mark.parametrize("e0,ef", [(1, 64), (8, 64), (100, 64), (5, 4)])
    def test_entries_to_beam_equals_jax(self, e0, ef):
        rng = np.random.RandomState(e0)
        d = _tied(rng, (8, e0))
        ids = rng.randint(-1, 99, size=(8, e0)).astype(np.int32)
        ji, jd = jsm.entries_to_beam(jnp.asarray(ids), jnp.asarray(d), ef)
        ti, td = tsm.entries_to_beam(_t(ids), _t(d), ef)
        np.testing.assert_array_equal(ti.numpy(), _n(ji))
        np.testing.assert_array_equal(td.numpy(), _n(jd))

    @pytest.mark.parametrize("n,k", [(64, 32), (33, 10), (16, 16)])
    def test_topk_ascending_equals_jax(self, n, k):
        rng = np.random.RandomState(n + k)
        d = _tied(rng, (8, n))
        ids = rng.randint(-1, 99, size=(8, n)).astype(np.int32)
        jd, ji = jsm.topk_ascending(jnp.asarray(d), jnp.asarray(ids), k)
        td, ti = tsm.topk_ascending(_t(d), _t(ids), k)
        np.testing.assert_array_equal(td.numpy(), _n(jd))
        np.testing.assert_array_equal(ti.numpy(), _n(ji))


class TestRowOps:
    def test_first_occurrence_mask(self):
        ids = np.random.RandomState(0).randint(-1, 6, size=(32, 20))
        ids = ids.astype(np.int32)
        np.testing.assert_array_equal(
            tbitset.first_occurrence_mask(_t(ids)).numpy(),
            _n(jbitset.first_occurrence_mask(jnp.asarray(ids))))

    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
    def test_quantize_rows_equal(self, storage):
        x = np.random.RandomState(1).randn(64, 40).astype(np.float32)
        x[3] = 0.0  # zero row: int8 scale falls back to 1
        jr, js, jn = jquant.quantize_rows(jnp.asarray(x), storage)
        tr, ts, tn = tquant.quantize_rows(_t(x), storage)
        np.testing.assert_array_equal(tr.float().numpy(),
                                      _n(jr.astype(jnp.float32)))
        np.testing.assert_array_equal(ts.numpy(), _n(js))
        np.testing.assert_allclose(tn.numpy(), _n(jn), rtol=1e-6)

    @pytest.mark.parametrize("m", [4, 12, 40])
    def test_compact_by_mask_equals_jax(self, m):
        rng = np.random.RandomState(m)
        ids = rng.randint(-1, 500, size=(16, 24)).astype(np.int32)
        d = rng.rand(16, 24).astype(np.float32)
        mask = rng.rand(16, 24) < 0.5
        ji, jd = jbuild.compact_by_mask(jnp.asarray(ids), jnp.asarray(d),
                                        jnp.asarray(mask), m)
        ti, td = tbuild.compact_by_mask(_t(ids), _t(d), _t(mask), m)
        np.testing.assert_array_equal(ti.numpy(), _n(ji))
        np.testing.assert_array_equal(td.numpy(), _n(jd))

    @pytest.mark.parametrize("keep_pruned", [False, True])
    @pytest.mark.parametrize("scan_limit", [None, 10])
    def test_heuristic_admit_equals_jax(self, keep_pruned, scan_limit):
        rng = np.random.RandomState(7)
        b, k, m = 32, 16, 5
        cand_d = np.sort(rng.rand(b, k).astype(np.float32), axis=1)
        x = rng.rand(b, k, 3).astype(np.float32)
        pair = np.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1))
        pair = pair.astype(np.float32)
        valid = rng.rand(b, k) < 0.9
        j = jbuild.heuristic_admit(jnp.asarray(cand_d), jnp.asarray(pair),
                                   jnp.asarray(valid), m, keep_pruned,
                                   scan_limit=scan_limit)
        t = tbuild.heuristic_admit(_t(cand_d), _t(pair), _t(valid), m,
                                   keep_pruned, scan_limit=scan_limit)
        np.testing.assert_array_equal(t.numpy(), _n(j))


class TestRegistryConfigData:
    def test_builtin_pair_dists_match_numpy(self):
        rng = np.random.RandomState(2)
        rows = rng.randn(4, 6, 8).astype(np.float32)
        q = rng.randn(4, 8).astype(np.float32)
        for name in ("l2", "ip", "cosine"):
            m = tmetrics.get_metric(name)
            np.testing.assert_allclose(
                m.pair_dist(_t(rows), _t(q)).numpy(),
                m.pair_dist(rows, q), rtol=1e-5, atol=1e-5)

    def test_register_and_validate(self):
        tmetrics.register_metric(
            "l1_torch_test", lambda r, q: abs(r - q[..., None, :]).sum(-1))
        try:
            assert HnswConfig(dim=4, metric="l1_torch_test").metric \
                == "l1_torch_test"
            with pytest.raises(ValueError):
                tmetrics.register_metric("l2", lambda r, q: r)
        finally:
            tmetrics.unregister_metric("l1_torch_test")
        with pytest.raises(ValueError):
            HnswConfig(dim=4, metric="l1_torch_test")
        with pytest.raises(ValueError):
            tmetrics.unregister_metric("l2")

    @pytest.mark.parametrize("m,n", [(12, 4000), (16, 1_000_000), (2, 1)])
    def test_config_matches_jax(self, m, n):
        t, j = HnswConfig(dim=8, M=m), JaxConfig(dim=8, M=m)
        assert t.M_max0 == j.M_max0 and t.mL == j.mL
        assert t.derived_max_level(n) == j.derived_max_level(n)
        with pytest.raises(ValueError):
            HnswConfig(dim=8, storage="fp8")

    def test_levels_and_datasets_match_jax(self):
        a = tbuild.sample_levels(np.random.RandomState(5), 1000, 0.4, 6)
        b = jbuild.sample_levels(np.random.RandomState(5), 1000, 0.4, 6)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tds.clustered(300, 7, 5, seed=3),
                                      jds.clustered(300, 7, 5, seed=3))
        data = tds.clustered(300, 7, 5, seed=3)
        np.testing.assert_array_equal(tds.queries_like(data, 20, seed=4),
                                      jds.queries_like(data, 20, seed=4))
