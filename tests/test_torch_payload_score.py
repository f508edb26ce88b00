"""Packed score (K1) of the torch port.

The TPU kernel `payload_score` has no interpret mode, so it cannot run on
the CPU; the JAX engine's inline expression that does the same job
(`ocaml_hnsw_tpu/models/packed.py`, `_beam_body`, the non-fused bits=8
branch) stands in for it.  The port's plain version is held

  * against an exact NumPy int64 dot: ids exactly equal, distances at
    rtol 1e-6 (the same f32 epilogue);
  * against the JAX expression on the same PackedGraph: ids equal, and
    distances within the bf16-product bound — the JAX engine rounds each
    int8 product to bf16, so |Δdot| ≤ 2⁻⁸·Σ_d |x8·q8|, which moves the l2
    distance by up to 2·s²·|Δdot| (plus f32 rounding of the terms)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu.models.graph import GraphTensors as JaxGraph
from ocaml_hnsw_tpu.models.packed import pack_graph as jax_pack_graph

from ocaml_hnsw_tpu_torch.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models.bulk import bulk_build
from ocaml_hnsw_tpu_torch.models.graph import graph_to_numpy
from ocaml_hnsw_tpu_torch.models.packed import (
    packed_from_numpy, quantize_queries,
)
from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.ops.kernels.payload_score import (
    STAGES, WARPS, kernel_instance, launch_plan, nibble_unpack,
    packed_score, packed_score_plain, query_slots,
)

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA; the port's
# tests are small, and the lane runs about 2.5x faster this way.
torch.set_num_threads(1)

B, E = 64, 2


@pytest.fixture(scope="module")
def packs():
    """The JAX package's pack of a graph (built by the port, which is
    faster here; tests/test_torch_bulk.py holds its build to JAX's)."""
    data = clustered(600, 20, n_clusters=8, seed=4)
    tg = bulk_build(data, HnswConfig(dim=20, M=6), knn_k=12, batch=256,
                    device="cpu")
    g = JaxGraph(**{f: jnp.asarray(a) for f, a in graph_to_numpy(tg).items()},
                 l_max_static=tg.l_max_static)
    jp = jax_pack_graph(g, "l2")
    tp = packed_from_numpy(np.asarray(jp.pay), np.asarray(jp.meta),
                           np.asarray(jp.scale), "cpu")
    rng = np.random.RandomState(0)
    nodes = rng.randint(-1, 600, size=(B, E)).astype(np.int32)
    nodes[0, 1] = -1
    q = queries_like(data, B, seed=6)
    q8 = quantize_queries(torch.from_numpy(q), tp.scale)
    q8 = torch.nn.functional.pad(q8, (0, tp.d_pad - q8.shape[1]))
    qn = torch.from_numpy((q * q).sum(1))
    return jp, tp, torch.from_numpy(nodes), q8, qn


def _numpy_exact(tp, nodes, q8, qn, needs_norms):
    pay = tp.pay.numpy().astype(np.int64)
    meta = tp.meta.numpy().astype(np.int64)
    nodes = nodes.numpy()
    deg = tp.deg
    safe = np.maximum(nodes, 0)
    ids = np.where(nodes[:, :, None] >= 0, meta[safe][:, :, :deg], -1)
    dot = np.einsum("bejd,bd->bej", pay[safe], q8.numpy().astype(np.int64))
    s2 = np.float32(tp.scale.numpy()) * np.float32(tp.scale.numpy())
    if needs_norms:
        t = (meta[safe][:, :, deg:] - 2 * dot).astype(np.float32)
        d = s2 * t + qn.numpy()[:, None, None]
    else:
        d = np.float32(1.0) - s2 * dot.astype(np.float32)
    ids = ids.reshape(B, -1)
    return ids, np.where(ids < 0, np.inf, d.reshape(B, -1)), dot


def _jax_inline(jp, nodes, q8, qn, needs_norms):
    """The JAX engine's expression (packed.py, _beam_body, bits=8 unfused)."""
    nodes = jnp.asarray(nodes.numpy())
    b, expand = nodes.shape
    deg, c_full = jp.deg, jp.chunks
    c, stored = c_full, jp.d_pad
    s2 = jp.scale * jp.scale
    q16 = jnp.asarray(q8.numpy()).astype(jnp.bfloat16)
    safe = jnp.maximum(nodes, 0)
    mrow = jp.meta[safe]
    nbrs = jnp.where((nodes >= 0)[:, :, None], mrow[:, :, :deg], -1)
    nrm = mrow[:, :, deg:2 * deg].astype(jnp.float32)
    cid = (safe[:, :, None] * c_full
           + jnp.arange(c, dtype=jnp.int32)[None, None, :]).reshape(b, -1)
    vec8 = jp.pay[cid].reshape(b, expand, deg, stored)
    dot = jnp.sum(vec8.astype(jnp.bfloat16) * q16[:, None, None, :],
                  axis=-1, dtype=jnp.float32)
    if needs_norms:
        d = s2 * (nrm - 2.0 * dot) + jnp.asarray(qn.numpy())[:, None, None]
    else:
        d = 1.0 - s2 * dot
    return np.asarray(nbrs.reshape(b, -1)), np.asarray(d.reshape(b, -1))


@pytest.mark.parametrize("needs_norms", [True, False])
class TestPackedScore:
    def test_plain_equals_exact_int_dot(self, packs, needs_norms):
        _, tp, nodes, q8, qn = packs
        ids, d = packed_score_plain(nodes, tp.meta, tp.pay, q8, qn, tp.scale,
                                    needs_norms)
        want_ids, want_d, _ = _numpy_exact(tp, nodes, q8, qn, needs_norms)
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-6, atol=0)

    def test_plain_within_bf16_bound_of_jax(self, packs, needs_norms):
        jp, tp, nodes, q8, qn = packs
        ids, d = packed_score_plain(nodes, tp.meta, tp.pay, q8, qn, tp.scale,
                                    needs_norms)
        j_ids, j_d = _jax_inline(jp, nodes, q8, qn, needs_norms)
        np.testing.assert_array_equal(ids.numpy(), j_ids)
        live = ids.numpy() >= 0
        # Σ_d |x8·q8| per candidate, from the payload
        pay = tp.pay.numpy().astype(np.int64)
        safe = np.maximum(nodes.numpy(), 0)
        absdot = np.einsum("bejd,bd->bej", np.abs(pay[safe]),
                           np.abs(q8.numpy().astype(np.int64)))
        s2 = float(tp.scale) ** 2
        bound = 2.0 * s2 * 2.0 ** -8 * absdot.reshape(B, -1) \
            + 1e-6 * (np.abs(j_d) + 1.0)
        diff = np.abs(d.numpy() - j_d)
        assert (diff[live] <= bound[live]).all(), diff[live].max()

    def test_cpu_wrapper_is_plain_version(self, packs, needs_norms):
        _, tp, nodes, q8, qn = packs
        before = packed_score.launches
        a = packed_score(nodes, tp.meta, tp.pay, q8, qn, tp.scale, needs_norms)
        b = packed_score_plain(nodes, tp.meta, tp.pay, q8, qn, tp.scale,
                               needs_norms)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert packed_score.launches == before


def test_cpu_wrapper_options_are_plain(packs):
    """slots and bits=4 on CPU tensors: the plain version, no launch."""
    _, tp, nodes, q8, qn = packs
    q16 = (q8.float() + 0.25).to(torch.bfloat16)
    pay4 = tp.pay[:, :, :tp.d_pad // 2].contiguous()
    before = packed_score.launches
    for args in ((nodes, tp.meta, tp.pay, q8, qn, tp.scale, True, 3, 8),
                 (nodes, tp.meta, pay4, q16, qn, tp.scale, False, None, 4),
                 (nodes, tp.meta, pay4, q16, qn, tp.scale, True, 7, 4)):
        a = packed_score(*args)
        b = packed_score_plain(*args)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        slots = tp.deg if args[7] is None else args[7]
        assert a[0].shape == (B, E * slots)
    assert packed_score.launches == before


@pytest.mark.parametrize("needs_norms", [True, False])
def test_plain_int4_every_nibble_pair_is_exact(needs_norms):
    """bits=4 slabs whose rows hold every byte (all 256 nibble pairs,
    as chip_smoke.py holds the kernel to) against integer bf16
    queries: every product and partial sum is an integer under 2^24,
    so the plain version's f32 dot is exact and equals an f64 dot of
    the signed nibbles."""
    rng = np.random.RandomState(3)
    n, deg, d_pad, b = 30, 8, 256, 5
    pay = np.stack([np.stack([rng.permutation(256).astype(np.uint8)
                              for _ in range(deg)]) for _ in range(n)])
    pay = torch.from_numpy(pay.view(np.int8))
    ids = rng.randint(-1, n, size=(n, deg)).astype(np.int32)
    nrm = rng.randint(0, 1 << 12, size=(n, deg)).astype(np.int32)
    meta = torch.from_numpy(np.concatenate([ids, nrm], axis=1))
    q16 = torch.from_numpy(rng.randint(-8, 9, size=(b, 2 * d_pad))
                           .astype(np.float32)).to(torch.bfloat16)
    nodes = torch.from_numpy(rng.randint(-1, n, size=(b, 2))
                             .astype(np.int32))
    qn = torch.from_numpy(rng.rand(b).astype(np.float32) * 100)
    scale = torch.tensor(0.05)
    cand_ids, cand_d = packed_score_plain(nodes, meta, pay, q16, qn,
                                          scale, needs_norms, bits=4)
    safe = nodes.clamp_min(0).long()
    comps = torch.stack(nibble_unpack(pay), dim=-1).reshape(
        n, deg, 2 * d_pad)
    dot = torch.einsum("bejd,bd->bej", comps[safe].double(),
                       q16.double()).float()
    s2 = scale * scale
    if needs_norms:
        d = s2 * (meta[safe][:, :, deg:].float() - 2.0 * dot) \
            + qn[:, None, None]
    else:
        d = 1.0 - s2 * dot
    want_ids = torch.where((nodes >= 0)[:, :, None],
                           meta[safe][:, :, :deg], -1).reshape(b, -1)
    assert torch.equal(cand_ids, want_ids)
    want = torch.where(want_ids < 0, float("inf"), d.reshape(b, -1))
    np.testing.assert_allclose(cand_d.numpy(), want.numpy(), rtol=1e-6)


def _header(barriers: int) -> int:
    return -(-barriers * 8 // 128) * 128


class TestLaunchPlan:
    """The ring shape csrc/payload_score.cu is launched with."""

    @staticmethod
    def _holds(p, deg, d_pad, slots, bits, e):
        """Every plan: the block fits, a stage holds an item's slab prefix
        and (in the ring) meta row, a warp's share holds its stages and
        query slots, the header its warps x stages mbarriers."""
        assert p.smem_bytes <= _lib.SMEM_LIMIT
        assert 1 <= p.stages <= STAGES
        assert 1 <= p.warps <= WARPS
        item = slots * d_pad + (8 * deg if p.meta_in_ring else 0)
        assert p.stage_bytes == -(-item // 128) * 128
        q_bytes = d_pad if bits == 8 else 4 * d_pad
        assert p.query_slots == query_slots(p.stages, e)
        assert p.warp_bytes % 128 == 0
        assert p.warp_bytes >= p.stages * p.stage_bytes \
            + p.query_slots * q_bytes
        assert _header(p.warps * p.stages) >= 8 * p.warps * p.stages
        assert p.smem_bytes == _header(p.warps * p.stages) \
            + p.warps * p.warp_bytes

    @pytest.mark.parametrize("deg,d_pad", [(32, 128), (24, 128), (48, 128),
                                           (33, 128), (32, 768), (64, 1024),
                                           (128, 1024)])
    def test_ring_fits_and_holds_an_item(self, deg, d_pad):
        p = launch_plan(2, deg, d_pad)
        self._holds(p, deg, d_pad, deg, 8, 2)
        assert p.meta_in_ring == (deg % 2 == 0)  # 8·deg bytes, 16-aligned

    @pytest.mark.parametrize("deg,d_pad,slots,bits", [
        (32, 128, 16, 8), (32, 128, 1, 8), (33, 128, 5, 8), (32, 64, None, 4),
        (32, 64, 16, 4), (16, 64, 1, 4), (32, 384, None, 4), (64, 512, 7, 4),
    ])
    def test_options_ring_fits(self, deg, d_pad, slots, bits):
        """slots: only that prefix of the slab is staged (the meta row stays
        whole); bits=4: d_pad stored bytes per row, a bf16 query row of
        2·d_pad components (4·d_pad bytes) in the query slots."""
        p = launch_plan(2, deg, d_pad, True, slots, bits)
        full = launch_plan(2, deg, d_pad, True, None, bits)
        self._holds(p, deg, d_pad, deg if slots is None else slots, bits, 2)
        assert p.stage_bytes <= full.stage_bytes
        assert p.meta_in_ring == (deg % 2 == 0)

    def test_int4_main_shape(self):
        # F3: E=2, deg=32, d=128: a 2 KB nibble slab and its meta row per
        # stage (the 256 B bf16 query row in a query slot), two stages
        p = launch_plan(2, 32, 64, True, None, 4)
        assert (p.stages, p.warps, p.stage_bytes) == (2, 4, 2304)
        assert (p.query_slots, p.smem_bytes) == (2, 20608)

    def test_main_shape_and_misaligned_meta(self):
        # main: 4 KB slab + 256 B meta row per stage, the query row in a
        # query slot
        p = launch_plan(2, 32, 128)
        assert (p.stages, p.warps, p.stage_bytes) == (2, 4, 4352)
        assert not launch_plan(2, 32, 128, meta_aligned=False).meta_in_ring

    def test_slab_too_large_raises(self):
        with pytest.raises(ValueError, match="does not fit"):
            launch_plan(2, 128, 2048)

    @pytest.mark.parametrize("e,deg,d_pad,slots,bits", [
        (2, 32, 128, None, 8),   # main B=4096 and 8192, E's shard step
        (8, 32, 128, None, 8),   # C's construction beam, B=1024 E=8
        (2, 32, 128, 16, 8),     # F2 deg_limit=16
        (2, 32, 64, None, 4),    # F3 bits=4
        (2, 16, 128, None, 8),   # F4 refined deg-16 payload
        (1, 24, 128, None, 8), (3, 33, 128, 9, 4),
        (2, 128, 1024, None, 8),  # a 128 KB slab: one stage
    ])
    def test_k1_row_plans(self, e, deg, d_pad, slots, bits):
        """Every K1 row: two stages, whatever the call's items per warp
        (one stage, re-armed after scoring, where two do not fit a block),
        as many warps as fit up to WARPS."""
        p = launch_plan(e, deg, d_pad, True, slots, bits)
        self._holds(p, deg, d_pad, deg if slots is None else slots, bits, e)
        assert p.stages == (1 if d_pad * deg > 100_000 else STAGES)
        more = _header((p.warps + 1) * p.stages) + (p.warps + 1) * p.warp_bytes
        assert p.warps == WARPS or more > _lib.SMEM_LIMIT

    @pytest.mark.parametrize("e", [1, 2, 3, 8])
    def test_query_slots_cover_the_items_in_flight(self, e):
        """Any `stages` consecutive items of a warp's range belong to at
        most query_slots(stages, e) queries, wherever the range starts in
        a query: so a query row is never overwritten while read."""
        for stages in range(1, 9):
            most = max(len({(off + k) // e for k in range(i, i + stages)})
                       for off in range(e) for i in range(3 * e))
            assert query_slots(stages, e) == most

    def test_kernel_instances(self):
        assert kernel_instance(128, 8) == "packed_score_kernel<8, 8>"
        assert kernel_instance(256, 8) == "packed_score_kernel<0, 8>"
        assert kernel_instance(64, 4) == "packed_score_kernel<4, 4>"
        assert kernel_instance(384, 4) == "packed_score_kernel<0, 4>"


def test_cpu_wrapper_stays_plain_at_16_slots_and_int4(packs):
    """Half-degree slots (at most 16: the kernel's two lanes per row) and
    bits=4 on CPU tensors: still the plain version, no launch."""
    _, tp, nodes, q8, qn = packs
    q16 = (q8.float() + 0.25).to(torch.bfloat16)
    pay4 = tp.pay[:, :, :tp.d_pad // 2].contiguous()
    half = tp.deg // 2
    assert half <= 16
    before = packed_score.launches
    for args in ((nodes, tp.meta, tp.pay, q8, qn, tp.scale, True, half, 8),
                 (nodes, tp.meta, pay4, q16, qn, tp.scale, True, None, 4),
                 (nodes, tp.meta, pay4, q16, qn, tp.scale, False, half, 4)):
        a = packed_score(*args)
        b = packed_score_plain(*args)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert packed_score.launches == before
