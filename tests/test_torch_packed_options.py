"""The packed engine's options in the torch port against the JAX package
(`ocaml_hnsw_tpu/models/packed.py`): `pack_graph(max_chunk=, bits=4,
fused=True)`, `knn_search_packed(bits=4, fused=True, deg_limit=)`, and K1's
`slots` / `bits` arguments (`ops/kernels/payload_score.py`).

  * Pack bytes: payload, meta, scale and chunk width W equal JAX's exactly
    (a fused JAX pack with its inlined meta bytes stripped).
  * Effective deg_limit: `packed_slots` against JAX's own `_packed_layout`
    on shape-only packs (nothing compiles), including the layouts whose
    chunk rows JAX cannot reshape into whole neighbours, where the port
    raises.
  * Search on the integer grid (|x| <= 7, scale 1.0: every product and sum
    is exact in bf16 and f32): ids and distances EXACTLY equal to JAX's for
    bits=4, fused, and a deg_limit that rounds to whole chunks.
  * K1's plain version on real-valued data against the JAX beam body's
    expression: bits=4 within the bf16 bound |Δdot| <= 2⁻⁸·Σ|y·q/s| (JAX
    rounds each product to bf16, the port sums exact f32 products), and
    `slots` exactly the first columns of the full call.
Graphs are built by the port and carried into the JAX package with
`graph_to_numpy` (tests/test_torch_bulk.py holds the build to JAX's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocaml_hnsw_tpu.models import packed as jpacked
from ocaml_hnsw_tpu.models.graph import GraphTensors as JaxGraph

from ocaml_hnsw_tpu_torch.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import packed as tpacked
from ocaml_hnsw_tpu_torch.models.bulk import bulk_build
from ocaml_hnsw_tpu_torch.models.graph import graph_to_numpy
from ocaml_hnsw_tpu_torch.ops.kernels.payload_score import (
    nibble_unpack, packed_score, packed_score_plain,
)

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA; the port's
# tests are small, and the lane runs about 2.5x faster this way.
torch.set_num_threads(1)


def port_to_jax(g):
    arrays = graph_to_numpy(g)
    return JaxGraph(**{f: jnp.asarray(a) for f, a in arrays.items()},
                    l_max_static=g.l_max_static)


@pytest.fixture(scope="module")
def real_graphs():
    """Clustered real-valued data, deg 16 (so max_chunk 512 / 1024 / 4096
    give four, two and one chunk rows per node)."""
    data = clustered(1000, 24, n_clusters=8, seed=2)
    tg = bulk_build(data, HnswConfig(dim=24, M=8), knn_k=16, batch=512,
                    device="cpu")
    return data, tg, port_to_jax(tg)


@pytest.fixture(scope="module")
def grid_graphs():
    """Integer-grid vectors and queries, |x| <= 7 (the bits=4 grid at
    scale 1.0), deg 16, built by the port."""
    rng = np.random.RandomState(12)
    centers = rng.randint(-5, 6, size=(16, 16))
    data = np.clip(centers[rng.randint(0, 16, size=2000)]
                   + rng.randint(-2, 3, size=(2000, 16)), -7, 7)
    data = data.astype(np.float32)
    q = np.clip(data[rng.randint(0, 2000, size=64)]
                + rng.randint(-1, 2, size=(64, 16)), -7, 7)
    tg = bulk_build(data, HnswConfig(dim=16, M=8), knn_k=16, batch=512,
                    device="cpu")
    return q.astype(np.float32), tg, port_to_jax(tg)


PACK_CASES = {
    "bits4": dict(bits=4),
    "bits4_scale": dict(bits=4, scale=0.05),
    "bits4_with_dist": dict(bits=4, with_dist=True),
    "fused": dict(fused=True),
    "fused_bits4": dict(fused=True, bits=4),
    "max_chunk512": dict(max_chunk=512),
    "max_chunk1024": dict(max_chunk=1024),
    "max_chunk4096": dict(max_chunk=4096),
}


class TestPackOptions:
    @pytest.mark.parametrize("case", sorted(PACK_CASES))
    def test_bytes_equal_jax(self, real_graphs, case):
        _, tg, jg = real_graphs
        kw = PACK_CASES[case]
        jp = jpacked.pack_graph(jg, "l2", **kw)
        tp = tpacked.pack_graph(tg, "l2", **kw)
        fused = kw.get("fused", False)
        fp = tpacked.packed_from_numpy(jp.pay, jp.meta, jp.scale, "cpu",
                                       fused=fused)
        assert torch.equal(tp.pay, fp.pay) and torch.equal(tp.meta, fp.meta)
        assert tp.scale.numpy().tobytes() == np.asarray(jp.scale).tobytes()
        mpc = tpacked.FUSED_META_TOTAL // jp.chunks if fused else 0
        assert tp.chunk_w == fp.chunk_w == jp.pay.shape[1] - mpc
        if not fused:  # JAX's d_pad counts a fused row's meta bytes too
            assert tp.d_pad == jp.d_pad  # stored bytes per neighbour
        if kw.get("bits") == 4:
            assert tp.pay.shape == (tg.n_cap, 16, 64)
        if kw.get("with_dist"):
            np.testing.assert_allclose(tp.dist.numpy(), np.asarray(jp.dist),
                                       rtol=1e-6)

    def test_nibble_roundtrip_exact(self):
        y = torch.from_numpy(
            np.random.RandomState(0).randint(-8, 8, size=(7, 128))
            .astype(np.int8))
        packed = tpacked._nibble_pack(y)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(jpacked._nibble_pack(jnp.asarray(
                y.numpy()))))
        lo, hi = nibble_unpack(packed)
        assert torch.equal(lo, y[:, 0::2]) and torch.equal(hi, y[:, 1::2])

    def test_chunk_width_equals_jax(self):
        for total in (1536, 2048, 3072, 4224, 2112, 24576, 100, 6144):
            for mc in (512, 1024, 2048, 4096):
                assert tpacked._chunk_width(total, mc) == \
                    jpacked._chunk_width(total, mc), (total, mc)
        for fn in (tpacked._chunk_width, jpacked._chunk_width):
            with pytest.raises(ValueError):
                fn(4099, 2048)  # prime: no divisor >= 32

    def test_bits4_query_equals_jax_bf16(self, real_graphs):
        """bits=4 queries are bf16(q / s).  Inside the JAX engine the scale
        is a traced value, so XLA divides (it folds only a constant divisor
        into a multiply); the port's division gives the same bits."""
        data, tg, _ = real_graphs
        q = queries_like(data, 256, seed=3)
        s = tpacked.pack_graph(tg, "l2", bits=4).scale
        port = (torch.from_numpy(q) / s).to(torch.bfloat16)
        jit = jax.jit(lambda a, b: (a / b).astype(jnp.bfloat16))(
            jnp.asarray(q), jnp.asarray(s.numpy()))
        np.testing.assert_array_equal(
            port.view(torch.int16).numpy(),
            np.asarray(jit).view(np.int16))
        # before the rounding too: XLA's f32 quotient is torch's, bit for bit
        f32 = jax.jit(lambda a, b: a / b)(jnp.asarray(q),
                                          jnp.asarray(s.numpy()))
        np.testing.assert_array_equal(np.asarray(f32),
                                      (torch.from_numpy(q) / s).numpy())


def _jax_layout(deg, stored, w, fused=False, deg_limit=None):
    """JAX `_packed_layout` on a shape-only pack: (deg_eff, c, w, stored)."""
    c_full = (deg * stored) // w
    row_w = w + (jpacked.FUSED_META_TOTAL // c_full if fused else 0)
    jp = jpacked.PackedGraph(
        pay=jax.ShapeDtypeStruct((c_full, row_w), jnp.int8),
        meta=jax.ShapeDtypeStruct((1, 2 * deg), jnp.int32), scale=None)
    d_eff, c, _, w_row, mpc, st, _ = jpacked._packed_layout(
        jp, 2, 64, deg_limit, 8, fused)
    return d_eff, c, w_row - mpc, st


# (deg, d, bits, max_chunk, deg_limit)
LAYOUTS = [
    (32, 128, 8, 2048, 8), (32, 128, 8, 2048, 16), (32, 128, 8, 2048, 24),
    (32, 128, 8, 4096, 16), (32, 128, 8, 2048, None), (32, 128, 8, 2048, 40),
    (32, 128, 4, 2048, 8), (16, 24, 8, 1024, 5), (16, 24, 8, 512, 3),
    (24, 100, 8, 2048, 7), (48, 256, 4, 2048, 10), (33, 128, 8, 2048, 5),
    (32, 768, 8, 2048, 16), (32, 768, 8, 2048, 3), (32, 768, 4, 2048, 16),
]


class TestDegLimitLayout:
    @pytest.mark.parametrize("deg,d,bits,max_chunk,deg_limit", LAYOUTS)
    def test_slots_equal_jax_layout(self, deg, d, bits, max_chunk,
                                    deg_limit):
        d_pad = tpacked.pack_d_pad(d)
        stored = d_pad if bits == 8 else d_pad // 2
        w = tpacked._chunk_width(deg * stored, max_chunk)
        tp = tpacked.PackedGraph(
            pay=torch.zeros((1, deg, stored), dtype=torch.int8),
            meta=torch.zeros((1, 2 * deg), dtype=torch.int32),
            scale=torch.tensor(1.0), chunk_w=w)
        d_eff, c, w_jax, st = _jax_layout(deg, stored, w,
                                          deg_limit=deg_limit)
        assert (w_jax, st) == (w, stored)
        if c * w != d_eff * st:  # JAX's [B, E·c, W] -> [B, E, deg, stored]
            with pytest.raises(ValueError, match="whole neighbours"):
                tpacked.packed_slots(tp, deg_limit)
        else:
            assert tpacked.packed_slots(tp, deg_limit) == d_eff

    def test_fused_deg_limit_raises_like_jax(self):
        tp = tpacked.PackedGraph(
            pay=torch.zeros((1, 16, 128), dtype=torch.int8),
            meta=torch.zeros((1, 32), dtype=torch.int32),
            scale=torch.tensor(1.0))
        for limit in (8, 16, 40):
            with pytest.raises(ValueError, match="fused"):
                _jax_layout(16, 128, 2048, fused=True, deg_limit=limit)
            with pytest.raises(ValueError, match="fused"):
                tpacked.packed_slots(tp, limit, fused=True)
        assert tpacked.packed_slots(tp, None, fused=True) == 16


GRID_SEARCH = {
    # bits=4 payload, while loop with its early exit
    "bits4": (dict(bits=4), dict(bits=4, expand=2)),
    # fused payload through the interleaved loop
    "fused_interleave": (dict(fused=True),
                         dict(fused=True, expand=2, interleave=2,
                              max_iters=10)),
    # W=1024 holds 8 neighbours: deg_limit 5 rounds to 8 slots; the
    # expand schedule passes them to each phase
    "deg_limit_rounds": (dict(max_chunk=1024),
                         dict(deg_limit=5, expand_schedule=((4, 2), (2, 8)))),
}


class TestSearchOptions:
    @pytest.mark.parametrize("case", sorted(GRID_SEARCH))
    def test_integer_grid_exact(self, grid_graphs, case):
        q, tg, jg = grid_graphs
        pack_kw, search_kw = GRID_SEARCH[case]
        kw = dict(k=10, ef=32, metric="l2", seeds=None, **search_kw)
        jp = jpacked.pack_graph(jg, "l2", scale=1.0, **pack_kw)
        tp = tpacked.pack_graph(tg, "l2", scale=1.0, **pack_kw)
        j_ids, j_d = jpacked.knn_search_packed(jg, jp, jnp.asarray(q), **kw)
        t_ids, t_d = tpacked.knn_search_packed(tg, tp, torch.from_numpy(q),
                                               **kw)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        assert (t_ids.numpy() >= 0).all()
        if "deg_limit" in search_kw:
            assert tpacked.packed_slots(tp, search_kw["deg_limit"]) == 8


def _k1_inputs(tg, data, bits, b=48, e=2):
    tp = tpacked.pack_graph(tg, "l2", bits=bits)
    rng = np.random.RandomState(5)
    nodes = rng.randint(-1, 1000, size=(b, e)).astype(np.int32)
    nodes[0, 0] = -1
    q = torch.from_numpy(queries_like(data, b, seed=6))
    if bits == 8:
        q8 = tpacked.quantize_queries(q, tp.scale)
    else:
        q8 = (q / tp.scale).to(torch.bfloat16)
    width = tp.d_pad * (1 if bits == 8 else 2)
    q8 = torch.nn.functional.pad(q8, (0, width - q8.shape[1]))
    return tp, torch.from_numpy(nodes), q8, (q * q).sum(1)


def _jax_beam_score4(tp, nodes, q16, qn, needs_norms):
    """The JAX beam body's bits=4 expression (packed.py, _beam_body, the
    unfused branch) on the same payload, meta and query."""
    deg = tp.deg
    nodes = jnp.asarray(nodes.numpy())
    safe = jnp.maximum(nodes, 0)
    meta = jnp.asarray(tp.meta.numpy())
    mrow = meta[safe]
    nbrs = jnp.where((nodes >= 0)[:, :, None], mrow[:, :, :deg], -1)
    nrm = mrow[:, :, deg:].astype(jnp.float32)
    vec8 = jnp.asarray(tp.pay.numpy())[safe]
    q16 = jnp.asarray(q16.float().numpy()).astype(jnp.bfloat16)
    lo, hi = jpacked.nibble_unpack_bf16(vec8)
    dot = jnp.sum(lo * q16[:, 0::2][:, None, None, :]
                  + hi * q16[:, 1::2][:, None, None, :],
                  axis=-1, dtype=jnp.float32)
    s2 = jnp.float32(tp.scale.numpy()) ** 2
    if needs_norms:
        d = s2 * (nrm - 2.0 * dot) + jnp.asarray(qn.numpy())[:, None, None]
    else:
        d = 1.0 - s2 * dot
    b = nodes.shape[0]
    return np.asarray(nbrs.reshape(b, -1)), np.asarray(d.reshape(b, -1))


class TestK1Options:
    @pytest.mark.parametrize("needs_norms", [True, False])
    def test_bits4_plain_within_bf16_bound_of_jax(self, real_graphs,
                                                  needs_norms):
        data, tg, _ = real_graphs
        tp, nodes, q16, qn = _k1_inputs(tg, data, bits=4)
        ids, d = packed_score_plain(nodes, tp.meta, tp.pay, q16, qn,
                                    tp.scale, needs_norms, None, 4)
        j_ids, j_d = _jax_beam_score4(tp, nodes, q16, qn, needs_norms)
        np.testing.assert_array_equal(ids.numpy(), j_ids)
        live = ids.numpy() >= 0
        # Σ|y·q/s| per candidate, from the unpacked payload
        lo, hi = nibble_unpack(tp.pay[nodes.clamp_min(0).long()])
        qf = q16.float()[:, None, None, :]
        absdot = (lo.float().abs() * qf[..., 0::2].abs()
                  + hi.float().abs() * qf[..., 1::2].abs()).sum(-1).numpy()
        s2 = float(tp.scale) ** 2
        bound = (2.0 * s2 if needs_norms else s2) * 2.0 ** -8 \
            * absdot.reshape(len(ids), -1) + 1e-6 * (np.abs(j_d) + 1.0)
        diff = np.abs(d.numpy() - j_d)
        assert (diff[live] <= bound[live]).all(), diff[live].max()

    @pytest.mark.parametrize("bits", [8, 4])
    def test_slots_are_the_first_columns(self, real_graphs, bits):
        data, tg, _ = real_graphs
        tp, nodes, q8, qn = _k1_inputs(tg, data, bits=bits)
        b, e = nodes.shape
        full_ids, full_d = packed_score_plain(nodes, tp.meta, tp.pay, q8, qn,
                                              tp.scale, True, None, bits)
        for slots in (1, 5, 8, 16):
            ids, d = packed_score_plain(nodes, tp.meta, tp.pay, q8, qn,
                                        tp.scale, True, slots, bits)
            assert ids.shape == (b, e * slots)
            want = full_ids.reshape(b, e, -1)[:, :, :slots].reshape(b, -1)
            assert torch.equal(ids, want)
            want = full_d.reshape(b, e, -1)[:, :, :slots].reshape(b, -1)
            assert torch.equal(d, want)
        before = packed_score.launches
        got = packed_score(nodes, tp.meta, tp.pay, q8, qn, tp.scale, True, 5,
                           bits)
        want = packed_score_plain(nodes, tp.meta, tp.pay, q8, qn, tp.scale,
                                  True, 5, bits)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert packed_score.launches == before  # CPU: the plain version
