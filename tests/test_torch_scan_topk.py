"""Scan-and-select (K3) of the torch port, on the CPU.

On the CPU `scan_topk` runs its plain version; the CUDA kernel is held
against that version on the card by chip_smoke.py.  Here:

  * `scan_topk_plain` against the candidates of the JAX package's
    `flat_search` (called with k = rerank_k, so its reranked output is the
    candidate set; `approx_min_k` is exact on the CPU): bf16 and int8 scans
    under l2, ip and cosine, tombstones, n < n_cap, D = 96, 100, 128,
    rerank_k 32 and 97.  Stated tolerance: the sets are equal but for ids
    whose score lies within 1e-4 (relative) of the k-th score, where the
    two packages' f32 sums of the bf16 products may order a near-tie
    differently;
  * `scan_topk_plain` in query blocks of any size: the same lists;
  * `merge_splits`, the merge the card runs over its per-split lists, over
    plain per-split lists with S = 1, 3 and 8: ids and scores identical to
    one plain scan over all rows; its (score, id) order at ties;
  * `paged_topk`, which serves rerank_k > K_MAX in pages bounded by the
    page before: over plain pages, the first rerank_k entries of one list
    in (score, id) order, ties across page edges included;
  * `launch_plan`: tiles, splits, shared memory and the D padding;
  * the routes: a registered metric with a callable `matmul_score` counts
    one `plain_routes`; `exact=True` never enters `scan_topk`; a CUDA
    tensor reaches the launch (a stand-in for the library), never the
    plain version, and a rerank_k over K_MAX takes one launch per page,
    each bounded by the last entry of the one before (the stand-in keeps
    the kernel's per-split lists in plain torch);
  * `bulk_build` with its kNN-table batch at 8192 and at 1024: the same
    graph.
"""

import ctypes

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu.models import flat as jflat

from ocaml_hnsw_tpu_torch import HnswConfig
from ocaml_hnsw_tpu_torch.models import bulk as tbulk
from ocaml_hnsw_tpu_torch.models import flat as tflat
from ocaml_hnsw_tpu_torch.ops import metrics as tmetrics
from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.ops.kernels import scan_topk as k3

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

N, CAP, B = 3000, 4096, 48
#: (scan dtype, metric, D, rerank_k): every dtype x metric once, each
#: width and each rerank_k at least twice (one JAX compile each)
CASES = [
    ("bf16", "l2", 128, 32),
    ("bf16", "ip", 96, 97),
    ("bf16", "cosine", 100, 32),
    ("int8", "l2", 100, 97),
    ("int8", "ip", 128, 32),
    ("int8", "cosine", 96, 97),
]
TIE_RTOL = 1e-4


def _data(seed, dim, metric):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, dim).astype(np.float32)
    q = rng.randn(B, dim).astype(np.float32)
    if metric == "cosine":  # both packages normalize rows and queries
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    dead = rng.choice(N, size=N // 20, replace=False)
    return x, q, dead


def _port_flat(x, dim, dtype, dead):
    t = tflat.empty_flat(dim, CAP, scan_dtype=dtype, device="cpu")
    tflat.flat_add(t, torch.from_numpy(x), 0, N)
    t.deleted[torch.from_numpy(dead)] = True
    return t


def _args(t, q):
    return (t.scan, t.scales, t.norms, t.deleted, t.n, torch.from_numpy(q))


@pytest.mark.parametrize("dtype,metric,dim,rk", CASES)
def test_plain_equals_jax_candidates(dtype, metric, dim, rk):
    x, q, dead = _data(dim + rk, dim, metric)
    t = _port_flat(x, dim, dtype, dead)
    assert t.n_cap == CAP and int(t.n) == N < t.n_cap
    j = jflat.empty_flat(dim, CAP, scan_dtype=dtype)
    j = jflat.flat_add(j, jnp.asarray(x), jnp.int32(0), jnp.int32(N))
    j = j._replace(deleted=j.deleted.at[jnp.asarray(dead)].set(True))
    # k = rerank_k: the JAX rerank returns the whole candidate set (masked
    # ids as -1)
    j_ids, _ = jflat.flat_search(j, jnp.asarray(q), k=rk, metric=metric,
                                 rerank_k=rk)
    j_ids = np.asarray(j_ids)
    s, ids = k3.scan_topk_plain(*_args(t, q), rk, metric)
    assert s.shape == ids.shape == (B, rk) and ids.dtype == torch.int64
    assert torch.all(s[:, 1:] >= s[:, :-1])  # ascending
    # every score of every row, for the tie window
    full, order = k3.scan_topk_plain(*_args(t, q), CAP, metric)
    by_id = torch.empty_like(full).scatter_(1, order, full).numpy()
    s, ids = s.numpy(), ids.numpy()
    for b in range(B):
        mine = set(ids[b][np.isfinite(s[b])].tolist())
        theirs = set(j_ids[b][j_ids[b] >= 0].tolist())
        assert not mine & set(dead.tolist())
        kth = s[b, -1]
        for i in mine ^ theirs:
            assert abs(by_id[b, i] - kth) <= TIE_RTOL * (1 + abs(kth)), (b, i)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_merge_splits_equals_one_scan(dtype, splits):
    """Per-split plain lists (the rows cut as the kernel's blockIdx.y cuts
    them, ids offset by the split's first row), stacked [B, S, K] and
    merged: the ids and scores of one plain scan over all rows."""
    metric, rk = "ip", 97
    x, q, dead = _data(7, 128, metric)
    t = _port_flat(x, 128, dtype, dead)
    args = _args(t, q)
    want_s, want_i = k3.scan_topk_plain(*args, rk, metric)
    split_rows = -(-CAP // splits)
    parts_s, parts_i = [], []
    for lo in range(0, CAP, split_rows):
        sl = slice(lo, lo + split_rows)
        s, i = k3.scan_topk_plain(t.scan[sl], t.scales[sl], t.norms[sl],
                                  t.deleted[sl], t.n - lo, args[5], rk,
                                  metric)
        parts_s.append(s)
        parts_i.append((i + lo).to(torch.int32))
    assert len(parts_s) == splits
    got_s, got_i = k3.merge_splits(torch.stack(parts_s, 1),
                                   torch.stack(parts_i, 1), rk)
    assert got_i.dtype == torch.int64
    assert torch.equal(got_s, want_s)
    assert torch.equal(torch.sort(got_i, 1).values,
                       torch.sort(want_i, 1).values)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("qb", [1, 7])
def test_plain_does_not_depend_on_its_query_blocks(dtype, qb, monkeypatch):
    """The plain version in query blocks of 1 and 7 (its score budget cut
    to that many rows of scores) against one block: int8 the same scores
    and ids (exact integer dots); bf16 scores within 1e-5 (a one-query
    block is a matrix-vector product, which sums in another order) and
    ids equal but within TIE_RTOL of the k-th score."""
    x, q, dead = _data(17, 96, "l2")
    t = _port_flat(x, 96, dtype, dead)
    want_s, want_i = k3.scan_topk_plain(*_args(t, q), 97, "l2")
    monkeypatch.setattr(k3, "PLAIN_BLOCK_BYTES", qb * 4 * CAP)
    got_s, got_i = k3.scan_topk_plain(*_args(t, q), 97, "l2")
    if dtype == "int8":
        assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)
        return
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
    for b in range(B):
        kth = float(want_s[b, -1])
        score = dict(zip(got_i[b].tolist(), got_s[b].tolist()))
        score.update(zip(want_i[b].tolist(), want_s[b].tolist()))
        for i in set(got_i[b].tolist()) ^ set(want_i[b].tolist()):
            assert abs(score[i] - kth) <= TIE_RTOL * (1 + abs(kth)), (b, i)


def test_merge_splits_orders_ties_by_id():
    """Equal scores in (score, id) order, the lower id first, -0.0 with
    0.0, the empty entry (+inf, -1) last: the order the kernel keeps."""
    inf = float("inf")
    s = torch.tensor([[[1.0, 2.0, inf], [1.0, -0.0, 0.0]],
                      [[inf, inf, inf], [3.0, 3.0, inf]]])
    i = torch.tensor([[[5, 7, -1], [3, 9, 2]],
                      [[-1, -1, -1], [8, 4, -1]]], dtype=torch.int32)
    got_s, got_i = k3.merge_splits(s, i, 4)
    assert got_i.tolist() == [[2, 9, 3, 5], [4, 8, -1, -1]]
    assert got_s[1].tolist() == [3.0, 3.0, inf, inf]


def _order(by_id):
    """Per query, every id in (score, id) order, as numpy (scores, ids)."""
    b, n = by_id.shape
    ids = np.arange(n)
    out = [np.lexsort((ids, row)) for row in by_id]
    return (np.stack([row[o] for row, o in zip(by_id, out)]),
            np.stack(out))


def _after(scores, ids, bound, q):
    """Mask of (scores, ids) entries after query q's bound."""
    if bound is None:
        return np.ones(scores.shape, bool)
    bs, bi = float(bound[0][q]), int(bound[1][q])
    return (scores > bs) | ((scores == bs) & (ids > bi))


def _lowest_after(scores, ids, k, bound, q):
    """The first k finite entries after the bound, padded with (+inf, -1):
    what the kernel keeps of a list in (score, id) order."""
    keep = _after(scores, ids, bound, q) & np.isfinite(scores)
    s, i = scores[keep][:k], ids[keep][:k]
    pad = k - len(s)
    return (np.concatenate([s, np.full(pad, np.inf, np.float32)]),
            np.concatenate([i, np.full(pad, -1)]))


def _tied_flat(dtype):
    """_port_flat over rows whose second fifth repeats the first: scores
    tie exactly in both scans."""
    x, q, dead = _data(13, 64, "l2")
    x[600:1200] = x[:600]
    q[:8] = x[:8]
    return _port_flat(x, 64, dtype, dead), q


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("rk", [257, 300, 700])
def test_paged_topk_equals_one_list(dtype, rk):
    """Pages of the plain lists, each the lowest K_MAX after the last entry
    of the page before: the first rerank_k of one list in (score, id)
    order, ties across page edges included."""
    t, q = _tied_flat(dtype)
    full_s, full_i = k3.scan_topk_plain(*_args(t, q), CAP, "l2")
    by_id = torch.empty_like(full_s).scatter_(1, full_i, full_s).numpy()
    scores, ids = _order(by_id)
    pages = []

    def page(k, bound):
        assert k <= k3.K_MAX and (bound is None) == (not pages)
        lists = [_lowest_after(scores[b], ids[b], k, bound, b)
                 for b in range(B)]
        pages.append(k)
        return (torch.from_numpy(np.stack([s for s, _ in lists])),
                torch.from_numpy(np.stack([i for _, i in lists])))

    got_s, got_i = k3.paged_topk(page, rk)
    assert pages == [k3.K_MAX] * (rk // k3.K_MAX) + [rk % k3.K_MAX]
    want = [_lowest_after(scores[b], ids[b], rk, None, b) for b in range(B)]
    np.testing.assert_array_equal(got_s.numpy(), [s for s, _ in want])
    np.testing.assert_array_equal(got_i.numpy(), [i for _, i in want])
    # the ties are there, and some straddle a page edge
    edge = scores[:, k3.K_MAX - 1:k3.K_MAX + 1]
    assert (np.diff(scores[:, :rk], axis=1) == 0).any()
    assert dtype == "bf16" or (edge[:, 0] == edge[:, 1]).any()


class TestLaunchPlan:
    MAIN_ROWS = 1_003_520  # the 1M flat's slots (4096-aligned)

    def test_main_path_shapes(self):
        # the kNN table's 8192-row block: k = 64 + 1 + 32 = 97 -> lists of
        # 128.  The wgmma block: two consumer warpgroups of 64 queries,
        # 64-row tiles, 32-entry buffers with the 4 ring items left (2
        # tiles of 2 chunks), rows by TMA, each fetch for 128 queries; 64
        # query tiles x 2 splits fill a wave of 132 SMs
        p = k3.launch_plan(8192, self.MAIN_ROWS, 128, 2, 97)
        assert (p.path, p.qt, p.rt, p.kcap, p.stages, p.dp_bytes, p.vec,
                p.buf, p.producer) == (
            "wgmma", 128, 64, 128, 4, 256, 16, 32, "tma")
        assert (p.qtiles, p.splits) == (64, 2)
        assert p.split_rows * p.splits >= self.MAIN_ROWS
        # the flat batch: lists of 32 leave room for the deepest ring
        p = k3.launch_plan(8192, self.MAIN_ROWS, 128, 2, 32)
        assert (p.path, p.qt, p.rt, p.kcap, p.stages, p.buf, p.producer,
                p.splits) == ("wgmma", 128, 64, 32, 16, 32, "tma", 2)
        # G1's int8 kNN block: one 128-byte chunk a row, 5 items
        p = k3.launch_plan(8192, self.MAIN_ROWS, 128, 1, 97)
        assert (p.path, p.stages, p.buf, p.dp_bytes, p.producer) == (
            "wgmma", 5, 32, 128, "tma")

    @pytest.mark.parametrize("dim,itemsize,align,dp,vec,path,producer,qt", [
        (100, 2, 16, 224, 8, "wgmma", "cp.async", 128),  # glove: 200 B rows
        (96, 1, 16, 96, 16, "wgmma", "tma", 128),        # deep10m int8
        (100, 1, 16, 128, 4, "wgmma", "cp.async", 128),
        (101, 2, 16, 224, 2, "sync", "", 128),           # 2-byte units
        (99, 1, 16, 128, 1, "sync", "", 128),
        (128, 2, 8, 256, 8, "wgmma", "cp.async", 128),   # base 8 B off 16
        (128, 2, 16, 256, 16, "wgmma", "tma", 128),
        # two warpgroups' query tiles of 1536 bytes a row pass shared
        # memory: one warpgroup; at 2048 bytes a row, even one's does
        (768, 2, 16, 1536, 16, "wgmma", "tma", 64),
        (1024, 2, 16, 2048, 16, "sync", "", 32),
    ])
    def test_padding_and_copy_unit(self, dim, itemsize, align, dp, vec, path,
                                   producer, qt):
        p = k3.launch_plan(1024, 100_000, dim, itemsize, 32, align)
        assert (p.dp_bytes, p.vec, p.path, p.producer, p.qt) == (
            dp, vec, path, producer, qt)
        assert p.dp_bytes % k3.STEP_BYTES == 0

    @pytest.mark.parametrize("b", [1, 40, 300, 1024, 8192])
    @pytest.mark.parametrize("rk", [1, 32, 97, 256])
    @pytest.mark.parametrize("dim,itemsize", [(96, 1), (128, 2), (768, 2),
                                              (2048, 2)])
    def test_blocks_fit_and_cover(self, b, rk, dim, itemsize):
        n = 1_183_514
        p = k3.launch_plan(b, n, dim, itemsize, rk)
        assert p.smem_bytes == k3.block_smem(p.path, p.qt, p.dp_bytes,
                                             p.kcap, p.stages, p.buf,
                                             itemsize == 1)
        assert p.smem_bytes <= _lib.SMEM_LIMIT == 232448
        assert p.kcap >= max(32, rk) and p.kcap & (p.kcap - 1) == 0
        nchunks = -(-p.dp_bytes // k3.CHUNK_BYTES)
        if p.path == "wgmma":
            wgs = p.qt // k3.WG_QUERIES
            assert wgs in k3.WG_WARPGROUPS and p.rt == k3.WG_ROWS
            assert 2 <= p.stages <= k3.WG_MAX_STAGES and p.buf in k3.WG_BUFS
            # a merged buffer takes the four lanes' queues of its query
            assert 4 * k3.WG_QUEUE <= p.buf
            # a warpgroup holds a whole tile's items (one per 128-byte
            # chunk of D) until its products are done
            assert p.stages >= nchunks
            # one consumer warpgroup only where two do not fit
            assert wgs == 2 or all(
                k3._wgmma_stages(p.dp_bytes, p.kcap, bf, itemsize == 1, 2)
                < max(2, nchunks) for bf in k3.WG_BUFS)
        else:
            assert p.qt in k3.QUERY_TILES and p.rt == k3.row_tile(p.qt)
            assert 2 <= p.stages <= k3.MAX_STAGES and p.buf == k3.BUF
            assert p.qt <= max(16, 1 << (b - 1).bit_length())  # no idle tile
            # the sync block only where no wgmma block of one warpgroup
            # fits
            assert all(k3._wgmma_stages(p.dp_bytes, p.kcap, bf,
                                        itemsize == 1, 1) < max(2, nchunks)
                       for bf in k3.WG_BUFS)
        assert p.qtiles * p.qt >= b > (p.qtiles - 1) * p.qt
        assert p.split_rows % p.rt == 0
        assert (p.splits - 1) * p.split_rows < n <= p.splits * p.split_rows

    @pytest.mark.parametrize("b,n,dim,itemsize,rk,qt,stages,buf", [
        # sift's kNN-table block (k = 97, lists of 128) and flat batch
        (8192, MAIN_ROWS, 128, 2, 97, 128, 4, 32),
        (8192, MAIN_ROWS, 128, 2, 32, 128, 16, 32),
        # glove's 100-d cosine flat batch: 200-byte rows by cp.async
        (8192, 1_183_514, 100, 2, 32, 128, 16, 32),
        # lists of 256 on one warpgroup (a rerank_k of 129..256, a page)
        (8192, MAIN_ROWS, 128, 2, 256, 64, 8, 32),
        # int8: G1's kNN block, D2's 96-d flat batch
        (8192, MAIN_ROWS, 128, 1, 97, 128, 5, 32),
        (8192, 10_002_432, 96, 1, 32, 128, 16, 32),
        # wide rows: 16-entry buffers on one warpgroup or two
        (1024, 100_000, 512, 2, 97, 64, 11, 16),
        (1024, 100_000, 384, 2, 32, 128, 10, 16),
    ])
    def test_buffers_take_the_register_queues(self, b, n, dim, itemsize, rk,
                                              qt, stages, buf):
        # the candidate path's queues (WG_QUEUE a thread and query, four
        # lanes a query) fit every buffer the plan picks, the ring as deep
        # as before the buffer counts left shared memory, and the block in
        # the card's shared memory
        p = k3.launch_plan(b, n, dim, itemsize, rk)
        assert (p.path, p.qt, p.stages, p.buf) == ("wgmma", qt, stages, buf)
        assert 4 * k3.WG_QUEUE <= p.buf
        assert p.smem_bytes == k3.wgmma_smem(p.dp_bytes, p.kcap, p.stages,
                                             p.buf, itemsize == 1,
                                             qt // k3.WG_QUERIES)
        assert p.smem_bytes <= _lib.SMEM_LIMIT

    def test_splits_fill_the_card(self):
        # 1024 queries in 128-query blocks: 8 tiles x 14 splits fill 132
        p = k3.launch_plan(1024, self.MAIN_ROWS, 128, 2, 97, sm_count=132)
        blocks = p.qtiles * p.splits
        assert blocks / (-(-blocks // 132) * 132) >= k3.FILL
        # one query: its splits alone nearly fill the card (the plan picks
        # S for a full wave; whole row tiles per split round S down a bit)
        p = k3.launch_plan(1, self.MAIN_ROWS, 128, 2, 32, sm_count=132)
        assert p.qtiles == 1 and 0.8 * 132 <= p.splits <= 132
        # two resident blocks per SM: a wave of 264 blocks to fill
        p = k3.launch_plan(8192, self.MAIN_ROWS, 128, 2, 32, sm_count=132,
                           per_sm=2)
        assert p.splits == 4 and 64 * 4 / 264 >= k3.FILL

    def test_refused_shapes_raise(self):
        with pytest.raises(ValueError, match="rerank_k"):
            k3.launch_plan(64, 4096, 128, 2, k3.K_MAX + 1)
        with pytest.raises(ValueError, match="shared memory"):
            k3.launch_plan(64, 4096, 8192, 2, 256)

    @pytest.mark.parametrize("path,dim,itemsize,rk", [
        ("wgmma", 101, 2, 32),   # 2-byte copies: sync only
        ("wgmma", 768, 2, 256),  # lists and rows past shared memory
        ("wgmma", 1024, 2, 32),  # one warpgroup's query tile and ring too
        ("sync", 8192, 2, 256),
        ("mma", 128, 2, 32),     # no such path
    ])
    def test_forcing_a_path_the_shape_cannot_take_raises(self, path, dim,
                                                         itemsize, rk):
        with pytest.raises(ValueError, match="path|shared memory"):
            k3.launch_plan(1024, 100_000, dim, itemsize, rk, path=path)

    def test_forced_paths_plan_both_where_both_fit(self):
        for path in k3.PATHS:
            p = k3.launch_plan(8192, self.MAIN_ROWS, 128, 2, 97, path=path)
            assert p.path == path
        assert k3.launch_plan(8192, self.MAIN_ROWS, 128, 2, 97,
                              path="sync").qt == 64

    @pytest.mark.parametrize("dim,itemsize", [(96, 1), (100, 2), (128, 2)])
    def test_lists_of_256_take_one_warpgroup(self, dim, itemsize):
        # kcap 256 (rerank_k 129..256, and each full page of a larger
        # rerank_k): two warpgroups' lists (128 x 288 entries of 8 bytes)
        # pass shared memory, one warpgroup's 64 fit with 8 ring items
        for rk in (129, k3.K_MAX):
            p = k3.launch_plan(8192, self.MAIN_ROWS, dim, itemsize, rk)
            assert (p.path, p.qt, p.kcap, p.stages, p.buf) == (
                "wgmma", 64, 256, 8, 32)
            assert p.smem_bytes == k3.wgmma_smem(p.dp_bytes, 256, 8, 32,
                                                 itemsize == 1, 1)
        # a rerank_k of 300: a full page of 256, then one of 44 (kcap 64)
        # on the two-warpgroup block
        p = k3.launch_plan(8192, self.MAIN_ROWS, dim, itemsize, 300 - 256)
        assert (p.path, p.qt, p.kcap) == ("wgmma", 128, 64)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one: the wrapper's route
    for the card, up to the launch."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def counters():
    before = (k3.scan_topk.launches, dict(k3.scan_topk.launches_by_dtype),
              k3.scan_topk.plain_routes, dict(k3.scan_topk.launches_by_path))
    yield
    k3.scan_topk.launches = before[0]
    k3.scan_topk.launches_by_dtype.update(before[1])
    k3.scan_topk.plain_routes = before[2]
    k3.scan_topk.launches_by_path.update(before[3])


class TestRoutes:
    @pytest.fixture(scope="class")
    def flat(self):
        x, q, dead = _data(3, 32, "l2")
        return _port_flat(x, 32, "bf16", dead), q

    def test_cpu_takes_the_plain_version(self, flat, counters):
        t, q = flat
        before = (k3.scan_topk.launches, k3.scan_topk.plain_routes)
        got = k3.scan_topk(*_args(t, q), 32, "l2")
        want = k3.scan_topk_plain(*_args(t, q), 32, "l2")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (k3.scan_topk.launches, k3.scan_topk.plain_routes) == before

    def test_registered_metric_counts_a_plain_route(self, flat, counters):
        t, q = flat
        if not tmetrics.is_metric("neg_dot_k3"):
            tmetrics.register_metric(
                "neg_dot_k3",
                lambda rows, qq: -(rows * qq[..., None, :]).sum(-1),
                matmul_score=lambda dot, x_norms: -dot)
        before = k3.scan_topk.plain_routes
        got = k3.scan_topk(*_args(t, q), 32, "neg_dot_k3")
        want = k3.scan_topk_plain(*_args(t, q), 32, "ip")
        assert k3.scan_topk.plain_routes == before + 1
        assert torch.equal(got[1], want[1])

    def test_exact_never_enters_scan_topk(self, flat, monkeypatch):
        t, q = flat

        def refuse(*args, **kwargs):
            raise AssertionError("exact=True entered scan_topk")

        monkeypatch.setattr(tflat, "scan_topk", refuse)
        ids, d = tflat.flat_search(t, torch.from_numpy(q), 10, "l2",
                                   exact=True)
        assert ids.shape == (B, 10) and torch.isfinite(d).all()
        with pytest.raises(AssertionError, match="entered"):
            tflat.flat_search(t, torch.from_numpy(q), 10, "l2")

    @pytest.mark.parametrize("dtype", ["bf16", "int8"])
    def test_a_card_tensor_reaches_the_launch(self, dtype, monkeypatch,
                                              counters):
        x, q, dead = _data(5, 100, "cosine")
        t = _port_flat(x, 100, dtype, dead)
        calls = []

        def launch(device, *args):
            calls.append(args)
            return 0

        def refuse(*args, **kwargs):
            raise AssertionError("a card tensor took the plain version")

        monkeypatch.setattr(k3, "_launch", launch)
        monkeypatch.setattr(k3, "_sm_count", lambda device: 132)
        monkeypatch.setattr(k3, "occupancy", lambda *a: 1)
        monkeypatch.setattr(k3, "scan_topk_plain", refuse)
        scan = torch.Tensor._make_subclass(_OnCard, t.scan)
        before = dict(k3.scan_topk.launches_by_dtype)
        paths_before = dict(k3.scan_topk.launches_by_path)
        n_before = k3.scan_topk.launches
        s, i = k3.scan_topk(scan, t.scales, t.norms, t.deleted, t.n,
                            torch.from_numpy(q), 32, "cosine")
        assert s.shape == i.shape == (B, 32)
        (args,) = calls
        # every argument of the C entry point but the stream
        assert len(args) + 1 == len(_lib._SIGNATURES["ohnsw_scan_topk"])
        plan = k3.launch_plan(B, CAP, 100, scan.element_size(), 32,
                              k3._alignment(scan.data_ptr()), 132)
        # the flat's own norms, tombstones and n: the kernel masks rows
        assert args[3:6] == (t.norms.data_ptr(), t.deleted.data_ptr(),
                             t.n.data_ptr())
        assert args[8:10] == (None, None)  # no page bound
        assert args[12:] == (B, CAP, 100 * scan.element_size(),
                             plan.dp_bytes, 32, plan.kcap,
                             k3.PATHS[plan.path], plan.qt, plan.buf,
                             plan.split_rows, plan.splits, 0, 1, plan.vec,
                             plan.stages, int(plan.producer == "tma"),
                             plan.smem_bytes)
        # 200- and 100-byte rows: the wgmma block, its producer by cp.async
        assert (plan.path, plan.producer) == ("wgmma", "cp.async")
        assert k3.scan_topk.launches_by_path == dict(
            paths_before, wgmma=paths_before["wgmma"] + 1)
        assert k3.scan_topk.launches == n_before + 1
        before[dtype] += 1
        assert k3.scan_topk.launches_by_dtype == before

    @pytest.mark.parametrize("dtype,rk", [("int8", 300), ("bf16", 600)])
    def test_a_card_tensor_pages_over_k_max(self, dtype, rk, monkeypatch,
                                            counters):
        """rerank_k > K_MAX on the card: one launch per page, the first
        unbounded and each later one bounded by the last entry of the page
        before.  The stand-in for the library keeps each split's lowest K
        after the bound in (score, id) order, as the kernel does, from the
        plain scores; the result is the first rerank_k of one list."""
        t, q = _tied_flat(dtype)
        full_s, full_i = k3.scan_topk_plain(*_args(t, q), CAP, "l2")
        by_id = torch.empty_like(full_s).scatter_(1, full_i, full_s).numpy()
        calls = []

        def launch(device, *args):
            lb_s, lb_i, out_s, out_i = args[8:12]
            b, k, split_rows, splits = args[12], args[16], args[21], args[22]
            bound = None if lb_s is None else (
                np.ctypeslib.as_array((ctypes.c_float * b).from_address(lb_s)),
                np.ctypeslib.as_array((ctypes.c_int32 * b).from_address(lb_i)))
            calls.append((k, bound is not None))
            lists_s = np.empty((b, splits, k), np.float32)
            lists_i = np.empty((b, splits, k), np.int32)
            for si in range(splits):
                lo = si * split_rows
                part = by_id[:, lo:lo + split_rows]
                ps, pi = _order(part)
                for qb in range(b):
                    lists_s[qb, si], lists_i[qb, si] = _lowest_after(
                        ps[qb], pi[qb] + lo, k, bound, qb)
            ctypes.memmove(out_s, lists_s.ctypes.data, lists_s.nbytes)
            ctypes.memmove(out_i, lists_i.ctypes.data, lists_i.nbytes)
            return 0

        monkeypatch.setattr(k3, "_launch", launch)
        monkeypatch.setattr(k3, "_sm_count", lambda device: 4)
        monkeypatch.setattr(k3, "occupancy", lambda *a: 1)
        scan = torch.Tensor._make_subclass(_OnCard, t.scan)
        n_before = k3.scan_topk.launches
        s, i = k3.scan_topk(scan, t.scales, t.norms, t.deleted, t.n,
                            torch.from_numpy(q), rk, "l2")
        pages = -(-rk // k3.K_MAX)
        assert calls == [(k3.K_MAX, False)] + [(k3.K_MAX, True)] * (
            pages - 2) + [(rk - (pages - 1) * k3.K_MAX, True)]
        assert k3.scan_topk.launches == n_before + pages
        plan = k3.launch_plan(B, CAP, 64, scan.element_size(), k3.K_MAX,
                              16, 4)
        assert plan.splits > 1  # the stand-in's lists need a merge
        scores, ids = _order(by_id)
        want = [_lowest_after(scores[b], ids[b], rk, None, b)
                for b in range(B)]
        np.testing.assert_array_equal(s.numpy(), [w for w, _ in want])
        np.testing.assert_array_equal(i.numpy(), [w for _, w in want])

    def test_a_forced_path_the_shape_cannot_take_raises(self, monkeypatch,
                                                         counters):
        x, q, dead = _data(23, 101, "l2")
        t = _port_flat(x, 101, "bf16", dead)
        launched = []
        monkeypatch.setattr(k3, "_launch", lambda *a: launched.append(a))
        monkeypatch.setattr(k3, "_sm_count", lambda device: 132)
        monkeypatch.setattr(k3, "occupancy", lambda *a: 1)
        scan = torch.Tensor._make_subclass(_OnCard, t.scan)
        with pytest.raises(ValueError, match="wgmma"):
            k3.scan_topk(scan, t.scales, t.norms, t.deleted, t.n,
                         torch.from_numpy(q), 32, "l2", path="wgmma")
        with pytest.raises(ValueError, match="unknown path"):
            k3.scan_topk(scan, t.scales, t.norms, t.deleted, t.n,
                         torch.from_numpy(q), 32, "l2", path="hmma")
        assert not launched

    def test_card_tensors_are_checked(self, flat, monkeypatch):
        t, q = flat
        monkeypatch.setattr(k3, "_launch", lambda *a: 0)
        scan = torch.Tensor._make_subclass(_OnCard, t.scan.float())
        with pytest.raises(TypeError, match="scan dtype"):
            k3.scan_topk(scan, t.scales, t.norms, t.deleted, t.n,
                         torch.from_numpy(q), 32, "l2")
        scan = torch.Tensor._make_subclass(_OnCard, t.scan)
        with pytest.raises(ValueError, match="q must be"):
            k3.scan_topk(scan, t.scales, t.norms, t.deleted, t.n,
                         torch.from_numpy(q).double(), 32, "l2")


@pytest.mark.parametrize("scan_dtype", ["bf16", "int8"])
def test_bulk_build_batch_8192_equals_1024(scan_dtype):
    """Each row's candidates are exact per row: the kNN table, and so the
    graph, does not depend on the batch (8192 is one batch here, 1024
    three)."""
    rng = np.random.RandomState(11)
    data = rng.randn(3000, 16).astype(np.float32)
    cfg = HnswConfig(dim=16, M=8, ef_construction=40, seed=5)
    graphs = [tbulk.bulk_build(data, cfg, knn_k=16, batch=batch,
                               scan_dtype=scan_dtype, device="cpu")
              for batch in (8192, 1024)]
    for name in ("adj0", "adj_up", "up_base", "levels"):
        assert torch.equal(getattr(graphs[0], name),
                           getattr(graphs[1], name)), name

