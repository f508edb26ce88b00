"""Scan-and-select (K3): `scan_topk` launches `csrc/scan_topk.cu` on CUDA
tensors; `scan_topk_plain` is the same function in plain torch.

Per query, the `rerank_k` lowest scan scores over every row of a flat index
and their ids: the bf16 (or int8) product of the queries with the scan rows,
the metric's rank-equivalent score (l2: ‖x‖² − 2·dot; ip, cosine: −dot),
+inf at tombstones and, for the norm-free metrics, at slots j ≥ n.

Replaces what the JAX package runs on the TPU for its flat scan
(`ocaml_hnsw_tpu/models/flat.py:170-200`): XLA's MXU `dot_general` fused
with `jax.lax.approx_min_k`, the TPU's hardware PartialReduce inside the
score stream, so the [B, N] score block never reaches memory.  The kernel
keeps it out of memory too: the product runs on the tensor cores and each
query's top list is kept in shared memory behind a running threshold.  It
is bound by its operations: 2·B·N·D at 989 TFLOP/s (bf16) or 1,979 TOP/s
(int8) against the distinct bytes at 3.35 TB/s (`chip_smoke.py` times it
beside that bound).  Design: the source's note.

Two paths, chosen by shape in `block_plan` (never after an error):
"wgmma" (`csrc/scan_topk_wgmma.cu`: warp-specialised, `wgmma` on the tensor
cores, rows by TMA, 128 or 64 queries a block) wherever its block fits,
"sync" (the `mma.sync` block) elsewhere; `scan_topk(..., path=)`
forces one (ValueError where the shape cannot take it).  Each block
writes its row split's list; `merge_splits` takes the lowest `rerank_k` of
the S lists per query.  A launch keeps at most K_MAX per query; a larger
`rerank_k` comes in pages of K_MAX (`paged_topk`), each launch bounded by
the last (score, id) of the page before.  On the CPU the plain version
runs.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ocaml_hnsw_tpu_torch.ops.distance import INF
from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import _sm_count
from ocaml_hnsw_tpu_torch.ops.metrics import get_metric

#: built-in metrics the kernel computes, with its l2 flag (1: ‖x‖² − 2·dot,
#: 0: −dot); any other metric takes the plain version (`plain_routes`)
KERNEL_METRICS = {"l2": 1, "ip": 0, "cosine": 0}
#: the most entries per query one launch keeps (csrc kMaxKcap): the flat
#: engine's 32 and the kNN table's knn_k + 1 + 32 up to knn_k = 223 in one
#: launch; a larger rerank_k takes one launch per K_MAX
K_MAX = 256
_DTYPES = {torch.bfloat16: 0, torch.int8: 1}
#: scan dtypes by the names `scan_topk.launches_by_dtype` counts under
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.int8: "int8"}
#: the kernel's paths (csrc/scan_topk.cu's note) and their C codes:
#: "wgmma", the warp-specialised wgmma + TMA block, takes every shape it
#: fits; "sync", the mma.sync block, the rest (2- and 1-byte row
#: copies, rows so wide that a 64-query block's lists, query tile and ring
#: pass shared memory)
PATHS = {"sync": 0, "wgmma": 1}
#: csrc constants of the sync path: warps per block, row bytes per ring
#: stage and per mma k-step, the shared-memory stride of a staged row
#: chunk, buffer entries per query, the deepest ring
WARPS = 8
CHUNK_BYTES = 128
STEP_BYTES = 32
ROW_STRIDE = CHUNK_BYTES + 16
BUF = 32
MAX_STAGES = 8
#: queries per sync block the kernel is built for (largest first)
QUERY_TILES = (128, 64, 32, 16)
#: csrc constants of the wgmma path: queries per consumer warpgroup
#: (wgmma's M), consumer warpgroups per block (two where they fit, else
#: one), rows per tile (wgmma's N), bytes of one ring item (a tile's
#: 128-byte chunk), the deepest ring, the buffer sizes built
WG_QUERIES = 64
WG_WARPGROUPS = (2, 1)
WG_ROWS = 64
WG_ITEM = WG_ROWS * CHUNK_BYTES
WG_MAX_STAGES = 16
WG_BUFS = (32, 16)
#: slots of the wgmma block's side ring (a tile's bias and int8 scales)
WG_SIDE_SLOTS = 6
#: the wgmma plan keeps 32-entry buffers while its ring still holds this
#: many tiles' items, else takes 16 (at the kNN table's block, half the
#: merges beat a deeper ring: PERF.md §6)
WG_RING_TILES = 2
#: (score, id) a wgmma consumer thread queues in registers per query before
#: its warp flushes them to the buffers (csrc kQueue); four lanes share a
#: query, so a buffer holds at least 4 x WG_QUEUE entries
WG_QUEUE = 4
#: the plan adds row splits until the grid's last wave is this full, with
#: at least MIN_SPLIT_TILES row tiles per split
FILL = 0.85
MIN_SPLIT_TILES = 4

#: bytes of one f32 score block [query block, N] of the plain version (it
#: holds up to three at a time: product, scores, the int8 scale block)
PLAIN_BLOCK_BYTES = 4 << 30
#: an f32 sum of products of int8 values is exact up to this many terms
#: (127² · 1040 < 2²⁴)
_EXACT_INT8_TERMS = 1040


def quantize_int8(rows):
    """Symmetric per-row int8 as the JAX package's compiled flat_add and
    flat_search compute it: (int8 rows, f32 scales).  The scale is amax
    times the f32 constant 1/127 (XLA folds a division by a constant into
    that product; a true division differs in the last bit of 3% of the
    scales), the rows are round(rows / scale), a true division."""
    amax = torch.amax(torch.abs(rows), dim=1)
    inv127 = float(torch.tensor(1.0) / torch.tensor(127.0))
    scale = torch.where(amax > 0, amax * inv127, 1.0)
    q = torch.clamp(torch.round(rows / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def int8_dot(qi, rows):
    """Exact integer dot products of int8 queries [B, D] and int8 rows
    [N, D], as f32[B, N].  On the CPU an int32 product; on the card an f32
    product of the upcast operands, exact while every partial sum stays an
    integer below 2²⁴, so D goes in pieces of 1040 summed in int32."""
    if not qi.is_cuda:
        return torch.matmul(qi.to(torch.int32), rows.to(torch.int32).T).float()
    d = qi.shape[1]
    if d <= _EXACT_INT8_TERMS:
        return torch.matmul(qi.float(), rows.float().T)
    acc = None
    for lo in range(0, d, _EXACT_INT8_TERMS):
        hi = lo + _EXACT_INT8_TERMS
        part = torch.matmul(qi[:, lo:hi].float(),
                            rows[:, lo:hi].float().T).to(torch.int32)
        acc = part if acc is None else acc.add_(part)
    return acc.float()


def scan_topk_plain(rows, scales, norms, deleted, n, q, rerank_k: int,
                    metric: str):
    """Plain torch version: (scores f32[B, rerank_k], ids i64[B, rerank_k])
    ascending, the lowest scores of q f32[B, D] against rows [N, D] (bf16,
    or int8 with per-row `scales`), tombstones and, for norm-free metrics,
    slots j ≥ n (a 0-d tensor) at +inf.  A library product, the score and
    mask passes and `torch.topk`, in query blocks of PLAIN_BLOCK_BYTES of
    scores."""
    m = get_metric(metric)
    b, n_cap = q.shape[0], rows.shape[0]
    qb = max(1, PLAIN_BLOCK_BYTES // (4 * max(1, n_cap)))
    int8 = rows.dtype == torch.int8
    if int8:
        qq, qs = quantize_int8(q)
    else:
        qq = q.to(torch.bfloat16).float()
    dead = deleted
    if not m.needs_norms:
        # empty slots carry norms=+inf, which l2-style metrics consume; for
        # norm-free metrics mask unoccupied slots explicitly
        dead = dead | (torch.arange(n_cap, device=q.device) >= n)
    out_s, out_i = [], []
    for q0 in range(0, b, qb):
        if int8:
            dot = int8_dot(qq[q0:q0 + qb], rows)
            dot *= qs[q0:q0 + qb, None] * scales[None, :]
        else:
            dot = torch.matmul(qq[q0:q0 + qb], rows.float().T)
        # rank-equivalent scores from the one product (l2 drops +‖q‖²)
        scores = m.matmul_score(dot, norms[None, :])
        del dot
        scores.masked_fill_(dead[None, :], INF)
        s, i = torch.topk(scores, min(rerank_k, n_cap), dim=1, largest=False)
        out_s.append(s)
        out_i.append(i)
    if len(out_s) == 1:
        return out_s[0], out_i[0]
    return torch.cat(out_s), torch.cat(out_i)


def merge_splits(scores, ids, k: int):
    """The lowest k of each query's S split lists in (score, id) order (the
    kernel's: ids as unsigned, so -1 sorts last): scores f32[B, S, K] and
    ids [B, S, K] -> (scores f32[B, k], ids i64[B, k]) ascending.  One
    top-k over 64-bit keys, the score's bits in an order-keeping integer
    form above the id."""
    b = scores.shape[0]
    s, i = scores.reshape(b, -1), ids.reshape(b, -1)
    bits = (s + 0.0).view(torch.int32)  # + 0.0: -0.0 sorts as 0.0
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    key = (bits.long() << 32) | (i.long() & 0xFFFFFFFF)
    _, pick = torch.topk(key, k, dim=1, largest=False)
    return torch.gather(s, 1, pick), torch.gather(i, 1, pick).long()


def paged_topk(page, rerank_k: int):
    """The lowest rerank_k (score, id) per query, ascending, from pages of
    at most K_MAX: `page(k, bound)` returns the lowest k after `bound` (f32
    scores [B], int32 ids [B]; None for the first page), as merge_splits
    orders them.  Each page's bound is the last entry of the one before."""
    if rerank_k <= K_MAX:
        return page(rerank_k, None)
    out_s, out_i, bound = [], [], None
    for p0 in range(0, rerank_k, K_MAX):
        s, i = page(min(K_MAX, rerank_k - p0), bound)
        out_s.append(s)
        out_i.append(i)
        bound = (s[:, -1].contiguous(), i[:, -1].to(torch.int32).contiguous())
    return torch.cat(out_s, 1), torch.cat(out_i, 1)


def row_tile(qt: int) -> int:
    """Rows per tile of a qt-query sync block (csrc: a warp owns 16·MT
    queries x 32 rows, MT = 2 from 32 queries up, and 8 warps cover the
    tile)."""
    mt = 2 if qt >= 32 else 1
    return 32 * (WARPS // (qt // (16 * mt)))


def sync_smem(qt: int, dp_bytes: int, kcap: int, stages: int) -> int:
    """Dynamic shared memory of one sync block: the query tile (rows padded
    by 16 bytes), the ring, each query's list of kcap and buffer of BUF
    (score, id) entries, its threshold (score, id) and count."""
    return (qt * (dp_bytes + 16) + stages * row_tile(qt) * ROW_STRIDE
            + qt * (kcap + BUF) * 8 + qt * 12)


def wgmma_smem(dp_bytes: int, kcap: int, stages: int, buf: int,
               int8: bool, warpgroups: int) -> int:
    """Dynamic shared memory of one wgmma block (csrc `layout`): the ring's
    items of WG_ROWS x 128 bytes, each consumer warpgroup's query tile
    (one item's size per 128-byte chunk of D), the side ring's slots of a
    tile's bias (and int8 scales), a full and an empty barrier per item
    and per side slot, each query's list of kcap and buffer of `buf`
    entries (the buffer's count lives in registers)."""
    nchunks = -(-dp_bytes // CHUNK_BYTES)
    side = WG_ROWS * 4 * (2 if int8 else 1)
    return (stages * (WG_ITEM + 16) + WG_SIDE_SLOTS * (side + 16)
            + warpgroups * nchunks * WG_ITEM
            + warpgroups * WG_QUERIES * (kcap + buf) * 8)


def block_smem(path: str, qt: int, dp_bytes: int, kcap: int, stages: int,
               buf: int = BUF, int8: bool = False) -> int:
    """Dynamic shared memory of one block of `path` with `qt` queries."""
    if path == "wgmma":
        return wgmma_smem(dp_bytes, kcap, stages, buf, int8,
                          qt // WG_QUERIES)
    return sync_smem(qt, dp_bytes, kcap, stages)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A block of `path` ("wgmma": csrc/scan_topk_wgmma.cu; "sync":
    csrc/scan_topk.cu): `qt` queries (wgmma: 64 per consumer warpgroup) x
    row tiles of `rt` rows through a ring of `stages` stages (wgmma: items
    of rt rows x 128 bytes), lists of `kcap` entries and buffers of `buf`,
    queries and rows zero-padded to `dp_bytes`, rows copied `vec` bytes at
    a time where the producer copies them.  wgmma only: `producer` "tma"
    or "cp.async"."""

    path: str
    qt: int
    rt: int
    kcap: int
    stages: int
    dp_bytes: int
    vec: int
    smem_bytes: int
    buf: int = BUF
    producer: str = ""


@dataclasses.dataclass(frozen=True)
class LaunchPlan(BlockPlan):
    """A BlockPlan and its grid: `splits` row splits of `split_rows` rows
    cover N, `qtiles` query tiles cover B."""

    split_rows: int = 0
    splits: int = 1
    qtiles: int = 1


def _splits(qtiles: int, row_tiles: int, slots: int) -> int:
    """Row splits: the fewest whose grid fills its last wave to FILL (the
    best fill if none does), at least MIN_SPLIT_TILES row tiles each."""
    s_max = max(1, min(row_tiles // MIN_SPLIT_TILES, 65535))
    best, best_fill = 1, 0.0
    for s in range(1, s_max + 1):
        blocks = qtiles * s
        fill = blocks / (-(-blocks // slots) * slots)
        if fill >= FILL:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


def _sync_block(b: int, dp_bytes: int, kcap: int, vec: int):
    """The sync block (or None): of the query tiles no wider than B needs,
    the one whose ring (as deep as shared memory allows, up to MAX_STAGES)
    keeps the most queries x bytes in flight, the larger tile on a tie."""
    cap = max(16, 1 << (max(b, 1) - 1).bit_length())
    best = None
    for qt in QUERY_TILES:
        stage = row_tile(qt) * ROW_STRIDE
        room = _lib.SMEM_LIMIT - sync_smem(qt, dp_bytes, kcap, 0)
        stages = min(MAX_STAGES, room // stage)
        if qt > cap or stages < 2:
            continue
        if best is None or qt * (stages - 1) * stage > best[0]:
            best = (qt * (stages - 1) * stage, qt, stages)
    if best is None:
        return None
    _, qt, stages = best
    return BlockPlan("sync", qt, row_tile(qt), kcap, stages, dp_bytes, vec,
                     sync_smem(qt, dp_bytes, kcap, stages))


def _wgmma_stages(dp_bytes: int, kcap: int, buf: int, int8: bool,
                  warpgroups: int) -> int:
    room = _lib.SMEM_LIMIT - wgmma_smem(dp_bytes, kcap, 0, buf, int8,
                                        warpgroups)
    return min(WG_MAX_STAGES, room // (WG_ITEM + 16))


def _wgmma_block(row_bytes: int, dp_bytes: int, kcap: int, vec: int,
                 align: int, int8: bool):
    """The wgmma block (or None if it does not fit or a row takes copies
    under 4 bytes): two consumer warpgroups where their block fits, else
    one.  The buffer: 32 entries where the ring still holds WG_RING_TILES
    tiles' items, else 16 (the shared memory of the kNN table's lists).
    The producer: TMA where the rows' stride and base are multiples of 16
    bytes, else cp.async."""
    if vec < 4:
        return None
    # a warpgroup holds a tile's items until its products are done
    nchunks = -(-dp_bytes // CHUNK_BYTES)
    for wgs in WG_WARPGROUPS:
        fits = [(bf, _wgmma_stages(dp_bytes, kcap, bf, int8, wgs))
                for bf in WG_BUFS]
        fits = [(bf, st) for bf, st in fits if st >= max(2, nchunks)]
        if fits:
            break
    else:
        return None
    deep = [f for f in fits if f[1] >= WG_RING_TILES * nchunks]
    bf, stages = deep[0] if deep else max(fits, key=lambda f: f[1])
    tma = row_bytes % 16 == 0 and align % 16 == 0
    return BlockPlan("wgmma", wgs * WG_QUERIES, WG_ROWS, kcap, stages,
                     dp_bytes, vec,
                     wgmma_smem(dp_bytes, kcap, stages, bf, int8, wgs), bf,
                     "tma" if tma else "cp.async")


@functools.lru_cache(maxsize=None)
def block_plan(b: int, dim: int, itemsize: int, rerank_k: int,
               align: int = 16, path: str | None = None) -> BlockPlan:
    """`align`: the largest power of two up to 16 that divides the rows'
    base address.  The path by shape alone (PATHS): the wgmma block where
    it fits (`_wgmma_block`), else the sync block (`_sync_block`); `path`
    forces one (for timing) and raises ValueError where the shape cannot
    take it.  Rows are copied in the widest
    unit up to 16 bytes that divides both the row width and `align`.
    Raises ValueError for rerank_k > K_MAX (one launch's most) or rows too
    wide for either block."""
    if not 1 <= rerank_k <= K_MAX:
        raise ValueError(f"scan_topk: rerank_k={rerank_k} outside 1..{K_MAX}")
    if path not in (None, *PATHS):
        raise ValueError(f"scan_topk: unknown path {path!r}")
    row_bytes = dim * itemsize
    dp_bytes = -(-max(row_bytes, 1) // STEP_BYTES) * STEP_BYTES
    kcap = max(32, 1 << (rerank_k - 1).bit_length())
    vec = next(v for v in (16, 8, 4, 2, 1)
               if row_bytes % v == 0 and align % v == 0)
    blk = None
    if path in (None, "wgmma"):
        blk = _wgmma_block(row_bytes, dp_bytes, kcap, vec, align,
                           itemsize == 1)
    if blk is None and path in (None, "sync"):
        blk = _sync_block(b, dp_bytes, kcap, vec)
    if blk is None:
        raise ValueError(f"scan_topk: D={dim} x {itemsize} B rows (aligned "
                         f"to {align}) with rerank_k={rerank_k} fit no "
                         f"{path or 'wgmma or sync'} block in "
                         f"{_lib.SMEM_LIMIT} bytes of shared memory")
    return blk


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, n: int, dim: int, itemsize: int, rerank_k: int,
                align: int = 16, sm_count: int = 132, per_sm: int = 1,
                path: str | None = None) -> LaunchPlan:
    """`block_plan`'s block and a grid over N rows: row splits until the
    grid of `sm_count` SMs, each holding `per_sm` blocks of the plan
    (`occupancy`), fills its last wave (`_splits`)."""
    blk = block_plan(b, dim, itemsize, rerank_k, align, path)
    row_tiles = max(1, -(-n // blk.rt))
    qtiles = -(-max(b, 1) // blk.qt)
    splits = _splits(qtiles, row_tiles, sm_count * max(1, per_sm))
    split_rows = -(-row_tiles // splits) * blk.rt
    return LaunchPlan(**dataclasses.asdict(blk), split_rows=split_rows,
                      splits=max(1, -(-n // split_rows)), qtiles=qtiles)


@functools.lru_cache(maxsize=None)
def occupancy(device_index: int, path: str, dtype_code: int, qt: int,
              bound: bool, buf: int, smem_bytes: int) -> int:
    """Blocks of the kernel's (path, dtype, qt, bound, buf) instance with
    smem_bytes of shared memory that one SM of the card holds at once
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    import ctypes

    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _lib.check(_lib.library().ohnsw_scan_topk_occupancy(
            PATHS[path], dtype_code, qt, int(bound), buf, smem_bytes,
            ctypes.byref(per_sm)), "scan_topk occupancy")
    return per_sm.value


def plan_for(scan, b: int, rerank_k: int, bound: bool = False,
             path: str | None = None) -> LaunchPlan:
    """The launch plan of `scan_topk` for B queries against the card
    tensor `scan` (`bound`: a later page's launch; `path`: forced),
    residency read from the card."""
    n_rows, dim = scan.shape
    itemsize, align = scan.element_size(), _alignment(scan.data_ptr())
    blk = block_plan(b, dim, itemsize, rerank_k, align, path)
    dev = scan.device
    return launch_plan(b, n_rows, dim, itemsize, rerank_k, align,
                       _sm_count(dev),
                       occupancy(dev.index, blk.path, _DTYPES[scan.dtype],
                                 blk.qt, bound, blk.buf, blk.smem_bytes),
                       path)


def _alignment(ptr: int) -> int:
    return 16 if ptr % 16 == 0 else ptr & -ptr


def _launch(device, *args) -> int:
    """Call the C entry point on `device`'s current stream."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        return _lib.library().ohnsw_scan_topk(*args, stream)


def launches_kernel(scan, metric: str) -> bool:
    """Whether `scan_topk` launches the kernel for a scan of these rows
    under `metric`; where not, its plain version serves the call."""
    return metric in KERNEL_METRICS and scan.is_cuda


def scan_topk(scan, scales, norms, deleted, n, q, rerank_k: int,
              metric: str, path: str | None = None):
    """(scores f32[B, rerank_k], ids i64[B, rerank_k]) ascending: the lowest
    scan scores of q f32[B, D] against scan rows bf16 or int8 [N, D] (int8
    with f32 `scales[N]`), `norms` f32[N], tombstones `deleted` bool[N],
    the occupied count `n` (0-d int32).  The queries are prepared as the
    scan's operand here: rounded to bf16, or quantized per row to int8.
    An id is -1 (score +inf) only where fewer than rerank_k rows score
    finite.  `path` ("wgmma" or "sync") forces the kernel's path, for
    timing; it raises ValueError where the shape cannot take it.

    Routes:
      * l2, ip, cosine (KERNEL_METRICS): CPU tensors take the plain
        version; CUDA tensors launch the kernel (one launch per K_MAX of
        rerank_k, `paged_topk`) or raise (there is no fallback).
        `scan_topk.launches` counts these launches and nothing else,
        `launches_by_dtype` the same by scan dtype ("bf16", "int8"),
        `launches_by_path` by path ("wgmma", "sync").
      * any other registered metric (its `matmul_score` is a Python
        callable the kernel cannot hold): the plain version on whatever
        device the tensors are on, counted in `scan_topk.plain_routes`."""
    if not launches_kernel(scan, metric):
        if metric not in KERNEL_METRICS:
            scan_topk.plain_routes += 1
        return scan_topk_plain(scan, scales, norms, deleted, n, q, rerank_k,
                               metric)
    n_rows, dim = scan.shape
    b = q.shape[0]
    if scan.dtype not in _DTYPES:
        raise TypeError(f"scan_topk: unsupported scan dtype {scan.dtype}")
    if q.dtype != torch.float32 or q.shape != (b, dim):
        raise ValueError(f"scan_topk: q must be f32[{b}, {dim}], got "
                         f"{q.dtype}{tuple(q.shape)}")
    if scales.dtype != torch.float32 or norms.dtype != torch.float32 \
            or deleted.dtype != torch.bool or n.dtype != torch.int32 \
            or scales.shape != (n_rows,) or norms.shape != (n_rows,) \
            or deleted.shape != (n_rows,) or n.numel() != 1:
        raise TypeError("scan_topk: scales and norms must be f32[N], "
                        "deleted bool[N] and n one int32")
    for t in (scales, norms, deleted, n, q):
        if t.device != scan.device:
            raise ValueError("scan_topk: tensors on different devices")
    if rerank_k < 1:
        raise ValueError(f"scan_topk: rerank_k={rerank_k} < 1")
    if path not in (None, *PATHS):
        raise ValueError(f"scan_topk: unknown path {path!r}")
    dev = scan.device
    scan, scales, norms = scan.contiguous(), scales.contiguous(), \
        norms.contiguous()
    deleted = deleted.contiguous()
    if b == 0 or n_rows == 0:
        return (torch.full((b, rerank_k), INF, device=dev),
                torch.full((b, rerank_k), -1, dtype=torch.int64, device=dev))
    # the queries as the scan's operand, zero-padded to dp_bytes
    int8 = scan.dtype == torch.int8
    dp = block_plan(b, dim, scan.element_size(), min(rerank_k, K_MAX),
                    _alignment(scan.data_ptr()), path).dp_bytes
    qp = torch.zeros((b, dp // scan.element_size()), dtype=scan.dtype,
                     device=dev)
    if int8:
        qi, qs = quantize_int8(q)
        qp[:, :dim] = qi
    else:
        qp[:, :dim] = q
        qs = scales  # not read

    def page(k, bound):
        plan = plan_for(scan, b, k, bound is not None, path)
        out_s = torch.empty((b, plan.splits, k), dtype=torch.float32,
                            device=dev)
        out_i = torch.empty((b, plan.splits, k), dtype=torch.int32,
                            device=dev)
        lb_s, lb_i = (None, None) if bound is None else \
            (bound[0].data_ptr(), bound[1].data_ptr())
        status = _launch(
            dev, scan.data_ptr(), _DTYPES[scan.dtype], scales.data_ptr(),
            norms.data_ptr(), deleted.data_ptr(), n.data_ptr(),
            qp.data_ptr(), qs.data_ptr(), lb_s, lb_i, out_s.data_ptr(),
            out_i.data_ptr(),
            b, n_rows, dim * scan.element_size(), plan.dp_bytes, k,
            plan.kcap, PATHS[plan.path], plan.qt, plan.buf, plan.split_rows,
            plan.splits, KERNEL_METRICS[metric],
            int(not get_metric(metric).needs_norms), plan.vec, plan.stages,
            int(plan.producer == "tma"), plan.smem_bytes)
        _lib.check(status, "scan_topk")
        scan_topk.launches += 1
        scan_topk.launches_by_dtype[DTYPE_NAMES[scan.dtype]] += 1
        scan_topk.launches_by_path[plan.path] += 1
        return merge_splits(out_s, out_i, k)

    return paged_topk(page, rerank_k)


scan_topk.launches = 0  # kernel launches (not counting plain-version calls)
scan_topk.launches_by_dtype = dict.fromkeys(DTYPE_NAMES.values(), 0)
scan_topk.launches_by_path = dict.fromkeys(PATHS, 0)
scan_topk.plain_routes = 0  # calls routed to the plain version by metric
#                             (module docstring; never the CPU)
