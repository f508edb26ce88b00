"""Gather-distance (K2): `gather_dists` launches `csrc/gather_dist.cu` on CUDA
tensors; `gather_dists_plain` is the same function in plain torch.

Replaces the TPU kernel `ocaml_hnsw_tpu/ops/pallas/gather_dist.py::gather_l2`
under the wider contract of `ocaml_hnsw_tpu/ops/distance.py::dists_to_ids`:
d[b, k] = dist(q[b], dequant(vectors[ids[b, k]])) for rows stored as f32,
bf16 or int8 (with per-row `scales`), l2 or ip/cosine, +inf at id -1.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ocaml_hnsw_tpu_torch.ops.metrics import get_metric
from ocaml_hnsw_tpu_torch.ops.kernels import _lib

#: built-in metrics the kernel computes: 0 = l2, 1 = 1 - dot
KERNEL_METRICS = {"l2": 0, "ip": 1, "cosine": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: row dtypes by the names `gather_dists.launches_by_dtype` counts under
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int8: "int8"}
#: the kernel widens int8 rows without a conversion instruction (csrc
#: `biased_byte`): f32 bits INT8_MAGIC | (b ^ 0x80) are 2^23 + 128 + v for
#: the signed byte v stored as bits b, and minus INT8_BIAS = 2^23 + 128 they
#: are v exactly (`int8_bits_to_float` is that construction in torch)
INT8_MAGIC, INT8_BIAS = 0x4B000000, 8388736.0
#: warp tasks the plan aims for per SM (about 4 per resident warp), so the
#: persistent grid ends with little imbalance
TASKS_PER_SM = 128
#: rows in flight per warp on the generic path
GENERIC_ROWS = 4
#: the ring path takes aligned rows of a 16-byte multiple width from this
#: many bytes up (and every such row wider than 1024 elements): the
#: crossing point of the vector and ring paths, measured by the width
#: sweep of commit 3d59fe2 (PERF.md §6)
RING_MIN_ROW_BYTES = 2048
#: ring path: warps per block (csrc kMaxRingWarps), and the (lanes per row
#: as log2, stages per warp) shapes tried in order, widest ring first, until
#: one warp's stages and query row fit in a block's shared memory
RING_WARPS = 4
RING_SHAPES = ((3, 8), (4, 4), (5, 2), (5, 1))
PATHS = ("generic", "vector", "ring")  # csrc's path codes 0, 1, 2


def _header_bytes(barriers: int) -> int:
    """csrc/ring.cuh header_bytes: mbarriers, rounded up to 128 bytes."""
    return -(-barriers * 8 // 128) * 128


def ring_smem(dim: int, itemsize: int, stages: int, warps: int) -> int:
    """Dynamic shared memory of one ring-path block: the mbarriers (one per
    stage and one for the query, per warp), then per warp `stages` rows and
    the f32 query row."""
    return (_header_bytes(warps * (stages + 1))
            + warps * (stages * dim * itemsize + 4 * dim))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How csrc/gather_dist.cu covers a [B, K] call.  A warp task is one
    query and `kc` consecutive ids (the last of its `nchunks` may be
    shorter).  `path`:
      * "vector": a row is D·itemsize/16 chunks of 16 bytes, `1 << lpr_log2`
        lanes per row, `cpl` chunks per lane, straight into registers;
      * "ring": rows through a ring of `stages` shared-memory stages per
        warp filled by bulk copies, `1 << lpr_log2` lanes per row, `warps`
        per block, `smem_bytes` of shared memory per block;
      * "generic": any width or alignment, lanes stride the row."""

    path: str
    kc: int
    nchunks: int
    cpl: int = 0
    lpr_log2: int = 5
    stages: int = 0
    warps: int = 0
    smem_bytes: int = 0

    @property
    def rows_per_iteration(self) -> int:
        if self.path == "generic":
            return GENERIC_ROWS
        if self.path == "ring":
            return 32 >> self.lpr_log2
        return (8 // self.cpl) * (32 >> self.lpr_log2)


def _ring_plan(dim: int, itemsize: int) -> LaunchPlan | None:
    """The widest ring shape whose block fits in `_lib.SMEM_LIMIT` (with as
    many warps, up to RING_WARPS, as fit), or None if not even one stage of
    one warp does."""
    for lpr_log2, stages in RING_SHAPES:
        for warps in range(RING_WARPS, 0, -1):
            smem = ring_smem(dim, itemsize, stages, warps)
            if smem <= _lib.SMEM_LIMIT:
                return LaunchPlan("ring", 0, 0, 0, lpr_log2, stages, warps,
                                  smem)
    return None


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, k: int, dim: int, itemsize: int, aligned: bool,
                sm_count: int = 132, path: str | None = None) -> LaunchPlan:
    """`aligned`: the rows' and the queries' base addresses are 16-byte
    aligned.  Aligned rows of a 16-byte multiple width take the ring path
    from RING_MIN_ROW_BYTES or 1025 elements up, the vector path below
    (up to 1024 elements); the rest the generic one.  `path` forces a path
    (for timing one against another); a path the shape cannot take raises
    ValueError."""
    row_bytes = dim * itemsize
    nch, rem = divmod(row_bytes, 16)
    chunked = aligned and rem == 0 and dim > 0
    ring = _ring_plan(dim, itemsize) if chunked else None
    can_vector = chunked and dim <= 1024
    if path is None:
        if ring is not None and (row_bytes >= RING_MIN_ROW_BYTES
                                 or dim > 1024):
            path = "ring"
        else:
            path = "vector" if can_vector else "generic"
    if path == "ring":
        if ring is None:
            raise ValueError(f"gather_dists: D={dim} x {itemsize} B rows "
                             f"(aligned={aligned}) cannot take the ring path")
        plan = ring
    elif path == "vector":
        if not can_vector:
            raise ValueError(f"gather_dists: D={dim} x {itemsize} B rows "
                             f"(aligned={aligned}) cannot take the vector "
                             "path")
        cpl = 1 << max(0, (nch - 1) // 32).bit_length()  # ceil(nch/32) → 2^j
        lpr_log2 = min(5, max(0, nch - 1).bit_length())  # ceil(log2 nch)
        plan = LaunchPlan("vector", 0, 0, cpl, lpr_log2)
    elif path == "generic":
        plan = LaunchPlan("generic", 0, 0)
    else:
        raise ValueError(f"gather_dists: unknown path {path!r}")
    # split K until the card has ~TASKS_PER_SM tasks per SM, in whole
    # iterations of rows and at most 32 ids (one per lane) per task
    want = max(1, -(-TASKS_PER_SM * sm_count // max(b, 1)))
    kc = -(-k // want)
    step = min(32, plan.rows_per_iteration)
    kc = min(32, -(-max(kc, 1) // step) * step)
    return dataclasses.replace(plan, kc=kc, nchunks=-(-k // kc))


def int8_bits_to_float(v: torch.Tensor) -> torch.Tensor:
    """int8 values -> f32 by the kernel's bit construction (the plain
    mirror of csrc/gather_dist.cu `biased_byte`): equal to `v.float()`."""
    b = v.to(torch.int32) & 0xFF
    return (INT8_MAGIC | (b ^ 0x80)).view(torch.float32) - INT8_BIAS


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gather_dists_plain(vectors, scales, q, ids, metric: str):
    """Plain torch version: gather, dequantize, `pair_dist`, +inf at -1."""
    safe = ids.clamp_min(0).long()
    rows = vectors[safe]  # [B, K, D]
    if rows.dtype == torch.int8:
        rows = rows.float() * scales[safe][:, :, None]
    elif rows.dtype != torch.float32:
        rows = rows.float()
    d = get_metric(metric).pair_dist(rows, q)
    return torch.where(ids < 0, float("inf"), d)


def gather_dists(vectors, scales, q, ids, metric: str,
                 path: str | None = None):
    """f32[B, K] distances d(q_b, vectors[ids[b, k]]).

    vectors [N, D] f32/bf16/int8, scales f32[N], q f32[B, D], ids i32[B, K].

    Which metric takes which route:
      * l2, ip, cosine (KERNEL_METRICS): CPU tensors take the plain version;
        CUDA tensors launch the kernel or raise (there is no fallback).
        `gather_dists.launches` counts these launches and nothing else,
        `gather_dists.launches_by_path` the same launches by the plan's
        path ("vector", "ring", "generic"), `launches_by_dtype` by the
        rows' dtype ("f32", "bf16", "int8"); `path` forces one (for timing
        one against another: `launch_plan`).
      * any other registered metric: gather, dequantize and the metric's own
        `pair_dist`, on whatever device the tensors are on.  A user's Python
        callable cannot be compiled into csrc/gather_dist.cu, and this is
        what the JAX package does for such metrics
        (`ops/distance.py::dists_to_ids`).  `gather_dists.registry_calls`
        counts these calls."""
    if metric not in KERNEL_METRICS:
        gather_dists.registry_calls += 1
        return gather_dists_plain(vectors, scales, q, ids, metric)
    if not vectors.is_cuda:
        return gather_dists_plain(vectors, scales, q, ids, metric)
    b, k = ids.shape
    n, dim = vectors.shape
    if vectors.dtype not in _DTYPES:
        raise TypeError(f"gather_dists: unsupported row dtype {vectors.dtype}")
    if q.dtype != torch.float32 or q.shape != (b, dim):
        raise ValueError(f"gather_dists: q must be f32[{b}, {dim}], got "
                         f"{q.dtype}{tuple(q.shape)}")
    if ids.dtype != torch.int32 or scales.dtype != torch.float32 \
            or scales.shape != (n,):
        raise TypeError("gather_dists: ids must be int32 and scales f32[N]")
    for t in (scales, q, ids):
        if t.device != vectors.device:
            raise ValueError("gather_dists: tensors on different devices")
    vectors, scales = vectors.contiguous(), scales.contiguous()
    q, ids = q.contiguous(), ids.contiguous()
    out = torch.empty((b, k), dtype=torch.float32, device=vectors.device)
    if b * k == 0:
        return out
    plan = launch_plan(b, k, dim, vectors.element_size(),
                       vectors.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0,
                       _sm_count(vectors.device), path)
    lib = _lib.library()
    with torch.cuda.device(vectors.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ohnsw_gather_dists(
            vectors.data_ptr(), _DTYPES[vectors.dtype], scales.data_ptr(),
            q.data_ptr(), ids.data_ptr(), out.data_ptr(), b, k, dim,
            KERNEL_METRICS[metric], plan.kc, plan.nchunks,
            PATHS.index(plan.path), plan.cpl, plan.lpr_log2, plan.stages,
            plan.warps, plan.smem_bytes, stream)
    _lib.check(status, "gather_dists")
    gather_dists.launches += 1
    gather_dists.launches_by_path[plan.path] += 1
    gather_dists.launches_by_dtype[DTYPE_NAMES[vectors.dtype]] += 1
    return out


gather_dists.launches = 0  # kernel launches (not counting plain-version calls)
gather_dists.launches_by_path = dict.fromkeys(PATHS, 0)
gather_dists.launches_by_dtype = dict.fromkeys(DTYPE_NAMES.values(), 0)
gather_dists.registry_calls = 0  # calls under a metric outside KERNEL_METRICS
