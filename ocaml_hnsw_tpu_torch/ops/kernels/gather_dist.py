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
#: warp tasks the plan aims for per SM (about 4 per resident warp), so the
#: persistent grid ends with little imbalance
TASKS_PER_SM = 128
#: rows in flight per warp on the generic path
GENERIC_ROWS = 4


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How csrc/gather_dist.cu covers a [B, K] call.  A warp task is one
    query and `kc` consecutive ids (the last of its `nchunks` may be
    shorter).  Vector path (cpl > 0): a row is D·itemsize/16 chunks of 16
    bytes, `1 << lpr_log2` lanes per row, `cpl` chunks per lane.  cpl = 0 is
    the generic path (any width or alignment)."""

    kc: int
    nchunks: int
    cpl: int
    lpr_log2: int

    @property
    def rows_per_iteration(self) -> int:
        if self.cpl == 0:
            return GENERIC_ROWS
        return (8 // self.cpl) * (32 >> self.lpr_log2)


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, k: int, dim: int, itemsize: int, aligned: bool,
                sm_count: int = 132) -> LaunchPlan:
    """`aligned`: the rows' and the queries' base addresses are 16-byte
    aligned.  Rows of a 16-byte multiple width up to 1024 elements take the
    vector path; the rest the generic one."""
    nch, rem = divmod(dim * itemsize, 16)
    if aligned and rem == 0 and 0 < dim <= 1024:
        cpl = 1 << max(0, (nch - 1) // 32).bit_length()  # ceil(nch/32) → 2^j
        lpr_log2 = min(5, max(0, nch - 1).bit_length())  # ceil(log2 nch)
        plan = LaunchPlan(0, 0, cpl, lpr_log2)
    else:
        plan = LaunchPlan(0, 0, 0, 5)
    # split K until the card has ~TASKS_PER_SM tasks per SM, in whole
    # iterations of rows and at most 32 ids (one per lane) per task
    want = max(1, -(-TASKS_PER_SM * sm_count // max(b, 1)))
    kc = -(-k // want)
    step = min(32, plan.rows_per_iteration)
    kc = min(32, -(-max(kc, 1) // step) * step)
    return dataclasses.replace(plan, kc=kc, nchunks=-(-k // kc))


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


def gather_dists(vectors, scales, q, ids, metric: str):
    """f32[B, K] distances d(q_b, vectors[ids[b, k]]).

    vectors [N, D] f32/bf16/int8, scales f32[N], q f32[B, D], ids i32[B, K].
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise: there is no fallback)."""
    if not vectors.is_cuda:
        return gather_dists_plain(vectors, scales, q, ids, metric)
    if metric not in KERNEL_METRICS:
        raise NotImplementedError(
            f"gather_dists: no CUDA kernel for registered metric {metric!r}")
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
                       _sm_count(vectors.device))
    lib = _lib.library()
    with torch.cuda.device(vectors.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ohnsw_gather_dists(
            vectors.data_ptr(), _DTYPES[vectors.dtype], scales.data_ptr(),
            q.data_ptr(), ids.data_ptr(), out.data_ptr(), b, k, dim,
            KERNEL_METRICS[metric], plan.kc, plan.nchunks, plan.cpl,
            plan.lpr_log2, stream)
    _lib.check(status, "gather_dists")
    gather_dists.launches += 1
    return out


gather_dists.launches = 0  # kernel launches (not counting plain-version calls)
