"""Packed score (K1): `packed_score` launches `csrc/payload_score.cu` on CUDA
tensors; `packed_score_plain` is the same function in plain torch.

Replaces the TPU kernel `ocaml_hnsw_tpu/ops/pallas/payload_score.py::
payload_score` and the inline expression the JAX engine runs in its place
(`ocaml_hnsw_tpu/models/packed.py`, `_beam_body`): for each query b and
expanded node nodes[b, e], the node's deg neighbour ids and their distances

    l2:        s²·(‖x8‖² − 2·x8·q8) + ‖q‖²
    ip/cosine: 1 − s²·(x8·q8)

with the dot exact in int32 (the JAX engine rounds each product to bf16), and
id −1 / distance +inf where the node is −1 or the adjacency slot is empty.

Two options, as the JAX engine's `deg_limit` and `bits=4`: `slots` scores
only the first slots neighbours of each node (a prefix of its slab), and
`bits=4` reads a nibble-packed [deg, d_pad/2] slab against a bf16 query row
q/s [B, d_pad], each nibble times the query value summed in f32 (the JAX
engine rounds each product to bf16 instead).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.utils import round_up

#: warps per block (csrc kMaxWarps)
WARPS = 4
#: stages of each warp's ring (csrc/payload_score.cu: one item armed ahead
#: of the one it scores timed as fast as any ring on an H100, whatever the
#: call's items per warp)
STAGES = 2


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Shape of the kernel's shared-memory rings (csrc/payload_score.cu):
    each of a block's `warps` warps owns `stages` stages of `stage_bytes`,
    each holding one item's slab prefix and (when `meta_in_ring`) its whole
    meta row, and `query_slots` query rows, in `warp_bytes`; it keeps one
    item armed ahead of the one it scores (two or more stages: the next item
    is armed when one lands; one: the stage is re-armed after its item is
    scored)."""

    stages: int
    warps: int
    stage_bytes: int
    query_slots: int
    warp_bytes: int
    smem_bytes: int
    meta_in_ring: bool


def _header_bytes(barriers: int) -> int:
    return round_up(barriers * 8, 128)  # one mbarrier per stage


def query_bytes(d_pad: int, bits: int) -> int:
    """Bytes of one query row against slab rows of d_pad stored bytes:
    int8[d_pad], or bf16[2·d_pad] for bits=4."""
    return d_pad if bits == 8 else 4 * d_pad


def query_slots(stages: int, e: int) -> int:
    """Query rows a warp keeps: as many as the queries that `stages`
    consecutive items of E per query can belong to (the items in flight and
    the one being scored), so a row is never overwritten while read."""
    return -(-(stages - 1) // e) + 1


@functools.lru_cache(maxsize=None)
def launch_plan(e: int, deg: int, d_pad: int, meta_aligned: bool = True,
                slots: int | None = None, bits: int = 8) -> LaunchPlan:
    """Ring shape for a call of E expanded nodes per query from the item
    size: the first `slots` rows of a node's [deg, d_pad]-byte slab and,
    when it can be one bulk copy (16-byte multiple, aligned base), the meta
    row (else the warp reads it from device memory); E sets the query
    slots.  STAGES stages per warp, whatever the call's size; one stage,
    re-armed after scoring, when two do not fit.
    Up to WARPS warps per block, as many as fit 227 KiB.  Raises ValueError
    if one stage does not fit."""
    slots = deg if slots is None else slots
    meta_in_ring = meta_aligned and (8 * deg) % 16 == 0
    stage = round_up(slots * d_pad + (8 * deg if meta_in_ring else 0), 128)
    q_bytes = query_bytes(d_pad, bits)
    for stages in range(STAGES, 0, -1):
        slots_q = query_slots(stages, e)
        warp = round_up(stages * stage + slots_q * q_bytes, 128)
        for warps in range(WARPS, 0, -1):
            smem = _header_bytes(warps * stages) + warps * warp
            if smem <= _lib.SMEM_LIMIT:
                return LaunchPlan(stages, warps, stage, slots_q, warp, smem,
                                  meta_in_ring)
    raise ValueError(f"packed_score: a [{deg}, {d_pad}] slab does not fit "
                     "in one block's shared memory")


def kernel_instance(d_pad: int, bits: int) -> str:
    """The template instance of csrc's kernel a call at this d_pad and bits
    launches (as `sass_op_counts` names it)."""
    nvec = {(128, 8): 8, (64, 4): 4}.get((d_pad, bits), 0)
    return f"packed_score_kernel<{nvec}, {bits}>"


def occupancy(plan: LaunchPlan, d_pad: int, bits: int) -> int:
    """Blocks of this plan that one SM of the current card holds at once
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`, as the launch asks)."""
    import ctypes

    per_sm = ctypes.c_int(0)
    _lib.check(_lib.library().ohnsw_packed_score_occupancy(
        d_pad, bits, plan.warps, plan.smem_bytes, ctypes.byref(per_sm)),
        "packed_score occupancy")
    return per_sm.value


def nibble_unpack(v):
    """Nibble-packed int8 bytes -> (lo, hi) int8 planes, each in [-8, 7]:
    lo holds the even components, hi the odd ones (the inverse of
    `models/packed.py::_nibble_pack`)."""
    vi = v.to(torch.int32)
    lo = ((vi & 0xF) ^ 8) - 8
    hi = vi >> 4  # arithmetic shift: the signed high nibble
    return lo.to(torch.int8), hi.to(torch.int8)


def packed_score_plain(nodes, meta, pay, q8, qn, scale, needs_norms: bool,
                       slots: int | None = None, bits: int = 8):
    """Plain torch version.  nodes i32[B, E]; meta i32[N, 2·deg]; pay
    int8[N, deg, d_pad]; q8 int8[B, d_pad] (bits=8) or bf16[B, 2·d_pad]
    (bits=4); qn f32[B]; scale f32 scalar; slots in [1, deg] (None: deg).
    Returns (cand_ids i32[B, E·slots], cand_d f32[B, E·slots])."""
    b = nodes.shape[0]
    deg = pay.shape[1]
    slots = deg if slots is None else slots
    safe = nodes.clamp_min(0).long()
    mrow = meta[safe]  # [B, E, 2·deg]
    nbrs = torch.where((nodes >= 0)[:, :, None], mrow[:, :, :slots], -1)
    nrm = mrow[:, :, deg:deg + slots]
    slab = pay[:, :slots][safe]  # [B, E, slots, d_pad]
    s2 = scale * scale
    if bits == 8:
        dot = torch.sum(slab.to(torch.int32)
                        * q8.to(torch.int32)[:, None, None, :], dim=-1,
                        dtype=torch.int32)
        t = (nrm - 2 * dot).float()
        dot = dot.float()
    else:
        lo, hi = nibble_unpack(slab)
        qf = q8.float()[:, None, None, :]
        dot = torch.sum(lo.float() * qf[..., 0::2]
                        + hi.float() * qf[..., 1::2], dim=-1)
        t = nrm.float() - 2.0 * dot
    if needs_norms:
        d = s2 * t + qn[:, None, None]
    else:
        d = 1.0 - s2 * dot
    cand_ids = nbrs.reshape(b, -1)
    cand_d = torch.where(cand_ids < 0, float("inf"), d.reshape(b, -1))
    return cand_ids, cand_d


def packed_score(nodes, meta, pay, q8, qn, scale, needs_norms: bool,
                 slots: int | None = None, bits: int = 8):
    """See `packed_score_plain`.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise: there is no fallback).  `scale`
    stays a device tensor, so a beam iteration needs no host sync."""
    if not pay.is_cuda:
        return packed_score_plain(nodes, meta, pay, q8, qn, scale, needs_norms,
                                  slots, bits)
    b, e = nodes.shape
    n_cap, deg, d_pad = pay.shape
    slots = deg if slots is None else slots
    if bits not in (8, 4):
        raise ValueError(f"packed_score: bits must be 8 or 4, got {bits}")
    if not 1 <= slots <= deg:
        raise ValueError(f"packed_score: slots={slots} outside [1, {deg}]")
    q_dtype, q_width = ((torch.int8, d_pad) if bits == 8
                        else (torch.bfloat16, 2 * d_pad))
    if pay.dtype != torch.int8 or q8.dtype != q_dtype:
        raise TypeError(f"packed_score: pay must be int8 and q8 {q_dtype}")
    if nodes.dtype != torch.int32 or meta.dtype != torch.int32:
        raise TypeError("packed_score: nodes and meta must be int32")
    if meta.shape != (n_cap, 2 * deg) or q8.shape != (b, q_width) \
            or qn.shape != (b,) or qn.dtype != torch.float32:
        raise ValueError("packed_score: shapes disagree (meta [N, 2·deg], "
                         "q8 [B, d_pad] or bf16 [B, 2·d_pad], qn f32[B])")
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError("packed_score: scale must be one f32 on the device")
    if d_pad % 16:
        raise ValueError("packed_score: d_pad must be a multiple of 16")
    for t in (nodes, meta, q8, qn, scale):
        if t.device != pay.device:
            raise ValueError("packed_score: tensors on different devices")
    nodes, meta, q8 = nodes.contiguous(), meta.contiguous(), q8.contiguous()
    pay, qn = pay.contiguous(), qn.contiguous()
    if pay.data_ptr() % 16 or q8.data_ptr() % 16:
        raise ValueError("packed_score: pay and q8 must be 16-byte aligned")
    cand_ids = torch.empty((b, e * slots), dtype=torch.int32,
                           device=pay.device)
    cand_d = torch.empty((b, e * slots), dtype=torch.float32,
                         device=pay.device)
    if b * e * slots == 0:
        return cand_ids, cand_d
    plan = launch_plan(e, deg, d_pad, meta.data_ptr() % 16 == 0, slots, bits)
    lib = _lib.library()
    with torch.cuda.device(pay.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ohnsw_packed_score(
            nodes.data_ptr(), meta.data_ptr(), pay.data_ptr(), q8.data_ptr(),
            qn.data_ptr(), scale.data_ptr(), cand_ids.data_ptr(),
            cand_d.data_ptr(), b, e, deg, d_pad, int(needs_norms), slots,
            bits, plan.stages, plan.warps, plan.stage_bytes,
            plan.query_slots, plan.warp_bytes, plan.smem_bytes,
            int(plan.meta_in_ring), stream)
    _lib.check(status, "packed_score")
    packed_score.launches += 1
    return cand_ids, cand_d


packed_score.launches = 0  # kernel launches (not counting plain-version calls)
