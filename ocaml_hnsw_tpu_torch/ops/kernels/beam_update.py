"""Beam update (K4): `beam_update` launches `csrc/beam_update.cu` on CUDA
tensors; `beam_update_plain` is the same function in plain torch.

Everything in one iteration of the packed beam loop
(`models/packed.py::_beam_body`) but the candidate scoring (K1): per query
row, mark K1's candidates fresh (id >= 0, not in the beam, first of its id
in the row), merge the fresh ones into the sorted beam with the bitonic
networks of `ops/sortmerge.py` (`merge_into_beam`), and select the next
iteration's E nearest unexpanded nodes.  Beam entries pack pk = 2·id +
expanded into one int32 (-1: empty, which reads as expanded).  The kernel
replaces no TPU kernel: on the TPU the JAX engine's whole step is one XLA
program; run eagerly it was ~215 small launches an iteration.

The kernel runs the same compare-exchange networks with the same strict
swap rule, so its outputs equal the plain version's bit for bit, ties
included.  Rows up to next_pow2(max(ef, C)) = `MAX_P2` (4096) entries;
wider rows raise.  Merges up to 256 wide take one warp per row in
registers, wider ones one block per row in shared memory: the shapes
decide, nothing else.
"""

from __future__ import annotations

import torch

from ocaml_hnsw_tpu_torch.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu_torch.ops.distance import INF
from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.ops.sortmerge import merge_into_beam, next_pow2

#: widest next_pow2(max(ef, C)) the kernel takes (csrc kMaxP2)
MAX_P2 = 4096


def _select_plain(beam_pk, expand: int):
    """The E = `expand` nearest unexpanded entries of the sorted beam (a
    cumsum mask): their expanded bits set, their ids (-1 past the last)."""
    ar = torch.arange(1, expand + 1, dtype=torch.int32, device=beam_pk.device)
    unexp = (beam_pk & 1) == 0
    slot = torch.cumsum(unexp.to(torch.int32), dim=1, dtype=torch.int32)
    sel_mask = unexp & (slot <= expand)
    beam_pk = torch.where(sel_mask, beam_pk | 1, beam_pk)
    oh = sel_mask[:, None, :] & (slot[:, None, :] == ar[None, :, None])
    pos = torch.argmax(oh.to(torch.uint8), dim=2)  # first hit per e
    active = torch.any(oh, dim=2)
    nodes = torch.where(active, torch.gather(beam_pk, 1, pos) >> 1, -1)
    return beam_pk, nodes


def beam_update_plain(beam_pk, beam_d, cand_ids=None, cand_d=None, *,
                      expand: int, select_next: bool = True):
    """Plain torch version.  beam_pk i32[B, ef], beam_d f32[B, ef]
    ascending; cand_ids i32[B, C], cand_d f32[B, C] (K1's output), or None
    for the selection alone.  Returns (beam_pk, beam_d, nodes i32[B,
    expand], or None when select_next is False)."""
    if cand_ids is not None:
        ef = beam_pk.shape[1]
        in_beam = torch.any(
            cand_ids[:, :, None] == (beam_pk >> 1)[:, None, :], dim=2)
        fresh = ((cand_ids >= 0) & ~in_beam
                 & first_occurrence_mask(cand_ids))
        cand_pk = torch.where(fresh, cand_ids * 2, -1)  # enter unexpanded
        cand_d = torch.where(fresh, cand_d, INF)
        beam_d, (beam_pk,) = merge_into_beam(
            beam_d, [(beam_pk, -1)], cand_d, [(cand_pk, -1)], ef,
        )
    if not select_next:
        return beam_pk, beam_d, None
    beam_pk, nodes = _select_plain(beam_pk, expand)
    return beam_pk, beam_d, nodes


def _check(beam_pk, beam_d, cand_ids, cand_d, expand: int,
           select_next: bool) -> None:
    if beam_pk.dtype != torch.int32 or beam_d.dtype != torch.float32:
        raise TypeError("beam_update: beam_pk must be int32, beam_d float32")
    if beam_pk.dim() != 2 or beam_d.shape != beam_pk.shape \
            or beam_pk.shape[1] < 1:
        raise ValueError("beam_update: beam_pk and beam_d must be [B, ef], "
                         "ef >= 1")
    if select_next and expand < 1:
        raise ValueError(f"beam_update: expand={expand} < 1")
    c = 0
    if cand_ids is None:
        if cand_d is not None or not select_next:
            raise ValueError("beam_update: without candidates there is only "
                             "the selection (cand_d None, select_next)")
    else:
        if cand_ids.dtype != torch.int32 or cand_d.dtype != torch.float32:
            raise TypeError("beam_update: cand_ids must be int32, cand_d "
                            "float32")
        if cand_ids.dim() != 2 or cand_d.shape != cand_ids.shape \
                or cand_ids.shape[0] != beam_pk.shape[0]:
            raise ValueError("beam_update: cand_ids and cand_d must be "
                             "[B, C] with the beam's B")
        c = cand_ids.shape[1]
        if cand_ids.device != beam_pk.device \
                or cand_d.device != beam_pk.device:
            raise ValueError("beam_update: tensors on different devices")
    if beam_d.device != beam_pk.device:
        raise ValueError("beam_update: tensors on different devices")
    if next_pow2(max(beam_pk.shape[1], c)) > MAX_P2:
        raise ValueError(f"beam_update: next_pow2(max(ef, C)) over {MAX_P2}"
                         f" (ef={beam_pk.shape[1]}, C={c})")


def beam_update(beam_pk, beam_d, cand_ids=None, cand_d=None, *, expand: int,
                select_next: bool = True):
    """See `beam_update_plain`.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise: there is no fallback), on torch's
    current stream, without a host sync.  The selection alone (no
    candidates) returns beam_d itself."""
    _check(beam_pk, beam_d, cand_ids, cand_d, expand, select_next)
    if not beam_pk.is_cuda:
        return beam_update_plain(beam_pk, beam_d, cand_ids, cand_d,
                                 expand=expand, select_next=select_next)
    b, ef = beam_pk.shape
    beam_pk, beam_d = beam_pk.contiguous(), beam_d.contiguous()
    out_pk = torch.empty_like(beam_pk)
    out_d = beam_d
    c = 0
    if cand_ids is not None:
        cand_ids, cand_d = cand_ids.contiguous(), cand_d.contiguous()
        c = cand_ids.shape[1]
        out_d = torch.empty_like(beam_d)
    nodes = (torch.empty((b, expand), dtype=torch.int32,
                         device=beam_pk.device) if select_next else None)
    if b == 0:
        return out_pk, out_d, nodes
    lib = _lib.library()
    with torch.cuda.device(beam_pk.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ohnsw_beam_update(
            beam_pk.data_ptr(), beam_d.data_ptr(),
            None if cand_ids is None else cand_ids.data_ptr(),
            None if cand_d is None else cand_d.data_ptr(),
            out_pk.data_ptr(), out_d.data_ptr(),
            None if nodes is None else nodes.data_ptr(),
            b, ef, c, expand, int(select_next), stream)
    _lib.check(status, "beam_update")
    beam_update.launches += 1
    return out_pk, out_d, nodes


beam_update.launches = 0  # kernel launches (not counting plain-version calls)
