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

`beam_step_classic` is the same kernel's entry for the classic engine's
beam (`models/search.py::beam_search_layer`, beam-only dedup), whose
candidate block is deduplicated and compacted before K2 scores it: one
launch merges the previous iteration's scored block into the beam, selects
the next E nodes, reads their adjacency rows (a dense layer table or an
`UpperView` of the upper arena), marks the fresh ids and packs them into
K2's next block.  `beam_step_classic_plain` holds the eager ops it replaced
(~290 launches an iteration), with the same outputs bit for bit.
"""

from __future__ import annotations

import torch

from ocaml_hnsw_tpu_torch.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu_torch.ops.distance import INF
from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.ops.sortmerge import merge_into_beam, next_pow2

#: widest next_pow2(max(ef, C)) the kernel takes (csrc kMaxP2)
MAX_P2 = 4096
#: most expand·deg slots the classic step takes (csrc kMaxSlots)
MAX_SLOTS = 4096


def select_unexpanded(beam_pk, expand: int):
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
    beam_pk, nodes = select_unexpanded(beam_pk, expand)
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


def classic_width(expand: int, deg: int, compact_k: int | None) -> int:
    """Width of the classic step's candidate block: the expand·deg slots,
    or `compact_k` when that is fewer."""
    slots = expand * deg
    return compact_k if compact_k is not None and compact_k < slots \
        else slots


def beam_step_classic_plain(beam_pk, beam_d, cand_ids, cand_d, adj, live, *,
                            expand: int, compact_k: int | None = None):
    """Plain torch version.  beam_pk i32[B, ef], beam_d f32[B, ef]
    ascending; cand_ids i32[B, C'], cand_d f32[B, C'] the previous step's
    block and its distances (K2's), or None on the first step; adj the
    layer's adjacency (i32[N, deg], or an `UpperView`); live an int32
    tensor of one element, set to 1 when some row's merged beam has an
    unexpanded member (left as it was otherwise).  Returns (beam_pk, beam_d,
    cand_ids i32[B, classic_width(expand, deg, compact_k)]): the merged beam
    with the E selected members marked expanded, and the next block (fresh
    ids packed left in slot order when compacted, else in place; -1
    elsewhere)."""
    from ocaml_hnsw_tpu_torch.models.graph import adj_take

    ef = beam_pk.shape[1]
    dev = beam_pk.device
    if cand_ids is not None:
        cand_pk = torch.where(cand_ids < 0, -1, cand_ids * 2)
        beam_d, (beam_pk,) = merge_into_beam(
            beam_d, [(beam_pk, -1)], cand_d, [(cand_pk, -1)], ef)
    live.bitwise_or_(torch.any((beam_pk & 1) == 0).to(torch.int32))
    beam_pk, nodes = select_unexpanded(beam_pk, expand)
    # frontier expansion: adjacency gather
    nbrs = adj_take(adj, nodes.clamp_min(0))  # [B, E, deg]
    nbrs = torch.where((nodes >= 0)[:, :, None], nbrs, -1).flatten(1)
    # beam-only dedup
    in_beam = torch.any(nbrs[:, :, None] == (beam_pk >> 1)[:, None, :], dim=2)
    fresh = (nbrs >= 0) & ~in_beam & first_occurrence_mask(nbrs)
    cand_ids = torch.where(fresh, nbrs, -1)
    if compact_k is not None and compact_k < cand_ids.shape[1]:
        # fresh ids packed left in slot order (the kept keys are distinct,
        # so a stable sort equals the JAX bitonic network)
        kk = cand_ids.shape[1]
        slots = torch.arange(kk, dtype=torch.int32, device=dev)
        key = torch.where(fresh, slots[None, :], kk)
        skey, order = torch.sort(key, dim=1, stable=True)
        cand_ids = torch.where(skey[:, :compact_k] < kk,
                               torch.gather(cand_ids, 1,
                                            order[:, :compact_k]), -1)
    return beam_pk, beam_d, cand_ids


def _adj_fields(adj):
    """(table, up_base, levels, level, sink row) of a dense layer table
    (up_base and levels None) or of an `UpperView`."""
    if isinstance(adj, torch.Tensor):
        return adj, None, None, 0, -1
    return (adj.table, adj.up_base, adj.levels, adj.level,
            adj.table.shape[0] - 1)


def _check_classic(beam_pk, beam_d, cand_ids, cand_d, adj, live,
                   expand: int, compact_k: int | None) -> None:
    table, up_base, levels, level, _ = _adj_fields(adj)
    ints = [("beam_pk", beam_pk), ("adjacency", table), ("live", live)]
    if up_base is not None:
        ints += [("up_base", up_base), ("levels", levels)]
    for name, t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"beam_step_classic: {name} must be int32")
    if beam_d.dtype != torch.float32:
        raise TypeError("beam_step_classic: beam_d must be float32")
    if beam_pk.dim() != 2 or beam_d.shape != beam_pk.shape \
            or beam_pk.shape[1] < 1:
        raise ValueError("beam_step_classic: beam_pk and beam_d must be "
                         "[B, ef], ef >= 1")
    b, ef = beam_pk.shape
    if table.dim() != 2 or table.shape[1] < 1 or live.numel() != 1:
        raise ValueError("beam_step_classic: the adjacency must be [N, deg] "
                         "and live one element")
    if up_base is not None and (level < 1 or up_base.dim() != 1
                                or levels.shape != up_base.shape):
        raise ValueError("beam_step_classic: an UpperView needs level >= 1 "
                         "and up_base, levels of one shape [N]")
    if not 1 <= expand <= ef:
        raise ValueError(f"beam_step_classic: expand={expand} outside "
                         f"[1, ef={ef}]")
    if compact_k is not None and compact_k < 1:
        raise ValueError(f"beam_step_classic: compact_k={compact_k} < 1")
    c_in = 0
    tensors = [beam_d, table, live] + ([up_base, levels]
                                       if up_base is not None else [])
    if (cand_ids is None) != (cand_d is None):
        raise ValueError("beam_step_classic: cand_ids and cand_d go together")
    if cand_ids is not None:
        if cand_ids.dtype != torch.int32 or cand_d.dtype != torch.float32:
            raise TypeError("beam_step_classic: cand_ids must be int32, "
                            "cand_d float32")
        if cand_ids.dim() != 2 or cand_d.shape != cand_ids.shape \
                or cand_ids.shape[0] != b:
            raise ValueError("beam_step_classic: cand_ids and cand_d must be "
                             "[B, C] with the beam's B")
        c_in = cand_ids.shape[1]
        tensors += [cand_ids, cand_d]
    if any(t.device != beam_pk.device for t in tensors):
        raise ValueError("beam_step_classic: tensors on different devices")
    if next_pow2(max(ef, c_in)) > MAX_P2 or expand * table.shape[1] \
            > MAX_SLOTS:
        raise ValueError(f"beam_step_classic: next_pow2(max(ef, C)) over "
                         f"{MAX_P2} or expand·deg over {MAX_SLOTS} (ef={ef}, "
                         f"C={c_in}, expand={expand}, deg={table.shape[1]})")


def beam_step_classic(beam_pk, beam_d, cand_ids, cand_d, adj, live, *,
                      expand: int, compact_k: int | None = None):
    """See `beam_step_classic_plain`.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise: there is no fallback), on
    torch's current stream, without a host sync."""
    _check_classic(beam_pk, beam_d, cand_ids, cand_d, adj, live, expand,
                   compact_k)
    if not beam_pk.is_cuda:
        return beam_step_classic_plain(beam_pk, beam_d, cand_ids, cand_d,
                                       adj, live, expand=expand,
                                       compact_k=compact_k)
    table, up_base, levels, level, sink = _adj_fields(adj)
    b, ef = beam_pk.shape
    deg = table.shape[1]
    c = classic_width(expand, deg, compact_k)
    beam_pk, beam_d = beam_pk.contiguous(), beam_d.contiguous()
    table = table.contiguous()
    out_pk = torch.empty_like(beam_pk)
    out_d = torch.empty_like(beam_d)
    out_cand = torch.empty((b, c), dtype=torch.int32, device=beam_pk.device)
    if b == 0:
        return out_pk, out_d, out_cand
    c_in = 0
    if cand_ids is not None:
        cand_ids, cand_d = cand_ids.contiguous(), cand_d.contiguous()
        c_in = cand_ids.shape[1]
    if up_base is not None:
        up_base, levels = up_base.contiguous(), levels.contiguous()
    lib = _lib.library()
    with torch.cuda.device(beam_pk.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ohnsw_beam_step_classic(
            beam_pk.data_ptr(), beam_d.data_ptr(),
            None if cand_ids is None else cand_ids.data_ptr(),
            None if cand_d is None else cand_d.data_ptr(),
            table.data_ptr(),
            None if up_base is None else up_base.data_ptr(),
            None if levels is None else levels.data_ptr(),
            out_pk.data_ptr(), out_d.data_ptr(), out_cand.data_ptr(),
            live.data_ptr(), b, ef, c_in, expand, deg, c, level, sink,
            stream)
    _lib.check(status, "beam_step_classic")
    beam_step_classic.launches += 1
    return out_pk, out_d, out_cand


beam_step_classic.launches = 0  # kernel launches (not plain-version calls)
