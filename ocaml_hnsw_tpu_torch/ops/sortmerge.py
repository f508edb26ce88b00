"""Bitonic sort / merge networks for the beam update, ported from
`ocaml_hnsw_tpu/ops/sortmerge.py` as the same networks, so that rows with
equal keys come out in the same order as in the JAX package.

A compare-exchange stage pairs position i with i ^ j.  Viewing a row as
[n/(2j), 2, j] puts each pair's lower and upper element at [:, 0, t] and
[:, 1, t], so a stage is one swap mask and a `where` per carried array, with
no gather.  The JAX stage keeps each element unless its partner is strictly
better in the wanted direction; for a pair whose lower element should hold the
min (`up`) that is a swap iff hi < lo, else iff hi > lo, so equal keys never
move — the same as here.

All widths must be powers of two; callers pad with ±inf sentinels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=256)
def _up_mask(n: int, j: int, k: int, ascending: bool, device: torch.device):
    """Per-pair direction of a sort stage, as bool[n/(2j), j] on `device`, or
    a Python bool when every pair of the stage goes the same way."""
    lower = np.arange(n).reshape(n // (2 * j), 2, j)[:, 0, :]
    up = (lower & k) == 0
    if not ascending:
        up = ~up
    if up.all():
        return True
    if not up.any():
        return False
    return torch.as_tensor(up, device=device)


def _stage(d, payloads, j: int, up):
    """One compare-exchange stage between positions i and i ^ j."""
    b, n = d.shape
    dv = d.reshape(b, n // (2 * j), 2, j)
    lo, hi = dv[:, :, 0, :], dv[:, :, 1, :]
    if up is True:
        swap = hi < lo
    elif up is False:
        swap = hi > lo
    else:
        swap = torch.where(up, hi < lo, hi > lo)
    swap = swap[:, :, None, :]

    def apply(x):
        xv = x.reshape(b, n // (2 * j), 2, j)
        return torch.where(swap, xv.flip(2), xv).reshape(b, n)

    return apply(d), [apply(p) for p in payloads]


def bitonic_sort(d, payloads=(), ascending: bool = True):
    """Full bitonic sort of f32[B, n] (n a power of two), payloads carried."""
    n = d.shape[-1]
    assert n & (n - 1) == 0, "width must be a power of two"
    payloads = list(payloads)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            d, payloads = _stage(d, payloads, j,
                                 _up_mask(n, j, k, ascending, d.device))
            j //= 2
        k *= 2
    return d, payloads


def bitonic_merge(d, payloads=()):
    """Ascending merge of a *bitonic* row (e.g. ascending half ++ descending
    half): f32[B, n] with n a power of two; log2(n) stages."""
    n = d.shape[-1]
    assert n & (n - 1) == 0, "width must be a power of two"
    payloads = list(payloads)
    j = n // 2
    while j >= 1:
        d, payloads = _stage(d, payloads, j, True)
        j //= 2
    return d, payloads


def _pad_cols(x, before: int, after: int, fill):
    if before == 0 and after == 0:
        return x
    return torch.nn.functional.pad(x, (before, after), value=fill)


def entries_to_beam(entry_ids, entry_d, ef: int):
    """Initial beam from entry candidates: sort ascending at the entries'
    own (power-of-two) width, then pad/truncate to ef.
    Returns (beam_ids i32[B, ef], beam_d f32[B, ef]) ascending."""
    e0 = entry_ids.shape[1]
    p2 = next_pow2(e0)
    entry_d = _pad_cols(entry_d, 0, p2 - e0, float("inf"))
    entry_ids = _pad_cols(entry_ids, 0, p2 - e0, -1)
    d_s, (ids_s,) = bitonic_sort(entry_d, [entry_ids], ascending=True)
    if p2 >= ef:
        return ids_s[:, :ef], d_s[:, :ef]
    pad = ef - p2
    return _pad_cols(ids_s, 0, pad, -1), _pad_cols(d_s, 0, pad, float("inf"))


def topk_ascending(d, payload_ids, k: int):
    """Smallest-k of f32[B, n] with an i32 payload, ascending — a bitonic
    full sort at next_pow2(n).  Returns (d f32[B, k], ids i32[B, k])."""
    n = d.shape[-1]
    p2 = next_pow2(n)
    d = _pad_cols(d, 0, p2 - n, float("inf"))
    payload_ids = _pad_cols(payload_ids, 0, p2 - n, -1)
    d_s, (ids_s,) = bitonic_sort(d, [payload_ids], ascending=True)
    return d_s[:, :k], ids_s[:, :k]


def merge_into_beam(beam_d, beam_payloads, cand_d, cand_payloads, ef: int):
    """Merge unsorted candidates into a sorted-ascending beam, keep best ef.

    beam: f32[B, ef] ascending (+inf padded).  cand: f32[B, C] unsorted.
    Payloads are (tensor, fill) pairs.  Returns (d, payloads) of width ef,
    ascending: sort the candidates descending at their own power-of-two
    width, pad to the common width (+inf at the FRONT keeps the run
    descending), then one bitonic merge of beam(asc) ++ cand(desc)."""
    c = cand_d.shape[-1]
    p2 = next_pow2(max(ef, c))
    p2c = next_pow2(c)
    fills = [f for _, f in cand_payloads]
    cand_d = _pad_cols(cand_d, 0, p2c - c, float("inf"))
    cps = [_pad_cols(p, 0, p2c - c, f) for (p, _), f in zip(cand_payloads, fills)]
    cd, cp = bitonic_sort(cand_d, cps, ascending=False)
    cd = _pad_cols(cd, p2 - p2c, 0, float("inf"))
    cp = [_pad_cols(p, p2 - p2c, 0, f) for p, f in zip(cp, fills)]
    beam_d = _pad_cols(beam_d, 0, p2 - ef, float("inf"))
    bps = [_pad_cols(p, 0, p2 - ef, f) for p, f in beam_payloads]
    m_d = torch.cat([beam_d, cd], dim=1)  # ascending ++ descending
    m_p = [torch.cat([a, b], dim=1) for a, b in zip(bps, cp)]
    m_d, m_p = bitonic_merge(m_d, m_p)
    return m_d[:, :ef], [p[:, :ef] for p in m_p]
