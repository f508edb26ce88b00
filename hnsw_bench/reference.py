"""The plain reference: exact k nearest neighbours in plain PyTorch float32,
from the host rows the port was given, and the control (the same
arithmetic in bfloat16).

It imports nothing of the port and takes nothing the port made: it
normalises the rows itself (cosine), scores every row of every slab, and
recomputes each distance it reports in the direct form.  Candidates come
from the product form (‖x‖² − 2·q·x, or −q·x) of a chunk of queries
against a slab of rows, as `ocaml_hnsw_tpu_torch/bench/harness.py::
device_ground_truth` computes them; the top `k + REFINE` candidates are
then re-scored in the direct form (Σ (q − x)², or 1 − Σ q·x) and the top k
kept, so that the product form's rounding cannot reorder close
neighbours.

Distances follow hnswlib: "l2" is the squared Euclidean distance, "cosine"
is 1 − cos on rows and queries scaled to unit length.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

METRICS = ("l2", "cosine")
#: candidates beyond k re-scored in the direct form
REFINE = 16
#: queries per chunk and rows per slab (a [chunk, slab] f32 score matrix
#: of 2 GiB)
CHUNK = 512
SLAB = 1 << 20
#: rows gathered per direct-form block
GATHER_ROWS = 1 << 21


def full_f32() -> None:
    """Products in float32 run as float32 (TF32 rounds them to 10 bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass
class Rows:
    """The reference's own copy of the rows on the device."""

    x: torch.Tensor  # [N, D] in `dtype`, unit rows for cosine
    sq: torch.Tensor  # [N] ‖x‖² in `dtype`
    metric: str

    @property
    def n(self) -> int:
        return self.x.shape[0]


def _unit(x: torch.Tensor) -> torch.Tensor:
    nrm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / torch.where(nrm == 0, 1.0, nrm)


def rows(host: np.ndarray, metric: str, device,
         dtype=torch.float32) -> Rows:
    """Upload the host rows (f32) in slabs and prepare them in `dtype`."""
    if metric not in METRICS:
        raise ValueError(f"reference metric must be one of {METRICS}")
    n, d = host.shape
    x = torch.empty((n, d), dtype=dtype, device=device)
    for lo in range(0, n, SLAB):
        part = torch.from_numpy(np.ascontiguousarray(
            host[lo:lo + SLAB], dtype=np.float32)).to(device)
        if metric == "cosine":
            part = _unit(part)
        x[lo:lo + part.shape[0]] = part.to(dtype)
    return Rows(x=x, sq=torch.sum(x * x, dim=1), metric=metric)


def queries(host: np.ndarray, ref: Rows) -> torch.Tensor:
    q = torch.from_numpy(np.ascontiguousarray(host, dtype=np.float32)).to(
        ref.x.device)
    if ref.metric == "cosine":
        q = _unit(q)
    return q.to(ref.x.dtype)


def direct(ref: Rows, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Distances of q[i] to rows ids[i, j] in the direct form, in the rows'
    dtype: Σ (q − x)² for l2, 1 − Σ q·x for cosine.  ids < 0 give +inf."""
    b, k = ids.shape
    out = torch.empty((b, k), dtype=ref.x.dtype, device=q.device)
    step = max(1, GATHER_ROWS // max(k, 1))
    for lo in range(0, b, step):
        idc = ids[lo:lo + step]
        x = ref.x[idc.clamp_min(0)]
        qc = q[lo:lo + step, None, :]
        if ref.metric == "l2":
            diff = qc - x
            d = torch.sum(diff * diff, dim=-1)
        else:
            d = 1.0 - torch.sum(qc * x, dim=-1)
        out[lo:lo + step] = torch.where(idc < 0, float("inf"), d)
    return out


def _product_scores(ref: Rows, q: torch.Tensor, lo: int, hi: int):
    dot = q @ ref.x[lo:hi].T
    if ref.metric == "l2":
        return ref.sq[lo:hi][None, :] - 2.0 * dot
    return -dot


def knn(ref: Rows, q: torch.Tensor, k: int, exclude=None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids i64[Q, k], distances [Q, k]) ascending: the k rows nearest each
    query, all rows scanned.  `exclude` i64[Q] drops one row per query (a
    node's own row).  Equal distances keep the lower id."""
    cand = k + REFINE + (1 if exclude is not None else 0)
    out_i, out_d = [], []
    for c0 in range(0, q.shape[0], CHUNK):
        qc = q[c0:c0 + CHUNK]
        ids, scores = [], []
        for lo in range(0, ref.n, SLAB):
            hi = min(ref.n, lo + SLAB)
            s = _product_scores(ref, qc, lo, hi)
            top = torch.topk(s, min(cand, hi - lo), dim=1, largest=False)
            ids.append(top.indices + lo)
            scores.append(top.values)
        ids, scores = torch.cat(ids, dim=1), torch.cat(scores, dim=1)
        pick = torch.topk(scores, min(cand, ids.shape[1]), dim=1,
                          largest=False).indices
        ids = torch.gather(ids, 1, pick)
        if exclude is not None:
            ids = torch.where(ids == exclude[c0:c0 + CHUNK, None], -1, ids)
        d = direct(ref, qc, ids)
        ids, order = torch.sort(ids, dim=1)  # ties keep the lower id
        d = torch.gather(d, 1, order)
        d, order = torch.sort(d, dim=1, stable=True)
        out_i.append(torch.gather(ids, 1, order[:, :k]))
        out_d.append(d[:, :k])
    return torch.cat(out_i), torch.cat(out_d)


def recall(found: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Hits per row: how many of true[i]'s ids found[i] holds (each found id
    counted once), as in `harness.py::recall_of` (ann-benchmarks)."""
    f = torch.sort(found, dim=1).values
    dup = torch.zeros_like(f, dtype=torch.bool)
    dup[:, 1:] = f[:, 1:] == f[:, :-1]
    f = torch.where(dup | (f < 0), -2, f)
    return (f[:, :, None] == true[:, None, :]).any(dim=2).sum(dim=1)
