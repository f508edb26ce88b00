"""What decides `correct`: the answers the timed path returned, and the
level-0 lists of the graph it built, against the plain reference.

Numbers compared (each against the cell's limit in `limits/<cell>.json`):

- `recall_at_10`: recall@k of every answer, against the reference's exact
  neighbours of its query (at least the configuration's recall target).
- `dist_gap`: the widest gap between a distance the port returned and the
  reference's direct-form distance from the same query to the same label,
  over the median distance of the reference's k-th neighbours.  A label
  the port altered, or a distance it computed in a lower precision,
  widens it.
- `adj0_invalid` (graphs): level-0 entries that are out of range, a node's
  own id, or repeated in its list, and nodes with an empty list: exactly 0.
- `nn1_missing` (graphs): the share of nodes, sampled from the seed, whose
  exact nearest other row is not in their level-0 list.

Imports nothing of the port: it reads the port's outputs as host arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from hnsw_bench import reference

#: answers judged per block
BLOCK = 1 << 17
#: nodes whose nearest neighbour `judge_graph` looks for
NN1_SAMPLE = 4096
#: added to the run's seed for the node sample's generator
SAMPLE_SEED_OFFSET = 2


def truth(ref: reference.Rows, pool: np.ndarray, k: int):
    """(query pool on the device, exact ids [P, k], their distances, the
    median k-th distance): what every answer is held to."""
    q = reference.queries(pool, ref)
    ids, d = reference.knn(ref, q, k)
    return q, ids, d, float(torch.median(d[:, k - 1].float()))


def judge_answers(ref: reference.Rows, q, true_ids, scale: float,
                  pool_idx: np.ndarray, labels: np.ndarray,
                  dists: np.ndarray) -> dict:
    """recall_at_10 and dist_gap of answers (labels [A, k], dists [A, k]) to
    the queries q[pool_idx]."""
    if labels.shape != dists.shape or labels.shape[0] != pool_idx.shape[0]:
        raise ValueError("answers: labels, dists and query ids disagree")
    dev = q.device
    hits, gap = 0, 0.0
    for lo in range(0, labels.shape[0], BLOCK):
        idx = torch.from_numpy(pool_idx[lo:lo + BLOCK]).to(dev)
        lab = torch.from_numpy(labels[lo:lo + BLOCK].astype(np.int64)).to(dev)
        got = torch.from_numpy(dists[lo:lo + BLOCK]).to(dev).float()
        hits += int(reference.recall(lab, true_ids[idx]).sum())
        bad = (lab < 0) | (lab >= ref.n)
        want = reference.direct(ref, q[idx], torch.where(bad, -1, lab)).float()
        g = torch.where(bad | ~torch.isfinite(got), float("inf"),
                        (got - want).abs())
        gap = max(gap, float(g.max()))
    n_ans = labels.shape[0] * labels.shape[1]
    return {"recall_at_10": hits / n_ans if n_ans else 0.0,
            "dist_gap": gap / scale}


def sample_nodes(n: int, seed: int) -> np.ndarray:
    gen = torch.Generator().manual_seed(seed + SAMPLE_SEED_OFFSET)
    return torch.randperm(n, generator=gen)[:min(NN1_SAMPLE, n)].numpy()


def nearest_other(ref: reference.Rows, nodes: np.ndarray) -> torch.Tensor:
    """Each node's exact nearest other row, i64[S]."""
    ids = torch.from_numpy(nodes.astype(np.int64)).to(ref.x.device)
    return reference.knn(ref, ref.x[ids], 1, exclude=ids)[0][:, 0]


def judge_graph(ref: reference.Rows, adj0: np.ndarray, nodes: np.ndarray,
                nearest: torch.Tensor) -> dict:
    """adj0_invalid and nn1_missing of the level-0 lists adj0 i32[n, deg]
    (-1 = empty slot; row i is node i)."""
    n = adj0.shape[0]
    if n != ref.n:
        raise ValueError(f"graph has {n} level-0 lists for {ref.n} rows")
    dev = ref.x.device
    invalid = 0
    for lo in range(0, n, BLOCK):
        a = torch.from_numpy(adj0[lo:lo + BLOCK].astype(np.int64)).to(dev)
        own = torch.arange(lo, lo + a.shape[0], device=dev)[:, None]
        s = torch.sort(a, dim=1).values
        rep = torch.zeros_like(s, dtype=torch.bool)
        rep[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
        invalid += int(((a < -1) | (a >= n) | (a == own)).sum())
        invalid += int(rep.sum()) + int((a < 0).all(dim=1).sum())
    lists = torch.from_numpy(adj0[nodes].astype(np.int64)).to(dev)
    found = (lists == nearest[:, None]).any(dim=1)
    return {"adj0_invalid": invalid,
            "nn1_missing": float((~found).float().mean())}


def checks(numbers: dict, limits: dict) -> list[dict]:
    """[{name, value, limit, op}] for each number that has a limit; a
    number without one, or a limit without its number, raises."""
    if set(numbers) != set(limits):
        raise ValueError(f"numbers {sorted(numbers)} and limits "
                         f"{sorted(limits)} differ")
    out = []
    for name, lim in limits.items():
        (op, bound), = lim.items()
        v = numbers[name]
        ok = v >= bound if op == "min" else v <= bound
        out.append({"name": name, "value": v, "limit": bound, "op": op,
                    "ok": bool(ok)})
    return out
