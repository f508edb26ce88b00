"""Closed-loop updates: an index that serves while its items are re-embedded.
The port refuses a label it already holds, so an update is what an hnswlib
user then writes: `add_items` of the new version under the item's label,
then `mark_deleted` of the old version's label.  One client; each step
adds the next `round_size` new versions from the host array (labels =
their row indices), tombstones their old versions one label a call, then
sends one `knn_query` of `request` pool queries, cycling the pool, on the
classic engine at the configuration's operating point.  A step returns the
items it updated; once the stream is spent, a step sends only its query
batch and returns 0.

The items updated are the last `stream.rows` rows of the run (`S`; the
second half of a configuration cut below 2·S).  The old version of row r
is r + `stream.jitter` · N(0, 1), drawn on the device from a generator
seeded by the run's seed + OLD_SEED_OFFSET, and carries label n + (r −
first), where `first` = n − S.  Set-up: `init_index(max_elements=n)`, one
`add_items` of the snapshot (rows [0, first) and the S old versions: the
bulk build), `resize_index(n + S)`, then one step, so that every shape has
run.

`qps` counts the queries of the steps that updated items, over the time
from the window's start to the end of the last such step.  The products:
the rest of the stream updated after the window in the same calls, so
that the live set is exactly the run's rows with S tombstones in the
graph; the whole pool answered at the operating point; and the level-0
lists of the n live rows in the items' labels (`live_lists`: an edge to an
old version is an edge to its item, which the search reaches through it).
The window's own answers come from a partial index and are not judged."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from hnsw_bench import api
from hnsw_bench.drivers.stream import query_kwargs, snapshot_rows

#: added to the run's seed for the old versions' generator (the query
#: pool takes 1, the judge's node sample 2)
OLD_SEED_OFFSET = 3
#: live rows whose level-0 lists are mapped at once
LIST_BLOCK = 1 << 17


@dataclasses.dataclass
class State:
    index: object
    kwargs: dict
    size: int
    first: int  # the first row updated; row r's old version is n + r - first
    cursor: int  # the next row to update
    sent: int = 0  # query batches sent
    update_queries: int = 0  # queries of the window's updating steps
    t_start: float | None = None
    t_last: float | None = None


def old_versions(run, first: int) -> np.ndarray:
    """The old versions of rows [first, n) on the host: each row plus
    `stream.jitter` · N(0, 1), drawn on the run's device."""
    dev = run.device
    gen = torch.Generator(device=dev).manual_seed(run.seed + OLD_SEED_OFFSET)
    new = torch.from_numpy(run.rows[first:]).to(dev)
    old = new + run.cfg["stream"]["jitter"] * torch.randn(
        new.shape, generator=gen, device=dev)
    return old.cpu().numpy()


def _update(st: State, run) -> int:
    """Add the next `round_size` new versions and tombstone their old ones;
    the items updated."""
    n = run.rows.shape[0]
    lo = st.cursor
    hi = min(lo + run.cfg["round_size"], n)
    if hi <= lo:
        return 0
    st.index.add_items(run.rows[lo:hi], ids=np.arange(lo, hi))
    for label in range(n + lo - st.first, n + hi - st.first):
        st.index.mark_deleted(label)
    st.cursor = hi
    return hi - lo


def setup(run) -> State:
    from ocaml_hnsw_tpu_torch import Index

    cfg = run.cfg
    n = run.rows.shape[0]
    first = snapshot_rows(cfg)
    s = n - first
    index = Index(cfg["metric"], cfg["dim"], device=run.device)
    index.init_index(max_elements=n, M=cfg["M"],
                     ef_construction=cfg["ef_construction"],
                     random_seed=cfg["random_seed"],
                     round_size=cfg["round_size"], storage=cfg["storage"])
    index.add_items(np.concatenate([run.rows[:first], old_versions(run, first)]),
                    ids=np.concatenate([np.arange(first), n + np.arange(s)]))
    index.resize_index(n + s)
    st = State(index=index, kwargs=query_kwargs(run),
               size=run.mix["request"], first=first, cursor=first)
    step(st, run)
    st.update_queries, st.t_start, st.t_last = 0, None, None
    return st


def step(st: State, run) -> int:
    t = time.perf_counter()
    if st.t_start is None:
        st.t_start = t
    items = _update(st, run)
    p = run.pool.shape[0]
    idx = (st.sent * st.size + np.arange(st.size)) % p
    st.index.knn_query(run.pool[idx], **st.kwargs)
    st.sent += 1
    if items:
        st.update_queries += st.size
        st.t_last = time.perf_counter()
    return items


def window_metrics(st: State, run, seconds: float) -> dict:
    if not st.update_queries:
        return {}
    return {"qps": st.update_queries / (st.t_last - st.t_start)}


def live_lists(index, n: int, first: int) -> np.ndarray:
    """Level-0 lists of labels 0..n-1 (every live row), i32[n, deg]: row i
    is label i's list, each entry the label of the item it points at.  An
    entry at a tombstoned row, the old version n + r - first of row r,
    points at item r; it is written -1 where item r is the row itself or
    one of the row's live entries already points at r, and wherever the
    slot is empty."""
    graph = index.graph
    dev = graph.adj0.device
    labels = torch.as_tensor(index.get_ids_list(), dtype=torch.int64,
                             device=dev)  # internal id -> label
    live = labels < n
    if int(live.sum()) != n or not torch.equal(
            graph.deleted[:labels.shape[0]], ~live):
        raise RuntimeError("the live rows are not labels 0..n-1 with every "
                           "other row tombstoned")
    item = torch.where(live, labels, labels - n + first)
    id_of = torch.empty(n, dtype=torch.int64, device=dev)
    id_of[labels[live]] = torch.nonzero(live).squeeze(1)
    out = torch.empty((n, graph.adj0.shape[1]), dtype=torch.int32)
    for lo in range(0, n, LIST_BLOCK):
        adj = graph.adj0[id_of[lo:lo + LIST_BLOCK]].long()
        at = adj.clamp_min(0)
        ent = torch.where(adj < 0, -1, item[at])
        old = (adj >= 0) & graph.deleted[at]
        held = torch.where(old, -1, ent)  # what the live entries point at
        own = torch.arange(lo, lo + adj.shape[0], device=dev)[:, None]
        again = (ent[:, :, None] == held[:, None, :]).any(dim=2)
        out[lo:lo + adj.shape[0]] = torch.where(
            old & ((ent == own) | again), -1, ent).int().cpu()
    return out.numpy()


def products(st: State, run) -> dict:
    while _update(st, run):
        pass
    p = run.pool.shape[0]
    answers = api.Answers()
    for lo in range(0, p, st.size):
        idx = np.arange(lo, min(lo + st.size, p))
        answers.add(idx, *st.index.knn_query(run.pool[idx], **st.kwargs))
    adj0 = live_lists(st.index, run.rows.shape[0], st.first)
    st.index = None
    return {"answers": answers.arrays(), "adj0": adj0}
