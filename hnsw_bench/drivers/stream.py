"""Closed-loop streaming ingest: an index built from a snapshot of the rows
keeps taking the rest of them while it serves.  One client; each step is an
`Index.add_items` of the next `round_size` stream rows from the host array
(labels = their row indices), then one `knn_query` of `request` pool
queries, cycling the pool, on the classic engine at the configuration's
operating point.  A step returns the rows it inserted; once the stream is
spent, a step sends only its query batch and returns 0.

Set-up does what an hnswlib user who grows an index does: `init_index(
max_elements=warm)`, `add_items` of the snapshot (the bulk build),
`resize_index(n)`; then one step, so that every shape has run.  The
snapshot is the first `n - stream.rows` rows.

`qps` counts the queries of the steps that inserted rows, over the time
from the window's start to the end of the last such step: the sustained
QPS during ingest.  The products: the rest of the stream inserted after
the window in the same calls, then the whole pool answered by the final
index at the operating point, and its level-0 lists.  The window's own
answers come from a partial index and are not judged."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from hnsw_bench import api


@dataclasses.dataclass
class State:
    index: object
    kwargs: dict
    size: int
    cursor: int  # the next stream row
    sent: int = 0  # query batches sent
    ingest_queries: int = 0  # queries of the window's inserting steps
    t_start: float | None = None
    t_last: float | None = None


def snapshot_rows(cfg: dict) -> int:
    """Rows built in bulk before the stream starts: all but the stream's
    `stream.rows`, and at least half of `n` (a configuration cut below
    twice its stream streams its second half)."""
    n = cfg["n"]
    return max(n - cfg["stream"]["rows"], n // 2)


def query_kwargs(run) -> dict:
    op = run.cfg["engines"]["classic"]
    return dict(k=run.k, engine="classic", ef=op["ef"],
                max_iters=op["max_iters"])


def _ingest(st: State, run) -> int:
    """Add the next `round_size` stream rows; the rows added."""
    lo = st.cursor
    hi = min(lo + run.cfg["round_size"], run.rows.shape[0])
    if hi <= lo:
        return 0
    st.index.add_items(run.rows[lo:hi], ids=np.arange(lo, hi))
    st.cursor = hi
    return hi - lo


def setup(run) -> State:
    from ocaml_hnsw_tpu_torch import Index

    cfg = run.cfg
    warm = snapshot_rows(cfg)
    index = Index(cfg["metric"], cfg["dim"], device=run.device)
    index.init_index(max_elements=warm, M=cfg["M"],
                     ef_construction=cfg["ef_construction"],
                     random_seed=cfg["random_seed"],
                     round_size=cfg["round_size"], storage=cfg["storage"])
    index.add_items(run.rows[:warm])
    index.resize_index(run.rows.shape[0])
    st = State(index=index, kwargs=query_kwargs(run),
               size=run.mix["request"], cursor=warm)
    step(st, run)
    st.ingest_queries, st.t_start, st.t_last = 0, None, None
    return st


def step(st: State, run) -> int:
    t = time.perf_counter()
    if st.t_start is None:
        st.t_start = t
    rows = _ingest(st, run)
    p = run.pool.shape[0]
    idx = (st.sent * st.size + np.arange(st.size)) % p
    st.index.knn_query(run.pool[idx], **st.kwargs)
    st.sent += 1
    if rows:
        st.ingest_queries += st.size
        st.t_last = time.perf_counter()
    return rows


def window_metrics(st: State, run, seconds: float) -> dict:
    if not st.ingest_queries:
        return {}
    return {"qps": st.ingest_queries / (st.t_last - st.t_start)}


def products(st: State, run) -> dict:
    while _ingest(st, run):
        pass
    p = run.pool.shape[0]
    answers = api.Answers()
    for lo in range(0, p, st.size):
        idx = np.arange(lo, min(lo + st.size, p))
        answers.add(idx, *st.index.knn_query(run.pool[idx], **st.kwargs))
    adj0 = st.index.graph.adj0[:run.rows.shape[0]].cpu().numpy()
    st.index = None
    return {"answers": answers.arrays(), "adj0": adj0}
