"""Closed-loop queries: one client sends `request` queries a call to the
index's `knn_query` (host array in, labels and distances out), the next
call as soon as the last returns, cycling through the query pool.

Set-up fills the index from the host rows through `add_items` (the bulk
build for an `Index`) and sends two requests, so that the packed payload
and the seed index exist and every shape has run.  Each answer is kept for
the check; latency is the `knn_query` call alone."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from hnsw_bench import api, stats

WARM_REQUESTS = 2


@dataclasses.dataclass
class State:
    index: object
    kwargs: dict
    size: int
    sent: int = 0
    latencies: list = dataclasses.field(default_factory=list)
    answers: api.Answers = dataclasses.field(default_factory=api.Answers)


def _request(run, st: State) -> np.ndarray:
    """Pool indices of the next request."""
    p = run.pool.shape[0]
    return (st.sent * st.size + np.arange(st.size)) % p


def setup(run) -> State:
    index = api.new_index(run, run.mix["index"])
    index.add_items(run.rows)
    st = State(index=index, kwargs=api.query_kwargs(run, run.mix["engine"]),
               size=run.mix["request"])
    for _ in range(WARM_REQUESTS):
        index.knn_query(run.pool[_request(run, st)], **st.kwargs)
    return st


def step(st: State, run) -> int:
    idx = _request(run, st)
    q = run.pool[idx]
    t = time.perf_counter()
    labels, dists = st.index.knn_query(q, **st.kwargs)
    st.latencies.append(time.perf_counter() - t)
    st.sent += 1
    st.answers.add(idx, labels, dists)
    return st.size


def window_metrics(st: State, run, seconds: float) -> dict:
    return {"qps": st.sent * st.size / seconds,
            "p95_ms": 1e3 * stats.percentile(st.latencies, 95)}


def products(st: State, run) -> dict:
    return {"answers": st.answers.arrays()}
