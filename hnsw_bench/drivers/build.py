"""Closed-loop whole builds: a fresh `Index` (`init_index`) filled with all
the configuration's rows from the host array (`add_items`, which takes the
bulk build on an empty index), again as soon as the last has ended.

Set-up runs one whole build, so every kernel is built and every shape has
run.  A step ends in a device synchronise, so it holds the whole build.
The products are the last graph's level-0 lists and its answers to the
query pool at the configuration's packed operating point, asked once the
window has closed."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hnsw_bench import api

#: queries per `knn_query` call when the last graph answers the pool
ANSWER_BATCH = 8192


@dataclasses.dataclass
class State:
    index: object = None
    builds: int = 0


def _build(run):
    index = api.new_index(run, "Index")
    index.add_items(run.rows)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    return index


def setup(run) -> State:
    _build(run)
    return State()


def step(st: State, run) -> int:
    st.index = None  # the last graph is freed before the next is built
    st.index = _build(run)
    st.builds += 1
    return run.rows.shape[0]


def window_metrics(st: State, run, seconds: float) -> dict:
    return {"add_vps": st.builds * run.rows.shape[0] / seconds}


def products(st: State, run) -> dict:
    index = st.index
    n = run.rows.shape[0]
    kwargs = api.query_kwargs(run, run.mix["engine"])
    answers = api.Answers()
    for lo in range(0, run.pool.shape[0], ANSWER_BATCH):
        idx = np.arange(lo, min(lo + ANSWER_BATCH, run.pool.shape[0]))
        answers.add(idx, *index.knn_query(run.pool[idx], **kwargs))
    adj0 = index.graph.adj0[:n].cpu().numpy()
    st.index = None
    return {"answers": answers.arrays(), "adj0": adj0}
