"""Tracing, timing and search cost counters, the port of
`ocaml_hnsw_tpu/utils/profiling.py`:

- `trace(logdir)` / `annotate(name)`: a torch.profiler capture (a Chrome
  trace in `logdir`) around build and search sections, and named regions
  inside it;
- `sync(x)`: wait for the device that holds `x`.  CUDA calls return before
  the device finishes, so a host clock must synchronize before it is read;
- `Timer`: a wall-clock timer;
- `search_stats(...)`: per-batch counters of one classic search: beam loop
  iterations, node expansions, distance evaluations, gathered bytes, the
  numbers that explain a recall/QPS point.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block (host, and the
    device when there is one) into `logdir`/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace (context manager)."""
    return torch.profiler.record_function(name)


def sync(x) -> None:
    """Wait until the device that holds `x` (a tensor, or an index state with
    a `device`: GraphTensors, FlatTensors) has finished all queued work.
    Nothing to wait for on the CPU."""
    dev = torch.device(x.device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock timer (call `sync` on the result inside the block)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


def search_stats(graph, queries, k: int, ef: int, metric: str,
                 expand: int = 4) -> dict:
    """Run one batched classic search and return its cost counters.

    Counters are exact for the lockstep engine: every iteration gathers
    B·expand·deg rows and evaluates that many distances (static shapes)."""
    from ocaml_hnsw_tpu_torch.models.search import (
        beam_search_layer, descend, preprocess_queries,
    )
    from ocaml_hnsw_tpu_torch.ops.distance import query_norms

    q = torch.as_tensor(queries, dtype=torch.float32).to(graph.device)
    q = preprocess_queries(q, metric)
    qn = query_norms(q, metric)
    cur, cur_d = descend(graph, q, qn, metric, stop_level=0)
    _, d, iters = beam_search_layer(
        graph.vectors, graph.scales, graph.norms, graph.adj0, q, qn,
        cur[:, None], cur_d[:, None], max(ef, k), metric,
        expand=expand, visited_bits=0,
    )
    b = q.shape[0]
    deg = graph.adj0.shape[1]
    iters = int(iters)
    dists = b * iters * expand * deg
    row_bytes = graph.vectors.shape[1] * graph.vectors.element_size()
    return {
        "batch": b,
        "ef": max(ef, k),
        "expand": expand,
        "beam_iterations": iters,
        "expansions_per_query": iters * expand,
        "distance_evals": dists,
        "distance_evals_per_query": dists // b,
        "gathered_bytes": dists * row_bytes,
        "found_mean_dist": float(torch.mean(
            torch.where(torch.isinf(d), 0.0, d))),
    }
