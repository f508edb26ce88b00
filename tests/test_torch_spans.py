"""The port's `hnsw.*` spans (`utils/profiling.py::annotate`), on the CPU.

With no profiler recording, `annotate` hands back one shared null context
and the query and build paths never enter `record_function`; the bulk
build synchronises only for its logger's stage lines.  Under
torch.profiler, an `Index` taking the 1M path at a small size (bulk
build, seed scan, packed engine with two interleaved halves) and a
`FlatIndex` leave every span of PERF.md's list in the trace, each inside
the span the list names and as many times as the call makes it; and the
answers are those of the same calls without the profiler.
"""

import json
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ocaml_hnsw_tpu_torch import FlatIndex, Index
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import bulk
from ocaml_hnsw_tpu_torch.models.build import BuildState
from ocaml_hnsw_tpu_torch.utils import profiling

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers.
torch.set_num_threads(1)

N, DIM, Q = 1500, 16, 64
MAX_ITERS = 5
QUERY = dict(k=10, engine="packed", ef=32, max_iters=MAX_ITERS, rerank_k=16,
             expand=2, interleave=2)

#: span -> (the spans it may lie directly inside, None for no hnsw span;
#: how many the build and one query make: an int, or "levels" for one per
#: upper level of the graph that holds two or more nodes)
INDEX_SPANS = {
    "hnsw.api.prepare": ((None,), 2),
    "hnsw.api.labels": ((None,), 3),
    "hnsw.api.add": ((None,), 1),
    "hnsw.bulk.prepare": (("hnsw.api.add",), 1),
    "hnsw.bulk.layer0_knn": (("hnsw.api.add",), 1),
    "hnsw.bulk.layer0_select": (("hnsw.api.add",), 1),
    "hnsw.bulk.layer0_reverse": (("hnsw.api.add",), 1),
    "hnsw.bulk.layer0_merge": (("hnsw.api.add",), 1),
    "hnsw.bulk.upper": (("hnsw.api.add",), "levels"),
    "hnsw.flat.scan": (("hnsw.bulk.layer0_knn", "hnsw.bulk.upper"), None),
    "hnsw.flat.rerank": (("hnsw.bulk.layer0_knn", "hnsw.bulk.upper"), None),
    "hnsw.sync.adopt_n": (("hnsw.api.add",), 1),
    "hnsw.sync.adopt_levels": (("hnsw.api.add",), 1),
    "hnsw.sync.adopt_up_n": (("hnsw.api.add",), 1),
    "hnsw.api.seed_index": ((None,), 1),
    "hnsw.sync.seed_levels": (("hnsw.api.seed_index",), 1),
    "hnsw.api.pack": ((None,), 1),
    "hnsw.packed.seed": ((None,), 1),
    "hnsw.packed.beam": ((None,), 1),
    "hnsw.packed.beam_iter": (("hnsw.packed.beam",), 2 * MAX_ITERS),
    "hnsw.packed.rerank": ((None,), 1),
    "hnsw.api.fetch": ((None,), 1),
}
FLAT_SPANS = {
    "hnsw.sync.flat_n": ((None,), 2),
    "hnsw.api.prepare": ((None,), 2),
    "hnsw.api.labels": ((None,), 3),
    "hnsw.api.add": ((None,), 1),
    "hnsw.flat.scan": ((None,), 1),
    "hnsw.flat.rerank": ((None,), 1),
    "hnsw.api.fetch": ((None,), 1),
}
#: the query's spans in the order it opens them
#: (the first after an add, so it seeds and packs)
QUERY_ORDER = ("hnsw.api.prepare", "hnsw.api.seed_index", "hnsw.api.pack",
               "hnsw.packed.seed", "hnsw.packed.beam", "hnsw.packed.rerank",
               "hnsw.api.fetch", "hnsw.api.labels")


def _data():
    rng = np.random.default_rng(7)
    centres = rng.normal(size=(12, DIM))
    rows = centres[rng.integers(0, 12, N)] + 0.2 * rng.normal(size=(N, DIM))
    queries = rows[rng.integers(0, N, Q)] + 0.05 * rng.normal(size=(Q, DIM))
    return rows.astype(np.float32), queries.astype(np.float32)


def _index(rows):
    index = Index("l2", DIM, device="cpu")
    index.init_index(max_elements=N, M=8, ef_construction=40)
    index.add_items(rows)
    return index


def _flat(rows):
    index = FlatIndex("l2", DIM, device="cpu")
    index.init_index(max_elements=N, rerank_k=16)
    index.add_items(rows)
    return index


def _spans(prof, tmp_path) -> list[tuple[str, float, float]]:
    """(name, start, end) of every hnsw.* span in the profile, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("hnsw.")),
                  key=lambda s: s[1])


def _parent(span, spans):
    """Name of the innermost other hnsw span holding `span`, or None."""
    holders = [s for s in spans if s is not span and s[1] <= span[1]
               and span[2] <= s[2]]
    return max(holders, key=lambda s: s[1])[0] if holders else None


@pytest.fixture(scope="module")
def low_thresholds():
    mp = pytest.MonkeyPatch()
    mp.setattr(BuildState, "BULK_THRESHOLD", 1000)
    mp.setattr(Index, "SEED_THRESHOLD", 1000)
    mp.setattr(Index, "PACKED_THRESHOLD", 1000)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def traced(low_thresholds, tmp_path_factory):
    """Each kind built and queried once without a profiler and once under
    it: kind -> (answers off, answers on, spans, the traced index)."""
    rows, queries = _data()
    out = {}
    for kind, make, kw in (("index", _index, QUERY),
                           ("flat", _flat, dict(k=10))):
        plain = make(rows)
        off = plain.knn_query(queries, **kw)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            index = make(rows)
            on = index.knn_query(queries, **kw)
        spans = _spans(prof, tmp_path_factory.mktemp(kind))
        if kind == "index":
            assert torch.equal(plain.graph.adj0, index.graph.adj0)
        out[kind] = (off, on, spans, index)
    return out


def test_annotate_off_is_one_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.annotate("hnsw.a"), profiling.annotate("hnsw.b")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="hnsw.c"):
            profiling.annotate("hnsw.c")


@pytest.mark.parametrize("make, kw", [(_index, QUERY), (_flat, dict(k=10))],
                         ids=["index", "flat"])
def test_paths_enter_no_span_without_a_profiler(low_thresholds, monkeypatch,
                                                make, kw):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rows, queries = _data()
    labels, _ = make(rows).knn_query(queries, **kw)
    assert labels.shape == (Q, 10) and (labels >= 0).all()


@pytest.mark.parametrize("level, syncs", [(logging.WARNING, 0),
                                          (logging.INFO, 6)])
def test_bulk_build_syncs_only_for_its_logger(monkeypatch, level, syncs):
    """Off, no stage synchronises; at INFO, each stage line and the total
    do (4 layer-0 stages, one per upper level, the total)."""
    calls = []
    monkeypatch.setattr(bulk, "_sync", calls.append)
    rows, _ = _data()
    cfg = HnswConfig(dim=DIM, metric="l2", M=8, ef_construction=40)
    levels = np.zeros(N, np.int64)
    levels[::50] = 1  # one upper level
    old = bulk.log.level
    bulk.log.setLevel(level)
    try:
        bulk.bulk_build(rows, cfg, levels=levels, device="cpu")
    finally:
        bulk.log.setLevel(old)
    assert len(calls) == syncs


@pytest.mark.parametrize("kind", ["index", "flat"])
def test_answers_equal_with_and_without_the_profiler(traced, kind):
    (l_off, d_off), (l_on, d_on), _, _ = traced[kind]
    np.testing.assert_array_equal(l_off, l_on)
    np.testing.assert_array_equal(d_off, d_on)


@pytest.mark.parametrize("kind, name", [("index", n) for n in INDEX_SPANS]
                         + [("flat", n) for n in FLAT_SPANS])
def test_span_lies_where_the_list_says(traced, kind, name):
    _, _, spans, index = traced[kind]
    parents, count = (INDEX_SPANS if kind == "index" else FLAT_SPANS)[name]
    mine = [s for s in spans if s[0] == name]
    assert mine, f"no {name} span"
    if count == "levels":
        levels = index.graph.levels
        count = sum(int((levels >= lvl).sum()) > 1
                    for lvl in range(1, int(index.graph.max_level) + 1))
    if count is not None:
        assert len(mine) == count
    for s in mine:
        assert _parent(s, spans) in parents, (s, _parent(s, spans))


def test_every_span_is_listed(traced):
    for kind, listed in (("index", INDEX_SPANS), ("flat", FLAT_SPANS)):
        assert {s[0] for s in traced[kind][2]} == set(listed)


def test_query_spans_follow_the_call(traced):
    spans = traced["index"][2]
    query_start = [s for s in spans if s[0] == "hnsw.api.prepare"][-1][1]
    order = [s[0] for s in spans if s[1] >= query_start
             and _parent(s, spans) is None]
    assert tuple(order) == QUERY_ORDER


def test_exit_check_spans_the_early_exit_reads(low_thresholds, tmp_path):
    """interleave=1: one read of "any unexpanded?" before each iteration,
    inside the beam span; the last may end the loop."""
    rows, queries = _data()
    index = _index(rows)
    index.knn_query(queries, **QUERY)  # packs and seeds off the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index.knn_query(queries, **dict(QUERY, interleave=1, max_iters=500))
    spans = _spans(prof, tmp_path)
    checks = [s for s in spans if s[0] == "hnsw.sync.exit_check"]
    iters = [s for s in spans if s[0] == "hnsw.packed.beam_iter"]
    assert 0 < len(iters) < 500 and len(checks) == len(iters) + 1
    assert all(_parent(s, spans) == "hnsw.packed.beam" for s in checks)
