"""A stream through the public `Index` at 768-d cosine on the CPU, as the
benchmark's `laion1m` deployment runs at 1M rows: a snapshot built in bulk
at its own size, grown by `resize_index`, then 256-row adds (one insert
round each) interleaved with 64-query classic calls.

The final index's answers are held to a plain float32 exact kNN that
imports nothing of the port.  The stream runs twice from one snapshot:
once with `record_function` refused (no span is entered without a
profiler), once under torch.profiler, where each insert round, each of its
stages and each query call leaves its span; both give the same answers
and the same graph.
"""

import copy
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ocaml_hnsw_tpu_torch import Index
from ocaml_hnsw_tpu_torch.models.build import BuildState

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers.
torch.set_num_threads(1)

SNAPSHOT, N, DIM = 3000, 4096, 768
ROUND, BATCH = 256, 64
FINAL_QUERIES = 128
# small M and ef_construction: the CPU's plain kernels gather 3 KB rows
M, EFC = 8, 32
QUERY = dict(k=10, engine="classic", ef=64, max_iters=24)
RECALL_MIN = 0.95
#: |port's distance − the direct form's| on unit rows: f32 sums of 768
#: products err by ~1e-6; rows rounded to bf16 move a distance by ~1e-3
DIST_TOL = 2e-5
#: the rounds of the stream: 256-row adds, then the 72 rows left
ADDS = [(lo, min(lo + ROUND, N)) for lo in range(SNAPSHOT, N, ROUND)]

#: span -> the spans it may lie directly inside (None: no hnsw span)
STAGES = {
    "hnsw.build.place": ("hnsw.build.round",),
    "hnsw.build.entry": ("hnsw.build.round",),
    "hnsw.build.beam": ("hnsw.build.round",),
    "hnsw.build.select": ("hnsw.build.round",),
    "hnsw.build.edges": ("hnsw.build.round",),
    "hnsw.build.upper": ("hnsw.build.round",),
    "hnsw.build.round": ("hnsw.api.add",),
    "hnsw.classic.seed": (None,),
    "hnsw.classic.beam": (None,),
    "hnsw.classic.final": (None,),
    "hnsw.api.resize": (None,),
    "hnsw.sync.converge": ("hnsw.build.upper", "hnsw.build.beam",
                           "hnsw.classic.beam"),
    "hnsw.sync.greedy": ("hnsw.build.entry", "hnsw.classic.seed"),
}


def _data():
    rng = np.random.default_rng(11)
    centres = rng.normal(size=(16, DIM))
    rows = centres[rng.integers(0, 16, N)] + 0.15 * rng.normal(size=(N, DIM))
    queries = rows[rng.integers(0, N, FINAL_QUERIES)] \
        + 0.1 * rng.normal(size=(FINAL_QUERIES, DIM))
    return rows.astype(np.float32), queries.astype(np.float32)


def _stream(index, rows, queries):
    """resize, the adds each followed by one query call, then the final
    index's answers to every query: (answers of each call, final labels,
    final distances, adj0)."""
    index.resize_index(N)
    calls = []
    for i, (lo, hi) in enumerate(ADDS):
        index.add_items(rows[lo:hi], ids=np.arange(lo, hi))
        q = queries[(i * BATCH + np.arange(BATCH)) % FINAL_QUERIES]
        calls.append(index.knn_query(q, **QUERY))
    final = [index.knn_query(queries[lo:lo + BATCH], **QUERY)
             for lo in range(0, FINAL_QUERIES, BATCH)]
    labels = np.concatenate([f[0] for f in final])
    dists = np.concatenate([f[1] for f in final])
    return calls, labels, dists, index.graph.adj0.clone()


def _spans(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("hnsw.")),
                  key=lambda s: s[1])


def _parent(span, spans):
    holders = [s for s in spans if s is not span and s[1] <= span[1]
               and span[2] <= s[2]]
    return max(holders, key=lambda s: s[1])[0] if holders else None


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The stream off the profiler (no span entered) and under it, from one
    bulk-built snapshot: {"off": result, "on": result, "spans": [...],
    "rows", "queries", "index": the traced index}."""
    mp = pytest.MonkeyPatch()
    mp.setattr(BuildState, "BULK_THRESHOLD", 1000)
    mp.setattr(Index, "SEED_THRESHOLD", 1000)
    try:
        rows, queries = _data()
        snap = Index("cosine", DIM, device="cpu")
        snap.init_index(max_elements=SNAPSHOT, M=M, ef_construction=EFC,
                        round_size=ROUND)
        snap.add_items(rows[:SNAPSHOT])
        off_index, on_index = copy.deepcopy(snap), copy.deepcopy(snap)

        def refuse(name):
            raise AssertionError(f"record_function({name!r}) entered")

        with mp.context() as m:
            m.setattr(torch.profiler, "record_function", refuse)
            off = _stream(off_index, rows, queries)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = _stream(on_index, rows, queries)
        spans = _spans(prof, tmp_path_factory.mktemp("stream"))
    finally:
        mp.undo()
    return {"off": off, "on": on, "spans": spans, "rows": rows,
            "queries": queries, "index": on_index}


def _exact(rows, queries, k, dtype=torch.float32):
    """Plain exact kNN under 1 − cos on unit rows, in `dtype` (TF32 off):
    (ids [Q, k], distances [Q, k])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(rows).to(dtype)
    q = torch.from_numpy(queries).to(dtype)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    d = 1.0 - q @ x.T
    top = torch.topk(d.float(), k, dim=1, largest=False)
    return top.indices.numpy(), top.values.numpy()


def _direct(rows, queries, labels):
    """1 − Σ q·x in f32 from unit rows, for each (query, label)."""
    x = torch.from_numpy(rows)
    q = torch.from_numpy(queries)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    lab = torch.from_numpy(labels.astype(np.int64))
    return (1.0 - torch.sum(q[:, None, :] * x[lab], dim=2)).numpy()


def test_final_index_holds_every_row(streams):
    index = streams["index"]
    assert index.get_current_count() == N
    assert index.get_ids_list() == list(range(N))
    adj0 = streams["on"][3][:N]
    assert ((adj0 >= 0).sum(dim=1) > 0).all()


def test_final_answers_hold_to_the_exact_knn(streams):
    _, labels, dists, _ = streams["on"]
    rows, queries = streams["rows"], streams["queries"]
    true_ids, _ = _exact(rows, queries, QUERY["k"])
    hits = sum(len(set(a) & set(b)) for a, b in zip(labels, true_ids))
    assert hits / labels.size >= RECALL_MIN
    assert (labels >= 0).all()
    gap = np.abs(dists - _direct(rows, queries, labels)).max()
    assert gap <= DIST_TOL


def test_bf16_distances_fail_the_tolerance(streams):
    """The tolerance is tight: the exact neighbours' distances computed
    from bf16 rows and queries miss it."""
    rows, queries = streams["rows"], streams["queries"]
    ids, d16 = _exact(rows, queries, QUERY["k"], dtype=torch.bfloat16)
    assert np.abs(d16 - _direct(rows, queries, ids)).max() > DIST_TOL


def test_answers_and_graph_equal_with_and_without_the_profiler(streams):
    (calls_off, l_off, d_off, a_off) = streams["off"]
    (calls_on, l_on, d_on, a_on) = streams["on"]
    for (lo, do), (ln, dn) in zip(calls_off + [(l_off, d_off)],
                                  calls_on + [(l_on, d_on)]):
        np.testing.assert_array_equal(lo, ln)
        np.testing.assert_array_equal(do, dn)
    assert torch.equal(a_off, a_on)


def test_one_round_span_per_round_and_one_beam_per_query_call(streams):
    spans = streams["spans"]
    count = lambda name: sum(1 for s in spans if s[0] == name)
    n_calls = len(ADDS) + FINAL_QUERIES // BATCH
    assert count("hnsw.build.round") == len(ADDS)
    assert count("hnsw.classic.beam") == n_calls
    assert count("hnsw.api.resize") == 1
    for stage in ("place", "entry", "beam", "select", "edges"):
        assert count(f"hnsw.build.{stage}") == len(ADDS)
    for stage in ("seed", "final"):
        assert count(f"hnsw.classic.{stage}") == n_calls


@pytest.mark.parametrize("name", sorted(STAGES))
def test_span_lies_where_the_list_says(streams, name):
    spans = streams["spans"]
    mine = [s for s in spans if s[0] == name]
    assert mine, f"no {name} span"
    for s in mine:
        assert _parent(s, spans) in STAGES[name], (s, _parent(s, spans))
