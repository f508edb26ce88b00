"""Tombstones of the port's `Index` (`mark_deleted` / `unmark_deleted`), on the
CPU.

The calls record each change on the host; the changes reach
`graph.deleted` in one scatter when a call next reads or copies the graph
(`api.py`'s module docstring).  Held here:

  * every order of those calls among `add_items`, `knn_query`,
    `resize_index`, `save_index` + `load_index`, `load_index` over the
    index, `get_items` and the `graph` property gives the same answers,
    bit for bit, and the same `deleted` bits as writing each tombstone
    into the graph at its call;
  * the calls launch nothing, and the next read applies them all in one
    `hnsw.api.delete` span holding one `index_put_`;
  * unmarking a pending delete cancels it, the last call of a label wins,
    and an unknown label raises at the call;
  * the same calls on the JAX package's `Index`, loaded from the port's
    checkpoint, give the same answers: equal labels and distances to rtol
    1e-5, as `tests/test_torch_classic.py` holds the classic engine with
    greedy-descent entry (f32 summation order differs).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ocaml_hnsw_tpu.api import Index as JaxIndex
from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like

from ocaml_hnsw_tpu_torch import Index

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

N, DIM, EXTRA = 600, 16, 40
INIT = dict(max_elements=700, M=8, ef_construction=32, round_size=64)
LABELS = np.arange(N, dtype=np.int64) * 3 + 7
NEW_LABELS = np.arange(EXTRA, dtype=np.int64) + 10_000
KW = dict(k=10, ef=32)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(rows, queries, the checkpoint of a 600-row index under LABELS)."""
    data = clustered(N + EXTRA, DIM, n_clusters=8, seed=11)
    t = Index("l2", DIM, device="cpu")
    t.init_index(**INIT)
    t.add_items(data[:N], ids=LABELS)
    path = tmp_path_factory.mktemp("tombstones") / "index.npz"
    t.save_index(path)
    return data, queries_like(data[:N], 32, seed=12), path


def _load(path) -> Index:
    t = Index("l2", DIM, device="cpu")
    t.load_index(path)
    return t


class PerLabel:
    """The index driven as before this change: each tombstone written into
    the graph at its call."""

    def __init__(self, index):
        self.index = index

    def mark_deleted(self, label):
        self.index.graph.deleted[self.index._id_of(label)] = True

    def unmark_deleted(self, label):
        self.index.graph.deleted[self.index._id_of(label)] = False


def _victims(t, queries):
    """Labels that answer the queries first: tombstones that move answers."""
    return list(dict.fromkeys(t.knn_query(queries, **KW)[0][:, :2]
                              .reshape(-1).tolist()))


#: call orders: ("mark" | "unmark", which victims), or a call that reads
#: or copies the graph
ORDERS = {
    "query": [("mark", "a"), ("mark", "b"), ("query",), ("unmark", "a"),
              ("query",)],
    "add": [("mark", "a"), ("add",), ("mark", "new"), ("query",),
            ("unmark", "new"), ("query",)],
    "resize": [("mark", "a"), ("mark", "b"), ("resize",), ("unmark", "b"),
               ("query",)],
    "save_load": [("mark", "a"), ("unmark", "a"), ("mark", "b"),
                  ("save_load",), ("mark", "a"), ("query",)],
    "get_items": [("mark", "a"), ("get_items",), ("mark", "b"), ("query",)],
    "graph": [("mark", "a"), ("graph",), ("unmark", "a"), ("mark", "b"),
              ("query",)],
    "load": [("mark", "a"), ("load",), ("mark", "b"), ("query",)],
}


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_pending_changes_equal_per_label_writes(built, tmp_path, order):
    data, queries, path = built
    t, r = _load(path), _load(path)
    victims = _victims(t, queries)
    groups = {"a": victims[::2], "b": victims[1::2],
              "new": NEW_LABELS[:5].tolist()}
    writers = {id(t): t, id(r): PerLabel(r)}
    for step, op in enumerate(ORDERS[order]):
        outs = []
        for idx in (t, r):
            w = writers[id(idx)] if op[0] in ("mark", "unmark") else None
            if op[0] == "mark":
                for lab in groups[op[1]]:
                    w.mark_deleted(lab)
            elif op[0] == "unmark":
                for lab in groups[op[1]]:
                    w.unmark_deleted(lab)
            elif op[0] == "query":
                outs.append(idx.knn_query(queries, **KW))
            elif op[0] == "add":
                idx.add_items(data[N:], ids=NEW_LABELS)
            elif op[0] == "resize":
                idx.resize_index(800)
            elif op[0] == "get_items":
                outs.append((idx.get_items(victims),))
            elif op[0] == "graph":
                outs.append((idx.graph.deleted.numpy().copy(),))
            elif op[0] == "load":  # the checkpoint replaces the graph
                idx.load_index(path)
            elif op[0] == "save_load":
                file = tmp_path / f"{id(idx)}.npz"
                idx.save_index(file)
                with np.load(file) as z:
                    outs.append((z["deleted"],))
        if op[0] == "save_load":
            t, r = _load(tmp_path / f"{id(t)}.npz"), \
                _load(tmp_path / f"{id(r)}.npz")
            writers = {id(t): t, id(r): PerLabel(r)}
        if outs:
            for a, b in zip(*outs):
                np.testing.assert_array_equal(a, b, err_msg=f"{op} #{step}")
    assert torch.equal(t.graph.deleted, r.graph.deleted)
    assert t.graph.deleted.any()


def test_calls_launch_nothing_then_one_scatter(built):
    _, queries, path = built
    t = _load(path)
    victims = _victims(t, queries)
    before = t._state.graph.deleted.clone()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for lab in victims:
            t.mark_deleted(lab)
        t.unmark_deleted(victims[0])
    assert not [e.name for e in prof.events() if e.name.startswith("aten::")]
    assert torch.equal(t._state.graph.deleted, before)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        labels, _ = t.knn_query(queries, **KW)
    events = prof.events()
    spans = [e for e in events if e.name == "hnsw.api.delete"]
    assert len(spans) == 1
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    puts = [e for e in events if e.name == "aten::index_put_"
            and lo <= e.time_range.start and e.time_range.end <= hi]
    assert len(puts) == 1
    dead = set(victims[1:])
    assert not dead & set(labels.reshape(-1).tolist())
    ids = torch.tensor([t._id_of(lab) for lab in victims])
    assert t.graph.deleted[ids].tolist() == [False] + [True] * len(dead)
    assert int(t.graph.deleted.sum()) == len(dead)


def test_unmark_cancels_a_pending_delete_and_the_last_call_wins(built):
    _, queries, path = built
    t, fresh = _load(path), _load(path)
    victims = _victims(t, queries)
    for lab in victims:
        t.mark_deleted(lab)
        t.unmark_deleted(lab)
    for a, b in zip(t.knn_query(queries, **KW), fresh.knn_query(queries, **KW)):
        np.testing.assert_array_equal(a, b)
    assert not t.graph.deleted.any()
    x = victims[0]
    t.mark_deleted(x)
    t.unmark_deleted(x)
    t.mark_deleted(x)
    assert x not in t.knn_query(queries, **KW)[0].reshape(-1).tolist()
    assert int(t.graph.deleted.sum()) == 1


def test_unknown_label_raises_at_the_call(built):
    _, _, path = built
    t = _load(path)
    for call in (t.mark_deleted, t.unmark_deleted):
        with pytest.raises(KeyError, match="not in index"):
            call(10 ** 9)
    assert t._tombstones == {}
    empty = Index("l2", DIM, device="cpu")
    with pytest.raises(RuntimeError, match="init_index"):
        empty.mark_deleted(7)


def test_same_calls_answer_as_the_jax_index(built):
    """One graph (the port's checkpoint) in both packages, the same calls:
    equal labels, distances to rtol 1e-5, equal tombstone bits."""
    _, queries, path = built
    t = _load(path)
    j = JaxIndex("l2", DIM)
    j.load_index(path)
    victims = _victims(t, queries)

    def same():
        (tl, td), (jl, jd) = t.knn_query(queries, **KW), \
            j.knn_query(queries, **KW)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
        return tl

    for idx in (t, j):
        for lab in victims:
            idx.mark_deleted(lab)
    assert not set(victims) & set(same().reshape(-1).tolist())
    for idx in (t, j):
        for lab in victims[::3]:
            idx.unmark_deleted(lab)
        idx.mark_deleted(int(LABELS[0]))
    same()
    np.testing.assert_array_equal(
        t.graph.deleted.numpy(),
        np.asarray(j._require_init().graph.deleted))
