"""`utils/profiling.py` and `models/graph.py::from_oracle` of the torch port
against the JAX package's, on the CPU.

A 300-point NumPy oracle index (the JAX package's `OracleHNSW`, which the
port takes as given) becomes tensors in both packages: equal tensor for
tensor, for f32 and int8 storage.  `search_stats` on that graph gives the JAX
package's counters exactly (the lockstep beam visits the same nodes) and its
mean found distance to 1e-5.  One (k, ef) pair keeps the JAX side to one
compiled search.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.config import HnswConfig as JaxConfig
from ocaml_hnsw_tpu.models.graph import from_oracle as jax_from_oracle
from ocaml_hnsw_tpu.oracle import OracleHNSW
from ocaml_hnsw_tpu.utils import profiling as jprof

from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, from_oracle, graph_to_numpy,
)
from ocaml_hnsw_tpu_torch.utils import profiling as tprof

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

N, DIM = 300, 16


@pytest.fixture(scope="module")
def oracle():
    data = clustered(N, DIM, n_clusters=8, seed=0)
    o = OracleHNSW(JaxConfig(dim=DIM, M=8, ef_construction=50))
    o.add_items(data)
    o.mark_deleted(3)
    return data, o


def _with_storage(o, storage):
    """The same oracle under another storage dtype: any object with the
    oracle's fields will do."""
    fields = ("element_count", "vectors", "levels", "adj", "deleted",
              "entry", "max_level")
    return types.SimpleNamespace(
        config=dataclasses.replace(o.config, storage=storage),
        **{f: getattr(o, f) for f in fields})


@pytest.mark.parametrize("storage,max_elements", [
    ("f32", None), ("int8", 500), ("bf16", None)])
def test_from_oracle_equals_jax(oracle, storage, max_elements):
    o = _with_storage(oracle[1], storage)
    t = from_oracle(o, max_elements, device="cpu")
    j = jax_from_oracle(o, max_elements)
    assert t.l_max_static == j.l_max_static
    got = graph_to_numpy(t)
    for f in GraphTensors._fields:
        want = np.asarray(getattr(j, f))
        if storage == "bf16" and f == "vectors":
            want = want.astype(np.float32)
        assert got[f].dtype == want.dtype and got[f].shape == want.shape, f
        if f == "norms":  # f32 summation order
            np.testing.assert_allclose(got[f], want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)
    assert bool(t.deleted[3]) and int(t.n) == N


def test_from_oracle_empty():
    o = OracleHNSW(JaxConfig(dim=DIM, M=8, ef_construction=50))
    t = from_oracle(o, 100, device="cpu")
    assert int(t.n) == 0 and int(t.entry) == -1 and int(t.max_level) == -1
    assert (t.adj0 == -1).all()


def test_search_stats_equal_jax(oracle):
    data, o = oracle
    q = queries_like(data, 32, seed=1)
    t = from_oracle(o, device="cpu")
    want = jprof.search_stats(jax_from_oracle(o), q, k=10, ef=32, metric="l2")
    got = tprof.search_stats(t, q, k=10, ef=32, metric="l2")
    assert list(got) == list(want)
    mean = "found_mean_dist"
    assert {k: v for k, v in got.items() if k != mean} == \
        {k: v for k, v in want.items() if k != mean}
    assert got[mean] == pytest.approx(want[mean], rel=1e-5)
    assert got["beam_iterations"] > 0
    assert got["distance_evals"] == (
        32 * got["beam_iterations"] * got["expand"] * t.adj0.shape[1])
    assert got["gathered_bytes"] == got["distance_evals"] * DIM * 4
    json.dumps(got)  # plain numbers
    # more ef => at least as many iterations; int8 rows are a byte each
    wide = tprof.search_stats(t, q, k=10, ef=128, metric="l2")
    assert wide["beam_iterations"] >= got["beam_iterations"]
    t8 = from_oracle(_with_storage(o, "int8"), device="cpu")
    s8 = tprof.search_stats(t8, q, k=10, ef=32, metric="l2", expand=2)
    assert s8["gathered_bytes"] == s8["distance_evals"] * DIM
    assert s8["expansions_per_query"] == 2 * s8["beam_iterations"]


def test_timer_and_sync():
    with tprof.Timer("t") as t:
        x = torch.ones((64, 64)) @ torch.ones((64, 64))
        tprof.sync(x)
    assert t.seconds > 0 and t.name == "t"


def test_sync_takes_index_states(oracle):
    g = from_oracle(oracle[1], device="cpu")
    tprof.sync(g)  # a GraphTensors: nothing to wait for on the CPU
    with pytest.raises(AttributeError):
        tprof.sync([g])  # needs something that names its device


def test_trace_and_annotate(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        with tprof.annotate("square"):
            torch.ones((8, 8)) @ torch.ones((8, 8))
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "square" for e in events)
