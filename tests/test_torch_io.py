"""Checkpoints of the torch port against the JAX package's
(`ocaml_hnsw_tpu/io.py`, `Index.save_index` / `load_index` / `get_items` /
`resize_index` of `ocaml_hnsw_tpu/api.py`).

An index is built by the port (300 x 24 clustered rows, custom labels) and
its graph written by the JAX package's `save_index_file`.  Then:

  * the port loads that file and saves it again: every array of the two
    files (names, dtypes, bytes) is identical, for f32, bf16 and int8
    storage, and the JAX package loads the port's file to the same graph
    (f32 and int8; the JAX loader cannot read bf16 vectors back from any
    file, its own included — ROADMAP.md Queue 3, R9);
  * a format-v1 file (dense upper layers) converts to the same arena in
    both packages;
  * `load_index(max_elements=...)` resizes, and queries answer as before;
  * `get_items` equals the JAX Index's;
  * an add after a load draws the same levels as the JAX Index would, and
    leaves the RNG where JAX's is.
"""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocaml_hnsw_tpu import io as jio
from ocaml_hnsw_tpu.api import Index as JaxIndex
from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.config import HnswConfig as JaxConfig
from ocaml_hnsw_tpu.models import build as jbuild
from ocaml_hnsw_tpu.models.graph import GraphTensors as JaxGraph

from ocaml_hnsw_tpu_torch import Index
from ocaml_hnsw_tpu_torch import io as tio
from ocaml_hnsw_tpu_torch.models.graph import dense_upper, graph_to_numpy

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

N, DIM = 300, 24
INIT = dict(max_elements=400, M=8, ef_construction=32, round_size=64)
LABELS = np.arange(N, dtype=np.int64) * 3 + 7


def _jax_graph(g):
    arrays = graph_to_numpy(g)
    jg = JaxGraph(**{f: jnp.asarray(a) for f, a in arrays.items()},
                  l_max_static=g.l_max_static)
    if g.vectors.dtype == torch.bfloat16:  # widened values are exact
        jg = jg._replace(vectors=jg.vectors.astype(jnp.bfloat16))
    return jg


@pytest.fixture(scope="module")
def data():
    return clustered(N, DIM, n_clusters=8, seed=3)


@pytest.fixture(scope="module")
def jax_files(data, tmp_path_factory):
    """storage -> (path, port Index): the port's graph saved by the JAX
    package, for each storage."""
    out = {}
    for storage in ("f32", "bf16", "int8"):
        t = Index("l2", DIM, device="cpu")
        t.init_index(storage=storage, **INIT)
        t.add_items(data, ids=LABELS)
        path = tmp_path_factory.mktemp(storage) / "jax.npz"
        st = t._state
        jio.save_index_file(path, _jax_graph(st.graph),
                            JaxConfig(**vars(st.config)), t._labels,
                            rng_state=st.rng.get_state(),
                            max_elements=st.max_elements, ef=t.ef)
        out[storage] = path, t
    return out


ALL = ["f32", "bf16", "int8"]
#: storages the JAX loader can read back (R9: not bf16)
JAX_READABLE = ["f32", "int8"]


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class TestRoundTrip:
    @pytest.mark.parametrize("storage", ALL)
    def test_port_resave_is_identical(self, jax_files, storage, tmp_path):
        path, _ = jax_files[storage]
        t = Index("l2", DIM, device="cpu")
        t.load_index(path)
        out = tmp_path / "port.npz"
        t.save_index(out)
        a, b = _arrays(path), _arrays(out)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        if storage in JAX_READABLE:
            graph = jio.load_index_file(out)[0]
            for f in JaxGraph._fields:
                np.testing.assert_array_equal(np.asarray(getattr(graph, f)),
                                              a[f], err_msg=f)

    @pytest.mark.parametrize("storage", ALL)
    def test_loaded_index_answers_as_saved(self, jax_files, storage, data):
        path, t = jax_files[storage]
        u = Index("l2", DIM, device="cpu")
        u.load_index(path)
        q = queries_like(data, 32, seed=4)
        a, b = t.knn_query(q, k=10, ef=32), u.knn_query(q, k=10, ef=32)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert set(a[0].reshape(-1).tolist()) <= set(LABELS.tolist())

    @pytest.mark.parametrize("storage", JAX_READABLE)
    def test_get_items_equals_jax(self, jax_files, storage):
        path, _ = jax_files[storage]
        u = Index("l2", DIM, device="cpu")
        u.load_index(path)
        j = JaxIndex("l2", DIM)
        j.load_index(path)
        labels = LABELS[[0, 5, 77, 299]]
        np.testing.assert_array_equal(u.get_items(labels),
                                      j.get_items(labels))


class TestFormats:
    def test_v1_converts_like_jax(self, jax_files, tmp_path):
        path, t = jax_files["f32"]
        a = _arrays(path)
        g = t.graph
        dense = np.full((g.l_max, g.n_cap, g.adj_up.shape[1]), -1, np.int32)
        for lvl in range(1, g.l_max + 1):
            dense[lvl - 1, :t.get_current_count()] = dense_upper(g, lvl)
        meta = json.loads(bytes(a["meta_json"]).decode())
        meta["format_version"] = 1
        for k in ("adj_up", "up_base", "up_n", "l_max"):
            del a[k]
        a["adj_upper"] = dense
        a["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        v1 = tmp_path / "v1.npz"
        with open(v1, "wb") as f:
            np.savez(f, **a)
        tg = tio.load_index_file(v1, "cpu")[0]
        jg = jio.load_index_file(v1)[0]
        for f in ("adj_up", "up_base", "up_n", "adj0", "levels"):
            np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                          np.asarray(getattr(jg, f)))
        assert tg.l_max == jg.l_max
        for lvl in range(1, g.l_max + 1):
            np.testing.assert_array_equal(dense_upper(tg, lvl),
                                          dense_upper(g, lvl))

    @pytest.mark.parametrize("storage", ALL)
    def test_load_resizes(self, jax_files, storage, data):
        path, t = jax_files[storage]
        u = Index("l2", DIM, device="cpu")
        u.load_index(path, max_elements=5000)
        assert u.get_max_elements() == 5000
        assert u.graph.n_cap > t.graph.n_cap
        assert u.graph.adj_up.shape[0] > t.graph.adj_up.shape[0]
        assert (u.graph.adj_up[-1] == -1).all()  # the sink moved
        q = queries_like(data, 16, seed=5)
        np.testing.assert_array_equal(t.knn_query(q, k=5, ef=32)[0],
                                      u.knn_query(q, k=5, ef=32)[0])


class TestAddAfterLoad:
    @pytest.mark.parametrize("storage", JAX_READABLE)
    def test_level_stream_continues_like_jax(self, jax_files, storage, data):
        path, _ = jax_files[storage]
        u = Index("l2", DIM, device="cpu")
        u.load_index(path)
        j = JaxIndex("l2", DIM)
        j.load_index(path)
        js = j._state
        new = queries_like(data, 60, seed=6)
        want = jbuild.sample_levels(js.rng, 60, js.config.mL, js.l_max)
        u.add_items(new, ids=np.arange(60) + 10_000)
        np.testing.assert_array_equal(u.graph.levels[N:N + 60].numpy(), want)
        a, b = u._state.rng.get_state(), js.rng.get_state()
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
        lab, _ = u.knn_query(new[:8], k=1, ef=32)
        assert (lab[:, 0] == np.arange(8) + 10_000).all()
