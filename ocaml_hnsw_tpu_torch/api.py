"""Public API of the torch port: `Index`, `FlatIndex` and `BFIndex`, the
hnswlib-shaped surfaces of the JAX package's `ocaml_hnsw_tpu/api.py` on torch
tensors on one device.

A first `add_items` that fills most of an empty index builds the graph in
bulk (`models/bulk.py`); every other add goes through the incremental
rounds (`models/build.py`).  `knn_query` on an index of PACKED_THRESHOLD
nodes or more with a matmul metric and a payload within
PACKED_BUDGET_BYTES serves from the packed inline-int8 engine
(`models/packed.py`), anything else from the classic engine
(`models/search.py`).  `save_index` / `load_index` read and write the JAX
package's `.npz` format (`io.py`).  The defaults of `knn_query` are the JAX
package's, not a benchmarked operating point.

`Index.mark_deleted` / `unmark_deleted` record a tombstone change on the
host and launch nothing.  The changes reach the graph's `deleted` bits
together, in one copy and one scatter (the last change of a row wins), as
soon as a call reads or copies the graph: `knn_query`, `add_items`,
`resize_index`, `save_index`, `get_items` and the `graph` property;
`init_index` and `load_index` drop them with the graph they replace.  What
every call returns is what it would be had each change been written at
once.

`FlatIndex` is the flat scan (`models/flat.py`: bf16 or int8 scan, exact
rerank), `BFIndex` the same surface with an exact f32 scan; both read and
write the JAX package's flat `.npz` files.

`Index(space, dim, device="cuda")` (and the flat indexes alike) keeps every
tensor on `device` and never falls back to another: with no CUDA device,
"cuda" raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models.build import BuildState
from ocaml_hnsw_tpu_torch.models.graph import GraphTensors, grow_graph
from ocaml_hnsw_tpu_torch.models.search import knn_search
from ocaml_hnsw_tpu_torch.utils.profiling import annotate
from ocaml_hnsw_tpu_torch import io as index_io


def _check_space(space: str) -> None:
    from ocaml_hnsw_tpu_torch.ops.metrics import is_metric, registered_metrics

    if not is_metric(space):
        raise ValueError(
            f"space must be a registered metric {registered_metrics()} "
            f"(ops.metrics.register_metric adds new ones), got {space!r}"
        )


def _pad_batch(n: int) -> int:
    """Power-of-two batch buckets (floor 8), as in the JAX package."""
    b = 8
    while b < n:
        b *= 2
    return b


def _answers(ids, dists, q_n: int, labels):
    """The first q_n rows of a search's device ids and distances on the
    host, ids mapped through `labels`: (labels i64, dists f32), -1 where
    the id is -1."""
    with annotate("hnsw.api.fetch"):  # waits for the device, then the D2H
        ids = ids.cpu().numpy()[:q_n]
        dists = dists.cpu().numpy()[:q_n]
    with annotate("hnsw.api.labels"):
        out = np.where(ids >= 0, labels[np.maximum(ids, 0)], -1)
        return out.astype(np.int64), dists


def _add_labelled(index, ids, n_cur: int, n_new: int, add) -> None:
    """Run `add()`, which stores n_new rows at ids n_cur.., under their
    labels (`ids`, or n_cur.. when None): checked against `index`'s before
    the add, recorded in its `_label_to_id` and `_labels` after it."""
    with annotate("hnsw.api.labels"):
        if ids is None:
            labels = np.arange(n_cur, n_cur + n_new, dtype=np.int64)
        else:
            labels = np.asarray(ids, dtype=np.int64).reshape(-1)
            if labels.shape[0] != n_new:
                raise ValueError("ids length must match data rows")
        clash = [int(l) for l in labels if int(l) in index._label_to_id]
        if clash:
            raise ValueError(f"duplicate labels not supported: {clash[:5]}")
    with annotate("hnsw.api.add"):
        add()
    with annotate("hnsw.api.labels"):
        for off, lab in enumerate(labels):
            index._label_to_id[int(lab)] = n_cur + off
        index._labels = np.concatenate([index._labels, labels])


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available (pass device='cpu' to run on the CPU)")
    return dev


class Index:
    """HNSW index with the canonical hnswlib-style surface."""

    #: graphs at or above this size use the seed scan for layer-0 entry
    SEED_THRESHOLD = 4096
    #: graphs at or above this size use the packed inline-int8 engine when
    #: its payload fits PACKED_BUDGET_BYTES
    PACKED_THRESHOLD = 100_000
    PACKED_BUDGET_BYTES = 8 << 30

    def __init__(self, space: str, dim: int, *, device="cuda"):
        _check_space(space)
        self.space = space
        self.dim = dim
        self.device = _resolve_device(device)
        self._state: BuildState | None = None
        self._labels = np.zeros((0,), dtype=np.int64)
        self._label_to_id: dict[int, int] = {}
        self._seeds = None  # SeedIndex cache; invalidated on every add
        self._packed = None  # PackedGraph cache; invalidated on every add
        #: tombstone changes not yet on the device: internal id -> deleted
        self._tombstones: dict[int, bool] = {}
        self.ef = 10

    # ------------------------------------------------------------- lifecycle
    def init_index(
        self,
        max_elements: int,
        M: int = 16,
        ef_construction: int = 200,
        random_seed: int = 100,
        round_size: int = 1024,
        keep_pruned_connections: bool = False,
        extend_candidates: bool = False,
        select: str = "heuristic",
        storage: str = "f32",
        **_ignored,  # num_threads etc. accepted for source compatibility
    ) -> None:
        cfg = HnswConfig(
            dim=self.dim,
            metric=self.space,
            M=M,
            ef_construction=ef_construction,
            seed=random_seed,
            keep_pruned_connections=keep_pruned_connections,
            extend_candidates=extend_candidates,
            select=select,
            storage=storage,
        )
        self._state = BuildState(cfg, max_elements, round_size=round_size,
                                 device=self.device)
        self._seeds = None
        self._packed = None
        self._tombstones = {}
        self._labels = np.zeros((0,), dtype=np.int64)
        self._label_to_id = {}

    def _require_init(self) -> BuildState:
        if self._state is None:
            raise RuntimeError("call init_index (or load_index) first")
        return self._state

    @property
    def config(self) -> HnswConfig:
        return self._require_init().config

    @property
    def graph(self) -> GraphTensors:
        st = self._require_init()
        self._apply_tombstones()
        return st.graph

    def _apply_tombstones(self) -> None:
        """Write the pending tombstone changes into `graph.deleted`: one
        host-to-device copy of (ids, flags) and one scatter.  Each id is
        pending once, with its last change, so the scatter has no
        duplicate index."""
        if not self._tombstones:
            return
        with annotate("hnsw.api.delete"):
            pending = np.array([list(self._tombstones),
                                list(self._tombstones.values())],
                               dtype=np.int64)
            self._tombstones = {}
            t = torch.from_numpy(pending).to(self.device)
            self._state.graph.deleted.index_put_((t[0],), t[1].bool())

    # ------------------------------------------------------------- mutation
    def add_items(self, data, ids=None, **_ignored) -> None:
        st = self._require_init()
        with annotate("hnsw.api.prepare"):
            data = np.atleast_2d(np.asarray(data, dtype=np.float32))
            if data.shape[1] != self.dim:
                raise ValueError(
                    f"expected dim {self.dim}, got {data.shape[1]}")
            n_new = data.shape[0]
            n_cur = st.host_n
            if n_cur + n_new > st.max_elements:
                raise RuntimeError(
                    f"index is full: {n_cur} + {n_new} > max_elements "
                    f"{st.max_elements}"
                )
        self._apply_tombstones()
        _add_labelled(self, ids, n_cur, n_new, lambda: st.add(data))
        self._seeds = None  # upper-layer membership changed
        self._packed = None  # adjacency changed

    def mark_deleted(self, label: int) -> None:
        """Tombstone: the row stays in the graph and is traversed, but no
        query returns it.  An unknown label raises here.  The change is
        kept on the host and reaches the device with every other pending
        one when a call next reads or copies the graph (module
        docstring): a loop of calls launches nothing."""
        self._require_init()
        self._tombstones[self._id_of(label)] = True

    def unmark_deleted(self, label: int) -> None:
        """Undo `mark_deleted`, on the same terms: kept on the host until a
        call reads the graph; a pending delete of the label is cancelled."""
        self._require_init()
        self._tombstones[self._id_of(label)] = False

    @torch.no_grad()
    def resize_index(self, new_max_elements: int) -> None:
        """Grow capacity (graph tensors re-padded by `grow_graph`).  The
        level stream continues."""
        st = self._require_init()
        if new_max_elements < st.host_n:
            raise ValueError("cannot shrink below current element count")
        self._apply_tombstones()
        with annotate("hnsw.api.resize"):
            old = st.graph
            new_state = BuildState(st.config, new_max_elements,
                                   round_size=st.round_size,
                                   device=self.device)
            grow = new_state.graph.n_cap - old.n_cap
            if grow < 0:
                raise ValueError("resize would shrink padded capacity")
            t_grow = new_state.graph.t_cap - old.t_cap
            if t_grow < 0:
                raise ValueError("resize would shrink the upper arena")
            new_state.graph = None  # free the empty graph before padding
            graph = grow_graph(old, grow, t_grow,
                               max(new_state.l_max, old.l_max))
            new_state.rng = st.rng  # continue the level-sampling stream
            new_state.l_max = graph.l_max
            new_state.adopt_graph(graph)
        self._state = new_state
        self._seeds = None
        self._packed = None

    # --------------------------------------------------------------- queries
    def set_ef(self, ef: int) -> None:
        self.ef = int(ef)

    def _seed_index(self):
        """Lazy SeedIndex for the seed-scan entry on large graphs (None when
        too small or no upper-layer nodes exist)."""
        st = self._require_init()
        if st.host_n < self.SEED_THRESHOLD:
            return None
        if self._seeds is None:
            from ocaml_hnsw_tpu_torch.models.search import build_seed_index

            with annotate("hnsw.api.seed_index"):
                self._seeds = build_seed_index(st.graph, self.space)
        return self._seeds

    def _packed_index(self):
        """Lazy PackedGraph; None when the graph is small, the metric has no
        matmul form, or the payload would exceed PACKED_BUDGET_BYTES."""
        st = self._require_init()
        if st.host_n < self.PACKED_THRESHOLD:
            return None
        from ocaml_hnsw_tpu_torch.ops.metrics import get_metric

        if get_metric(self.space).matmul_score is None:
            return None
        from ocaml_hnsw_tpu_torch.models.packed import pack_d_pad, pack_graph

        deg = st.graph.adj0.shape[1]
        if st.graph.n_cap * deg * pack_d_pad(self.dim) > self.PACKED_BUDGET_BYTES:
            return None
        if self._packed is None:
            with annotate("hnsw.api.pack"):
                self._packed = pack_graph(st.graph, self.space)
        return self._packed

    def knn_query(self, data, k: int = 1, ef: int | None = None,
                  max_iters: int | None = None,
                  compact_k: int | str | None = "auto",
                  engine: str = "auto",
                  expand: int | None = None,
                  expand_schedule: tuple | None = None,
                  rerank_k: int | None = None,
                  interleave: int = 1,
                  **_ignored):
        """Returns (labels i64[Q, k], dists f32[Q, k]); -1 label on padding.

        engine="auto" serves large matmul-metric indexes from the packed
        engine (seed-scan entry, inline int8 beam, exact f32 rerank) and
        everything else from the classic engine (seed-scan entry on graphs
        of SEED_THRESHOLD nodes or more, else greedy descent; expand 4;
        compact_k="auto" = 3/4·4·M_max0 on seed-scan graphs when that is
        >= 96).  engine="classic"/"packed" forces a path (packed raises if
        unavailable).  expand / expand_schedule / rerank_k / interleave
        apply to the packed engine, compact_k to the classic one."""
        st = self._require_init()
        if st.host_n == 0:
            raise RuntimeError("index is empty")
        if engine not in ("auto", "classic", "packed"):
            raise ValueError(f"engine must be auto|classic|packed, got {engine!r}")
        self._apply_tombstones()
        with annotate("hnsw.api.prepare"):
            data = np.atleast_2d(np.asarray(data, dtype=np.float32))
            q_n = data.shape[0]
            b = _pad_batch(q_n)
            padded = np.zeros((b, self.dim), np.float32)
            padded[:q_n] = data
            queries = torch.from_numpy(padded).to(self.device)
        ef = max(ef if ef is not None else self.ef, k)
        seeds = self._seed_index()
        packed = self._packed_index() if engine in ("auto", "packed") else None
        if engine == "packed" and packed is None:
            raise RuntimeError(
                "packed engine unavailable: index too small, metric has no "
                "matmul form, or payload exceeds PACKED_BUDGET_BYTES"
            )
        if packed is not None:
            from ocaml_hnsw_tpu_torch.models.packed import knn_search_packed

            ids, dists = knn_search_packed(
                st.graph, packed, queries, k=k, ef=ef, metric=self.space,
                max_iters=max_iters, seeds=seeds, seed_e=8,
                expand=2 if expand is None else expand,
                expand_schedule=expand_schedule, rerank_k=rerank_k,
                interleave=interleave if b % max(interleave, 1) == 0 else 1,
            )
        else:
            if compact_k == "auto":
                m0 = st.config.M_max0
                compact_k = (3 * 4 * m0) // 4 if (
                    seeds is not None and 4 * m0 >= 128) else None
            ids, dists = knn_search(
                st.graph, queries, k=k, ef=ef, metric=self.space,
                max_iters=max_iters, seeds=seeds, compact_k=compact_k,
            )
        return _answers(ids, dists, q_n, self._labels)

    # ------------------------------------------------------------ inspection
    def get_current_count(self) -> int:
        return self._require_init().host_n

    def get_max_elements(self) -> int:
        return self._require_init().max_elements

    def get_ids_list(self) -> list[int]:
        return self._labels.tolist()

    def get_items(self, ids) -> np.ndarray:
        """Stored vectors as f32 (int8 storage dequantized by the per-row
        scales; cosine rows are the normalized form, as in hnswlib)."""
        from ocaml_hnsw_tpu_torch.ops.distance import gather_dequant

        st = self._require_init()
        iids = np.array([self._id_of(l) for l in np.asarray(ids).reshape(-1)],
                        dtype=np.int64)
        self._apply_tombstones()
        rows = gather_dequant(st.graph.vectors, st.graph.scales,
                              torch.from_numpy(iids[None, :]).to(self.device))
        return rows[0].cpu().numpy()

    def _id_of(self, label) -> int:
        try:
            return self._label_to_id[int(label)]
        except KeyError:
            raise KeyError(f"label {label} not in index") from None

    # ----------------------------------------------------------- checkpoints
    def save_index(self, path) -> None:
        st = self._require_init()
        self._apply_tombstones()
        index_io.save_index_file(
            path, st.graph, st.config, self._labels,
            rng_state=st.rng.get_state(), max_elements=st.max_elements,
            ef=self.ef,
        )

    def load_index(self, path, max_elements: int | None = None) -> None:
        """Load a file of either package; max_elements above the saved
        capacity resizes on load (as hnswlib does)."""
        (graph, config, labels, rng_state, saved_max,
         ef) = index_io.load_index_file(path, self.device)
        if config.metric != self.space or config.dim != self.dim:
            raise ValueError(
                f"index file is ({config.metric}, dim={config.dim}), this "
                f"Index is ({self.space}, dim={self.dim})"
            )
        self.ef = ef
        # round padding must stay inside the saved capacity headroom
        round_size = max(1, min(1024, graph.n_cap - saved_max - 1))
        st = BuildState(config, saved_max, round_size=round_size,
                        device=self.device)
        st.adopt_graph(graph)
        st.l_max = graph.l_max
        if rng_state is not None:
            st.rng.set_state(rng_state)
        self._state = st
        self._seeds = None
        self._packed = None
        self._tombstones = {}  # changes to the graph this load replaced
        self._labels = labels
        self._label_to_id = {int(l): i for i, l in enumerate(labels)}
        if max_elements is not None and max_elements > saved_max:
            self.resize_index(max_elements)  # hnswlib resize-on-load


class FlatIndex:
    """Flat-scan index (models/flat.py): one bf16 or int8 scan over the whole
    dataset, exact top-`rerank_k`, exact rerank.  No graph is built; every
    query reads every row."""

    exact = False

    def __init__(self, space: str, dim: int, *, device="cuda"):
        _check_space(space)
        self.space = space
        self.dim = dim
        self.device = _resolve_device(device)
        self._flat = None
        self._labels = np.zeros((0,), dtype=np.int64)
        self._label_to_id: dict[int, int] = {}
        self.max_elements = 0
        self.rerank_k = 32

    def init_index(self, max_elements: int, rerank_k: int = 32,
                   scan_dtype: str = "bf16", rerank_dtype: str = "f32",
                   **_ignored) -> None:
        """scan_dtype: "bf16" or "int8" (quantized distances, half the scan
        memory); rerank_dtype: "f32" or "bf16" (high-dimensional datasets
        where memory is short)."""
        from ocaml_hnsw_tpu_torch.models.flat import empty_flat

        self.max_elements = max_elements
        self.rerank_k = rerank_k
        self._flat = empty_flat(self.dim, max_elements, scan_dtype=scan_dtype,
                                rerank_dtype=rerank_dtype, device=self.device)

    def _require_init(self):
        if self._flat is None:
            raise RuntimeError("call init_index (or load_index) first")
        return self._flat

    def add_items(self, data, ids=None, **_ignored) -> None:
        from ocaml_hnsw_tpu_torch.models.flat import flat_add
        from ocaml_hnsw_tpu_torch.ops.metrics import get_metric

        flat = self._require_init()
        with annotate("hnsw.sync.flat_n"):
            n_cur = int(flat.n)
        with annotate("hnsw.api.prepare"):
            data = np.atleast_2d(np.asarray(data, dtype=np.float32))
            if data.shape[1] != self.dim:
                raise ValueError(
                    f"expected dim {self.dim}, got {data.shape[1]}")
            if get_metric(self.space).normalize_add:
                nrm = np.linalg.norm(data, axis=1, keepdims=True)
                data = data / np.where(nrm == 0, 1.0, nrm)
            n_new = data.shape[0]
            if n_cur + n_new > self.max_elements:
                raise RuntimeError("index is full; grow max_elements")

        def add():
            chunk = 65536  # bounds the f32 copy on the device
            for done in range(0, n_new, chunk):
                rows = torch.from_numpy(data[done:done + chunk])
                rows = rows.to(self.device)
                flat_add(flat, rows, n_cur + done, rows.shape[0])

        _add_labelled(self, ids, n_cur, n_new, add)

    def resize_index(self, new_max_elements: int) -> None:
        """Grow capacity (tensors re-padded; norms pad to +inf so empty
        slots never score)."""
        from ocaml_hnsw_tpu_torch.models.flat import FlatTensors
        from ocaml_hnsw_tpu_torch.utils import round_up

        flat = self._require_init()
        if new_max_elements < int(flat.n):
            raise ValueError("cannot shrink below current element count")
        self.max_elements = new_max_elements
        grow = round_up(max(new_max_elements, 4096), 4096) - flat.n_cap
        if grow <= 0:
            return

        def pad(a, fill):
            out = torch.full((a.shape[0] + grow, *a.shape[1:]), fill,
                             dtype=a.dtype, device=a.device)
            out[:a.shape[0]] = a
            return out

        self._flat = FlatTensors(
            scan=pad(flat.scan, 0), scales=pad(flat.scales, 1.0),
            rerank=pad(flat.rerank, 0), norms=pad(flat.norms, float("inf")),
            n=flat.n, deleted=pad(flat.deleted, False))

    def knn_query(self, data, k: int = 1, rerank_k: int | None = None,
                  **_ignored):
        """Returns (labels i64[Q, k], dists f32[Q, k]); -1 label on padding."""
        from ocaml_hnsw_tpu_torch.models.flat import flat_search

        flat = self._require_init()
        with annotate("hnsw.sync.flat_n"):
            empty = int(flat.n) == 0
        if empty:
            raise RuntimeError("index is empty")
        with annotate("hnsw.api.prepare"):
            data = np.atleast_2d(np.asarray(data, dtype=np.float32))
            q_n = data.shape[0]
            padded = np.zeros((_pad_batch(q_n), self.dim), np.float32)
            padded[:q_n] = data
            queries = torch.from_numpy(padded).to(self.device)
        ids, dists = flat_search(
            flat, queries, k=k, metric=self.space,
            rerank_k=max(k, rerank_k if rerank_k is not None else self.rerank_k),
            exact=self.exact,
        )
        return _answers(ids, dists, q_n, self._labels)

    def mark_deleted(self, label: int) -> None:
        self._require_init().deleted[self._label_to_id[int(label)]] = True

    delete_vector = mark_deleted  # hnswlib BFIndex spelling

    def unmark_deleted(self, label: int) -> None:
        self._require_init().deleted[self._label_to_id[int(label)]] = False

    def get_current_count(self) -> int:
        return 0 if self._flat is None else int(self._flat.n)

    def get_ids_list(self) -> list[int]:
        return self._labels.tolist()

    def save_index(self, path) -> None:
        """The JAX package's flat file: numpy has no bfloat16, so bf16 arrays
        are widened to f32 beside a dtype tag spelled as numpy spells it
        ("bfloat16", "int8", "float32")."""
        flat = self._require_init()

        def host(t):
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

        def tag(t):
            return np.frombuffer(
                str(t.dtype).removeprefix("torch.").encode(), np.uint8)

        arrays = dict(
            scan=host(flat.scan),
            scan_dtype=tag(flat.scan),
            rerank_dtype=tag(flat.rerank),
            scales=host(flat.scales),
            rerank=host(flat.rerank),
            norms=host(flat.norms),
            n=host(flat.n),
            deleted=host(flat.deleted),
            labels=self._labels,
            max_elements=np.int64(self.max_elements),
            space=np.frombuffer(self.space.encode(), dtype=np.uint8),
        )
        # an open handle keeps save("x.bin") / load("x.bin") symmetric
        # (np.savez appends ".npz" to bare string paths)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    def load_index(self, path, max_elements: int | None = None) -> None:
        """Load a file of either package (files from before the dtype tags
        and the separate scan load too); max_elements above the saved
        capacity resizes on load."""
        from ocaml_hnsw_tpu_torch.models.flat import FlatTensors

        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}

        def put(a, dtype=None):
            return torch.from_numpy(np.array(a, copy=True)).to(
                self.device, dtype)

        with np.load(path) as z:
            space = bytes(z["space"]).decode()
            if space != self.space:
                raise ValueError(f"index file is {space}, this is {self.space}")
            sd = bytes(z["scan_dtype"]).decode() if "scan_dtype" in z \
                else "float32"
            rd = bytes(z["rerank_dtype"]).decode() if "rerank_dtype" in z \
                else "float32"
            rerank = put(z["rerank"], dtypes[rd])
            self._flat = FlatTensors(
                scan=put(z["scan"], dtypes[sd]) if "scan" in z else rerank,
                scales=put(z["scales"]) if "scales" in z
                else torch.ones((rerank.shape[0],), device=self.device),
                rerank=rerank,
                norms=put(z["norms"]),
                n=put(z["n"]),
                deleted=put(z["deleted"]),
            )
            self._labels = np.asarray(z["labels"])
            self._label_to_id = {int(l): i for i, l in enumerate(self._labels)}
            self.max_elements = int(z["max_elements"])
        if max_elements is not None and max_elements > self.max_elements:
            self.resize_index(max_elements)  # hnswlib resize-on-load


class BFIndex(FlatIndex):
    """Exact brute-force index (hnswlib BFIndex parity): full-f32 scan and
    exact top-k.  Same surface as FlatIndex."""

    exact = True
