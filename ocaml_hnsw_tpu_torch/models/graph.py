"""Device-resident index state, the port of `ocaml_hnsw_tpu/models/graph.py`:
layer 0 is one int32[N_cap, M_max0] matrix with -1 sentinels, and the upper
layers live in one compact arena `adj_up[T_cap, M]` (node v's layer-ℓ row is
`adj_up[up_base[v] + ℓ - 1]`; the last arena row is a reserved sink).

`graph_from_numpy` / `graph_to_numpy` carry a graph across packages by the
field names of `GraphTensors._fields`, so a graph the JAX package built
(`np.asarray` of each field) becomes this package's graph, and back.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.utils import pad_to, round_up


@dataclasses.dataclass
class GraphTensors:
    """The whole index as tensors on one device.  Shapes use N_cap = padded
    capacity; field meanings are those of the JAX package's GraphTensors.

    vectors [N_cap, D] (f32 / bf16 / int8), scales f32[N_cap], norms
    f32[N_cap], adj0 i32[N_cap, M_max0], adj_up i32[T_cap, M], up_base
    i32[N_cap], levels i32[N_cap] (-1 = unoccupied), deleted bool[N_cap];
    up_n, entry, max_level, n are 0-d int32 tensors; l_max_static an int."""

    vectors: torch.Tensor
    scales: torch.Tensor
    norms: torch.Tensor
    adj0: torch.Tensor
    adj_up: torch.Tensor
    up_base: torch.Tensor
    up_n: torch.Tensor
    levels: torch.Tensor
    entry: torch.Tensor
    max_level: torch.Tensor
    n: torch.Tensor
    deleted: torch.Tensor
    l_max_static: int

    # names of the tensor fields, in declaration order (as in the JAX package)
    _fields = ("vectors", "scales", "norms", "adj0", "adj_up", "up_base",
               "up_n", "levels", "entry", "max_level", "n", "deleted")

    def _replace(self, **kw) -> "GraphTensors":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "GraphTensors":
        """A copy that shares no tensor (the build updates graphs in
        place)."""
        return self._replace(**{f: getattr(self, f).clone()
                                for f in self._fields})

    @property
    def n_cap(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def l_max(self) -> int:
        return self.l_max_static

    @property
    def t_cap(self) -> int:
        return self.adj_up.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def capacity(max_elements: int) -> int:
    """Pad capacity to a multiple of 128."""
    return round_up(max(max_elements, 128), 128)


def arena_capacity(max_elements: int, m: int) -> int:
    """Upper-arena row capacity: expected rows N/(M-1) with a 3x margin, +1
    for the reserved sink row."""
    want = 3 * capacity(max_elements) // max(m - 1, 1) + 1
    return round_up(max(want, 256), 128)


class UpperView(NamedTuple):
    """Adjacency view of one upper layer over the compact arena: node v's
    neighbors at `level` are table[up_base[v] + level - 1] when
    levels[v] >= level, else the all -1 sink row."""

    table: torch.Tensor  # i32[T_cap, M]
    up_base: torch.Tensor  # i32[N_cap]
    levels: torch.Tensor  # i32[N_cap]
    level: int  # >= 1

    @property
    def deg(self) -> int:
        return self.table.shape[1]

    def rows_of(self, safe_ids):
        """Arena row per node id (ids must be >= 0); sink row when the node
        has no row at this layer."""
        base = self.up_base[safe_ids]
        ok = (self.levels[safe_ids] >= self.level) & (base >= 0)
        return torch.where(ok, base + (self.level - 1), self.table.shape[0] - 1)


def adj_take(adj, safe_ids):
    """Gather adjacency rows for node ids (>= 0) from either a dense layer-0
    table or an UpperView."""
    safe_ids = safe_ids.long()
    if isinstance(adj, UpperView):
        return adj.table[adj.rows_of(safe_ids).long()]
    return adj[safe_ids]


def upper_view(graph: GraphTensors, level: int) -> UpperView:
    return UpperView(table=graph.adj_up, up_base=graph.up_base,
                     levels=graph.levels, level=level)


def dense_upper(graph: GraphTensors, level: int) -> np.ndarray:
    """One upper layer as a host [n, M] matrix (tests/debug)."""
    n = int(graph.n)
    ub = graph.up_base[:n].cpu().numpy()
    lv = graph.levels[:n].cpu().numpy()
    table = graph.adj_up.cpu().numpy()
    out = np.full((n, table.shape[1]), -1, np.int32)
    ok = (lv >= level) & (ub >= 0)
    out[ok] = table[ub[ok] + level - 1]
    return out


def empty_graph(config: HnswConfig, max_elements: int,
                device: torch.device | str = "cuda") -> GraphTensors:
    """An empty graph for `max_elements` rows on `device` (raises when
    "cuda" is asked for and there is no CUDA device)."""
    from ocaml_hnsw_tpu_torch.api import _resolve_device
    from ocaml_hnsw_tpu_torch.ops.quantize import storage_dtype

    device = _resolve_device(device)
    n_cap = capacity(max_elements)
    t_cap = arena_capacity(max_elements, config.M)

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return GraphTensors(
        vectors=torch.zeros((n_cap, config.dim),
                            dtype=storage_dtype(config.storage), device=device),
        scales=full((n_cap,), 1.0, torch.float32),
        norms=full((n_cap,), 0.0, torch.float32),
        adj0=full((n_cap, config.M_max0), -1, torch.int32),
        adj_up=full((t_cap, config.M), -1, torch.int32),
        up_base=full((n_cap,), -1, torch.int32),
        up_n=full((), 0, torch.int32),
        levels=full((n_cap,), -1, torch.int32),
        entry=full((), -1, torch.int32),
        max_level=full((), -1, torch.int32),
        n=full((), 0, torch.int32),
        deleted=full((n_cap,), False, torch.bool),
        l_max_static=config.derived_max_level(max_elements),
    )


def grow_graph(g: GraphTensors, rows: int, arena_rows: int,
               l_max_static: int) -> GraphTensors:
    """`g` with `rows` more empty node rows and `arena_rows` more empty
    upper-arena rows (resize_index).  The arena's sink row moves to the new
    last row; the old one is all -1 and becomes an allocatable row."""

    def pad(a, n, fill):
        out = torch.full((a.shape[0] + n, *a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        out[:a.shape[0]] = a
        return out

    return GraphTensors(
        vectors=pad(g.vectors, rows, 0),
        scales=pad(g.scales, rows, 1.0),
        norms=pad(g.norms, rows, 0.0),
        adj0=pad(g.adj0, rows, -1),
        adj_up=pad(g.adj_up, arena_rows, -1),
        up_base=pad(g.up_base, rows, -1),
        up_n=g.up_n.clone(),
        levels=pad(g.levels, rows, -1),
        entry=g.entry.clone(),
        max_level=g.max_level.clone(),
        n=g.n.clone(),
        deleted=pad(g.deleted, rows, False),
        l_max_static=l_max_static,
    )


def from_oracle(oracle, max_elements: int | None = None,
                device: torch.device | str = "cuda") -> GraphTensors:
    """GraphTensors of a NumPy oracle index (any object with the
    OracleHNSW fields: config, element_count, vectors, levels, adj, deleted,
    entry, max_level), the same tensors as the JAX package's `from_oracle`."""
    from ocaml_hnsw_tpu_torch.ops.metrics import get_metric
    from ocaml_hnsw_tpu_torch.ops.quantize import quantize_rows

    cfg = oracle.config
    n = oracle.element_count
    n_cap = capacity(max_elements or n)
    l_max = cfg.derived_max_level(max_elements or max(n, 2))
    vectors_f = np.zeros((n_cap, cfg.dim), np.float32)
    if n:
        vectors_f[:n] = np.stack(oracle.vectors)
    vectors, scales, norms = quantize_rows(torch.from_numpy(vectors_f),
                                           cfg.storage)
    if not get_metric(cfg.metric).needs_norms:
        norms = torch.zeros((n_cap,), dtype=torch.float32)

    adj0 = np.full((n_cap, cfg.M_max0), -1, np.int32)
    t_cap = arena_capacity(max_elements or max(n, 2), cfg.M)
    adj_up = np.full((t_cap, cfg.M), -1, np.int32)
    up_base = np.full((n_cap,), -1, np.int32)
    levels = np.full((n_cap,), -1, np.int32)
    up_n = 0
    for i in range(n):
        lvl = min(oracle.levels[i], l_max)
        levels[i] = lvl
        if lvl >= 1:  # the arena block, in insertion order
            up_base[i] = up_n
            up_n += lvl
        for lc, nbrs in enumerate(oracle.adj[i]):
            if lc == 0:
                adj0[i] = pad_to(np.asarray(nbrs, np.int32), cfg.M_max0, -1)
            elif lc <= l_max:
                adj_up[up_base[i] + lc - 1] = pad_to(
                    np.asarray(nbrs, np.int32), cfg.M, -1)
    if up_n >= t_cap:
        raise RuntimeError(f"arena overflow converting oracle: {up_n} rows "
                           f"> capacity {t_cap}")
    deleted = np.zeros((n_cap,), np.bool_)
    for e in oracle.deleted:
        deleted[e] = True
    max_level = min(max(oracle.max_level, 0), l_max) if n else -1
    arrays = dict(
        adj0=adj0, adj_up=adj_up, up_base=up_base, levels=levels,
        deleted=deleted, up_n=np.int32(up_n), entry=np.int32(oracle.entry),
        max_level=np.int32(max_level), n=np.int32(n))
    return GraphTensors(
        vectors=vectors.to(device), scales=scales.to(device),
        norms=norms.to(device),
        **{f: _to_torch(a, device) for f, a in arrays.items()},
        l_max_static=l_max,
    )


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    # bf16 from the JAX package: ml_dtypes' bfloat16, or its raw 2-byte
    # values (V2) as np.load returns them
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def graph_from_numpy(arrays, l_max_static: int,
                     device: torch.device | str) -> GraphTensors:
    """GraphTensors from a mapping of field name -> array (numpy, or anything
    np.asarray takes, such as a JAX GraphTensors' fields)."""
    return GraphTensors(
        **{f: _to_torch(arrays[f], device) for f in GraphTensors._fields},
        l_max_static=int(l_max_static),
    )


def graph_to_numpy(g: GraphTensors, bf16_bits: bool = False) -> dict:
    """Field name -> numpy array.  numpy has no bfloat16: bf16 vectors widen
    to f32, or with bf16_bits=True come out as their raw 2-byte values
    (dtype V2, what np.save writes for the JAX package's bfloat16)."""
    out = {}
    for f in GraphTensors._fields:
        t = getattr(g, f).detach().cpu()
        if t.dtype == torch.bfloat16:
            if bf16_bits:
                out[f] = t.view(torch.int16).numpy().view("V2")
                continue
            t = t.float()
        out[f] = t.numpy()
    return out
