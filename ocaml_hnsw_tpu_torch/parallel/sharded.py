"""The sharded index, the port of `ocaml_hnsw_tpu/parallel/sharded.py`: the
dataset and graph split by node id over S shards, each an independent HNSW
subindex on its own device, queries sent to every shard and merged exactly.

- Points go to shards **round-robin** by global insertion order (global id
  g ↔ shard g % S, local slot g // S), so every shard holds an unbiased
  sample of the data.  Each shard draws its levels from its own stream
  (`RandomState(seed + shard)`).
- The JAX package runs one SPMD program over a `jax.sharding.Mesh`; here
  one process drives a list of `torch.device`s, one per shard
  (`make_mesh`).  The per-shard steps are plain loops over the shards:
  build (`insert_round` with the shard's own seed bank), classic query
  (`knn_search`, seed-scan entry from the bank) and packed query
  (`knn_search_packed`).
- Query merge: each shard's local top-k, mapped to global ids
  (`l * S + s`), is moved to the first shard's device and concatenated
  shard-major into [B, S·k]; a stable ascending sort takes the global
  top-k, so ties resolve to the lower flat index, as the JAX package's
  `lax.top_k` does.  The merge is exact given the per-shard results.
- Checkpoints are the JAX package's sharded `.npz` (every shard's graph
  stacked on a leading axis), so a file written by either package loads in
  the other.

Shards may share a device: with more shards than cards they go round-robin
over the cards, and on the CPU every shard is on "cpu" (what the JAX
package's virtual CPU mesh is to its tests).  The shards' eager loops all
run from the one host thread, so shards on different cards do not overlap
in time.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.api import _check_space, _pad_batch, _resolve_device
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.io import _arena_from_dense
from ocaml_hnsw_tpu_torch.models.build import (
    SeedBank, bootstrap, insert_round, sample_levels, seed_capacity,
    upper_round_width,
)
from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, arena_capacity, capacity, empty_graph, graph_from_numpy,
    graph_to_numpy, grow_graph,
)
from ocaml_hnsw_tpu_torch.models.packed import knn_search_packed, pack_graph
from ocaml_hnsw_tpu_torch.models.search import knn_search, seed_index_from_bank
from ocaml_hnsw_tpu_torch.ops.distance import gather_dequant
from ocaml_hnsw_tpu_torch.ops.metrics import get_metric

FORMAT_VERSION = 2  # v2: compact upper-arena graphs (see models/graph.py)


def make_mesh(n_devices: int | None = None,
              device: str = "cuda") -> list[torch.device]:
    """One device per shard.  "cuda": `n_devices` shards (None = one per
    visible card) placed round-robin over the cards, so shards share cards
    when there are more shards than cards; raises when there is no CUDA
    device.  "cpu": `n_devices` shards (None = 1), all on the CPU."""
    dev = _resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (n_devices or 1)
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards)
            for i in range(n_devices or cards)]


def _merge(ids_per_shard, d_per_shard, k: int):
    """Exact global top-k of the per-shard results: local ids → global
    (`l * S + s`, -1 stays -1), concatenated shard-major on the first
    shard's device, then the k smallest distances by a stable sort (lower
    flat index first among ties, as `lax.top_k` orders them)."""
    s = len(ids_per_shard)
    dev = ids_per_shard[0].device
    gids = [torch.where(ids >= 0, ids * s + i, -1).to(dev)
            for i, ids in enumerate(ids_per_shard)]
    flat_ids = torch.cat(gids, dim=1)
    flat_d = torch.cat([d.to(dev) for d in d_per_shard], dim=1)
    order = torch.sort(flat_d, dim=1, stable=True).indices[:, :k]
    return torch.gather(flat_ids, 1, order), torch.gather(flat_d, 1, order)


@torch.no_grad()
def sharded_knn(graphs: list[GraphTensors], queries, k: int, ef: int,
                metric: str, banks: list[SeedBank] | None = None,
                max_iters: int | None = None, compact_k: int | None = None):
    """Classic query step: `knn_search` on every shard (seed-scan entry from
    the shard's bank when `banks` is given), then the exact merge.  Returns
    (global ids i32[B, k], dists f32[B, k]) on the first shard's device."""
    ids_all, d_all = [], []
    for i, g in enumerate(graphs):
        seeds = None
        if banks is not None:
            seeds = seed_index_from_bank(g, banks[i].ids, banks[i].n, metric)
        ids, d = knn_search(g, queries.to(g.device), k=k, ef=ef,
                            metric=metric, seeds=seeds, max_iters=max_iters,
                            compact_k=compact_k)
        ids_all.append(ids)
        d_all.append(d)
    return _merge(ids_all, d_all, k)


@torch.no_grad()
def sharded_pack(graphs: list[GraphTensors], metric: str) -> list:
    """Every shard's query payload (`pack_graph`, no `dist`), each on its
    shard's device and with its own scale."""
    return [pack_graph(g, metric) for g in graphs]


@torch.no_grad()
def sharded_knn_packed(graphs: list[GraphTensors], packs: list, queries,
                       k: int, ef: int, metric: str, banks: list[SeedBank],
                       max_iters: int | None = None, expand: int = 2,
                       rerank_k: int = 32,
                       expand_schedule: tuple | None = None):
    """Packed query step: `knn_search_packed` on every shard (seed-scan
    entry from its bank, 8 seeds, inline-int8 beam, exact rerank), then the
    exact merge."""
    ids_all, d_all = [], []
    for g, p, bank in zip(graphs, packs, banks):
        seeds = seed_index_from_bank(g, bank.ids, bank.n, metric)
        ids, d = knn_search_packed(
            g, p, queries.to(g.device), k=k, ef=ef, metric=metric,
            max_iters=max_iters, seeds=seeds, seed_e=8, rerank_k=rerank_k,
            expand=expand, expand_schedule=expand_schedule)
        ids_all.append(ids)
        d_all.append(d)
    return _merge(ids_all, d_all, k)


def sharded_insert_round(graphs: list[GraphTensors], vecs, levels, start,
                         count, banks: list[SeedBank], max_levels, *,
                         efc: int, m: int, m_max0: int, rev_cap: int,
                         metric: str, keep_pruned: bool, extend: bool = False,
                         heuristic: bool = True,
                         storage: str = "f32") -> list[int]:
    """Build step: one `insert_round` on every shard whose `count` is
    above 0 (shards are independent subindexes: no cross-shard edge).
    vecs[s]: f32[R, D] on shard s's device; levels[s]: host i32[R];
    start / count / max_levels: host ints per shard.  Returns the shards'
    new max levels.

    The JAX package also runs chunks of rounds as one `lax.scan` dispatch
    (`sharded_insert_rounds_scan`), where an exhausted shard rides along
    with count-0 rounds that leave its graph untouched; the port runs
    rounds in a plain loop and skips those rounds, which changes nothing."""
    out = list(max_levels)
    for i, g in enumerate(graphs):
        if count[i] <= 0:
            continue
        out[i] = insert_round(
            g, vecs[i], levels[i], int(start[i]), int(count[i]), out[i],
            banks[i], None, efc=efc, m=m, m_max0=m_max0, rev_cap=rev_cap,
            metric=metric, keep_pruned=keep_pruned, storage=storage,
            extend=extend, heuristic=heuristic)
    return out


class ShardedIndex:
    """Dataset-sharded HNSW over a list of devices (module docstring).

    Each shard gets every S-th point (round-robin), its own seeded level
    stream (seed + shard), and builds independently; queries fan out to all
    shards and merge exactly.  `mesh`: one `torch.device` per shard
    (`make_mesh`); None = one shard per visible CUDA card, raising when
    there is none."""

    #: total element count at which queries use the per-shard packed
    #: inline-int8 engine (the same threshold as api.Index)
    PACKED_THRESHOLD = 100_000

    def __init__(self, space: str, dim: int,
                 mesh: list[torch.device] | None = None):
        _check_space(space)
        self.space = space
        self.dim = dim
        self.mesh = [_resolve_device(d) for d in (mesh or make_mesh())]
        self.n_shards = len(self.mesh)
        self._graphs: list[GraphTensors] | None = None
        self._labels = np.zeros((0,), dtype=np.int64)
        self._packed_cache = None  # per-shard PackedGraphs; lazy
        self.ef = 10

    def init_index(self, max_elements: int, M: int = 16,
                   ef_construction: int = 200, random_seed: int = 100,
                   round_size: int = 256, max_level_cap: int | None = None,
                   storage: str = "f32", **_ignored) -> None:
        s = self.n_shards
        per_shard = -(-max_elements // s)  # ceil
        self.config = HnswConfig(
            dim=self.dim, metric=self.space, M=M,
            ef_construction=ef_construction, seed=random_seed,
            max_level_cap=max_level_cap, storage=storage,
        )
        self.max_elements = max_elements
        self.round_size = round_size
        self.per_shard_cap = per_shard
        self._graphs = [empty_graph(self.config, per_shard + round_size + 1,
                                    dev) for dev in self.mesh]
        u_cap = seed_capacity(self._graphs[0].n_cap, M)
        self._banks = [SeedBank.empty(u_cap, self.dim, dev)
                       for dev in self.mesh]
        self._packed_cache = None
        self._rngs = [
            np.random.RandomState(random_seed + i) for i in range(s)
        ]
        self._shard_n = np.zeros(s, dtype=np.int64)  # host mirror of n
        self._host_max_level = np.full(s, -1, dtype=np.int64)
        self._host_upper = np.zeros(s, dtype=np.int64)
        self.rev_cap = 8

    def _require_init(self) -> list[GraphTensors]:
        if self._graphs is None:
            raise RuntimeError("call init_index first")
        return self._graphs

    @torch.no_grad()
    def add_items(self, data, ids=None) -> None:
        """Insert rows: round-robin over the shards, an empty shard's first
        row by `bootstrap`, the rest in doubling rounds of `insert_round`
        per shard (the JAX package's host schedule, step for step)."""
        graphs = self._require_init()
        cfg = self.config
        s = self.n_shards
        data = np.atleast_2d(np.asarray(data, dtype=np.float32))
        if data.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {data.shape[1]}")
        if get_metric(cfg.metric).normalize_add:
            nrm = np.linalg.norm(data, axis=1, keepdims=True)
            data = data / np.where(nrm == 0, 1.0, nrm)
        n_new = data.shape[0]
        n_tot = int(self._shard_n.sum())
        if n_tot + n_new > self.max_elements:
            raise RuntimeError("index is full; grow max_elements")
        if ids is None:
            labels = np.arange(n_tot, n_tot + n_new, dtype=np.int64)
        else:
            labels = np.asarray(ids, dtype=np.int64).reshape(-1)
            if labels.shape[0] != n_new:
                raise ValueError("ids length must match data rows")
        clash = np.intersect1d(labels, self._labels)
        if clash.size:
            raise ValueError(
                f"duplicate labels not supported: {clash[:5].tolist()}"
            )
        self._labels = np.concatenate([self._labels, labels])

        # round-robin assignment by global insertion order
        shard_of = np.arange(n_tot, n_tot + n_new) % s
        per_shard_data = [data[shard_of == i] for i in range(s)]
        l_max = graphs[0].l_max
        per_shard_levels = [
            sample_levels(self._rngs[i], len(per_shard_data[i]), cfg.mL,
                          l_max)
            for i in range(s)
        ]

        # an empty shard's first row: no search needed.  `bootstrap` zeroes
        # the stored norm unless the metric needs norms; of the built-in
        # metrics only l2 does, which is the JAX package's rule here
        for i in range(s):
            if self._shard_n[i] or not len(per_shard_data[i]):
                continue
            lvl0 = int(per_shard_levels[i][0])
            g = graphs[i]
            bootstrap(g, torch.from_numpy(per_shard_data[i][0]).to(g.device),
                      lvl0, cfg.metric, storage=cfg.storage)
            if lvl0 >= 1:
                v0 = g.vectors[:1].float() * g.scales[:1, None]
                self._banks[i].append(
                    torch.zeros(1, dtype=torch.int32, device=g.device),
                    v0.to(torch.bfloat16), g.norms[:1])
                self._host_upper[i] += 1
            self._host_max_level[i] = max(self._host_max_level[i], lvl0)
            per_shard_data[i] = per_shard_data[i][1:]
            per_shard_levels[i] = per_shard_levels[i][1:]
            self._shard_n[i] += 1

        # every shard's round list (the doubling rule: a round never inserts
        # more points than the shard holds), checked against the upper
        # stages' widths before any round runs
        done = np.zeros(s, dtype=np.int64)
        todo = np.array([len(d) for d in per_shard_data])
        r = self.round_size
        w_1 = upper_round_width(r, cfg.M, 1)
        w_2 = upper_round_width(r, cfg.M, 2)
        shard_n = self._shard_n.copy()
        scheds: list[list[tuple[int, int]]] = [[] for _ in range(s)]
        while (done < todo).any():
            for i in range(s):
                c = max(int(min(r, todo[i] - done[i], max(shard_n[i], 1))), 0)
                if c:
                    lv_r = per_shard_levels[i][done[i]:done[i] + c]
                    c_1 = int((lv_r >= 1).sum())
                    c_2 = int((lv_r >= 2).sum())
                    if c_1 > w_1 or c_2 > w_2:
                        raise RuntimeError(
                            f"shard round has {c_1} points at level>=1 / "
                            f"{c_2} at level>=2 — exceeds the packed upper "
                            "widths"
                        )
                scheds[i].append((int(done[i]), c))
                done[i] += c
                shard_n[i] += c

        # one copy of each shard's rows to its device per add
        rows = [torch.from_numpy(np.ascontiguousarray(per_shard_data[i])).to(
            dev) for i, dev in enumerate(self.mesh)]
        kw = dict(
            efc=cfg.ef_construction, m=cfg.M, m_max0=cfg.M_max0,
            rev_cap=self.rev_cap, metric=cfg.metric,
            keep_pruned=cfg.keep_pruned_connections,
            extend=cfg.extend_candidates,
            heuristic=cfg.select == "heuristic",
            storage=cfg.storage,
        )
        max_levels = [int(x) for x in self._host_max_level]
        for ci in range(len(scheds[0])):
            vecs, lvls, start, count = [], [], [], []
            for i in range(s):
                d0, c = scheds[i][ci]
                ar = torch.arange(r, device=self.mesh[i])
                vecs.append(rows[i][(d0 + ar).clamp(max=max(todo[i] - 1, 0))]
                            if c else None)
                lv = np.zeros(r, np.int32)
                lv[:c] = per_shard_levels[i][d0:d0 + c]
                lvls.append(lv)
                start.append(int(self._shard_n[i]) + d0)
                count.append(c)
            max_levels = sharded_insert_round(
                graphs, vecs, lvls, start, count, self._banks, max_levels,
                **kw)
        for i in range(s):
            if todo[i]:
                lv_i = per_shard_levels[i]
                self._host_max_level[i] = max(
                    self._host_max_level[i], int(lv_i.max())
                )
                self._host_upper[i] += int((lv_i >= 1).sum())
        self._shard_n += todo
        self._packed_cache = None  # adjacency changed; repack lazily

    def set_ef(self, ef: int) -> None:
        self.ef = int(ef)

    def _packed_shards(self):
        """Lazy per-shard packed payloads (None when below threshold, no
        matmul metric form, or some shard lacks seed-bank entries)."""
        if self.get_current_count() < self.PACKED_THRESHOLD:
            return None
        if get_metric(self.space).matmul_score is None:
            return None
        if min(b.n for b in self._banks) <= 0:
            return None
        if self._packed_cache is None:
            self._packed_cache = sharded_pack(self._graphs, self.space)
        return self._packed_cache

    def knn_query(self, data, k: int = 1, ef: int | None = None,
                  max_iters: int | None = None, expand: int = 2,
                  rerank_k: int = 32, expand_schedule: tuple | None = None):
        """Returns (labels i64[Q, k], dists f32[Q, k]); -1 label on padding.
        The per-shard packed engine serves indexes of PACKED_THRESHOLD
        elements or more (expand / expand_schedule / rerank_k reach it),
        the classic engine everything else (seed-scan entry once every
        shard's bank holds a node, else greedy descent)."""
        graphs = self._require_init()
        data = np.atleast_2d(np.asarray(data, dtype=np.float32))
        q_n = data.shape[0]
        padded = np.zeros((_pad_batch(q_n), self.dim), np.float32)
        padded[:q_n] = data
        queries = torch.from_numpy(padded)
        ef = max(ef if ef is not None else self.ef, k)
        packs = self._packed_shards()
        if packs is not None:
            gids, d = sharded_knn_packed(
                graphs, packs, queries, k=k, ef=ef, metric=self.space,
                banks=self._banks, max_iters=max_iters, expand=expand,
                rerank_k=rerank_k, expand_schedule=expand_schedule)
        else:
            use_seeds = min(b.n for b in self._banks) > 0
            gids, d = sharded_knn(
                graphs, queries, k=k, ef=ef, metric=self.space,
                banks=self._banks if use_seeds else None,
                max_iters=max_iters)
        gids = gids.cpu().numpy()[:q_n]
        d = d.cpu().numpy()[:q_n]
        labels = np.where(gids >= 0, self._labels[np.maximum(gids, 0)], -1)
        return labels.astype(np.int64), d

    # -------------------------------------------------------------- mutation
    def _locate(self, label: int) -> tuple[int, int]:
        hits = np.where(self._labels == int(label))[0]
        if not hits.size:
            raise KeyError(f"label {label} not in index")
        gid = int(hits[0])
        return gid % self.n_shards, gid // self.n_shards

    def mark_deleted(self, label: int) -> None:
        """Tombstone (in place): traversed, never returned."""
        graphs = self._require_init()
        s, l = self._locate(label)
        graphs[s].deleted[l] = True

    def unmark_deleted(self, label: int) -> None:
        graphs = self._require_init()
        s, l = self._locate(label)
        graphs[s].deleted[l] = False

    # ------------------------------------------------------------ inspection
    def get_current_count(self) -> int:
        return int(self._shard_n.sum())

    def get_max_elements(self) -> int:
        return self.max_elements

    def get_ids_list(self) -> list[int]:
        return self._labels.tolist()

    def get_items(self, ids) -> np.ndarray:
        """Stored vectors as f32, gathered on the owning shard's device
        (only the requested rows come to the host)."""
        graphs = self._require_init()
        loc = np.array([self._locate(lab) for lab in np.atleast_1d(ids)],
                       np.int64).reshape(-1, 2)
        out = np.zeros((loc.shape[0], self.dim), np.float32)
        for s in np.unique(loc[:, 0]):
            at = np.nonzero(loc[:, 0] == s)[0]
            g = graphs[s]
            local = torch.from_numpy(loc[at, 1]).to(g.device)
            out[at] = gather_dequant(g.vectors, g.scales,
                                     local[None, :])[0].cpu().numpy()
        return out

    # ----------------------------------------------------------- checkpoints
    def save_index(self, path) -> None:
        """The JAX package's sharded file: every graph field stacked over
        the shards as `g_<field>` (bf16 rows as their raw 2-byte values),
        the seed banks' ids and counts, labels, host mirrors, the per-shard
        RNG states and `meta_json`."""
        graphs = self._require_init()
        meta = {
            "format_version": FORMAT_VERSION,
            "config": dataclasses.asdict(self.config),
            "n_shards": self.n_shards,
            "max_elements": self.max_elements,
            "round_size": self.round_size,
            "ef": self.ef,
            "rev_cap": self.rev_cap,
            "l_max": graphs[0].l_max_static,
        }
        per = [graph_to_numpy(g, bf16_bits=True) for g in graphs]
        arrays = {f"g_{name}": np.stack([p[name] for p in per])
                  for name in GraphTensors._fields}
        arrays.update(
            seed_bank=np.stack([b.ids.cpu().numpy() for b in self._banks]),
            seed_n=np.array([b.n for b in self._banks], np.int32),
            labels=self._labels,
            shard_n=self._shard_n,
            host_max_level=self._host_max_level,
            host_upper=self._host_upper,
            rng_keys=np.stack(
                [r.get_state()[1] for r in self._rngs]
            ),
            rng_rest=np.array(
                [[r.get_state()[2], r.get_state()[3], r.get_state()[4]]
                 for r in self._rngs], dtype=np.float64
            ),
            meta_json=np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8
            ),
        )
        # an open handle keeps save("x.bin") / load("x.bin") symmetric
        # (np.savez appends ".npz" to a bare name)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @torch.no_grad()
    def load_index(self, path, max_elements: int | None = None) -> None:
        """Load a sharded file of either package (format v1 files convert
        their dense upper layers); the file's shard count must equal this
        index's.  max_elements above the saved one resizes on load."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
            if meta["format_version"] > FORMAT_VERSION:
                raise ValueError("index file is newer than this library")
            if meta["n_shards"] != self.n_shards:
                raise ValueError(
                    f"index file has {meta['n_shards']} shards; this mesh "
                    f"has {self.n_shards} — shard counts must match"
                )
            cfg = HnswConfig(**meta["config"])
            if cfg.metric != self.space or cfg.dim != self.dim:
                raise ValueError("index file metric/dim mismatch")
            self.config = cfg
            self.max_elements = meta["max_elements"]
            self.round_size = meta["round_size"]
            self.ef = meta["ef"]
            self.rev_cap = meta["rev_cap"]
            self.per_shard_cap = -(-self.max_elements // self.n_shards)
            fields = {n: z[f"g_{n}"] for n in GraphTensors._fields
                      if f"g_{n}" in z}
            if "g_adj_upper" in z:  # format v1: dense upper layers, per shard
                dense = np.asarray(z["g_adj_upper"])  # [S, L, cap, M]
                per = [
                    _arena_from_dense(dense[i], fields["levels"][i],
                                      int(fields["n"][i]), cfg.M,
                                      self.per_shard_cap)
                    for i in range(self.n_shards)
                ]
                fields["adj_up"] = np.stack([p[0] for p in per])
                fields["up_base"] = np.stack([p[1] for p in per])
                fields["up_n"] = np.array([p[2] for p in per], np.int32)
                l_max = per[0][3]
            else:
                l_max = meta["l_max"]
            self._graphs = [
                graph_from_numpy({n: a[i] for n, a in fields.items()},
                                 l_max, dev)
                for i, dev in enumerate(self.mesh)
            ]
            self._packed_cache = None
            bank_ids, bank_n = z["seed_bank"], z["seed_n"]
            self._banks = []
            for i, dev in enumerate(self.mesh):
                bank = SeedBank.empty(bank_ids.shape[1], self.dim, dev)
                bank.ids.copy_(torch.from_numpy(bank_ids[i]))
                bank.n = int(bank_n[i])
                self._banks.append(bank)
            self._rebuild_seed_cache()
            self._labels = np.asarray(z["labels"])
            self._shard_n = np.asarray(z["shard_n"]).copy()
            self._host_max_level = np.asarray(z["host_max_level"]).copy()
            self._host_upper = np.asarray(z["host_upper"]).copy()
            self._rngs = []
            for i in range(self.n_shards):
                r = np.random.RandomState()
                pos, hg, g = z["rng_rest"][i]
                r.set_state(("MT19937", z["rng_keys"][i].astype(np.uint32),
                             int(pos), int(hg), float(g)))
                self._rngs.append(r)
        if max_elements is not None and max_elements > self.max_elements:
            self.resize_index(max_elements)

    @torch.no_grad()
    def resize_index(self, new_max_elements: int) -> None:
        """Grow capacity in place (every shard's tensors re-padded)."""
        graphs = self._require_init()
        if new_max_elements < self.get_current_count():
            raise ValueError("cannot shrink below current element count")
        per_shard = -(-new_max_elements // self.n_shards)
        rows = per_shard + self.round_size + 1
        old_cap = graphs[0].n_cap
        new_cap = capacity(rows)
        if new_cap < old_cap:
            self.max_elements = new_max_elements
            self.per_shard_cap = per_shard
            return  # padded capacity already sufficient
        grow = new_cap - old_cap
        t_grow = max(arena_capacity(rows, self.config.M) - graphs[0].t_cap, 0)
        l_max = max(self.config.derived_max_level(rows), graphs[0].l_max)
        self._graphs = [grow_graph(g, grow, t_grow, l_max) for g in graphs]
        self._packed_cache = None
        # the seed bank's capacity may need to grow with n_cap
        u_new = seed_capacity(new_cap, self.config.M)
        u_old = self._banks[0].ids.shape[0]
        if u_new > u_old:
            for bank in self._banks:
                bank.ids = torch.cat(
                    [bank.ids, bank.ids.new_full((u_new - u_old,), -1)])
            self._rebuild_seed_cache()
        self.max_elements = new_max_elements
        self.per_shard_cap = per_shard

    def _rebuild_seed_cache(self) -> None:
        """Recompute every bank's bf16 rows and norms from the stored
        vectors (after load and resize); empty slots hold zeros."""
        for g, bank in zip(self._graphs, self._banks):
            seeds = seed_index_from_bank(g, bank.ids, bank.n,
                                         self.config.metric)
            live = bank.ids >= 0
            bank.vecs = torch.where(live[:, None], seeds.vecs, 0)
            bank.norms = torch.where(live, seeds.norms, 0.0)
