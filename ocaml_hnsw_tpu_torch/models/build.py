"""Index construction, ported from `ocaml_hnsw_tpu/models/build.py`
for the bulk first-add path: level sampling (`sample_levels`, the same NumPy
stream as the JAX package and the oracle), the vectorized Alg-4 admit loop
(`heuristic_admit`), `compact_by_mask`, and a `BuildState` whose first large
add goes through `models/bulk.py::bulk_build`.

Every add that the JAX package would send to its incremental insert rounds
raises NotImplementedError here: the incremental build is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, capacity, empty_graph,
)
from ocaml_hnsw_tpu_torch.ops.distance import INF


# --------------------------------------------------------------------- levels
def sample_levels(rng: np.random.RandomState, n: int, m_l: float, cap: int):
    """level = ⌊−ln(U(0,1))·mL⌋ (Alg 1), same RNG stream as the oracle."""
    u = rng.uniform(size=n)
    return np.minimum((-np.log(1.0 - u) * m_l).astype(np.int32), cap)


# ------------------------------------------------------- heuristic (Alg 4)
def heuristic_admit(cand_d, pair_d, valid, m: int, keep_pruned: bool,
                    scan_limit: int | None = None):
    """Vectorized SELECT-NEIGHBORS-HEURISTIC admit loop.

    cand_d: f32[B, K] distances to the query point, sorted ascending.
    pair_d: f32[B, Ke, Ke] pairwise distances among the first Ke candidates.
    Admit candidate j iff it is strictly closer to the query than to every
    already-admitted candidate, in sequential candidate order.  scan_limit
    caps the candidate rank eligible for admission; the keep_pruned backfill
    still sees all K candidates.  Returns bool[B, K]."""
    b, k = cand_d.shape
    ke = pair_d.shape[1]
    depth = ke if scan_limit is None else min(ke, scan_limit)
    sel = torch.zeros((b, ke), dtype=torch.bool, device=cand_d.device)
    cnt = torch.zeros((b,), dtype=torch.int32, device=cand_d.device)
    for j in range(depth):
        dmin = torch.amin(torch.where(sel, pair_d[:, j, :], INF), dim=1)
        admit = valid[:, j] & (cnt < m) & (cand_d[:, j] < dmin)
        sel[:, j] = admit
        cnt += admit.to(torch.int32)
    if ke < k:
        sel = torch.nn.functional.pad(sel, (0, k - ke))
    if keep_pruned:  # Alg 4 keepPrunedConnections: backfill nearest rejected
        free = m - cnt
        rej = valid & ~sel
        rank = torch.cumsum(rej.to(torch.int32), dim=1)
        sel = sel | (rej & (rank <= free[:, None]))
    return sel


def compact_by_mask(ids, d, mask, m: int):
    """Pack masked entries left (stable) and truncate/pad to width m.

    The JAX package runs this as a bitonic network keyed by column index;
    the keys of kept entries are distinct, so any stable compaction gives
    the same result, and a stable sort is one launch instead of ~28 stages."""
    k = ids.shape[1]
    key = torch.where(mask, torch.arange(k, device=ids.device)[None, :], k + 1)
    order = torch.sort(key, dim=1, stable=True).indices
    w = min(m, k)
    order = order[:, :w]
    ok = torch.gather(mask, 1, order)
    out_ids = torch.where(ok, torch.gather(ids, 1, order), -1)
    out_d = torch.where(ok, torch.gather(d, 1, order), INF)
    if m > k:
        out_ids = torch.nn.functional.pad(out_ids, (0, m - k), value=-1)
        out_d = torch.nn.functional.pad(out_d, (0, m - k), value=INF)
    return out_ids, out_d


# ---------------------------------------------------------------- BuildState
class BuildState:
    """Host-side build state: owns the RNG stream (level sampling is the
    only randomness) and the graph.  Only the bulk first add is ported."""

    # first add() of at least this many rows into an EMPTY index takes the
    # bulk constructor (models/bulk.py); the same policy as the JAX package
    BULK_THRESHOLD = 100_000
    #: transient-workspace budget for the bulk passes (the JAX package's
    #: value, whose formula `bulk_workspace_bytes` is shared)
    BULK_BUDGET_BYTES = 8 << 30

    def __init__(self, config: HnswConfig, max_elements: int,
                 round_size: int = 1024,
                 device: torch.device | str = "cuda"):
        self.config = config
        self.round_size = round_size
        self.device = torch.device(device)
        # headroom as in the JAX package: one padded round may run past
        # max_elements, and the last row is the scatter sink
        self.max_elements = max_elements
        self.graph = empty_graph(config, max_elements + round_size + 1,
                                 self.device)
        self.l_max = self.graph.l_max
        self.rng = np.random.RandomState(config.seed)
        self.host_n = 0
        self.host_max_level = -1
        self.host_up_n = 0

    def _bulk_eligible(self, n_new: int) -> bool:
        cfg = self.config
        if self.host_n or n_new < self.BULK_THRESHOLD:
            return False
        # bulk passes run at index capacity: a sparse first add would pay
        # ~capacity/n_new extra compute
        if 2 * n_new < self.max_elements:
            return False
        if cfg.select != "heuristic" or cfg.extend_candidates:
            return False
        from ocaml_hnsw_tpu_torch.models.bulk import bulk_workspace_bytes

        n_cap = capacity(self.max_elements + self.round_size + 1)
        need = bulk_workspace_bytes(n_cap, cfg.dim, m=cfg.M,
                                    m_max0=cfg.M_max0)
        return need < self.BULK_BUDGET_BYTES

    def adopt_graph(self, graph: GraphTensors) -> None:
        """Install a built graph and rebuild the host-side mirrors."""
        self.graph = graph
        n = int(graph.n)
        lv = graph.levels[:n].cpu().numpy()
        self.host_n = n
        self.host_max_level = int(lv.max()) if n else -1
        self.host_up_n = int(graph.up_n)

    def prep(self, data):
        """Normalize at add time (cosine-style metrics)."""
        from ocaml_hnsw_tpu_torch.ops.metrics import get_metric

        normalize = get_metric(self.config.metric).normalize_add
        if isinstance(data, torch.Tensor):
            if normalize:
                from ocaml_hnsw_tpu_torch.models.search import normalize_rows

                data = normalize_rows(data.float())
            return data
        data = np.asarray(data, dtype=np.float32)
        if normalize:
            nrm = np.linalg.norm(data, axis=1, keepdims=True)
            data = data / np.where(nrm == 0, 1.0, nrm)
        return data

    def add(self, data) -> None:
        """Insert `data` (host numpy or a tensor).  A first add that fills
        most of an empty index is built by `bulk_build`; any other add needs
        the incremental builder, which is not ported yet."""
        n_new = data.shape[0]
        if self.host_n + n_new > self.max_elements:
            raise RuntimeError(
                f"index is full: {self.host_n} + {n_new} > "
                f"max_elements {self.max_elements}"
            )
        if not self._bulk_eligible(n_new):
            raise NotImplementedError("incremental build: later PR")
        data = self.prep(data)
        levels = sample_levels(self.rng, n_new, self.config.mL, self.l_max)
        # levels come from THIS state's stream, so the stream position after
        # the call matches the JAX package's
        from ocaml_hnsw_tpu_torch.models.bulk import bulk_build

        graph = bulk_build(
            data, self.config,
            max_elements=self.max_elements + self.round_size + 1,
            levels=levels, device=self.device,
        )
        self.adopt_graph(graph)
