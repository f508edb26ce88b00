"""Index checkpointing, the port of `ocaml_hnsw_tpu/io.py`: save/load of the
whole index as one `.npz` in the JAX package's format (v2: compact upper
arena; v1 files with dense upper layers convert on load).

Vectors, adjacency, entry point, levels, tombstones, labels, the config and
the RNG state (`rng_keys`/`rng_rest`, so an add after a load continues the
level-sampling stream) all go in the file, with the JAX package's names and
dtypes, so a file written by either package loads in the other.  numpy has
no bfloat16: bf16 vectors are written as their raw 2-byte values (numpy
dtype V2, which is what `np.save` makes of the JAX package's bfloat16
arrays) and read back by the same bits.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models.graph import (
    GraphTensors, arena_capacity, graph_from_numpy, graph_to_numpy,
)

FORMAT_VERSION = 2


def _arena_from_dense(adj_upper, levels, n, m, max_elements):
    """Convert a v1 dense [l_max, N_cap, M] upper-adjacency stack into the
    compact-arena layout (insertion-order row allocation)."""
    l_max = adj_upper.shape[0]
    t_cap = arena_capacity(max_elements, m)
    adj_up = np.full((t_cap, adj_upper.shape[2]), -1, np.int32)
    up_base = np.full((levels.shape[0],), -1, np.int32)
    up_n = 0
    for i in range(n):
        lvl = int(levels[i])
        if lvl >= 1:
            up_base[i] = up_n
            for lc in range(1, lvl + 1):
                adj_up[up_n + lc - 1] = adj_upper[lc - 1, i]
            up_n += lvl
    return adj_up, up_base, up_n, l_max


def save_index_file(path, graph: GraphTensors, config: HnswConfig,
                    labels: np.ndarray, rng_state=None,
                    max_elements: int | None = None, ef: int = 10) -> None:
    meta = {
        "format_version": FORMAT_VERSION,
        "config": dataclasses.asdict(config),
        "max_elements": int(max_elements or graph.n_cap),
        "ef": int(ef),  # query-time ef persists across save/load
    }
    arrays = graph_to_numpy(graph, bf16_bits=True)
    arrays["l_max"] = np.asarray(graph.l_max_static)
    arrays["labels"] = np.asarray(labels, dtype=np.int64)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                        dtype=np.uint8)
    if rng_state is not None:
        # RandomState.get_state() = (name, keys[624] u32, pos, has_gauss, gauss)
        _, keys, pos, has_gauss, gauss = rng_state
        arrays["rng_keys"] = keys
        arrays["rng_rest"] = np.array([pos, has_gauss, gauss],
                                      dtype=np.float64)
    # an open handle keeps save("idx.bin") / load("idx.bin") symmetric
    # (np.savez appends ".npz" to a bare name)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_index_file(path, device: torch.device | str = "cuda"):
    """Returns (graph on `device`, config, labels, rng_state, max_elements,
    ef)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
        if meta["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"index file format {meta['format_version']} is newer than "
                f"this library supports ({FORMAT_VERSION})"
            )
        config = HnswConfig(**meta["config"])
        arrays = {f: z[f] for f in GraphTensors._fields
                  if f not in ("adj_up", "up_base", "up_n")}
        if "adj_upper" in z:  # format v1: dense [l_max, N_cap, M] layers
            adj_up, up_base, up_n, l_max = _arena_from_dense(
                np.asarray(z["adj_upper"]), np.asarray(z["levels"]),
                int(z["n"]), config.M, meta["max_elements"],
            )
        else:
            adj_up, up_base = z["adj_up"], z["up_base"]
            up_n, l_max = int(z["up_n"]), int(z["l_max"])
        arrays.update(adj_up=adj_up, up_base=up_base,
                      up_n=np.asarray(up_n, dtype=np.int32))
        graph = graph_from_numpy(arrays, l_max, device)
        labels = np.asarray(z["labels"])
        rng_state = None
        if "rng_keys" in z:
            pos, has_gauss, gauss = z["rng_rest"]
            rng_state = ("MT19937", np.asarray(z["rng_keys"], dtype=np.uint32),
                         int(pos), int(has_gauss), float(gauss))
        return (graph, config, labels, rng_state, meta["max_elements"],
                meta.get("ef", 10))
