"""The port's public API as the drivers call it: an hnswlib-shaped `Index`
or `FlatIndex` made and filled from host arrays, and the operating point of
an engine as `knn_query` arguments, both read from the configuration."""

from __future__ import annotations

import numpy as np


def new_index(run, kind: str):
    """An empty `Index` (kind "Index") or `FlatIndex` sized for the
    configuration's rows, as a user opens one."""
    from ocaml_hnsw_tpu_torch import FlatIndex, Index

    cfg = run.cfg
    if kind == "Index":
        index = Index(cfg["metric"], cfg["dim"], device=run.device)
        index.init_index(max_elements=cfg["n"], M=cfg["M"],
                         ef_construction=cfg["ef_construction"],
                         random_seed=cfg["random_seed"])
    elif kind == "FlatIndex":
        flat = cfg["engines"]["flat"]
        index = FlatIndex(cfg["metric"], cfg["dim"], device=run.device)
        index.init_index(max_elements=cfg["n"], rerank_k=flat["rerank_k"],
                         scan_dtype=flat["scan_dtype"],
                         rerank_dtype=flat["rerank_dtype"])
    else:
        raise ValueError(f"unknown index kind {kind!r}")
    return index


def query_kwargs(run, engine: str) -> dict:
    """`knn_query` keyword arguments of the engine's operating point."""
    op = run.cfg["engines"][engine]
    if engine == "packed":
        return dict(k=run.k, engine="packed", ef=op["ef"],
                    max_iters=op["max_iters"], rerank_k=op["rerank_k"],
                    expand=op["expand"], interleave=op["interleave"])
    if engine == "flat":
        return dict(k=run.k, rerank_k=op["rerank_k"])
    raise ValueError(f"unknown engine {engine!r}")


class Answers:
    """Every answer a run returned: the pool index of each query, its labels
    and its distances."""

    def __init__(self):
        self.idx, self.labels, self.dists = [], [], []

    def add(self, idx: np.ndarray, labels: np.ndarray, dists: np.ndarray):
        self.idx.append(idx)
        self.labels.append(np.asarray(labels, dtype=np.int32))
        self.dists.append(np.asarray(dists, dtype=np.float32))

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self.idx:
            raise RuntimeError("no answers were returned")
        return (np.concatenate(self.idx), np.concatenate(self.labels),
                np.concatenate(self.dists))
