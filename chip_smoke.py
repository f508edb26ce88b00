"""Smoke run of the torch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain torch version at main-path shapes, then drives
the main path at full SIFT1M scale (1M x 128-d, L2, M=16) through the public
API — `Index.add_items` (bulk build) and `Index.knn_query` (packed engine) —
and checks recall@10 against exact ground truth computed on the card.

    python3 chip_smoke.py

Exits non-zero, printing no result, when no CUDA device is available.  The
last line of stdout is {"ok": true, "device": {...}}; the line before it
lists each kernel with its launches on the main path, its largest
difference from the plain version, and both versions' median times.
"""

from __future__ import annotations

import json
import logging
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ocaml_hnsw_tpu_torch import Index
from ocaml_hnsw_tpu_torch.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu_torch.models.packed import PackedGraph, quantize_queries
from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import (
    gather_dists, gather_dists_plain,
)
from ocaml_hnsw_tpu_torch.ops.kernels.payload_score import (
    packed_score, packed_score_plain,
)
from ocaml_hnsw_tpu_torch.ops.quantize import quantize_rows

N, DIM, M, EFC = 1_000_000, 128, 16, 200
N_QUERIES, QPS_BATCH = 1000, 8192
#: the JAX harness's first packed operating point (ef, max_iters, rerank_k,
#: expand, interleave); knn_query's own defaults differ
QUERY_KNOBS = dict(k=10, ef=64, max_iters=29, rerank_k=32, expand=2,
                   interleave=2)
RECALL_FLOOR = 0.90
K2_RTOL = K2_ATOL = 1e-5  # summation order differs (warp tree vs torch)
K1_RTOL = 1e-6  # the int32 dot is exact; both epilogues round alike


def say(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; count {torch.cuda.device_count()}")
    say(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build_kernels() -> None:
    t0 = time.perf_counter()
    path = _lib.build()
    _lib.library()
    say(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")


def check_gather_dists(data: np.ndarray) -> dict:
    """K2 against its plain version at B=8192, K in {8, 32, 97}, every
    storage dtype, l2 and ip, with -1 ids; rows from the main-path data."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(3)
    x = torch.from_numpy(data).to(dev)
    xn = x / torch.linalg.norm(x, dim=1, keepdim=True)
    q = torch.from_numpy(queries_like(data, QPS_BATCH, seed=11)).to(dev)
    qn = q / torch.linalg.norm(q, dim=1, keepdim=True)
    worst, timing = 0.0, None
    for metric, rows, qq in (("l2", x, q), ("ip", xn, qn)):
        for storage in ("f32", "bf16", "int8"):
            vec, scales, _ = quantize_rows(rows, storage)
            for k in (8, 32, 97):
                ids = gen.integers(-1, N, size=(QPS_BATCH, k)).astype(np.int32)
                ids[:, 0] = -1
                ids_t = torch.from_numpy(ids).to(dev)
                out = gather_dists(vec, scales, qq, ids_t, metric)
                ref = gather_dists_plain(vec, scales, qq, ids_t, metric)
                torch.cuda.synchronize()
                torch.testing.assert_close(out, ref, rtol=K2_RTOL,
                                           atol=K2_ATOL)
                fin = torch.isfinite(ref)
                err = float((out[fin] - ref[fin]).abs().max())
                worst = max(worst, err)
                if (metric, storage, k) == ("l2", "f32", 32):  # rerank shape
                    timing = (
                        median_ms(lambda: gather_dists(vec, scales, qq,
                                                       ids_t, metric)),
                        median_ms(lambda: gather_dists_plain(
                            vec, scales, qq, ids_t, metric)),
                    )
    say(f"[K2 gather_dists] 18 cases agree (rtol=atol={K2_RTOL}); "
        f"max |err| {worst:.3e}; B={QPS_BATCH} K=32 f32 l2: kernel "
        f"{timing[0]:.4f} ms, plain {timing[1]:.4f} ms")
    return dict(max_abs_err=worst, ms=timing[0], plain_ms=timing[1])


def check_packed_score(packed: PackedGraph, queries: np.ndarray) -> dict:
    """K1 against its plain version at the main-path shape (B=8192, E=2)
    on the index's own payload."""
    dev = packed.pay.device
    gen = np.random.default_rng(4)
    nodes = gen.integers(-1, N, size=(QPS_BATCH, 2)).astype(np.int32)
    nodes_t = torch.from_numpy(nodes).to(dev)
    q = torch.from_numpy(queries).to(dev)
    q8 = quantize_queries(q, packed.scale)
    q8 = torch.nn.functional.pad(q8, (0, packed.d_pad - q8.shape[1]))
    qn = torch.sum(q * q, dim=1)
    args = (nodes_t, packed.meta, packed.pay, q8, qn, packed.scale, True)
    ids, d = packed_score(*args)
    ids_ref, d_ref = packed_score_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(ids, ids_ref):
        raise AssertionError("packed_score: candidate ids differ from plain")
    torch.testing.assert_close(d, d_ref, rtol=K1_RTOL, atol=0.0)
    fin = torch.isfinite(d_ref)
    err = float((d[fin] - d_ref[fin]).abs().max())
    ms = median_ms(lambda: packed_score(*args))
    plain = median_ms(lambda: packed_score_plain(*args))
    say(f"[K1 packed_score] B={QPS_BATCH} E=2 deg={packed.deg} "
        f"d_pad={packed.d_pad}: ids equal, max |err| {err:.3e} "
        f"(rtol {K1_RTOL}); kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain)


def ground_truth(x: torch.Tensor, q: torch.Tensor, k: int) -> np.ndarray:
    """Exact l2 kNN in f32 on the card: matrix-form shortlist of 64, then
    an exact (x - q)² re-rank."""
    xn = torch.sum(x * x, dim=1)
    qn = torch.sum(q * q, dim=1)
    d = qn[:, None] - 2.0 * (q @ x.T) + xn[None, :]
    cand = torch.topk(d, 64, dim=1, largest=False).indices
    exact = torch.sum((x[cand] - q[:, None, :]) ** 2, dim=-1)
    order = torch.argsort(exact, dim=1, stable=True)[:, :k]
    return torch.gather(cand, 1, order).cpu().numpy()


def main() -> int:
    name, smi = phase_device()
    logging.basicConfig(stream=sys.stdout, level=logging.WARNING,
                        format="[%(name)s] %(message)s")
    logging.getLogger("ocaml_hnsw_tpu_torch").setLevel(logging.INFO)
    phase_build_kernels()

    t0 = time.perf_counter()
    data = clustered(N, DIM, n_clusters=400, seed=7)
    queries = queries_like(data, N_QUERIES, seed=8)
    qps_queries = queries_like(data, QPS_BATCH, seed=9)
    say(f"[data] clustered {N}x{DIM} + queries in "
        f"{time.perf_counter() - t0:.1f} s (host)")

    k2 = check_gather_dists(data)

    # ---- main path: bulk build + packed query through the public API
    index = Index("l2", DIM, device="cuda")
    index.init_index(max_elements=N, M=M, ef_construction=EFC)
    torch.cuda.reset_peak_memory_stats()
    gather_dists.launches = 0
    packed_score.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.add_items(data)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels, dists = index.knn_query(queries, **QUERY_KNOBS)
    query_s = time.perf_counter() - t0  # includes the one-off payload pack
    launches = {"gather_dists": gather_dists.launches,
                "packed_score": packed_score.launches}
    say(f"[main] launches during build+query: {json.dumps(launches)}")
    say(f"[main] build {build_s:.2f} s = {N / build_s:.0f} vectors/s; first "
        f"query batch (incl. payload pack) {query_s:.2f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{smi}]")

    # ---- correctness of what came out
    k = QUERY_KNOBS["k"]
    if labels.shape != (N_QUERIES, k) or dists.shape != (N_QUERIES, k):
        raise AssertionError(f"bad result shapes {labels.shape} {dists.shape}")
    if not np.isfinite(dists).all() or (labels < 0).any():
        raise AssertionError("non-finite distances or missing results")
    if (np.diff(dists, axis=1) < 0).any():
        raise AssertionError("distances not ascending")
    dev = torch.device("cuda")
    x = torch.from_numpy(data).to(dev)
    q = torch.from_numpy(queries).to(dev)
    exact = torch.sum(
        (x[torch.from_numpy(labels).to(dev)] - q[:, None, :]) ** 2, dim=-1)
    np.testing.assert_allclose(dists, exact.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    gt = ground_truth(x, q, k)
    del x
    rec = float(np.mean([len(set(a) & set(b)) / k
                         for a, b in zip(labels.tolist(), gt.tolist())]))
    say(f"[main] recall@{k} {rec:.4f} over {N_QUERIES} queries "
        f"(floor {RECALL_FLOOR}); knobs {json.dumps(QUERY_KNOBS)}")
    if rec < RECALL_FLOOR:
        raise AssertionError(f"recall@{k} {rec:.4f} < {RECALL_FLOOR}")

    # ---- throughput: 8192-query batches through knn_query
    index.knn_query(qps_queries, **QUERY_KNOBS)  # warm-up
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        index.knn_query(qps_queries, **QUERY_KNOBS)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    say(f"[main] QPS {QPS_BATCH / med:.0f} (median of 5 batches of "
        f"{QPS_BATCH}: {med * 1e3:.1f} ms) [{smi}]")

    # ---- K1 on the index's own 1M payload, at the main-path shape
    k1 = check_packed_score(index._packed_index(), qps_queries)

    for kern, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kern} was not launched on the main path")
    record = {"kernels": [
        dict(name="packed_score", route="cuda",
             source="ocaml_hnsw_tpu_torch/csrc/payload_score.cu",
             replaces="ocaml_hnsw_tpu/ops/pallas/payload_score.py:114",
             launches=launches["packed_score"], **k1),
        dict(name="gather_dists", route="cuda",
             source="ocaml_hnsw_tpu_torch/csrc/gather_dist.cu",
             replaces="ocaml_hnsw_tpu/ops/pallas/gather_dist.py:65",
             launches=launches["gather_dists"], **k2),
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
