"""Benchmark harness, the port of `ocaml_hnsw_tpu/bench/harness.py`: the
ann-benchmarks protocol on a synthetic stand-in dataset made on the device —
build (timed), exact ground truth, recall@k sweep, QPS at the target recall.
Returns one structured dict per run, with the JAX harness's keys.

Two engines are measured, the HNSW graph index and the flat scan
(models/flat.py); the headline is the faster one that meets the recall
target, and both results are reported.  `run_streaming_config` measures
ingest and queries interleaved on one device.

Every entry point takes `device="cuda"` and raises when there is no CUDA
device (tests pass `device="cpu"`).  All timed regions begin and end with a
device synchronize, and the query knobs are passed explicitly: they are the
harness's operating points, not `Index.knn_query`'s defaults.  Eager torch
compiles nothing, so there is no untimed warm-up build: the CUDA kernels
are built and cuBLAS is initialised once before the first timed region.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ocaml_hnsw_tpu_torch.api import _resolve_device
from ocaml_hnsw_tpu_torch.bench import datasets
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models.build import BuildState
from ocaml_hnsw_tpu_torch.models.flat import (
    FlatTensors, empty_flat, flat_add, flat_search,
)
from ocaml_hnsw_tpu_torch.models.search import (
    build_seed_index, knn_search, normalize_rows, preprocess_queries,
)
from ocaml_hnsw_tpu_torch.ops.distance import INF, require_full_f32_matmul
from ocaml_hnsw_tpu_torch.ops.metrics import get_metric
from ocaml_hnsw_tpu_torch.utils.profiling import sync


def recall_of(found_ids, true_ids) -> float:
    """recall@k = |found ∩ true| / (k · Q) (ann-benchmarks protocol)."""
    found_ids, true_ids = np.asarray(found_ids), np.asarray(true_ids)
    if found_ids.shape[0] != true_ids.shape[0]:
        raise ValueError("recall_of: row counts differ")
    k = true_ids.shape[1]
    hits = sum(len(set(f) & set(t))
               for f, t in zip(found_ids.tolist(), true_ids.tolist()))
    return hits / (k * true_ids.shape[0])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _warm_device(dev: torch.device) -> None:
    """Build and load the CUDA kernels and initialise cuBLAS, so that no
    timed region pays for either.  Also checks that f32 products are true
    f32 (the ground truth and the exact scan depend on it)."""
    require_full_f32_matmul(dev)
    if dev.type != "cuda":
        return
    from ocaml_hnsw_tpu_torch.ops.kernels import _lib

    _lib.library()
    a = torch.ones((64, 64), device=dev)
    (a @ a).sum().item()


def build_flat(data, metric: str, scan_dtype: str = "bf16",
               rerank_dtype: str = "f32",
               device: torch.device | str = "cuda") -> FlatTensors:
    """Load a dataset (host numpy, or a tensor already on the device) into
    FlatTensors on `device`, 262144 rows at a time."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.asarray(data, dtype=np.float32))
    n = data.shape[0]
    normalize = get_metric(metric).normalize_add
    flat = empty_flat(data.shape[1], n, scan_dtype=scan_dtype,
                      rerank_dtype=rerank_dtype, device=device)
    chunk = 262144
    for i in range(0, n, chunk):
        rows = data[i:i + chunk].to(flat.device, torch.float32)
        if normalize:
            rows = normalize_rows(rows)
        flat_add(flat, rows, i, rows.shape[0])
    return flat


def _gt_slab(src, qc, k: int, metric: str, start: int, n_slab: int):
    """Exact top-k of one query chunk against one slab of rows, in full f32.

    `src` is either FlatTensors (rows = its rerank matrix, tombstones
    honoured) or a raw [N, D] row matrix (rows normalized here for cosine).
    The raw f32 dataset keeps the ground truth exact even when the serving
    engine stores bf16 or int8 rows: a ground truth from rounded rows
    mislabels some true neighbours and caps the measured recall."""
    m = get_metric(metric)
    q = preprocess_queries(qc, metric)
    raw = isinstance(src, torch.Tensor)
    rows = (src if raw else src.rerank)[start:start + n_slab].float()
    if raw and m.normalize_add:
        rows = normalize_rows(rows)
    if m.matmul_score is not None:
        dot = torch.matmul(q, rows.T)
        nn = torch.sum(rows * rows, dim=1) if m.needs_norms \
            else torch.zeros((rows.shape[0],), device=rows.device)
        d = m.matmul_score(dot, nn[None, :])
    else:
        d = m.pair_dist(rows[None], q)  # the exact form, over the slab
    if not raw:
        ids_global = torch.arange(start, start + n_slab, device=rows.device)
        live = (ids_global < src.n) & ~src.deleted[start:start + n_slab]
        d = torch.where(live[None, :], d, INF)
    d, idx = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
    return idx + start, d


@torch.no_grad()
def device_ground_truth(src, queries, k: int, metric: str, chunk: int = 256,
                        n_slab: int = 1 << 20) -> np.ndarray:
    """Exact kNN on the device, chunked over queries and over slabs of rows
    so the [chunk, slab] score matrix stays near 1 GB (10M-row configs).

    `src`: FlatTensors, or the raw f32 [N, D] dataset as a tensor (see
    `_gt_slab`); queries go to its device.  Returns int32 ids [Q, k]."""
    require_full_f32_matmul(src.device)
    queries = torch.as_tensor(queries, dtype=torch.float32).to(src.device)
    n_cap = src.shape[0] if isinstance(src, torch.Tensor) else src.n_cap
    n_slab = min(n_slab, n_cap)
    out = []
    for i in range(0, queries.shape[0], chunk):
        qc = queries[i:i + chunk]
        slabs = [_gt_slab(src, qc, k, metric, start,
                          min(n_slab, n_cap - start))
                 for start in range(0, n_cap, n_slab)]
        all_ids = torch.cat([s[0] for s in slabs], dim=1)
        all_d = torch.cat([s[1] for s in slabs], dim=1)
        idx = torch.topk(all_d, k, dim=1, largest=False).indices
        out.append(_host(torch.gather(all_ids, 1, idx)).astype(np.int32))
    return np.concatenate(out)


def measure_qps(search_fn, queries, batch: int = 4096, warmup: int = 2,
                reps: int = 10) -> float:
    """Steady-state throughput of `search_fn(q_batch) -> ids`: the queries (a
    tensor on the device under test) tiled to one whole batch, `warmup`
    untimed calls, then `reps` calls between two device synchronizes, so the
    clock reads the device's work and not the enqueue.  No host-to-device
    copy is inside the loop.

    reps=10: QPS is a steady-state metric, and short runs under-measure it
    (the first dispatch's host cost and the final synchronize are edge
    effects that longer runs amortize)."""
    q = torch.as_tensor(queries)
    while q.shape[0] < batch:
        q = torch.cat([q, q])
    q = q[:batch].contiguous()
    for _ in range(warmup):
        search_fn(q)
    sync(q)
    t0 = time.perf_counter()
    for _ in range(reps):
        search_fn(q)
    sync(q)
    dt = time.perf_counter() - t0
    return batch * reps / dt


def run_streaming_config(
    name: str,
    n: int,
    dim: int,
    metric: str,
    n_queries: int = 1000,
    k: int = 10,
    M: int = 16,
    ef_construction: int = 200,
    round_size: int = 2048,
    # (ef, max_iters) operating points measured side by side during ingest
    # (each step times one query batch per setting); the headline row is the
    # cheapest whose end-state recall meets target_recall
    settings=((96, 16), (128, 24), (160, 32), (224, 48), (320, 80)),
    target_recall: float = 0.95,
    warm_frac: float = 0.5,
    n_steps: int = 10,
    qps_batch: int = 4096,
    seed: int = 7,
    storage: str = "f32",
    data_dtype: str = "f32",
    verbose: bool = True,
    device: torch.device | str = "cuda",
) -> dict:
    """Streaming ingest: interleaved timed insert rounds and query batches
    on one device.  Reports, per (ef, max_iters) setting, sustained query
    QPS during ingest and end-state recall; the headline is the cheapest
    setting meeting the recall target (or the best recall achieved if none
    does, reported as such).

    storage / data_dtype: the memory plan of the largest run — the dataset
    made as bf16 slabs and int8 rows in the graph (build and query cast per
    round; the ground truth stays exact, from the source rows in f32)."""
    dev = _resolve_device(device)

    def log(msg):
        if verbose:
            print(f"[stream:{name}] {msg}", flush=True)

    _warm_device(dev)
    log("generating dataset on device")
    data, make_q = datasets.clustered_device(
        n, dim, n_clusters=max(64, n // 2500), seed=seed,
        dtype=torch.bfloat16 if data_dtype == "bf16" else None, device=dev,
    )
    queries = make_q(n_queries, qseed=seed + 1)
    qb = queries
    while qb.shape[0] < qps_batch:
        qb = torch.cat([qb, qb])
    qb = qb[:qps_batch].contiguous()

    # exact ground truth up front, from the raw source rows
    log("computing exact ground truth on device")
    gt = device_ground_truth(data, queries, k, metric)

    cfg = HnswConfig(dim=dim, metric=metric, M=M,
                     ef_construction=ef_construction, storage=storage)
    state = BuildState(cfg, n, round_size=round_size, device=dev)
    n_warm = int(n * warm_frac)
    sync(data)
    t0 = time.perf_counter()
    # the warm build in slices of 500k rows: each add copies its slice as f32
    warm_chunk = 500_000
    for lo in range(0, n_warm, warm_chunk):
        state.add(data[lo: min(lo + warm_chunk, n_warm)])
    sync(state.graph)
    warm_s = time.perf_counter() - t0
    log(f"warm build {n_warm} in {warm_s:.1f}s = {n_warm/warm_s:.0f} vps")

    step_n = (n - n_warm) // n_steps
    ins_s = 0.0
    q_s = {s: 0.0 for s in settings}
    q_done = {s: 0 for s in settings}
    compact = 3 * (4 * cfg.M_max0) // 4 if cfg.M_max0 * 4 >= 128 else None
    for i in range(n_steps):
        lo = n_warm + i * step_n
        t0 = time.perf_counter()
        state.add(data[lo: lo + step_n])
        sync(state.graph)
        ins_s += time.perf_counter() - t0
        seeds = build_seed_index(state.graph, metric)
        for s in settings:
            ef, mi = s
            sync(qb)
            t0 = time.perf_counter()
            knn_search(state.graph, qb, k=k, ef=ef, metric=metric,
                       max_iters=mi, seeds=seeds, compact_k=compact)
            sync(qb)
            dt = time.perf_counter() - t0
            # the first step's batch carries one-off costs (allocator
            # growth); it stays out of the sustained number, as in the JAX
            # harness, where it paid the compile
            if i > 0:
                q_s[s] += dt
                q_done[s] += qps_batch
        log(f"step {i}: +{step_n} in {ins_s:.1f}s cum")

    # end-state recall per setting against the precomputed ground truth
    seeds = build_seed_index(state.graph, metric)
    sweep = []
    chosen = None
    for s in settings:
        ef, mi = s
        ids, _ = knn_search(state.graph, queries, k=k, ef=ef, metric=metric,
                            max_iters=mi, seeds=seeds, compact_k=compact)
        r = recall_of(_host(ids), gt)
        qps = round(q_done[s] / q_s[s]) if q_s[s] else None
        sweep.append({"ef": ef, "max_iters": mi, "recall": round(r, 4),
                      "sustained_qps_during_ingest": qps})
        log(f"ef={ef} mi={mi}: end recall@{k}={r:.4f} sustained={qps}")
        if chosen is None and r >= target_recall:
            chosen = sweep[-1]
    best = chosen or max(sweep, key=lambda s: s["recall"])
    ingested = n - n_warm
    out = {
        "config": name,
        "n": n,
        "dim": dim,
        "metric": metric,
        "streaming": True,
        "target_recall": target_recall,
        "met_target": chosen is not None,
        "warm_build_vps": round(n_warm / warm_s),
        "ingest_vps": round(ingested / ins_s),
        "sustained_qps_during_ingest": best["sustained_qps_during_ingest"],
        "recall": best["recall"],
        "ef": best["ef"],
        "max_iters": best["max_iters"],
        "sweep": sweep,
        "backend": dev.type,
    }
    log(json.dumps(out))
    return out


def run_config(
    name: str,
    n: int,
    dim: int,
    metric: str,
    n_queries: int = 1000,
    k: int = 10,
    M: int = 16,
    ef_construction: int = 200,
    round_size: int = 1024,
    # (ef, max_iters) pairs ordered by cost; None = run to convergence.
    # Recall is iteration-limited at these widths, so the sweep climbs
    # max_iters.
    ef_sweep=((48, 8), (64, 10), (96, 12), (96, 14), (96, 15), (96, 16),
              (96, 18), (96, 21), (96, 24), (128, 32), (128, None),
              (256, None)),
    # packed-engine sweep: (ef, max_iters, rerank_k, expand[, interleave]),
    # climbing recall; expand is an int or an ((e, iters), ...) schedule
    # (max_iters ignored for schedules).  The JAX harness's ladder: narrow
    # expansion, an 8192-query batch served as two interleaved halves.  The
    # first row brackets the 0.95 crossing on the SIFT1M-shaped data from
    # below; the tail is the safety ladder for harder datasets.
    packed_sweep=(
        (64, 29, 32, 2, 2),
        (64, 30, 32, 2, 2),
        (64, 33, 32, 2, 2),
        (96, 38, 48, 2, 2),
        (128, 48, 64, 2, 2),
        (128, 56, 64, 2, 2),
        (160, 64, 96, 2, 2),
        (192, 80, 96, 2, 2),
        (256, None, 128, 4),
    ),
    rerank_sweep=(32, 64, 128),
    target_recall: float = 0.95,
    qps_batch: int = 8192,
    # serve the entry scan from at most this many seed-bank rows (highest
    # levels first, the level-1 rest subsampled evenly)
    seed_cap: int | None = 16384,
    seed: int = 7,
    storage: str = "f32",
    scan_dtype: str = "bf16",
    rerank_dtype: str = "f32",
    engines=("hnsw", "flat"),
    # which hnsw query paths the sweep may use (packed preferred when its
    # availability policy holds; classic is the fallback ladder)
    hnsw_engines=("packed", "classic"),
    verbose: bool = True,
    device: torch.device | str = "cuda",
) -> dict:
    """Full ann-benchmarks protocol on a synthetic stand-in dataset."""
    dev = _resolve_device(device)

    def log(msg):
        if verbose:
            print(f"[bench:{name}] {msg}", flush=True)

    _warm_device(dev)
    log("generating dataset on device")
    data, make_q = datasets.clustered_device(
        n, dim, n_clusters=max(64, n // 2500), seed=seed, device=dev
    )
    queries = make_q(n_queries, qseed=seed + 1)

    # exact ground truth from the raw f32 rows, before any lossy-dtype
    # engine exists
    log("computing exact ground truth on device")
    gt = device_ground_truth(data, queries, k, metric)

    sync(data)
    t0 = time.perf_counter()
    flat = build_flat(data, metric, scan_dtype=scan_dtype,
                      rerank_dtype=rerank_dtype, device=dev)
    sync(flat)
    flat_build_s = time.perf_counter() - t0
    log(f"flat loaded in {flat_build_s:.1f}s")
    if "hnsw" not in engines:
        del data, make_q  # the raw f32 dataset is no longer needed

    results = {}

    if "hnsw" in engines:
        cfg = HnswConfig(dim=dim, metric=metric, M=M,
                         ef_construction=ef_construction, storage=storage)
        log(f"hnsw build: n={n} dim={dim} metric={metric} M={M} "
            f"efC={ef_construction} storage={storage}")
        sync(data)
        t0 = time.perf_counter()
        state = BuildState(cfg, n, round_size=round_size, device=dev)
        state.add(data)  # data is on the device: no host transfer
        sync(state.graph)
        build_s = time.perf_counter() - t0
        log(f"hnsw built in {build_s:.1f}s = {n / build_s:.0f} vectors/s")
        seeds = build_seed_index(state.graph, metric, cap=seed_cap) \
            if n >= 4096 else None
        # packed inline-int8 engine (models/packed.py): the query path for
        # matmul metrics at >=100k nodes whose payload fits the budget (the
        # same policy as api.Index._packed_index)
        packed = None
        pack_s = 0.0
        if n >= 100_000 and "packed" in hnsw_engines:
            from ocaml_hnsw_tpu_torch.models.packed import (
                pack_d_pad, pack_graph,
            )

            packed = state.packed_graph()  # maintained by a packed build
            if packed is not None:
                log("packed payload reused from the build (0s)")
            else:
                deg = state.graph.adj0.shape[1]
                fits = (state.graph.n_cap * deg * pack_d_pad(dim)) <= (8 << 30)
                if get_metric(metric).matmul_score is not None and fits:
                    t0 = time.perf_counter()
                    packed = pack_graph(state.graph, metric)
                    sync(packed.pay)
                    pack_s = time.perf_counter() - t0
                    log(f"packed payload built in {pack_s:.1f}s "
                        f"({packed.pay.nbytes / 2**30:.2f} GiB)")
        sweep = []
        chosen = None
        if packed is not None:
            from ocaml_hnsw_tpu_torch.models.packed import knn_search_packed

            for entry in packed_sweep:
                ef, mi, rk = entry[0], entry[1], entry[2]
                e = entry[3] if len(entry) > 3 else 4
                il = entry[4] if len(entry) > 4 else 1
                sched = e if isinstance(e, tuple) else None
                e_int = 4 if isinstance(e, tuple) else e

                # capped rows run a fixed number of iterations; uncapped
                # ladder rows need the early exit
                def search(q, ef=ef, mi=mi, rk=rk, e_int=e_int, sched=sched,
                           il=il):
                    return knn_search_packed(
                        state.graph, packed, q, k=k, ef=ef, metric=metric,
                        max_iters=mi, seeds=seeds, seed_e=8, rerank_k=rk,
                        expand=e_int, expand_schedule=sched,
                        early_exit=mi is None, interleave=il)[0]

                r = recall_of(_host(search(queries)), gt)
                qps = measure_qps(search, queries, batch=qps_batch)
                # typed JSON: int expands stay ints, schedules become
                # nested lists
                e_json = ([[int(a), int(b)] for a, b in e]
                          if isinstance(e, tuple) else int(e))
                sweep.append({"engine": "packed", "ef": ef, "max_iters": mi,
                              "rerank_k": rk, "expand": e_json,
                              "interleave": il,
                              "recall": round(r, 4), "qps": round(qps)})
                log(f"hnsw[packed] ef={ef} mi={mi} rk={rk} e={e} il={il}: "
                    f"recall@{k}={r:.4f} qps={qps:.0f}")
                if chosen is None and r >= target_recall:
                    chosen = sweep[-1]
                    break
        if chosen is None and "classic" in hnsw_engines:
            # compact only when the candidate block is wide enough to matter
            compact = 3 * (4 * cfg.M_max0) // 4 if 4 * cfg.M_max0 >= 128 else None
            for entry in ef_sweep:
                ef, mi = entry if isinstance(entry, tuple) else (entry, None)

                def search(q, ef=ef, mi=mi):
                    return knn_search(
                        state.graph, q, k=k, ef=ef, metric=metric,
                        max_iters=mi, seeds=seeds, compact_k=compact)[0]

                r = recall_of(_host(search(queries)), gt)
                qps = measure_qps(search, queries, batch=qps_batch)
                sweep.append({"engine": "classic", "ef": ef, "max_iters": mi,
                              "recall": round(r, 4), "qps": round(qps)})
                log(f"hnsw ef={ef} mi={mi}: recall@{k}={r:.4f} qps={qps:.0f}")
                if chosen is None and r >= target_recall:
                    chosen = sweep[-1]
                    break
        results["hnsw"] = {
            "build_seconds": round(build_s, 2),
            "pack_seconds": round(pack_s, 2),
            "build_vectors_per_second": round(n / build_s),
            "sweep": sweep,
            "best": chosen or sweep[-1],
        }

    if "flat" in engines:
        log(f"flat engine (loaded above in {flat_build_s:.1f}s)")
        sweep = []
        chosen = None
        for rk in rerank_sweep:
            def search(q, rk=rk):
                return flat_search(flat, q, k=k, metric=metric,
                                   rerank_k=rk)[0]

            r = recall_of(_host(search(queries)), gt)
            qps = measure_qps(search, queries, batch=qps_batch)
            sweep.append({"rerank_k": rk, "recall": round(r, 4),
                          "qps": round(qps)})
            log(f"flat rerank_k={rk}: recall@{k}={r:.4f} qps={qps:.0f}")
            if chosen is None and r >= target_recall:
                chosen = sweep[-1]
                break
        results["flat"] = {
            "build_seconds": round(flat_build_s, 2),
            "build_vectors_per_second": round(n / flat_build_s),
            "sweep": sweep,
            "best": chosen or sweep[-1],
        }

    # headline: the fastest engine meeting the target
    meeting = {
        e: v for e, v in results.items() if v["best"]["recall"] >= target_recall
    }
    pool = meeting or results
    head = max(pool, key=lambda e: pool[e]["best"]["qps"])
    return {
        "config": name,
        "n": n,
        "dim": dim,
        "metric": metric,
        "target_recall": target_recall,
        "engine": head,
        "recall": results[head]["best"]["recall"],
        "qps": results[head]["best"]["qps"],
        "engines": results,
        "backend": dev.type,
        "device": _device_name(dev),
    }
