"""Smoke run of the torch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain torch version on edge cases and at main-path
shapes, then drives the port's paths through the public API and checks
their results against exact ground truth computed on the card:

  A. a small index from empty (BASELINE config 1, bench.py `random10k`:
     10k x 128, L2): incremental build, classic-engine queries, save_index /
     load_index with a resize, an add after the load;
  B. streaming ingest at the shapes of bench.py `laion-streaming` (768-d,
     cosine), depth cut to 96k rows, through the port's
     `run_streaming_config`: a warm add, then 10 ingest steps each followed
     by one 4096-query batch per (ef, max_iters) setting;
  main. the SIFT1M main path (1M x 128-d, L2, M=16): `Index.add_items`
     (bulk build) and `Index.knn_query` (packed engine);
  C. resize_index and a 50k-row add on top of that bulk-built index (the
     build-maintained payload: K1 in the construction beam), then the main
     path's queries again over all 1.05M rows;
  D. the port's benchmark harness (`bench/harness.py::run_config`) and the
     flat indexes: D1 bench.py `glove1m` at full scale (1,183,514 x 100,
     cosine: bulk build, packed sweep, flat sweep); D2 the flat engine of
     bench.py `deep10m` (10M x 96, L2, int8 scan, bf16 rerank rows; its HNSW
     half is left out: at the incremental build's rate 10M rows take over an
     hour); D3 `BFIndex` over the main path's 1M rows against the exact
     ground truth, a `FlatIndex` save/load, and `Index` and `FlatIndex`
     under a registered L1 metric.

    python3 chip_smoke.py                 # the whole run
    python3 chip_smoke.py --kernels-only  # build + kernel checks on
                                          # synthetic data, no index
    python3 chip_smoke.py --profile-dir DIR  # also write the profiled
                                             # windows' op tables to DIR

Kernel times are medians of CUDA-event timings.  A spin kernel holds the
stream while each timed call is enqueued, so host-side launch cost is not
in the time, and a 128 MiB buffer (more than the 50 MB L2) is read before
every rep, untimed, so each call finds its data out of L2 (a read leaves
clean lines: a write would make the call pay for evicting dirty ones).
Cold inputs are random ids; "real" inputs are
captured from the main path itself (K1's nodes at the 10th beam iteration of
an 8192-query batch, K2's seed and rerank ids of that batch, and one
1024-row batch of the kNN table), also timed with the L2 flushed, so what
reuse remains is the sharing of hub rows inside one call.  Each time stands
beside its bound: the bytes the call must move (every distinct row or slab
it touches read once, every output written once) over 3.35 TB/s, or its
operations over the peak rate for their type if that is longer.

The kernels are also held and timed at the other paths' shapes, on inputs
captured there: K2 on a phase-A build round's candidate block, on a
phase-B query batch's and on the flat engines' rerank blocks of D1 and D2,
K1 on a phase-C construction beam step.  Ground truth everywhere is the
harness's `device_ground_truth` (exact f32 on the card).  Launch
counters are zeroed before each phase and read after it; a phase whose path
runs a kernel fails if that kernel did not launch.

Exits non-zero, printing no result, when no CUDA device is available.  The
last line of stdout is {"ok": true, "device": {...}}; the line before it is
the card's name and power limit, and the line before that lists each kernel
with its launches on the main path (and per phase), its largest difference
from the plain version, its times and bounds.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ocaml_hnsw_tpu_torch import BFIndex, FlatIndex, Index
from ocaml_hnsw_tpu_torch.bench import harness as harness_mod
from ocaml_hnsw_tpu_torch.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu_torch.bench.harness import device_ground_truth, recall_of
from ocaml_hnsw_tpu_torch.models import build as build_mod
from ocaml_hnsw_tpu_torch.models import bulk as bulk_mod
from ocaml_hnsw_tpu_torch.models import flat as flat_mod
from ocaml_hnsw_tpu_torch.models import packed as packed_mod
from ocaml_hnsw_tpu_torch.models import search as search_mod
from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.ops.kernels import gather_dist as k2_mod
from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import (
    gather_dists, gather_dists_plain,
)
from ocaml_hnsw_tpu_torch.ops.kernels.payload_score import (
    packed_score, packed_score_plain,
)
from ocaml_hnsw_tpu_torch.ops import metrics as metrics_mod
from ocaml_hnsw_tpu_torch.ops.quantize import quantize_rows
from ocaml_hnsw_tpu_torch.utils.profiling import search_stats

N, DIM, M, EFC = 1_000_000, 128, 16, 200
N_QUERIES, QPS_BATCH = 1000, 8192
#: the JAX harness's first packed operating point (ef, max_iters, rerank_k,
#: expand, interleave); knn_query's own defaults differ
QUERY_KNOBS = dict(k=10, ef=64, max_iters=29, rerank_k=32, expand=2,
                   interleave=2)
RECALL_FLOOR = 0.90
#: phase A: bench.py random10k (BASELINE config 1)
A_N, A_DIM, A_M, A_EFC, A_RS = 10_000, 128, 16, 64, 512
A_EF, A_ADD, A_FLOOR = 64, 1_000, 0.95
#: phase B: bench.py laion-streaming shapes (bench/harness.py
#: run_streaming_config), depth cut from 1M to 96k rows
B_N, B_DIM, B_EFC, B_RS, B_QB, B_STEPS = 96_000, 768, 200, 2048, 4096, 10
B_SETTINGS = ((96, 16), (128, 24))
B_FLOOR = 0.90  # at (128, 24)
#: phase C: resize + add on top of the main path's bulk-built index
C_MAX, C_ADD, C_FLOOR = 1_050_000, 50_000, 0.90
#: phase D1: bench.py glove1m, full scale; D2: bench.py deep10m's flat
#: engine, full scale; D3: registered-metric indexes
D1 = dict(n=1_183_514, dim=100, metric="cosine", round_size=2048,
          ef_construction=200, engines=("hnsw", "flat"))
D2 = dict(n=10_000_000, dim=96, metric="l2", engines=("flat",),
          scan_dtype="int8", rerank_dtype="bf16")
D_FLOOR = 0.95
D3_N, D3_DIM, D3_FLAT_N = 20_000, 32, 100_000
#: the classic engine's candidate compaction at M=16 (knn_query "auto")
COMPACT_K = 96
K2_RTOL = K2_ATOL = 1e-5  # summation order differs (warp tree vs torch)
# K1 must equal its plain version bit for bit (exact int32 dot, same
# rounding in the epilogue)

#: NVIDIA H100 SXM data sheet: memory rate, dense int8 and f32 (no tensor
#: core) peaks
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
FLUSH_BYTES = 128 << 20
SPIN_CYCLES = 2_000_000  # about 1 ms of spin ahead of each timed call
CAPTURE_ITER = 9  # the beam loop's 10th iteration
KNN_K = 64  # bulk_build's kNN table: k + 1 + 32 = 97 candidates reranked
DEV = torch.device("cuda")
PROFILE_DIR = None  # --profile-dir: where busy_share writes op tables
NO_LIBRARY = ("no single PyTorch call computes it: a gather and a distance "
              "are at least two calls (index_select, then a reduction)")


def say(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, flush=None, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call (module docstring)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()  # evicts the call's data from L2 (docstring)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, ops: int, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_cost(nodes, deg: int, d_pad: int) -> tuple[int, int]:
    """(bytes, int8 ops) of one packed_score call on these nodes."""
    live = nodes[nodes >= 0]
    b, e = nodes.shape
    nbytes = (int(torch.unique(live).numel()) * (deg * d_pad + 8 * deg)
              + b * (d_pad + 4) + b * e * 4 + b * e * deg * 8)
    return nbytes, 2 * int(live.numel()) * deg * d_pad


def k2_cost(vec, ids, metric: str) -> tuple[int, int]:
    """(bytes, f32 flops) of one gather_dists call on these ids."""
    b, k = ids.shape
    d = vec.shape[1]
    live = ids[ids >= 0]
    row = d * vec.element_size() + (4 if vec.dtype == torch.int8 else 0)
    nbytes = (int(torch.unique(live).numel()) * row + b * d * 4
              + b * k * 4 + b * k * 4)
    return nbytes, (3 if metric == "l2" else 2) * int(live.numel()) * d


def timed(row: dict, kernel, plain, nbytes: int, ops: int, peak: float,
          flush) -> dict:
    ms = device_ms(kernel, flush)
    plain_ms = device_ms(plain, flush)
    bms, by = bound(nbytes, ops, peak)
    row.update(bytes=nbytes, bound_ms=bms, bound_by=by, ms=ms,
               plain_ms=plain_ms, share=bms / ms)
    return row


def fmt(row: dict) -> str:
    if "ms" not in row:
        return f"max |err| {row['max_abs_err']:.3e}"
    return (f"max |err| {row['max_abs_err']:.3e}; {row['bytes'] / 1e6:.1f} MB,"
            f" bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}); "
            f"kernel {row['ms'] * 1e3:.1f} us = {row['share']:.0%} of bound;"
            f" plain {row['plain_ms'] * 1e3:.1f} us")


def k1_case(label: str, args, flush=None, time_it: bool = False) -> dict:
    """packed_score against its plain version: ids and distances equal."""
    nodes, _, pay = args[0], args[1], args[2]
    ids, d = packed_score(*args)
    ids_ref, d_ref = packed_score_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(ids, ids_ref):
        raise AssertionError(f"K1 {label}: candidate ids differ from plain")
    if not torch.equal(d, d_ref):
        raise AssertionError(f"K1 {label}: distances differ from plain")
    fin = torch.isfinite(d_ref)
    err = float((d[fin] - d_ref[fin]).abs().max()) if fin.any() else 0.0
    _, deg, d_pad = pay.shape
    row = dict(case=label, shape=[*nodes.shape, deg, d_pad], max_abs_err=err)
    if time_it:
        nbytes, ops = k1_cost(nodes, deg, d_pad)
        timed(row, lambda: packed_score(*args),
              lambda: packed_score_plain(*args), nbytes, ops,
              INT8_OPS_PER_S, flush)
    say(f"[K1 packed_score] {label} B={nodes.shape[0]} E={nodes.shape[1]} "
        f"deg={deg} d_pad={d_pad}: equal; {fmt(row)}")
    return row


def k2_case(label: str, vec, scales, q, ids, metric: str, flush=None,
            time_it: bool = False, path: str | None = None) -> dict:
    """gather_dists against its plain version within K2_RTOL / K2_ATOL;
    `path` ("vector" / "generic") asserts which path the plan takes."""
    plan = k2_mod.launch_plan(
        *ids.shape, vec.shape[1], vec.element_size(),
        vec.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0,
        k2_mod._sm_count(vec.device) if vec.is_cuda else 132)
    got = "generic" if plan.cpl == 0 else "vector"
    if path is not None and got != path:
        raise AssertionError(f"K2 {label}: plan took the {got} path")
    out = gather_dists(vec, scales, q, ids, metric)
    ref = gather_dists_plain(vec, scales, q, ids, metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=K2_RTOL, atol=K2_ATOL)
    fin = torch.isfinite(ref)
    err = float((out[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
    row = dict(case=label, shape=[*ids.shape, vec.shape[1]],
               dtype=str(vec.dtype).replace("torch.", ""), metric=metric,
               path=got, max_abs_err=err)
    if time_it:
        nbytes, ops = k2_cost(vec, ids, metric)
        timed(row, lambda: gather_dists(vec, scales, q, ids, metric),
              lambda: gather_dists_plain(vec, scales, q, ids, metric),
              nbytes, ops, F32_FLOPS_PER_S, flush)
    say(f"[K2 gather_dists] {label} B={ids.shape[0]} K={ids.shape[1]} "
        f"D={vec.shape[1]} {row['dtype']} {metric} ({got} path): "
        f"agree; {fmt(row)}")
    return row


@contextlib.contextmanager
def recording(module, name: str):
    """Keep the arguments of every call to `module.name` (a pass-through)."""
    calls = []
    real = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def metering(owner, name: str):
    """Replace `owner.name` by a pass-through that notes the kernel launches
    of every call (the counters read before and after it) and keeps the
    arguments of the last call only."""
    calls = []
    real = getattr(owner, name)

    def metered(*args, **kwargs):
        before = read_launches()
        out = real(*args, **kwargs)
        after = read_launches()
        if calls:
            calls[-1].pop("args")
            calls[-1].pop("kwargs")
        calls.append(dict(launches={k: after[k] - before[k] for k in after},
                          args=args, kwargs=kwargs))
        return out

    setattr(owner, name, metered)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def sum_launches(calls) -> dict:
    return {k: sum(c["launches"][k] for c in calls)
            for k in ("gather_dists", "packed_score")}


def reset_launches() -> None:
    gather_dists.launches = 0
    packed_score.launches = 0


def read_launches() -> dict:
    return {"gather_dists": gather_dists.launches,
            "packed_score": packed_score.launches}


def require_launches(phase: str, launches: dict, kernels) -> None:
    for kern in kernels:
        if launches[kern] <= 0:
            raise AssertionError(f"{kern} was not launched in phase {phase}")


def busy_share(fn, name: str) -> dict:
    """Profile fn once: the device-busy share of its wall time (kernels'
    device time summed by torch.profiler over the wall time of the profiled
    call; profiling adds host time, so this reads low; None when the
    profiler records no device time), the number of device kernels, and the
    wall time per kernel, and the six device kernels with the most device
    time as [name, ms, count].  With --profile-dir DIR the op table (by
    host time) goes to DIR/profile_<name>.txt."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0  # not the trace's processing
    stats = prof.key_averages()
    dev = [e for e in stats
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    kernels = sum(e.count for e in dev)
    if PROFILE_DIR is not None:
        os.makedirs(PROFILE_DIR, exist_ok=True)
        with open(os.path.join(PROFILE_DIR, f"profile_{name}.txt"), "w") as f:
            f.write(stats.table(sort_by="self_cpu_time_total", row_limit=40))
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return dict(share=dev_us / 1e6 / wall if dev_us > 0 else None,
                kernels=kernels, wall_s=wall,
                us_per_kernel=wall * 1e6 / kernels if kernels else None,
                top=[[e.key[:70], round(e.self_device_time_total / 1e3, 2),
                      e.count] for e in top])


def fmt_share(busy: dict) -> str:
    if busy["share"] is None:
        return "device busy not measured"
    return (f"device busy {busy['share']:.0%} of {busy['wall_s'] * 1e3:.0f} "
            f"ms, {busy['kernels']} kernels = {busy['us_per_kernel']:.1f} us "
            f"of wall each")


def check_result(labels, dists, n_q: int, k: int) -> None:
    if labels.shape != (n_q, k) or dists.shape != (n_q, k):
        raise AssertionError(f"bad result shapes {labels.shape} {dists.shape}")
    if not np.isfinite(dists).all() or (labels < 0).any():
        raise AssertionError("non-finite distances or missing results")
    if (np.diff(dists, axis=1) < 0).any():
        raise AssertionError("distances not ascending")


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
    # ptxas -v, per kernel: "Compiling entry function", its spills, then
    # its registers; one line each
    kernels, fn, spill = [], "?", ""
    for line in _lib.build_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            kernels.append((fn, line.split(":", 1)[1].strip(), spill))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(k[0] for k in kernels),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [k[0] for k in kernels]
    for name, (_, regs, spill) in zip(names, kernels):
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        say(f"[build] {name}: {regs}; {spill}")


# ------------------------------------------------------------ edge cases
def synthetic_packed(n: int, deg: int, d_pad: int, seed: int,
                     empty: float = 0.1):
    """A random int8 payload with meta [ids | norms], made on the device
    from `seed`; `empty` of the slots are -1 (the norms are random too:
    the kernel only carries them into the epilogue)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    pay = torch.randint(-127, 128, (n, deg, d_pad), dtype=torch.int8,
                        device=DEV, generator=g)
    ids = torch.randint(0, n, (n, deg), dtype=torch.int32, device=DEV,
                        generator=g)
    ids[torch.rand((n, deg), device=DEV, generator=g) < empty] = -1
    norms = torch.randint(0, 1 << 21, (n, deg), dtype=torch.int32,
                          device=DEV, generator=g)
    return pay, torch.cat([ids, norms], dim=1)


def k1_inputs(n: int, b: int, e: int, d_pad: int, gen, neg: float = 0.02):
    dev = DEV
    nodes = gen.integers(0, n, size=(b, e)).astype(np.int32)
    nodes[gen.random((b, e)) < neg] = -1
    if b:
        nodes[0, :] = -1  # one query with nothing to expand
    q8 = torch.from_numpy(
        gen.integers(-127, 128, size=(b, d_pad), dtype=np.int8)).to(dev)
    qn = torch.from_numpy(gen.random(b).astype(np.float32) * 100).to(dev)
    return torch.from_numpy(nodes).to(dev), q8, qn


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` whose base address is one element past 16-byte
    alignment."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def check_k1_edges(gen) -> list[dict]:
    scale = torch.tensor([0.02], device=DEV)
    rows = []
    cases = [  # label, n, deg, d_pad, B, E
        ("deg=48", 200_000, 48, 128, 4096, 2),
        ("deg=33 meta off the ring", 50_000, 33, 128, 1000, 3),
        ("d_pad=256", 20_000, 32, 256, 777, 2),
        ("d_pad=768 (25.6 KB stages)", 20_000, 32, 768, 512, 2),
        ("deg=64 d_pad=1024 (a warp per block)", 4_000, 64, 1024, 256, 2),
        ("deg=128 d_pad=1024 (one stage)", 1_000, 128, 1024, 200, 2),
        ("B=1 E=1", 1_000, 24, 128, 1, 1),
    ]
    for i, (label, n, deg, d_pad, b, e) in enumerate(cases):
        pay, meta = synthetic_packed(n, deg, d_pad, seed=i)
        nodes, q8, qn = k1_inputs(n, b, e, d_pad, gen)
        if b == 1:
            nodes.fill_(n - 1)
        for needs_norms in (True, False):
            tag = f"{label} {'l2' if needs_norms else 'ip'}"
            rows.append(k1_case(tag, (nodes, meta, pay, q8, qn, scale,
                                      needs_norms)))
        if label == "deg=48":
            args = (nodes.clone().fill_(-1), meta, pay, q8, qn, scale, True)
            rows.append(k1_case("every node -1", args))
            off = misaligned(meta)
            assert off.data_ptr() % 16
            rows.append(k1_case("meta base misaligned",
                                (nodes, off, pay, q8, qn, scale, True)))
        del pay, meta
    check_k1_empty(scale)
    return rows


def check_k1_empty(scale) -> None:
    """B = 0: an empty result and no launch."""
    pay = torch.zeros((4, 32, 128), dtype=torch.int8, device=DEV)
    meta = torch.zeros((4, 64), dtype=torch.int32, device=DEV)
    q8 = torch.zeros((0, 128), dtype=torch.int8, device=DEV)
    qn = torch.zeros((0,), dtype=torch.float32, device=DEV)
    nodes = torch.empty((0, 2), dtype=torch.int32, device=DEV)
    before = packed_score.launches
    ids, _ = packed_score(nodes, meta, pay, q8, qn, scale, True)
    if ids.shape != (0, 64) or packed_score.launches != before:
        raise AssertionError("K1 B=0: wrong shape or a launch")
    say("[K1 packed_score] B=0: empty result, no launch")


def check_k2_edges(x: torch.Tensor, gen) -> list[dict]:
    """Odd B and K on the vector path for every dtype and metric, and the
    generic path: bf16 D=100, misaligned bases, rows wider than 1024."""
    dev = x.device
    xn = x / torch.linalg.norm(x, dim=1, keepdim=True)
    n = x.shape[0]

    def ids_for(b, k, rows=n):
        ids = gen.integers(-1, rows, size=(b, k)).astype(np.int32)
        ids[:, 0] = -1
        return torch.from_numpy(ids).to(dev)

    def queries(b, d, unit):
        q = torch.from_numpy(gen.standard_normal((b, d)).astype(np.float32))
        q = q.to(dev)
        return q / torch.linalg.norm(q, dim=1, keepdim=True) if unit else q

    rows = []
    ids = ids_for(1000, 13)
    for metric, base in (("l2", x), ("ip", xn)):
        q = queries(1000, base.shape[1], metric == "ip")
        for storage in ("f32", "bf16", "int8"):
            vec, sc, _ = quantize_rows(base, storage)
            rows.append(k2_case("odd B, K", vec, sc, q, ids, metric,
                                path="vector"))
        narrow = base[:, :100].contiguous()
        vec, sc, _ = quantize_rows(narrow, "bf16")
        rows.append(k2_case("bf16 D=100", vec, sc, q[:, :100].contiguous(),
                            ids, metric, path="generic"))
    q = queries(1000, x.shape[1], False)
    part = min(n, 200_000)
    for storage in ("f32", "int8"):
        vec, sc, _ = quantize_rows(x[:part], storage)
        rows.append(k2_case("base misaligned", misaligned(vec), sc, q,
                            ids_for(1000, 13, part), "l2", path="generic"))
    wide = torch.from_numpy(
        gen.standard_normal((20_000, 768)).astype(np.float32)).to(dev)
    qw = queries(300, 768, False)
    for storage in ("f32", "bf16", "int8"):
        vec, sc, _ = quantize_rows(wide, storage)
        rows.append(k2_case("D=768", vec, sc, qw, ids_for(300, 37, 20_000),
                            "l2", path="vector"))
    tiny = torch.from_numpy(
        gen.standard_normal((5_000, 16)).astype(np.float32)).to(dev)
    vec, sc, _ = quantize_rows(tiny, "int8")
    rows.append(k2_case("int8 D=16 (a lane per row)", vec, sc,
                        queries(64, 16, False), ids_for(64, 45, 5_000), "l2",
                        path="vector"))
    vec, sc, _ = quantize_rows(wide.repeat(1, 3)[:2_000], "f32")
    rows.append(k2_case("D=2304", vec, sc, queries(50, 2304, False),
                        ids_for(50, 9, 2_000), "l2", path="generic"))
    return rows


# ------------------------------------------------------- main-path shapes
def check_k1_main(packed, qps_queries, captured, flush, gen) -> list[dict]:
    """On the index's own 1M payload: random nodes (cold) and the nodes of
    the main path's 10th beam iteration (real), at B=4096 (one interleaved
    half, the main path's call) and B=8192."""
    dev = packed.pay.device
    q = torch.from_numpy(qps_queries).to(dev)
    q8 = packed_mod.quantize_queries(q, packed.scale)
    q8 = torch.nn.functional.pad(q8, (0, packed.d_pad - q8.shape[1]))
    qn = torch.sum(q * q, dim=1)
    rows = []
    for b in (QPS_BATCH // 2, QPS_BATCH):
        nodes, _, _ = k1_inputs(N, b, 2, packed.d_pad, gen)
        args = (nodes, packed.meta, packed.pay, q8[:b], qn[:b], packed.scale,
                True)
        rows.append(k1_case(f"cold B={b}", args, flush, time_it=True))
        if b == QPS_BATCH:
            rows.append(k1_case("cold ip", args[:-1] + (False,)))
    half0, half1 = captured[2 * CAPTURE_ITER], captured[2 * CAPTURE_ITER + 1]
    rows.append(k1_case(f"real B={QPS_BATCH // 2}", half0, flush,
                        time_it=True))
    both = tuple(torch.cat([a, b]) for a, b in zip(
        (half0[0], half0[3], half0[4]), (half1[0], half1[3], half1[4])))
    args = (both[0], packed.meta, packed.pay, both[1], both[2], packed.scale,
            half0[6])
    rows.append(k1_case(f"real B={QPS_BATCH}", args, flush, time_it=True))
    return rows


def check_k2_main(x, data_q, seed_call, rerank_call, knn_call, flush,
                  gen) -> list[dict]:
    """On the main-path data: every dtype and metric at the three main-path
    shapes with random ids (f32 l2 timed cold), then the ids the main path
    itself used (timed)."""
    dev = x.device
    xn = x / torch.linalg.norm(x, dim=1, keepdim=True)
    q = torch.from_numpy(data_q).to(dev)
    qn = q / torch.linalg.norm(q, dim=1, keepdim=True)
    rows = []
    for metric, base, qq in (("l2", x, q), ("ip", xn, qn)):
        for storage in ("f32", "bf16", "int8"):
            vec, sc, _ = quantize_rows(base, storage)
            for b, k in ((QPS_BATCH, 8), (QPS_BATCH, 32), (1024, 97)):
                ids = gen.integers(-1, N, size=(b, k)).astype(np.int32)
                ids[:, 0] = -1
                t = (metric, storage) == ("l2", "f32")
                rows.append(k2_case(f"cold {b}x{k}", vec, sc, qq[:b],
                                    torch.from_numpy(ids).to(dev), metric,
                                    flush, time_it=t, path="vector"))
            del vec
    for label, (vec, sc, qq, ids, metric) in (
            ("real seed re-score", seed_call),
            ("real rerank", rerank_call),
            ("real kNN-table rerank", knn_call)):
        rows.append(k2_case(label, vec, sc, qq, ids, metric, flush,
                            time_it=True))
    return rows


def k2_args(call):
    """gather_dists arguments of a captured dists_to_ids call."""
    vectors, scales, _, q, _, ids, metric = call
    return vectors, scales, q, ids, metric


def capture_query(index, qps_queries):
    """Arguments of K1 and K2 in one 8192-query knn_query."""
    with recording(packed_mod, "packed_score") as k1_calls, \
            recording(packed_mod, "dists_to_ids") as rerank, \
            recording(search_mod, "dists_to_ids") as seed:
        index.knn_query(qps_queries, **QUERY_KNOBS)
    if len(k1_calls) != 2 * QUERY_KNOBS["max_iters"] or len(rerank) != 1 \
            or len(seed) != 1:
        raise AssertionError(f"capture: {len(k1_calls)} K1 calls, "
                             f"{len(rerank)} reranks, {len(seed)} seed scans")
    return k1_calls, k2_args(seed[0]), k2_args(rerank[0])


def capture_knn_batch(x: torch.Tensor):
    """Arguments of K2 in one 1024-row batch (the 11th) of the kNN table."""
    flat = bulk_mod.flat_from_rows(x, "l2")
    with recording(flat_mod, "gather_dists") as calls:
        bulk_mod.knn_table(flat, x[10 * 1024:11 * 1024], KNN_K, "l2")
    (vec, scales, q, ids, metric), = calls
    return vec, scales, q, ids, metric


def kernels_only(gen) -> int:
    """Edge checks plus cold timings on synthetic data (no index)."""
    flush = torch.zeros(FLUSH_BYTES // 4, device=DEV)
    check_k1_edges(gen)
    x = torch.from_numpy(clustered(200_000, DIM, n_clusters=400,
                                   seed=7)).to(DEV)
    check_k2_edges(x, gen)
    pay, meta = synthetic_packed(N, 32, 128, seed=100)
    scale = torch.tensor([0.02], device=DEV)
    for b in (4096, 8192):
        nodes, q8, qn = k1_inputs(N, b, 2, 128, gen)
        k1_case(f"cold synthetic B={b}", (nodes, meta, pay, q8, qn, scale,
                                          True), flush, time_it=True)
    del pay, meta
    g = torch.Generator(device=DEV).manual_seed(101)
    xs = torch.randn((N, DIM), device=DEV, generator=g)
    for b, k in ((8192, 8), (8192, 32), (1024, 97)):
        ids = torch.from_numpy(gen.integers(-1, N, size=(b, k)).astype(
            np.int32)).to(DEV)
        q = torch.randn((b, DIM), device=DEV, generator=g)
        k2_case(f"cold synthetic {b}x{k}", xs, torch.ones(N, device=DEV),
                q, ids, "l2", flush, time_it=True)
    check_int8_scan(gen)
    say("[kernels-only] all kernel checks passed")
    return 0


def cold_ids(gen, b: int, k: int, n: int) -> torch.Tensor:
    ids = gen.integers(-1, n, size=(b, k)).astype(np.int32)
    ids[:, 0] = -1
    return torch.from_numpy(ids).to(DEV)


# ------------------------------------------------- phase A: small index
def phase_a(smi: str, flush, gen) -> tuple[dict, list]:
    """BASELINE config 1 from empty: incremental build, classic queries,
    save/load with a resize, an add after the load."""
    data = clustered(A_N, A_DIM, n_clusters=64, seed=7)
    queries = queries_like(data, N_QUERIES, seed=8)
    x = torch.from_numpy(data).to(DEV)
    q = torch.from_numpy(queries).to(DEV)
    index = Index("l2", A_DIM, device=DEV.type)
    index.init_index(max_elements=A_N, M=A_M, ef_construction=A_EFC,
                     round_size=A_RS)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(search_mod, "dists_to_ids") as calls:
        index.add_items(data)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # a late round's level-0 beam step: 64 candidate blocks before the end
    build_call = [c for c in calls
                  if tuple(c[5].shape) == (A_RS, COMPACT_K)][-64]
    del calls
    build_launches = read_launches()
    require_launches("A build", build_launches, ["gather_dists"])
    if index._state._packed_build or build_launches["packed_score"]:
        raise AssertionError("phase A: a 10k index took the packed build")

    knobs = dict(k=10, ef=A_EF, engine="classic")
    reset_launches()
    labels, dists = index.knn_query(queries, **knobs)
    batch_launches = read_launches()
    require_launches("A query", batch_launches, ["gather_dists"])
    check_result(labels, dists, N_QUERIES, 10)
    rec = recall_of(labels, device_ground_truth(x, q, 10, "l2"))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        index.knn_query(queries, **knobs)
        times.append(time.perf_counter() - t0)
    qps = N_QUERIES / statistics.median(times)
    if rec < A_FLOOR:
        raise AssertionError(f"phase A recall@10 {rec:.4f} < {A_FLOOR}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "random10k.idx")
        index.save_index(path)
        loaded = Index("l2", A_DIM, device=DEV.type)
        loaded.load_index(path, max_elements=A_N + A_ADD)
    lab2, d2 = loaded.knn_query(queries, **knobs)
    if not (np.array_equal(labels, lab2) and np.array_equal(dists, d2)):
        raise AssertionError("phase A: results differ after save/load")
    extra = queries_like(data, A_ADD, seed=11)
    reset_launches()
    add_busy = busy_share(lambda: loaded.add_items(extra), "A_add")
    add_launches = read_launches()
    require_launches("A add after load", add_launches, ["gather_dists"])
    x_all = torch.cat([x, torch.from_numpy(extra).to(DEV)])
    lab3, d3 = loaded.knn_query(queries, **knobs)
    check_result(lab3, d3, N_QUERIES, 10)
    rec_all = recall_of(lab3, device_ground_truth(x_all, q, 10, "l2"))
    if rec_all < A_FLOOR:
        raise AssertionError(f"phase A recall@10 after the add {rec_all:.4f}"
                             f" < {A_FLOOR}")
    stats = search_stats(loaded.graph, queries[:256], k=10, ef=A_EF,
                         metric="l2")
    say(f"[A search_stats] {json.dumps(stats)}")
    if stats["beam_iterations"] <= 0 or stats["distance_evals"] != (
            stats["batch"] * stats["beam_iterations"] * stats["expand"]
            * loaded.graph.adj0.shape[1]):
        raise AssertionError(f"phase A: search_stats counters {stats}")
    out = dict(build_vps=A_N / build_s, build_s=build_s, recall=rec,
               qps=qps, recall_after_add=rec_all, add_busy=add_busy,
               launches_build=build_launches, launches_per_batch=batch_launches,
               launches_add=add_launches)
    say(f"[A random10k] build {build_s:.2f} s = {A_N / build_s:.0f} vectors/s;"
        f" recall@10 {rec:.4f} (floor {A_FLOOR}) at ef={A_EF} classic; "
        f"QPS {qps:.0f} (median of 5 batches of {N_QUERIES}); save/load with"
        f" resize to {A_N + A_ADD}: identical; +{A_ADD} after load: recall@10"
        f" {rec_all:.4f}, {fmt_share(add_busy)} in that add "
        f"(profiled); launches build {json.dumps(build_launches)}, per "
        f"batch {json.dumps(batch_launches)} [{smi}]")
    vec, sc, qq, ids, metric = k2_args(build_call)
    rows = [k2_case(f"A build round cold ({A_RS}, {COMPACT_K})", vec, sc, qq,
                    cold_ids(gen, A_RS, COMPACT_K, A_N), metric, flush,
                    time_it=True),
            k2_case(f"A build round real ({A_RS}, {COMPACT_K})", vec, sc, qq,
                    ids, metric, flush, time_it=True)]
    return out, rows


# ------------------------------------------- phase B: streaming ingest
def phase_b(smi: str, flush, gen) -> tuple[dict, list]:
    """laion-streaming shapes at 96k rows through the port's
    `run_streaming_config`: warm add, 10 ingest steps, one timed 4096-query
    batch per setting after each (the first step's batch excluded from the
    sustained QPS).  Every add and every query batch is metered for its
    kernel launches."""
    n_warm = B_N // 2
    reset_launches()
    with metering(build_mod.BuildState, "add") as adds, \
            metering(harness_mod, "knn_search") as searches:
        out = harness_mod.run_streaming_config(
            "laion-streaming", n=B_N, dim=B_DIM, metric="cosine",
            n_queries=N_QUERIES, M=M, ef_construction=B_EFC, round_size=B_RS,
            settings=B_SETTINGS, n_steps=B_STEPS, qps_batch=B_QB,
            verbose=False, device=DEV.type)
    say(f"[B] run_streaming_config: {json.dumps(out)}")
    if len(adds) != 1 + B_STEPS \
            or len(searches) != (B_STEPS + 1) * len(B_SETTINGS):
        raise AssertionError(f"phase B: {len(adds)} adds, {len(searches)} "
                             f"searches")
    warm_launches = sum_launches(adds[:1])
    ingest_launches = sum_launches(adds[1:])
    require_launches("B warm", warm_launches, ["gather_dists"])
    require_launches("B ingest", ingest_launches, ["gather_dists"])
    if warm_launches["packed_score"] or ingest_launches["packed_score"]:
        raise AssertionError(f"phase B: the packed build ran: warm "
                             f"{warm_launches}, ingest {ingest_launches}")
    # the last step's timed batches, one per setting
    timed = searches[-2 * len(B_SETTINGS):-len(B_SETTINGS)]
    for row, call in zip(out["sweep"], timed):
        row["launches_per_batch"] = call["launches"]
        require_launches(f"B query {row['ef']}/{row['max_iters']}",
                         call["launches"], ["gather_dists"])
    if out["n"] != B_N or out["backend"] != DEV.type or not all(
            0.0 <= r["recall"] <= 1.0 and r["sustained_qps_during_ingest"] > 0
            for r in out["sweep"]):
        raise AssertionError(f"phase B: malformed result {out}")
    # the end-state graph and queries, from the harness's last search
    (graph, queries), knobs = searches[-1]["args"], searches[-1]["kwargs"]
    del adds, searches
    qb = queries.repeat(-(-B_QB // queries.shape[0]), 1)[:B_QB].contiguous()
    with recording(search_mod, "dists_to_ids") as calls:
        search_mod.knn_search(graph, qb, **knobs)
    # the beam's 10th candidate block
    query_call = [c for c in calls
                  if tuple(c[5].shape) == (B_QB, COMPACT_K)][9]
    del calls
    query_busy = busy_share(lambda: search_mod.knn_search(graph, qb, **knobs),
                            "B_query")
    res = dict(warm_vps=out["warm_build_vps"], ingest_vps=out["ingest_vps"],
               launches_warm=warm_launches, launches_ingest=ingest_launches,
               sweep=out["sweep"], query_busy=query_busy)
    say(f"[B laion-streaming cut to {B_N}x{B_DIM} cosine] warm "
        f"{out['warm_build_vps']} vectors/s; ingest {out['ingest_vps']}"
        f" vectors/s over {B_STEPS} steps of {(B_N - n_warm) // B_STEPS}; "
        + "; ".join(
            f"ef={r['ef']} mi={r['max_iters']}: sustained QPS "
            f"{r['sustained_qps_during_ingest']}, end recall@10 "
            f"{r['recall']:.4f}" for r in out["sweep"])
        + f"; {fmt_share(query_busy)} in a {B_QB}-query batch at "
        f"{knobs['ef']}/{knobs['max_iters']} (profiled); K2 launches warm "
        f"{warm_launches['gather_dists']}, ingest "
        f"{ingest_launches['gather_dists']} [{smi}]")
    if out["sweep"][-1]["recall"] < B_FLOOR:
        raise AssertionError(f"phase B recall@10 {out['sweep'][-1]['recall']}"
                             f" < {B_FLOOR} at {B_SETTINGS[-1]}")
    vec, sc, qq, ids, metric = k2_args(query_call)
    rows = [k2_case(f"B query cold ({B_QB}, {COMPACT_K}) cosine", vec, sc,
                    qq, cold_ids(gen, B_QB, COMPACT_K, B_N), metric, flush,
                    time_it=True),
            k2_case(f"B query real ({B_QB}, {COMPACT_K}) cosine", vec, sc,
                    qq, ids, metric, flush, time_it=True)]
    return res, rows


# ------------------------------------- phase C: add after a bulk build
def phase_c(index, data, queries, smi: str, flush, gen) -> tuple[dict, list]:
    """resize_index + a 50k add on the bulk-built SIFT1M index: the packed
    build must switch on (K1 in the construction beam), the maintained
    payload must equal a fresh pack, and the main knobs must still reach
    the recall floor over all rows."""
    from ocaml_hnsw_tpu_torch.models.packed import pack_d_pad, pack_graph

    index.resize_index(C_MAX)
    st = index._state
    deg = st.graph.adj0.shape[1]
    payload = st.graph.n_cap * deg * pack_d_pad(DIM)
    if st.graph.n_cap < st.PACKED_BUILD_THRESHOLD \
            or payload > st.PACKED_BUILD_BUDGET_BYTES:
        raise AssertionError(f"phase C: n_cap {st.graph.n_cap}, payload "
                             f"{payload} B: the packed build cannot switch on")
    extra = queries_like(data, C_ADD, seed=10)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(packed_mod, "packed_score") as k1_calls:
        index.add_items(extra)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    launches = read_launches()
    require_launches("C add", launches, ["gather_dists", "packed_score"])
    pk = st.packed_graph()
    if not st._packed_build or pk is None:
        raise AssertionError("phase C: the packed build did not switch on")
    fresh = pack_graph(st.graph, "l2", with_dist=True)
    n = st.host_n
    same = dict(scale=torch.equal(pk.scale, fresh.scale),
                pay=torch.equal(pk.pay[:n], fresh.pay[:n]),
                meta=torch.equal(pk.meta[:n], fresh.meta[:n]),
                dist=torch.equal(pk.dist[:n], fresh.dist[:n]))
    del fresh
    if not all(same.values()):
        raise AssertionError(f"phase C: maintained payload != fresh pack "
                             f"{same}")
    x_all = torch.cat([torch.from_numpy(data), torch.from_numpy(extra)]).to(DEV)
    labels, dists = index.knn_query(queries, **QUERY_KNOBS)
    check_result(labels, dists, N_QUERIES, QUERY_KNOBS["k"])
    rec = recall_of(labels, device_ground_truth(
        x_all, queries, QUERY_KNOBS["k"], "l2"))
    del x_all
    out = dict(ingest_vps=C_ADD / add_s, add_s=add_s, launches_add=launches,
               recall=rec)
    say(f"[C add after bulk] resize to {C_MAX}, +{C_ADD} rows in {add_s:.2f} s"
        f" = {C_ADD / add_s:.0f} vectors/s with the packed build (payload "
        f"{payload / 1e9:.2f} GB); launches {json.dumps(launches)}; "
        f"maintained payload == fresh pack over {n} rows; recall@10 {rec:.4f}"
        f" over {n} rows at the main knobs (floor {C_FLOOR}) [{smi}]")
    if rec < C_FLOOR:
        raise AssertionError(f"phase C recall@10 {rec:.4f} < {C_FLOOR}")
    args = k1_calls[9]  # the first round's 10th beam step
    del k1_calls
    b, e = args[0].shape
    nodes, _, _ = k1_inputs(n, b, e, pk.d_pad, gen)
    rows = [k1_case(f"C build beam cold B={b} E={e}",
                    (nodes,) + tuple(args[1:]), flush, time_it=True),
            k1_case(f"C build beam real B={b} E={e}", args, flush,
                    time_it=True)]
    return out, rows


# ------------------------------- phase D: the harness and the flat indexes
def check_int8_scan(gen) -> None:
    """The int8 scan's integer dot against an int64 reference (an f64
    product is exact here), at the widths of deep10m (96), the 768-d
    configs and one past the single-product limit: equal."""
    for b, n, d in ((8192, 65_536, 96), (1024, 16_384, 768),
                    (256, 4_096, 1100)):
        qi = torch.from_numpy(gen.integers(-127, 128, size=(b, d),
                                           dtype=np.int8)).to(DEV)
        rows = torch.from_numpy(gen.integers(-127, 128, size=(n, d),
                                             dtype=np.int8)).to(DEV)
        got = flat_mod.int8_dot(qi, rows).to(torch.int64)
        ref = torch.matmul(qi.double(), rows.double().T).to(torch.int64)
        if not torch.equal(got, ref):
            raise AssertionError(f"int8 scan [{b}, {n}] D={d}: "
                                 f"{int((got != ref).sum())} sums differ")
        say(f"[D int8 scan] [{b}, {n}] D={d}: equal to the int64 reference")


def harness_case(tag: str, name: str, kwargs: dict, smi: str, flush, gen,
                 kernels) -> tuple[dict, list]:
    """One `run_config` on the card: its result printed as JSON, every
    engine's best recall held to D_FLOOR, `kernels` required to have
    launched, and K2 held and timed at the flat engine's rerank block (the
    arguments of the flat sweep's last batch)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with metering(flat_mod, "gather_dists") as reranks:
        out = harness_mod.run_config(name, qps_batch=QPS_BATCH, verbose=False,
                                     device=DEV.type, **kwargs)
    took = time.perf_counter() - t0
    launches = read_launches()
    say(f"[{tag}] run_config: {json.dumps(out)}")
    say(f"[{tag} {name}] {took:.1f} s; launches {json.dumps(launches)}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{smi}]")
    require_launches(tag, launches, kernels)
    if set(out["engines"]) != set(kwargs["engines"]) \
            or out["backend"] != DEV.type:
        raise AssertionError(f"{tag}: malformed result")
    for engine, res in out["engines"].items():
        if res["best"]["recall"] < D_FLOOR or res["best"]["qps"] <= 0:
            raise AssertionError(f"{tag}: {engine} best {res['best']} under "
                                 f"recall@10 {D_FLOOR}")
    vec, sc, q, ids, metric = reranks[-1]["args"]
    del reranks
    shape = f"({ids.shape[0]}, {ids.shape[1]})"
    label = (f"{shape} {str(vec.dtype).replace('torch.', '')} "
             f"D={vec.shape[1]} {metric}")
    n = kwargs["n"]
    rows = [k2_case(f"{tag} flat rerank cold {label}", vec, sc, q,
                    cold_ids(gen, *ids.shape, n), metric, flush,
                    time_it=True),
            k2_case(f"{tag} flat rerank real {label}", vec, sc, q, ids,
                    metric, flush, time_it=True)]
    return dict(result=out, launches=launches, seconds=took), rows


def l1_pair(rows, q):
    return abs(rows - q[..., None, :]).sum(-1)


def phase_d3(x: torch.Tensor, data: np.ndarray, queries: np.ndarray,
             gt: np.ndarray, smi: str) -> dict:
    """BFIndex over the main path's rows (`data`, on the card as `x`)
    against the ground truth; FlatIndex save/load; Index and FlatIndex
    under a registered metric."""
    k = gt.shape[1]
    bf = BFIndex("l2", DIM, device=DEV.type)
    bf.init_index(max_elements=N)
    bf.add_items(data)
    reset_launches()
    labels, dists = bf.knn_query(queries, k=k)
    require_launches("D3 BFIndex", read_launches(), ["gather_dists"])
    check_result(labels, dists, N_QUERIES, k)
    differ = int((labels != gt).any(axis=1).sum())
    if differ:
        # a row may differ only where f32 cannot tell two neighbours apart
        q = torch.from_numpy(queries).to(DEV)
        exact = torch.sum((x[torch.from_numpy(gt).to(DEV).long()]
                           - q[:, None, :]) ** 2, dim=-1)
        exact = torch.sort(exact, dim=1).values.cpu().numpy()
        np.testing.assert_allclose(dists, exact, rtol=1e-6, atol=1e-6)
    if recall_of(labels, gt) < 0.9999:
        raise AssertionError("D3: BFIndex differs from the ground truth")
    del bf
    say(f"[D3 BFIndex] {N}x{DIM} l2, {N_QUERIES} queries: ids equal to the "
        f"exact ground truth in {N_QUERIES - differ} rows ({differ} rows "
        f"differ at f32 ties, their distances equal to 1e-6)")

    fi = FlatIndex("l2", DIM, device=DEV.type)
    fi.init_index(max_elements=D3_FLAT_N, scan_dtype="int8",
                  rerank_dtype="bf16")
    fi.add_items(data[:D3_FLAT_N])
    fi.mark_deleted(5)
    want = fi.knn_query(queries, k=k)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flat.idx")
        fi.save_index(path)
        loaded = FlatIndex("l2", DIM, device=DEV.type)
        loaded.load_index(path, max_elements=D3_FLAT_N + 5000)
    got = loaded.knn_query(queries, k=k)
    if not (np.array_equal(want[0], got[0]) and np.array_equal(want[1],
                                                              got[1])):
        raise AssertionError("D3: FlatIndex results differ after save/load")
    say(f"[D3 FlatIndex] {D3_FLAT_N}x{DIM} int8 scan, bf16 rerank rows: "
        f"save, load with resize to {D3_FLAT_N + 5000}: identical results")
    del fi, loaded

    if not metrics_mod.is_metric("l1"):
        metrics_mod.register_metric("l1", l1_pair)
    rows = clustered(D3_N, D3_DIM, n_clusters=32, seed=5)
    qs = queries_like(rows, N_QUERIES, seed=6)
    gt1 = device_ground_truth(torch.from_numpy(rows).to(DEV), qs, k, "l1")
    reset_launches()
    calls = gather_dists.registry_calls
    index = Index("l1", D3_DIM, device=DEV.type)
    index.init_index(max_elements=D3_N, M=M, ef_construction=64)
    t0 = time.perf_counter()
    index.add_items(rows)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    labels, dists = index.knn_query(qs, k=k, ef=96)
    check_result(labels, dists, N_QUERIES, k)
    rec_hnsw = recall_of(labels, gt1)
    flat = FlatIndex("l1", D3_DIM, device=DEV.type)
    flat.init_index(max_elements=D3_N)
    flat.add_items(rows)
    labels, dists = flat.knn_query(qs, k=k)
    check_result(labels, dists, N_QUERIES, k)
    rec_flat = recall_of(labels, gt1)
    calls = gather_dists.registry_calls - calls
    launches = read_launches()
    say(f"[D3 registered metric l1] {D3_N}x{D3_DIM}: Index build "
        f"{D3_N / build_s:.0f} vectors/s, recall@10 {rec_hnsw:.4f} at ef=96;"
        f" FlatIndex (chunked exact scan) recall@10 {rec_flat:.4f}; "
        f"{calls} pair_dist calls on the card, kernel launches "
        f"{json.dumps(launches)} (a registered metric launches none) [{smi}]")
    if min(rec_hnsw, rec_flat) < D_FLOOR:
        raise AssertionError(f"D3: l1 recall {rec_hnsw} / {rec_flat} < "
                             f"{D_FLOOR}")
    if calls <= 0 or any(launches.values()):
        raise AssertionError(f"D3: l1 took {calls} registry calls and "
                             f"launches {launches}")
    return dict(l1_build_vps=D3_N / build_s, l1_recall=rec_hnsw,
                l1_flat_recall=rec_flat, bf_rows_differ=differ)


def headline(rows: list[dict], case: str) -> dict:
    (row,) = [r for r in rows if r["case"] == case]
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "bytes", "share")}


def main(argv: list[str]) -> int:
    global PROFILE_DIR
    if "--profile-dir" in argv:
        PROFILE_DIR = argv[argv.index("--profile-dir") + 1]
    name, smi = phase_device()
    logging.basicConfig(stream=sys.stdout, level=logging.WARNING,
                        format="[%(name)s] %(message)s")
    logging.getLogger("ocaml_hnsw_tpu_torch").setLevel(logging.INFO)
    phase_build_kernels()
    gen = np.random.default_rng(3)
    if "--kernels-only" in argv:
        return kernels_only(gen)

    t0 = time.perf_counter()
    data = clustered(N, DIM, n_clusters=400, seed=7)
    queries = queries_like(data, N_QUERIES, seed=8)
    qps_queries = queries_like(data, QPS_BATCH, seed=9)
    say(f"[data] clustered {N}x{DIM} + queries in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    dev = DEV
    x = torch.from_numpy(data).to(dev)
    k1_rows = check_k1_edges(gen)
    k2_rows = check_k2_edges(x, gen)
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)

    # ---- phases A and B: the incremental build and the classic engine
    t0 = time.perf_counter()
    phase_a_out, rows = phase_a(smi, flush, gen)
    k2_rows += rows
    say(f"[A] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_b_out, rows = phase_b(smi, flush, gen)
    k2_rows += rows
    say(f"[B] phase took {time.perf_counter() - t0:.1f} s")

    # ---- main path: bulk build + packed query through the public API
    index = Index("l2", DIM, device=DEV.type)
    index.init_index(max_elements=N, M=M, ef_construction=EFC)
    torch.cuda.reset_peak_memory_stats()
    gather_dists.launches = 0
    packed_score.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.add_items(data)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = {"gather_dists": gather_dists.launches,
                      "packed_score": packed_score.launches}
    t0 = time.perf_counter()
    labels, dists = index.knn_query(queries, **QUERY_KNOBS)
    query_s = time.perf_counter() - t0  # includes the one-off payload pack
    launches = {"gather_dists": gather_dists.launches,
                "packed_score": packed_score.launches}
    say(f"[main] launches during build+query: {json.dumps(launches)} "
        f"(build alone: {json.dumps(build_launches)})")
    say(f"[main] build {build_s:.2f} s = {N / build_s:.0f} vectors/s; first "
        f"query batch (incl. payload pack) {query_s:.2f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{smi}]")

    # ---- correctness of what came out
    k = QUERY_KNOBS["k"]
    check_result(labels, dists, N_QUERIES, k)
    q = torch.from_numpy(queries).to(dev)
    exact = torch.sum(
        (x[torch.from_numpy(labels).to(dev)] - q[:, None, :]) ** 2, dim=-1)
    np.testing.assert_allclose(dists, exact.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    gt = device_ground_truth(x, q, k, "l2")
    rec = recall_of(labels, gt)
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
    before = (gather_dists.launches, packed_score.launches)
    k1_calls, seed_call, rerank_call = capture_query(index, qps_queries)
    batch_launches = {"gather_dists": gather_dists.launches - before[0],
                      "packed_score": packed_score.launches - before[1]}
    say(f"[main] launches per {QPS_BATCH}-query batch: "
        f"{json.dumps(batch_launches)}")

    # ---- kernels at the main path's shapes, on its data and its inputs
    k1_rows += check_k1_main(index._packed_index(), qps_queries, k1_calls,
                             flush, gen)
    del k1_calls
    knn_call = capture_knn_batch(x)
    k2_rows += check_k2_main(x, qps_queries, seed_call, rerank_call, knn_call,
                             flush, gen)
    del knn_call, seed_call, rerank_call
    # where one flat-scan batch spends its device time (matmul, top-k, the
    # elementwise passes): 8192 queries over the 1M rows, bf16 scan
    flat = bulk_mod.flat_from_rows(x, "l2")
    qq = torch.from_numpy(qps_queries).to(dev)
    flat_mod.flat_search(flat, qq, 10, "l2")
    flat_busy = busy_share(lambda: flat_mod.flat_search(flat, qq, 10, "l2"),
                           "flat_batch")
    say(f"[main flat batch] {QPS_BATCH} queries over {N}x{DIM} bf16 scan, "
        f"profiled: {fmt_share(flat_busy)}; device time by kernel "
        f"[name, ms, count]: {json.dumps(flat_busy['top'])} [{smi}]")
    del flat, qq

    for kern, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kern} was not launched on the main path")

    # ---- phase C: add after the bulk build (packed-build upkeep, K1)
    t0 = time.perf_counter()
    phase_c_out, rows = phase_c(index, data, queries, smi, flush, gen)
    k1_rows += rows
    say(f"[C] phase took {time.perf_counter() - t0:.1f} s")
    del index

    # ---- phase D: the benchmark harness and the flat indexes
    t0 = time.perf_counter()
    check_int8_scan(gen)
    phase_d3(x, data, queries, gt, smi)
    del x, data
    say(f"[D3] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    d1_out, rows = harness_case("D1", "glove1m", D1, smi, flush, gen,
                                ["gather_dists", "packed_score"])
    k2_rows += rows
    say(f"[D1] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    d2_out, rows = harness_case("D2", "deep10m", D2, smi, flush, gen,
                                ["gather_dists"])
    k2_rows += rows
    say(f"[D2] phase took {time.perf_counter() - t0:.1f} s (flat engine "
        f"only: the HNSW half of deep10m is not run)")

    by_phase = {
        "main_build": build_launches,
        "main_query_batch": batch_launches,
        "A_build": phase_a_out["launches_build"],
        "A_query_batch": phase_a_out["launches_per_batch"],
        "A_add_after_load": phase_a_out["launches_add"],
        "B_warm": phase_b_out["launches_warm"],
        "B_ingest": phase_b_out["launches_ingest"],
        **{f"B_query_batch_ef{r['ef']}_mi{r['max_iters']}":
           r["launches_per_batch"] for r in phase_b_out["sweep"]},
        "C_add": phase_c_out["launches_add"],
        "D1_glove1m": d1_out["launches"],
        "D2_deep10m_flat": d2_out["launches"],
    }
    shapes = ("bytes", "bound_ms", "share", "ms", "plain_ms")
    record = {"kernels": [
        dict(name="packed_score", route="cuda",
             source="ocaml_hnsw_tpu_torch/csrc/payload_score.cu",
             replaces="ocaml_hnsw_tpu/ops/pallas/payload_score.py:114",
             launches=launches["packed_score"],
             launches_build=build_launches["packed_score"],
             launches_per_batch=batch_launches["packed_score"],
             launches_by_phase={p: c["packed_score"]
                                for p, c in by_phase.items()},
             max_abs_err=max(r["max_abs_err"] for r in k1_rows),
             **headline(k1_rows, f"real B={QPS_BATCH // 2}"), library_ms=None,
             library_note=NO_LIBRARY,
             shapes=[{"case": r["case"], "shape": r["shape"],
                      **{s: r[s] for s in shapes}}
                     for r in k1_rows if "ms" in r]),
        dict(name="gather_dists", route="cuda",
             source="ocaml_hnsw_tpu_torch/csrc/gather_dist.cu",
             replaces="ocaml_hnsw_tpu/ops/pallas/gather_dist.py:65",
             launches=launches["gather_dists"],
             launches_build=build_launches["gather_dists"],
             launches_per_batch=batch_launches["gather_dists"],
             launches_by_phase={p: c["gather_dists"]
                                for p, c in by_phase.items()},
             max_abs_err=max(r["max_abs_err"] for r in k2_rows),
             **headline(k2_rows, "real rerank"), library_ms=None,
             library_note=NO_LIBRARY,
             shapes=[{"case": r["case"], "shape": r["shape"],
                      **{s: r[s] for s in shapes}}
                     for r in k2_rows if "ms" in r]),
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
