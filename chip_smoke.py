"""Smoke run of the torch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain torch version on edge cases and at main-path
shapes, then drives the port's paths through the public API and checks
their results against exact ground truth computed on the card:

  A. a small index from empty (BASELINE config 1, bench.py `random10k`:
     10k x 128, L2): incremental build, classic-engine queries, save_index /
     load_index with a resize, an add after the load;
  B. streaming ingest at the shapes of bench.py `laion-streaming` (768-d,
     cosine), depth cut to 96k rows: a warm add, then 10 ingest steps each
     followed by one 4096-query batch per (ef, max_iters) setting;
  main. the SIFT1M main path (1M x 128-d, L2, M=16): `Index.add_items`
     (bulk build) and `Index.knn_query` (packed engine);
  C. resize_index and a 50k-row add on top of that bulk-built index (the
     build-maintained payload: K1 in the construction beam), then the main
     path's queries again over all 1.05M rows.

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

The kernels are also held and timed at the new paths' shapes, on inputs
captured there: K2 on a phase-A build round's candidate block and on a
phase-B query batch's, K1 on a phase-C construction beam step.  Launch
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

from ocaml_hnsw_tpu_torch import Index
from ocaml_hnsw_tpu_torch.bench.datasets import clustered, queries_like
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
from ocaml_hnsw_tpu_torch.ops.quantize import quantize_rows

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
    wall time per kernel.  With --profile-dir DIR the op table (by host
    time) goes to DIR/profile_<name>.txt."""
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
    return dict(share=dev_us / 1e6 / wall if dev_us > 0 else None,
                kernels=kernels, wall_s=wall,
                us_per_kernel=wall * 1e6 / kernels if kernels else None)


def fmt_share(busy: dict) -> str:
    if busy["share"] is None:
        return "device busy not measured"
    return (f"device busy {busy['share']:.0%} of {busy['wall_s'] * 1e3:.0f} "
            f"ms, {busy['kernels']} kernels = {busy['us_per_kernel']:.1f} us "
            f"of wall each")


def recall_of(labels: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(labels.tolist(), gt.tolist())]))


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
    say("[kernels-only] all kernel checks passed")
    return 0


def ground_truth(x: torch.Tensor, q: torch.Tensor, k: int,
                 metric: str = "l2") -> np.ndarray:
    """Exact kNN in f32 on the card: matrix-form shortlist of 64, then an
    exact re-rank ((x - q)² for l2; 1 - x̂·q̂ for cosine)."""
    if metric == "cosine":
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        q = q / torch.linalg.norm(q, dim=1, keepdim=True)
        cand = torch.topk(q @ x.T, 64, dim=1).indices
        exact = 1.0 - torch.sum(x[cand] * q[:, None, :], dim=-1)
    else:
        xn = torch.sum(x * x, dim=1)
        qn = torch.sum(q * q, dim=1)
        d = qn[:, None] - 2.0 * (q @ x.T) + xn[None, :]
        cand = torch.topk(d, 64, dim=1, largest=False).indices
        del d
        exact = torch.sum((x[cand] - q[:, None, :]) ** 2, dim=-1)
    order = torch.argsort(exact, dim=1, stable=True)[:, :k]
    return torch.gather(cand, 1, order).cpu().numpy()


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
    rec = recall_of(labels, ground_truth(x, q, 10))
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
    rec_all = recall_of(lab3, ground_truth(x_all, q, 10))
    if rec_all < A_FLOOR:
        raise AssertionError(f"phase A recall@10 after the add {rec_all:.4f}"
                             f" < {A_FLOOR}")
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
    """laion-streaming shapes at 96k rows: warm add, 10 ingest steps, one
    timed 4096-query batch per setting after each (the first step's batch
    excluded from the sustained QPS, as the harness does)."""
    data = clustered(B_N, B_DIM, n_clusters=64, seed=7)
    queries = queries_like(data, N_QUERIES, seed=8)
    qb = np.tile(queries, (-(-B_QB // N_QUERIES), 1))[:B_QB]
    x = torch.from_numpy(data).to(DEV)
    gt = ground_truth(x, torch.from_numpy(queries).to(DEV), 10, "cosine")
    del x
    index = Index("cosine", B_DIM, device=DEV.type)
    index.init_index(max_elements=B_N, M=M, ef_construction=B_EFC,
                     round_size=B_RS)
    n_warm = B_N // 2
    step = (B_N - n_warm) // B_STEPS
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.add_items(data[:n_warm])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = read_launches()
    require_launches("B warm", warm_launches, ["gather_dists"])
    if index._state._packed_build or warm_launches["packed_score"]:
        raise AssertionError("phase B: the packed build switched on")
    ins_s = 0.0
    ingest_launches = {"gather_dists": 0, "packed_score": 0}
    q_s = {s: 0.0 for s in B_SETTINGS}
    batch_launches = {}
    for i in range(B_STEPS):
        lo = n_warm + i * step
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.add_items(data[lo:lo + step])
        torch.cuda.synchronize()
        ins_s += time.perf_counter() - t0
        for kern, c in read_launches().items():
            ingest_launches[kern] += c
        index._seed_index()  # the harness builds the seeds outside the timer
        for ef, mi in B_SETTINGS:
            reset_launches()
            t0 = time.perf_counter()
            index.knn_query(qb, k=10, ef=ef, max_iters=mi, engine="classic")
            dt = time.perf_counter() - t0
            batch_launches[(ef, mi)] = read_launches()
            require_launches(f"B query {ef}/{mi}", batch_launches[(ef, mi)],
                             ["gather_dists"])
            if i > 0:
                q_s[(ef, mi)] += dt
    require_launches("B ingest", ingest_launches, ["gather_dists"])
    if index._state._packed_build or ingest_launches["packed_score"]:
        raise AssertionError(f"phase B: the packed build ran during ingest "
                             f"{ingest_launches}")
    sweep = []
    for ef, mi in B_SETTINGS:
        labels, dists = index.knn_query(queries, k=10, ef=ef, max_iters=mi,
                                        engine="classic")
        check_result(labels, dists, N_QUERIES, 10)
        sweep.append(dict(ef=ef, max_iters=mi, recall=recall_of(labels, gt),
                          sustained_qps=B_QB * (B_STEPS - 1) / q_s[(ef, mi)],
                          launches_per_batch=batch_launches[(ef, mi)]))
    ef, mi = B_SETTINGS[-1]
    with recording(search_mod, "dists_to_ids") as calls:
        index.knn_query(qb, k=10, ef=ef, max_iters=mi, engine="classic")
    # the beam's 10th candidate block
    query_call = [c for c in calls
                  if tuple(c[5].shape) == (B_QB, COMPACT_K)][9]
    del calls
    query_busy = busy_share(lambda: index.knn_query(
        qb, k=10, ef=ef, max_iters=mi, engine="classic"), "B_query")
    out = dict(warm_vps=n_warm / warm_s, ingest_vps=(B_N - n_warm) / ins_s,
               launches_warm=warm_launches, launches_ingest=ingest_launches,
               sweep=sweep, query_busy=query_busy)
    say(f"[B laion-streaming cut to {B_N}x{B_DIM} cosine] warm "
        f"{n_warm / warm_s:.0f} vectors/s; ingest {(B_N - n_warm) / ins_s:.0f}"
        f" vectors/s over {B_STEPS} steps of {step}; " + "; ".join(
            f"ef={r['ef']} mi={r['max_iters']}: sustained QPS "
            f"{r['sustained_qps']:.0f}, end recall@10 {r['recall']:.4f}"
            for r in sweep) + f"; {fmt_share(query_busy)} in a "
        f"{B_QB}-query batch at {ef}/{mi} (profiled); K2 launches warm "
        f"{warm_launches['gather_dists']}, ingest "
        f"{ingest_launches['gather_dists']} [{smi}]")
    if sweep[-1]["recall"] < B_FLOOR:
        raise AssertionError(f"phase B recall@10 {sweep[-1]['recall']:.4f} "
                             f"< {B_FLOOR} at {B_SETTINGS[-1]}")
    vec, sc, qq, ids, metric = k2_args(query_call)
    rows = [k2_case(f"B query cold ({B_QB}, {COMPACT_K}) cosine", vec, sc,
                    qq, cold_ids(gen, B_QB, COMPACT_K, B_N), metric, flush,
                    time_it=True),
            k2_case(f"B query real ({B_QB}, {COMPACT_K}) cosine", vec, sc,
                    qq, ids, metric, flush, time_it=True)]
    return out, rows


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
    rec = recall_of(labels, ground_truth(
        x_all, torch.from_numpy(queries).to(DEV), QUERY_KNOBS["k"]))
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
    gt = ground_truth(x, q, k)
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
    del knn_call, seed_call, rerank_call, x

    for kern, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kern} was not launched on the main path")

    # ---- phase C: add after the bulk build (packed-build upkeep, K1)
    t0 = time.perf_counter()
    phase_c_out, rows = phase_c(index, data, queries, smi, flush, gen)
    k1_rows += rows
    say(f"[C] phase took {time.perf_counter() - t0:.1f} s")

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
