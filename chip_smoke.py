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
  B8. the same at bench.py `laion5m-streaming`'s memory plan (int8 rows in
     the graph from a bf16 source, round_size 1024), depth cut from 5M to
     96k rows: K2 on int8 rows in every add and query batch;
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
     under a registered L1 metric;
  F. the packed engine's options on the main path's graph, before C grows
     it (`models/packed.py`, `models/refine.py`): F1 `pack_graph(fused=
     True)` answers as the plain pack does, F2 a `deg_limit` ladder (and
     `max_chunk=4096`), F3 `bits=4` on the main data and, as its guard, on
     a grid-aligned 100k set, F4 the refined half-degree graph (`refine`'s
     time, its K2 launches, recall and QPS);
  E. the sharded index (`parallel/sharded.py::ShardedIndex`), one shard per
     card or two sharing a single card: SIFT-shaped rows cut to 200k, an
     add of 60k and classic queries, an add of the other 140k and packed
     queries (recall, QPS), save -> load, a tombstone, `get_items`.
  G. the build options, after C: G1 `bulk_build(scan_dtype="int8")` over
     the main path's 1M rows (every kNN table from the flat engine's exact
     int8 scan, reranked in f32 by K2), queried by the packed engine at the
     main knobs; G2 `models.build.build` and BuildStates with a capped
     Alg-4 admit scan (`select_scan`) at phase A's shapes.

    python3 chip_smoke.py                 # the whole run
    python3 chip_smoke.py --kernels-only  # build + kernel checks on
                                          # synthetic data, no index
    python3 chip_smoke.py --phase-f       # kernel checks, the main path's
                                          # build and queries, phase F, stop
    python3 chip_smoke.py --phase-b8      # build, then phase B8 alone, stop
    python3 chip_smoke.py --phase-g       # build, the main path's data,
                                          # then phase G alone, stop
    python3 chip_smoke.py --beam-update   # build, K4's checks, then K4 on
                                          # the main path's queries, the
                                          # classic step's checks and its
                                          # laion-shaped loops, stop

Kernel times are `bench/kernel_race.py::time_ms` in its "read" mode: the
median of CUDA-event timings, a spin kernel holding the stream while each
timed call is enqueued, and a 128 MiB buffer read before every rep, so
each call finds its data out of L2.  Cold inputs are random ids; "real"
inputs are captured from the main path itself (K1's nodes at the 10th beam
iteration of an 8192-query batch, K2's seed and rerank ids of that batch, and one
1024-row batch of the kNN table), also timed with the L2 flushed, so what
reuse remains is the sharing of hub rows inside one call.  Each time stands
beside its bound, `hnsw_bench/roofline.py::least_seconds`: the bytes the
call must move (every distinct row or slab it touches read once, every
output written once) over the memory rate, or its operations over the peak
rate for their type if that is longer; K1's and K3's work is counted by
the roofline's `k1_cost` and `k3_cost`, as the benchmark counts it.  A line
`[floor]` gives the time of a near-empty launch timed the same way, which
every kernel time includes; each timed K1 line also gives its ring's
stages, the kernel's registers, resident warps per SM and items per warp.

The kernels are also held and timed at the other paths' shapes, on inputs
captured there: K2 on a phase-A build round's candidate block, on the
phase-B and phase-B8 query and build blocks, on the flat engines' rerank
blocks of D1 and D2, on phase E's level-0 build block and per-shard
rerank, K1 on a phase-C construction beam step, on a phase-E shard's query
beam step and at phase F's variants (`slots` on a deg_limit step,
`bits=4`, the refined deg-16 payload; K2 on refine's candidate block).

K4 (`beam_update`, the packed beam loop's dedup, merge and next-node
select) is held against its plain version bit for bit (the update, the
update without the next selection, the selection alone) at the paths'
shapes (`K4_SHAPES`: the main path's half batch, glove1m's packed point,
the construction beam, a deg_limit step; timed cold) and on edge shapes
and rows (`K4_EDGE_SHAPES`: B no multiple of a block, ef and C no powers
of two, the widest rows it takes; tied distances, candidates all -1,
repeated or already in the beam, beams fully expanded or empty).  With
`--beam-update`, the main path's 8192-query call must launch it 2 ×
max_iters + 2 times and answer exactly as the eager beam step it replaced;
it is timed on that call's own inputs, and the two calls in turns.

K4's classic step (`beam_step_classic`: the classic beam loop's merge,
select, adjacency expansion, dedup and compaction) is held against its
plain version bit for bit (with the previous step's block and without it;
the live flag too) at laion1m.stream's shapes (`K4C_SHAPES`: the round's
level-0 beam, the 4096-query classic batch, an upper level's beam over the
arena; timed cold) and on edge shapes and rows (`K4C_EDGE_SHAPES`; blocks
all -1 or repeated, a beam whose every adjacency id is in it, beams fully
expanded or empty, a batch with nothing left to expand).  With
`--beam-update`, `beam_search_layer` at those three shapes on a 200k x 768
cosine random graph must launch the step once an iteration (once more on
the step that finds every beam expanded), K2 once an iteration and K4's
merge once after a capped loop, run no bitonic stage but the entries'
sort, and answer exactly as the eager loop it replaced.

K3 (`scan_topk`, the flat scan and its top-k select in one kernel) is held
against its plain version on edge cases (B and N no multiple of a tile, D =
96, 100, 128, 768 and the narrow copy units, bf16 and int8, every metric,
tombstones, n < N, rerank_k 32, 97 and K_MAX, and rerank_k over K_MAX,
which takes one launch per page of K_MAX, with rows repeated so that
scores tie across a page's edge), each on every path that takes it (the
`wgmma` block, of two consumer warpgroups or of one, and the `sync`
block): int8 scores equal bit for bit, bf16 scores within the f32
summation bound (`k3_agree`).  On adversarial integer-valued inputs
(`check_k3_adversarial`: rows in decreasing distance to the queries, so
that nearly every tile brings candidates; rows repeated, so that scores
tie) its lists equal the plain version's in (score, id) order bit for
bit, bf16 and int8, at rerank_k 32, 97, K_MAX and a bounded page.  It is
timed cold at the main path's shapes
(the kNN table's 8192-row block, k = 97; the 8192-query flat batch, k =
32: each as planned and on the sync path; G1's int8 kNN block), at k =
256 on main's rows (the one-warpgroup block, and on the sync path) and at
D1's and D2's captured flat batches, beside its bound, its plain version
and cuBLAS's bf16 product of the same shapes alone.  No scan may take K3's
plain route (`read_launches`), no main-path phase its sync path, and the
main flat batch's profile must hold K3's kernel (`kernel_census`).
Ground truth everywhere is the harness's `device_ground_truth` (exact f32
on the card).  Launch counters are zeroed before each phase and read after
it; a phase whose path runs a kernel fails if that kernel did not launch.

Exits non-zero, printing no result, when no CUDA device is available.  The
last line of stdout is {"ok": true, "device": {...}}; the line before it is
the card's name and power limit, and the line before that lists each kernel
with its launches on the main path (and per phase), its largest difference
from the plain version, its times and bounds.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from hnsw_bench.roofline import (
    F32_FLOPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S, k1_cost, k3_cost,
    least_seconds,
)
from ocaml_hnsw_tpu_torch import BFIndex, FlatIndex, HnswConfig, Index
from ocaml_hnsw_tpu_torch.bench import harness as harness_mod
from ocaml_hnsw_tpu_torch.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu_torch.bench.harness import device_ground_truth, recall_of
from ocaml_hnsw_tpu_torch.bench.kernel_race import (
    CONVERSIONS, FLUSH_BYTES, sass_op_counts, time_ms,
)
from ocaml_hnsw_tpu_torch.models import build as build_mod
from ocaml_hnsw_tpu_torch.models import bulk as bulk_mod
from ocaml_hnsw_tpu_torch.models import flat as flat_mod
from ocaml_hnsw_tpu_torch.models import packed as packed_mod
from ocaml_hnsw_tpu_torch.models import search as search_mod
from ocaml_hnsw_tpu_torch.models.graph import UpperView
from ocaml_hnsw_tpu_torch.ops.kernels import _lib
from ocaml_hnsw_tpu_torch.ops.kernels.beam_update import (
    beam_step_classic, beam_step_classic_plain, beam_update,
    beam_update_plain, classic_width,
)
from ocaml_hnsw_tpu_torch.ops.kernels import gather_dist as k2_mod
from ocaml_hnsw_tpu_torch.ops.kernels import payload_score as k1_mod
from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import (
    gather_dists, gather_dists_plain,
)
from ocaml_hnsw_tpu_torch.ops.kernels.payload_score import (
    nibble_unpack, packed_score, packed_score_plain,
)
from ocaml_hnsw_tpu_torch.ops.kernels import scan_topk as k3_mod
from ocaml_hnsw_tpu_torch.ops.kernels.scan_topk import (
    scan_topk, scan_topk_plain,
)
from ocaml_hnsw_tpu_torch.ops import metrics as metrics_mod
from ocaml_hnsw_tpu_torch.ops import sortmerge as sortmerge_mod
from ocaml_hnsw_tpu_torch.ops.quantize import quantize_rows, storage_dtype
from ocaml_hnsw_tpu_torch.parallel import ShardedIndex
from ocaml_hnsw_tpu_torch.parallel.sharded import make_mesh
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
#: phases B and B8: bench.py's streaming configs (bench/harness.py
#: run_streaming_config), 768-d cosine, depth cut to 96k rows
B_N, B_DIM, B_EFC, B_QB, B_STEPS = 96_000, 768, 200, 4096, 10
B_SETTINGS = ((96, 16), (128, 24))
B_FLOOR = 0.90  # at (128, 24)
#: tag: (config, graph rows, source dtype, round_size, the K2 path of its
#: rows).  B: laion-streaming (cut from 1M), f32 rows; B8: laion5m-
#: streaming's memory plan (cut from 5M), int8 rows from a bf16 source
STREAM_PHASES = {
    "B": ("laion-streaming", "f32", "f32", 2048, "ring"),
    "B8": ("laion5m-streaming", "int8", "bf16", 1024, "vector"),
}
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
#: phase E: the sharded index, SIFT-shaped rows cut from 1M to 200k (the
#: sharded build is incremental); the first add stays under
#: ShardedIndex.PACKED_THRESHOLD (classic queries), the second crosses it
#: (packed queries at the JAX package's sharded S=1 knobs)
E_N, E_FIRST, E_RS = 200_000, 60_000, 2048
E_CLASSIC = dict(k=10, ef=64)
E_KNOBS = dict(k=10, ef=64, max_iters=29, expand=2, rerank_k=32)
E_FLOOR = 0.90
#: phase F: the packed engine's options on main's 1M graph; the deg_limit
#: ladder (effective 16, 16, 32 slots at W=2048) with one rung's max_iters
#: doubled; the bits=4 guard's grid-aligned set (components in [-7, 7]); the
#: refined half-degree graph and its query rung at max_iters x 1.25
F_DEG_LIMITS = (8, 16, 24)
F_RAISED = dict(deg_limit=16, max_iters=2 * QUERY_KNOBS["max_iters"])
F_GRID_N, F_GRID_SEED, F_INT4_SLACK = 100_000, 17, 0.02
F_REFINE_DEG = 16
F_REFINE_MI = (QUERY_KNOBS["max_iters"] * 5) // 4
#: phase G: G2's admit-scan caps at phase A's shapes: 64 (the JAX
#: package's measured cap, here the whole efC=64 beam) and 20 (64/200 of
#: the beam, the fraction that cap is of JAX's 1M efC=200 build)
G_SELECT_SCANS = (64, 20)
#: the JAX package's comment on select_scan=64 (`models/build.py:1121-1123`)
G_JAX_SCAN_DELTA = -0.004
#: paired QPS runs of an option against its full-byte pack: pairs, and the
#: measure_qps warm-up and timed batches of each run
F_PAIRS, F_PAIR_WARMUP, F_PAIR_REPS = 10, 1, 2
#: the classic engine's candidate compaction at M=16 (knn_query "auto")
COMPACT_K = 96
K2_RTOL = K2_ATOL = 1e-5  # summation order differs (warp tree vs torch)
#: per-row scales of the int8 rows holding every value (check_k2_int8_values)
INT8_EDGE_SCALES = (0.0, 1e-30, 1e30, 0.01, 1.0)
# K1 must equal its plain version bit for bit (exact int32 dot, same
# rounding in the epilogue)
#: K3 (scan_topk) edge cases: B queries against N rows cut from a
#: 12288-slot flat (no multiple of any tile) with n of them written, at
#: each width; rerank_k cycles through K3_KS
K3_EDGE = (300, 11_997, 10_000)
K3_DIMS = (96, 100, 128, 768)
K3_KS = (32, 97, k3_mod.K_MAX)
#: K3's adversarial inputs (`check_k3_adversarial`): B queries x N rows x
#: D, the duplicates' pool of distinct rows, the paged rerank_k
K3_ADV = (1024, 65_536, 128)
K3_ADV_POOL = 2048
K3_ADV_PAGED = 300
#: bf16 scans: the least share of (query, slot) ids K3 and its plain
#: version hold in common (the rest tie with the k-th score within the f32
#: summation bound)
K3_SHARED = 0.999
#: K3's kernel on the main path (the wgmma block's instances)
K3_MAIN_KERNEL = "scan_topk_wgmma"
#: the benchmark cells' seed scans (`check_seed_scan`) besides the main
#: path's own (sift1m.packed-8192's shape: 8192 queries, seed_e 8, over the
#: 1M index's 65,536-slot seed index): label, B queries, U_cap seed rows,
#: live rows (the level>=1 nodes, ~1/16 of the index), D, metric, seed_e.
#: laion1m.stream's classic call (seed_e 16) over 1M rows, and
#: msturing2m.update's over its 2M rows and 825k old versions
SEED_SCANS = (("laion1m", 4096, 65_536, 62_500, 768, "cosine", 16),
              ("msturing2m", 4096, 262_144, 176_000, 100, "l2", 16))
#: reps of K3's plain version at the main-path shapes (0.2-2.6 s a call)
K3_PLAIN_REPS = 3

#: K4 (beam_update) at the paths' shapes: label, B, ef, C, E.  The main
#: path's interleaved half (sift1m: ef 64, E 2 x deg 32; bits=4 has the same
#: shape), glove1m's packed point, the incremental build's construction
#: beam, phase F's deg_limit=16 step (slots 16, no interleave)
K4_SHAPES = (("sift B=4096", 4096, 64, 64, 2),
             ("glove packed ef=160", 4096, 160, 64, 2),
             ("construction beam", 1024, 200, 256, 8),
             ("slots=16 B=8192", 8192, 64, 32, 2))
#: K4 edge shapes: B no multiple of a block's rows, ef and C no powers of
#: two, a merge inside one register (width 32), the widest rows it takes
K4_EDGE_SHAPES = (("ef=100 C=64", 777, 100, 64, 2),
                  ("ef=12 C=5", 33, 12, 5, 3),
                  ("ef=10 C=16 (width 32)", 9, 10, 16, 1),
                  ("ef=3 C=2", 5, 3, 2, 4),
                  ("ef=64 C=300 (block)", 65, 64, 300, 2),
                  ("ef=4096 C=64 (widest beam)", 3, 4096, 64, 4),
                  ("ef=1000 C=4000 (widest run)", 2, 1000, 4000, 2))

#: K4's classic step (beam_step_classic) at laion1m.stream's shapes: label,
#: B, ef, E, deg, compact_k, upper (an UpperView).  The insert round's
#: level-0 beam (ef_construction 200, compact_k 96: a 512-wide merge, the
#: block path), the classic 4096-query batch (ef 128: the warp path), an
#: upper level's beam (ef 32, M = 16 ids a node, no compaction)
K4C_SHAPES = (("round level 0", 2048, 200, 4, 32, 96, False),
              ("query", 4096, 128, 4, 32, 96, False),
              ("round upper", 2048, 32, 4, 16, None, True))
#: classic-step edge shapes: B no multiple of a block's rows, ef, C and deg
#: no powers of two, a merge inside one register, over 256 slots (the block
#: path at a narrow beam), the widest beam and run it takes
K4C_EDGE_SHAPES = (
    ("ef=100 E=3 deg=7", 777, 100, 3, 7, None, False),
    ("ef=12 E=5 deg=5 ck=9", 33, 12, 5, 5, 9, True),
    ("ef=10 E=1 deg=16 (width 32)", 9, 10, 1, 16, None, False),
    ("ef=3 E=2 deg=2", 5, 3, 2, 2, None, True),
    ("ef=64 E=8 deg=40 ck=96 (320 slots)", 65, 64, 8, 40, 96, False),
    ("ef=4096 E=4 deg=32 ck=96 (widest beam)", 3, 4096, 4, 32, 96, True),
    ("ef=1000 E=64 deg=64 ck=4000 (widest run)", 2, 1000, 64, 64, 4000,
     False))
#: the laion-shaped loops' random graph: rows (768-d cosine) and the
#: entries a query starts from (the seed scan's seed_e)
K4C_N, K4C_DIM, K4C_ENTRIES = 200_000, 768, 16

REPS = 20  # timed calls per kernel time (K3's own: 10)
CAPTURE_ITER = 9  # the beam loop's 10th iteration
KNN_K = 64  # bulk_build's kNN table: k + 1 + 32 = 97 candidates reranked
DEV = torch.device("cuda")
NO_LIBRARY = ("no single PyTorch call computes it: a gather and a distance "
              "are at least two calls (index_select, then a reduction)")
K3_NO_LIBRARY = ("no single PyTorch call computes it: a product and a top-k "
                 "are two calls; product_ms is cuBLAS's bf16 product of the "
                 "same shapes alone, as context (never called by the port)")
K3_REPLACES = ("XLA's MXU dot_general fused with jax.lax.approx_min_k "
               "(ocaml_hnsw_tpu/models/flat.py:170-200), not a Pallas kernel")
K4_REPLACES = ("no TPU kernel: the JAX engine's beam step (models/packed.py,"
               " _beam_body) is one XLA program on the TPU")
K4_NO_LIBRARY = ("no single PyTorch call computes it: a dedup, a sort, a "
                 "merge and a select are many calls (plain_ms)")
K1_REGS: dict = {}  # registers per K1 instance (phase_build_kernels)
#: the tensor-core product instructions the build step counts per kernel:
#: mma.sync's (HMMA, IMMA) and wgmma's (HGMMA, IGMMA)
TENSOR_OPS = ("HMMA", "IMMA", "HGMMA", "IGMMA")


def say(msg: str) -> None:
    print(msg, flush=True)


def k1_int4_bound(args, d, d_ref):
    """|d - d_ref| allowed between K1 and its plain version at bits=4: both
    sum exact f32 products (nibble x bf16), in different orders, so the dot
    differs by at most 2·n·2⁻²⁴·Σ|y·q| (n = 2·d_pad <= 2¹⁰ terms), and the
    epilogue's roundings by a few ulps of its terms:
    2⁻¹⁴·s²·Σ|y·q| + 2⁻²⁰·(s²·‖y‖² + ‖q‖² + |d|) per candidate."""
    nodes, meta, pay, q16, qn, scale = args[:6]
    slots = args[7] or pay.shape[1]
    deg = meta.shape[1] // 2
    safe = nodes.clamp_min(0).long()
    lo, hi = nibble_unpack(pay[:, :slots][safe])
    qf = q16.float().abs()[:, None, None, :]
    absdot = (lo.float().abs() * qf[..., 0::2]
              + hi.float().abs() * qf[..., 1::2]).sum(-1)
    s2 = float(scale) ** 2
    nrm = meta[safe][:, :, deg:deg + slots].float()
    b = nodes.shape[0]
    return (2.0 ** -14 * s2 * absdot.reshape(b, -1)
            + 2.0 ** -20 * (s2 * nrm.reshape(b, -1) + qn[:, None].abs()
                            + d_ref.abs()))


def k1_residency(args) -> dict:
    """The ring packed_score launches `args` with (its launch plan, as the
    wrapper picks it) and what the card holds of it: stages, the kernel
    instance's registers, resident warps per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and items per warp."""
    nodes, meta, pay = args[:3]
    slots = (args[7] if len(args) > 7 else None) or pay.shape[1]
    bits = args[8] if len(args) > 8 else 8
    b, e = nodes.shape
    _, deg, d_pad = pay.shape
    sms = torch.cuda.get_device_properties(pay.device).multi_processor_count
    plan = k1_mod.launch_plan(e, deg, d_pad, meta.data_ptr() % 16 == 0,
                              slots, bits)
    per_sm = k1_mod.occupancy(plan, d_pad, bits)
    held = min(sms * per_sm * plan.warps,
               -(-b * e // plan.warps) * plan.warps)
    return dict(stages=plan.stages,
                registers=K1_REGS.get(k1_mod.kernel_instance(d_pad, bits)),
                warps_per_sm=per_sm * plan.warps, items_per_warp=b * e / held)


def method_floor() -> dict:
    """Device time of a near-empty launch (`torch.cuda._sleep(1)`) by
    `time_ms`, with and without the L2 flush: what every kernel time in
    this script includes besides the kernel's own work."""
    flush = torch.zeros(FLUSH_BYTES // 4, device=DEV)
    floor = {mode: time_ms(lambda: torch.cuda._sleep(1), how, REPS, flush)
             * 1e3 for mode, how in (("cold", "read"), ("warm", "warm"))}
    del flush
    return floor


def k2_cost(vec, ids, metric: str) -> tuple[int, int]:
    """(bytes, f32 flops) of one gather_dists call on these ids."""
    b, k = ids.shape
    d = vec.shape[1]
    live = ids[ids >= 0]
    row = d * vec.element_size() + (4 if vec.dtype == torch.int8 else 0)
    nbytes = (int(torch.unique(live).numel()) * row + b * d * 4
              + b * k * 4 + b * k * 4)
    return nbytes, (3 if metric == "l2" else 2) * int(live.numel()) * d


def k2_requested(vec, ids) -> int:
    """Bytes of the rows one gather_dists call requests: every live (b, k)
    fetches its row, whether or not another (b, k) fetched it (the bound
    counts each distinct row once; the two differ by the ids' reuse)."""
    row = vec.shape[1] * vec.element_size()
    return int((ids >= 0).sum()) * row


def timed(row: dict, kernel, plain, nbytes: int, ops: int, peak: float,
          flush) -> dict:
    ms = time_ms(kernel, "read", REPS, flush)
    plain_ms = time_ms(plain, "read", REPS, flush)
    bms = least_seconds(nbytes, ops, peak) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
    row.update(bytes=nbytes, bound_ms=bms, bound_by=by, ms=ms,
               plain_ms=plain_ms, share=bms / ms)
    return row


def fmt(row: dict) -> str:
    if "ms" not in row:
        return f"max |err| {row['max_abs_err']:.3e}"
    req = ""
    if "requested_bytes" in row:
        req = (f"; rows requested {row['requested_bytes'] / 1e6:.1f} MB = "
               f"{row['requested_bytes'] / row['ms'] / 1e9:.2f} TB/s")
    return (f"max |err| {row['max_abs_err']:.3e}; {row['bytes'] / 1e6:.1f} MB,"
            f" bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}); "
            f"kernel {row['ms'] * 1e3:.1f} us = {row['share']:.0%} of bound;"
            f" plain {row['plain_ms'] * 1e3:.1f} us{req}")


def k1_case(label: str, args, flush=None, time_it: bool = False) -> dict:
    """packed_score against its plain version: ids equal, distances equal
    bit for bit at bits=8 (exact int32 dot), within `k1_int4_bound` at
    bits=4.  `args` may carry slots and bits after needs_norms."""
    nodes, _, pay = args[0], args[1], args[2]
    slots = (args[7] if len(args) > 7 else None) or pay.shape[1]
    bits = args[8] if len(args) > 8 else 8
    ids, d = packed_score(*args)
    ids_ref, d_ref = packed_score_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(ids, ids_ref):
        raise AssertionError(f"K1 {label}: candidate ids differ from plain")
    fin = torch.isfinite(d_ref)
    if not torch.equal(torch.isfinite(d), fin):
        raise AssertionError(f"K1 {label}: empty slots differ from plain")
    if bits == 8:
        if not torch.equal(d, d_ref):
            raise AssertionError(f"K1 {label}: distances differ from plain")
        agree = "equal"
    else:
        over = ((d - d_ref).abs() > k1_int4_bound(args, d, d_ref)) & fin
        if over.any():
            raise AssertionError(f"K1 {label}: {int(over.sum())} distances "
                                 "outside the f32 summation bound")
        agree = "within the f32 summation bound"
    err = float((d[fin] - d_ref[fin]).abs().max()) if fin.any() else 0.0
    _, deg, d_pad = pay.shape
    row = dict(case=label, shape=[*nodes.shape, deg, d_pad], slots=slots,
               bits=bits, max_abs_err=err)
    ring = ""
    if time_it:
        nbytes, ops, peak = k1_cost(nodes, slots, d_pad, bits)
        timed(row, lambda: packed_score(*args),
              lambda: packed_score_plain(*args), nbytes, ops, peak, flush)
        row.update(k1_residency(args))
        ring = (f"; {row['stages']} stages, {row['registers']} registers, "
                f"{row['warps_per_sm']} warps per SM, "
                f"{row['items_per_warp']:.2f} items per warp")
    say(f"[K1 packed_score] {label} B={nodes.shape[0]} E={nodes.shape[1]} "
        f"deg={deg} slots={slots} d_pad={d_pad} bits={bits}: {agree}; "
        f"{fmt(row)}{ring}")
    return row


def k2_case(label: str, vec, scales, q, ids, metric: str, flush=None,
            time_it: bool = False, path: str | None = None,
            force: bool = False) -> dict:
    """gather_dists against its plain version within K2_RTOL / K2_ATOL;
    `path` ("vector" / "ring" / "generic") asserts which path the plan
    takes, or with `force` makes the plan take it."""
    run_path = path if force else None
    got = k2_mod.launch_plan(
        *ids.shape, vec.shape[1], vec.element_size(),
        vec.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0,
        k2_mod._sm_count(vec.device) if vec.is_cuda else 132, run_path).path
    if path is not None and got != path:
        raise AssertionError(f"K2 {label}: plan took the {got} path")
    out = gather_dists(vec, scales, q, ids, metric, run_path)
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
        row["requested_bytes"] = k2_requested(vec, ids)
        timed(row,
              lambda: gather_dists(vec, scales, q, ids, metric, run_path),
              lambda: gather_dists_plain(vec, scales, q, ids, metric),
              nbytes, ops, F32_FLOPS_PER_S, flush)
    say(f"[K2 gather_dists] {label} B={ids.shape[0]} K={ids.shape[1]} "
        f"D={vec.shape[1]} {row['dtype']} {metric} ({got} path"
        f"{', forced' if force else ''}): agree; {fmt(row)}")
    return row


@contextlib.contextmanager
def recording(module, name: str, want=None, keep: int | None = None):
    """Keep the arguments of every call to `module.name` (a pass-through),
    or of the calls whose arguments `want` accepts, the last `keep` only."""
    calls = collections.deque(maxlen=keep)
    real = getattr(module, name)

    def rec(*args, **kwargs):
        if want is None or want(args):
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
    arguments and the result of the last call only."""
    calls = []
    real = getattr(owner, name)

    def metered(*args, **kwargs):
        before = read_launches()
        out = real(*args, **kwargs)
        after = read_launches()
        if calls:
            for key in ("args", "kwargs", "result"):
                calls[-1].pop(key)
        calls.append(dict(launches={k: after[k] - before[k] for k in after},
                          args=args, kwargs=kwargs, result=out))
        return out

    setattr(owner, name, metered)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def sum_launches(calls) -> dict:
    return {k: sum(c["launches"][k] for c in calls) for k in read_launches()}


def reset_launches() -> None:
    gather_dists.launches = 0
    for counts in (gather_dists.launches_by_path,
                   gather_dists.launches_by_dtype):
        counts.update(dict.fromkeys(counts, 0))
    packed_score.launches = 0
    beam_update.launches = 0
    beam_step_classic.launches = 0
    scan_topk.launches = 0
    for counts in (scan_topk.launches_by_dtype, scan_topk.launches_by_path):
        counts.update(dict.fromkeys(counts, 0))
    search_mod.seed_entries.kernel_scans = 0
    search_mod.seed_entries.plain_scans = 0


def read_launches() -> dict:
    """Launch counts: each kernel's, K2's by path ("gather_dists/ring",
    ...) and by row dtype ("gather_dists/int8", ...), K3's by scan dtype
    ("scan_topk/int8", ...) and by path ("scan_topk/wgmma", ...), and the
    seed scans K3 served ("seed_entries/kernel").  Raises if any scan took
    K3's plain route (`scan_topk.plain_routes`,
    `seed_entries.plain_scans`): no path of this script may."""
    if scan_topk.plain_routes or search_mod.seed_entries.plain_scans:
        raise AssertionError(f"{scan_topk.plain_routes} scans and "
                             f"{search_mod.seed_entries.plain_scans} seed "
                             "scans took K3's plain route")
    return {"gather_dists": gather_dists.launches,
            "packed_score": packed_score.launches,
            "beam_update": beam_update.launches,
            "beam_step_classic": beam_step_classic.launches,
            "scan_topk": scan_topk.launches,
            "seed_entries/kernel": search_mod.seed_entries.kernel_scans,
            **{f"gather_dists/{p}": n
               for p, n in gather_dists.launches_by_path.items()},
            **{f"gather_dists/{d}": n
               for d, n in gather_dists.launches_by_dtype.items()},
            **{f"scan_topk/{d}": n
               for d, n in scan_topk.launches_by_dtype.items()},
            **{f"scan_topk/{p}": n
               for p, n in scan_topk.launches_by_path.items()}}


def require_launches(phase: str, launches: dict, kernels) -> None:
    for kern in kernels:
        if launches[kern] <= 0:
            raise AssertionError(f"{kern} was not launched in phase {phase}")
    # the main path's shapes all fit K3's wgmma block: its sync path (PR
    # 12's kernel, kept for the shapes that do not) must not run there
    if "scan_topk" in kernels and launches["scan_topk/sync"]:
        raise AssertionError(f"{launches['scan_topk/sync']} K3 launches took "
                             f"the sync path in phase {phase}")


def kernel_census(fn) -> list[str]:
    """The names of the device kernels one call of fn launches, as
    torch.profiler records them.  Once a process has run for a minute or
    so, torch.profiler drops the first kernel records of a window, more as
    the process ages (PERF.md §7); a schedule that runs fn in a wait and a
    warm-up step before the recorded one keeps that call whole."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # device events but the schedule's step annotation, which spans them
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


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
        # K3's instances keep everything in registers (the wgmma block of
        # two consumer warpgroups: 168 at launch, 232 for the consumers
        # and 40 for the producer after setmaxnreg; of one: as launched)
        if "scan_topk::" in name and not spill.startswith("0 bytes stack "
                                                         "frame, 0 bytes "
                                                         "spill"):
            raise AssertionError(f"{name} spills: {spill}")
        if name.startswith("void packed_score_kernel"):
            K1_REGS[name[len("void "):]] = int(regs.split()[1])
    # int -> float conversion instructions per kernel (cuobjdump -sass).
    # Every kernel keeps a few outside its loops (integer division by way
    # of a float reciprocal, K1's epilogue); K2 widens int8 rows by integer
    # ops, so its int8 vector and ring kernels may have no more than their
    # bf16 twins, which convert nothing per element
    sass = sass_op_counts(path, CONVERSIONS + TENSOR_OPS)
    for kernel, counts in sass.items():
        say(f"[build] sass {kernel}: {json.dumps(counts)}")
        # K3's product runs on the tensor cores: wgmma's HGMMA in the
        # wgmma path's bf16 instances and IGMMA in its int8 ones, HMMA and
        # IMMA in the sync path's (the mma.sync kernel)
        if kernel.startswith("scan_topk::scan_topk_"):
            targs = kernel.split("<")[1].rstrip(">").split(", ")
            if "scan_topk_wgmma" in kernel:  # <kInt8, kBound, BUF, WGS>
                op = "IGMMA" if targs[0] == "true" else "HGMMA"
            else:  # scan_topk_kernel<QT, kInt8, kBound>
                op = "IMMA" if targs[1] == "true" else "HMMA"
            if counts[op] == 0:
                raise AssertionError(f"{kernel}: no {op} in its SASS")
        if kernel.startswith(("gather_vec_kernel<signed char",
                              "gather_ring_kernel<signed char")):
            twin = sass[kernel.replace("signed char, true",
                                       "__nv_bfloat16, false")]
            if any(counts[op] > twin[op] for op in CONVERSIONS):
                raise AssertionError(f"{kernel}: int->float conversions "
                                     f"{counts}, its bf16 twin {twin}")


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


def k1_inputs(n: int, b: int, e: int, d_pad: int, gen, neg: float = 0.02,
              bits: int = 8):
    """Random nodes (some -1, all of query 0), a query row per query (int8
    [b, d_pad], or for bits=4 bf16 values of q/s [b, 2·d_pad]) and norms."""
    dev = DEV
    nodes = gen.integers(0, n, size=(b, e)).astype(np.int32)
    nodes[gen.random((b, e)) < neg] = -1
    if b:
        nodes[0, :] = -1  # one query with nothing to expand
    if bits == 8:
        q8 = torch.from_numpy(
            gen.integers(-127, 128, size=(b, d_pad), dtype=np.int8)).to(dev)
    else:
        q8 = torch.from_numpy((gen.standard_normal((b, 2 * d_pad)) * 3)
                              .astype(np.float32)).to(dev).to(torch.bfloat16)
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
        ("d_pad=48 (3 chunks a row)", 20_000, 32, 48, 777, 2),
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
            for slots in (1, deg):
                rows.append(k1_case(f"slots={slots}", (
                    nodes, meta, pay, q8, qn, scale, True, slots, 8)))
            for slots, needs_norms in ((17, True), (16, True), (9, False)):
                rows.append(k1_case(f"slots={slots} meta misaligned", (
                    nodes, off, pay, q8, qn, scale, needs_norms, slots, 8)))
        if label == "d_pad=256":  # deg 32: the meta row rides in the ring
            for slots in (17, 31):
                rows.append(k1_case(f"slots={slots} meta in ring", (
                    nodes, meta, pay, q8, qn, scale, False, slots, 8)))
        if d_pad != 128:
            # two lanes per row at <= 16 slots on the generic instance
            # (d_pad / 16 chunks from d_pad; at d_pad 48 an odd count, the
            # halves 2 and 1)
            for slots in (9, 16):
                for needs_norms in (True, False):
                    rows.append(k1_case(
                        f"{label} slots={slots} "
                        f"{'l2' if needs_norms else 'ip'}",
                        (nodes, meta, pay, q8, qn, scale, needs_norms, slots,
                         8)))
        del pay, meta
    rows += check_k1_int4(scale, gen)
    check_k1_empty(scale)
    return rows


def check_k1_int4(scale, gen) -> list[dict]:
    """bits=4 at d=100 (64 stored bytes, the components past 100 zero in
    payload and query, as a pack leaves them) and d=768 (384 bytes: the
    generic path), with and without slots, l2 and ip; and at d=128 on slabs
    that each hold every byte (all 256 nibble pairs)."""
    rows = []
    n, deg, stored = 20_000, 32, 64
    pay, meta = synthetic_packed(n, deg, stored, seed=256)
    every = np.tile(np.arange(256, dtype=np.uint8), deg * stored // 256)
    pay.copy_(torch.from_numpy(np.stack([gen.permutation(every)
                                         for _ in range(n)]).view(np.int8)
                               .reshape(n, deg, stored)))
    nodes, q16, qn = k1_inputs(n, 1000, 2, stored, gen, bits=4)
    for needs_norms in (True, False):
        rows.append(k1_case(f"bits=4 every nibble pair "
                            f"{'l2' if needs_norms else 'ip'}",
                            (nodes, meta, pay, q16, qn, scale, needs_norms,
                             None, 4)))
    del pay, meta
    for label, n, deg, d, b in (("bits=4 d=100", 50_000, 32, 100, 2000),
                                ("bits=4 d=768", 20_000, 32, 768, 500),
                                ("bits=4 deg=33 d=128", 20_000, 33, 128, 300)):
        stored = packed_mod.pack_d_pad(d) // 2
        pay, meta = synthetic_packed(n, deg, stored, seed=d + deg)
        nodes, q16, qn = k1_inputs(n, b, 2, stored, gen, bits=4)
        if d % 128:  # zero the padded components' nibbles and query values
            pay[:, :, d // 2:] = 0
            q16[:, d:] = 0
        for slots in (None, 9):
            for needs_norms in (True, False):
                tag = (f"{label} slots={slots or deg} "
                       f"{'l2' if needs_norms else 'ip'}")
                rows.append(k1_case(tag, (nodes, meta, pay, q16, qn, scale,
                                          needs_norms, slots, 4)))
        del pay, meta
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
    """Odd B and K on the vector path for every dtype and metric, the
    generic path (bf16 D=100, misaligned bases), and the ring path
    (`check_k2_ring`)."""
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
    tiny = torch.from_numpy(
        gen.standard_normal((5_000, 16)).astype(np.float32)).to(dev)
    vec, sc, _ = quantize_rows(tiny, "int8")
    rows.append(k2_case("int8 D=16 (a lane per row)", vec, sc,
                        queries(64, 16, False), ids_for(64, 45, 5_000), "l2",
                        path="vector"))
    rows += check_k2_ring(gen, ids_for, queries)
    rows += check_k2_int8_values(gen, ids_for)
    return rows


def check_k2_int8_values(gen, ids_for) -> list[dict]:
    """int8 rows that each hold every value -128..127 (quantize_rows never
    stores -128), per-row scales cycling through INT8_EDGE_SCALES, on every
    path: the vector path (forced) at D=768, the ring (forced) at D=2304,
    the generic path on a misaligned base.  l2 against random queries (at
    1e30 every distance overflows to +inf, in both versions alike); ip
    against one-hot queries, so each distance is one element times its
    scale, with no sum whose order could differ: a wrong element at the
    hot position shows far outside the tolerance."""
    rows = []
    for d, b, k, n, path, force in (
            (768, 301, 37, 3_000, "vector", True),
            (2304, 51, 9, 2_000, "ring", True),
            (768, 301, 37, 3_000, "generic", False)):
        vals = np.tile(np.arange(-128, 128, dtype=np.int8), d // 256)
        vec = torch.from_numpy(np.stack([gen.permutation(vals)
                                         for _ in range(n)])).to(DEV)
        sc = torch.tensor(INT8_EDGE_SCALES, dtype=torch.float32,
                          device=DEV).repeat(-(-n // len(INT8_EDGE_SCALES)))
        sc = sc[:n].contiguous()
        if path == "generic":
            vec = misaligned(vec)
        ids = ids_for(b, k, n)
        q = torch.from_numpy(gen.standard_normal((b, d)).astype(
            np.float32)).to(DEV)
        hot = torch.zeros((b, d), device=DEV)
        hot[torch.arange(b, device=DEV),
            torch.from_numpy(gen.integers(0, d, b)).to(DEV)] = 0.5
        for metric, qq in (("l2", q), ("ip", hot)):
            rows.append(k2_case(f"int8 every value, scales "
                                f"{INT8_EDGE_SCALES}", vec, sc, qq, ids,
                                metric, path=path, force=force))
    return rows


def check_k2_ring(gen, ids_for, queries) -> list[dict]:
    """The ring path at D=768 and D=2304 for every dtype, l2 and ip, on odd
    B and K (ragged tasks and row groups) with -1 and repeated ids; one row
    set taken by the vector path too; K=1, B=1 and every id -1; a ring
    forced on a misaligned query raises."""
    rows = []
    for d, b, k, n in ((768, 301, 37, 20_000), (2304, 51, 9, 2_000)):
        base = torch.from_numpy(
            gen.standard_normal((n, d)).astype(np.float32)).to(DEV)
        unit = base / torch.linalg.norm(base, dim=1, keepdim=True)
        ids = ids_for(b, k, n)
        ids[:, 2] = ids[:, 1]  # repeated ids in a task
        ids[1::2, k - 1] = ids[1::2, 3]
        for metric, rows_f in (("l2", base), ("ip", unit)):
            q = queries(b, d, metric == "ip")
            for storage in ("f32", "bf16", "int8"):
                vec, sc, _ = quantize_rows(rows_f, storage)
                rows.append(k2_case("odd B, K, repeated ids", vec, sc, q, ids,
                                    metric, path="ring", force=True))
                if d == 768 and metric == "l2":
                    rows.append(k2_case("odd B, K, repeated ids", vec, sc, q,
                                        ids, metric, path="vector",
                                        force=True))
        vec, sc, _ = quantize_rows(base, "f32")
        q = queries(b, d, False)
        rows.append(k2_case("K=1", vec, sc, q, ids[:, :1].contiguous(),
                            "l2", path="ring", force=True))
        rows.append(k2_case("B=1", vec, sc, q[:1], ids[:1], "l2",
                            path="ring", force=True))
        rows.append(k2_case("every id -1", vec, sc, q,
                            torch.full_like(ids, -1), "l2", path="ring",
                            force=True))
        if d == 2304:  # wider than 1024 elements: the plan's own choice
            rows.append(k2_case("unforced", vec, sc, q, ids, "l2",
                                path="ring"))
    try:
        gather_dists(vec, sc, misaligned(q), ids, "l2", "ring")
    except ValueError:
        say("[K2 gather_dists] ring forced on a misaligned query: raises")
    else:
        raise AssertionError("K2: a ring forced on a misaligned query ran")
    return rows


# ------------------------------------------------------- main-path shapes
# ------------------------------------------------------------ K3 scan_topk
def k3_inputs(b: int, n_rows: int, n_live: int, dim: int, dtype: str,
              metric: str, gen, dead_share: float = 0.05):
    """(scan, scales, norms, deleted, n, q): the first n_rows slots of a
    flat (`flat_add` of n_live random rows, unit rows under cosine), a
    `dead_share` of them tombstoned, and b random queries (unit under
    cosine, as `preprocess_queries` makes them)."""
    flat = flat_mod.empty_flat(dim, n_rows, scan_dtype=dtype, device=DEV)
    rows = torch.from_numpy(gen.standard_normal((n_live, dim),
                                                dtype=np.float32)).to(DEV)
    q = torch.from_numpy(gen.standard_normal((b, dim),
                                             dtype=np.float32)).to(DEV)
    if metric == "cosine":
        rows = rows / torch.linalg.norm(rows, dim=1, keepdim=True)
        q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    flat_mod.flat_add(flat, rows, 0, n_live)
    flat.deleted[:] = torch.from_numpy(gen.random(flat.n_cap)
                                       < dead_share).to(DEV)
    cut = slice(0, n_rows)
    return (flat.scan[cut], flat.scales[cut], flat.norms[cut],
            flat.deleted[cut], flat.n, q)


def k3_eps(scan, q, id_lists, l2: bool):
    """Per query, the f32 summation bound 2·D·2⁻²⁴·Σ|q_i·x_i| of a bf16
    scan's dot (two sums of exact products in different orders), doubled
    for l2's score, at its worst over the rows either list holds."""
    qa = q.to(torch.bfloat16).float().abs()
    worst = torch.zeros(q.shape[0], device=q.device)
    for ids in id_lists:
        x = scan[ids.clamp_min(0)].float().abs()
        t = torch.einsum("bkd,bd->bk", x, qa)
        worst = torch.maximum(worst, torch.where(ids >= 0, t, 0.0).amax(1))
    return (2.0 if l2 else 1.0) * 2 * q.shape[1] * 2.0 ** -24 * worst


def k3_agree(label: str, scan, q, s, i, s_ref, i_ref, metric: str) -> str:
    """K3's (scores, ids) against its plain version's, both ascending.
    int8: scores equal bit for bit, ids equal but where a score ties with
    the k-th.  bf16: every score within the f32 summation bound of the
    plain one at the same slot (`k3_eps`, plus the epilogue's last
    rounding), at least K3_SHARED of the (query, slot) ids shared, and
    every id the plain list lacks within that bound of its k-th score.
    Entries at +inf (fewer live rows than rerank_k) must match in number."""
    fin, fin_ref = torch.isfinite(s), torch.isfinite(s_ref)
    if not torch.equal(fin, fin_ref):
        raise AssertionError(f"K3 {label}: finite entries differ from plain")
    kth = s_ref[:, -1:]
    shared = (i[:, :, None] == i_ref[:, None, :]).any(-1) & fin
    if scan.dtype == torch.int8:
        if not torch.equal(s, s_ref):
            raise AssertionError(f"K3 {label}: int8 scores differ from plain")
        if (fin & ~shared & (s != kth)).any():
            raise AssertionError(f"K3 {label}: ids differ from plain away "
                                 "from ties with the k-th score")
        return "scores equal, ids equal but at ties"
    tol = (k3_eps(scan, q, (i, i_ref), metric == "l2")[:, None]
           + 2.0 ** -22 * s_ref.abs())
    over = ((s - s_ref).abs() > tol) & fin
    if over.any():
        raise AssertionError(f"K3 {label}: {int(over.sum())} scores outside "
                             "the f32 summation bound")
    frac = float(shared.sum()) / max(1, int(fin.sum()))
    if frac < K3_SHARED:
        raise AssertionError(f"K3 {label}: {frac:.5f} of ids shared < "
                             f"{K3_SHARED}")
    miss = fin & ~shared & ((s - kth).abs() > tol[:, -1:])
    if miss.any():
        raise AssertionError(f"K3 {label}: {int(miss.sum())} ids the plain "
                             "list lacks, away from its k-th score")
    return f"within the f32 bound, {frac:.5f} of ids shared"


def k3_product(scan, q):
    """cuBLAS's bf16 product of the same shapes alone (int8 rows upcast to
    bf16 first, untimed), 1024 queries at a time into one [1024, N] block:
    context for K3's time; the port never calls it."""
    rows = scan if scan.dtype == torch.bfloat16 else scan.to(torch.bfloat16)
    qb = q.to(torch.bfloat16)
    out = torch.empty((min(1024, q.shape[0]), rows.shape[0]),
                      dtype=torch.bfloat16, device=DEV)

    def run():
        for q0 in range(0, qb.shape[0], out.shape[0]):
            blk = qb[q0:q0 + out.shape[0]]
            torch.matmul(blk, rows.T, out=out[:blk.shape[0]])

    return run


def k3_case(label: str, args, rerank_k: int, metric: str, flush=None,
            time_it: bool = False, path: str | None = None) -> dict:
    """scan_topk (on `path` when given) against scan_topk_plain on `args`
    (scan, scales, norms, deleted, n, q) by `k3_agree`; with `time_it`,
    both cold beside the bound, and the bf16 product alone
    (`k3_product`)."""
    scan, q = args[0], args[5]
    s, i = scan_topk(*args, rerank_k, metric, path=path)
    s_ref, i_ref = scan_topk_plain(*args, rerank_k, metric)
    torch.cuda.synchronize()
    agree = k3_agree(label, scan, q, s, i, s_ref, i_ref, metric)
    fin = torch.isfinite(s_ref)
    err = float((s[fin] - s_ref[fin]).abs().max()) if fin.any() else 0.0
    b, dim = q.shape
    plan = k3_mod.plan_for(scan, b, min(rerank_k, k3_mod.K_MAX), path=path)
    row = dict(case=label, shape=[b, scan.shape[0], dim, rerank_k],
               dtype=str(scan.dtype).replace("torch.", ""), metric=metric,
               max_abs_err=err, path=plan.path,
               plan=dict(path=plan.path, qt=plan.qt, stages=plan.stages,
                         buf=plan.buf, producer=plan.producer,
                         splits=plan.splits,
                         vec=plan.vec, smem=plan.smem_bytes,
                         pages=-(-rerank_k // k3_mod.K_MAX)))
    timing = ""
    if time_it:
        # the live rows, as the benchmark's k3_roofline_pct counts them
        n = int(args[4])
        nbytes, ops, peak = k3_cost(n - int(args[3][:n].sum()), dim,
                                    scan.element_size(), b, rerank_k)
        ms = time_ms(lambda: scan_topk(*args, rerank_k, metric, path=path),
                     "read", 10, flush)
        plain_ms = time_ms(lambda: scan_topk_plain(*args, rerank_k, metric),
                           "read", K3_PLAIN_REPS, flush)
        product_ms = time_ms(k3_product(scan, q), "read", 5, flush)
        bms = least_seconds(nbytes, ops, peak) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
        row.update(bytes=nbytes, bound_ms=bms, bound_by=by, ms=ms,
                   plain_ms=plain_ms, share=bms / ms, product_ms=product_ms,
                   tops=ops / ms / 1e9)
        timing = (f"; {nbytes / 1e6:.1f} MB, {ops / 1e12:.2f} T ops, bound "
                  f"{bms:.3f} ms ({by}); kernel {ms:.3f} ms = {bms / ms:.1%}"
                  f" of bound, {row['tops']:.1f} T ops/s; plain "
                  f"{plain_ms:.2f} ms; bf16 product alone {product_ms:.3f} ms")
    say(f"[K3 scan_topk] {label} B={b} N={scan.shape[0]} D={dim} "
        f"k={rerank_k} {row['dtype']} {metric} "
        f"(plan {json.dumps(row['plan'])})"
        f": {agree}; max |err| {err:.3e}{timing}")
    return row


def k3_paths(args, rerank_k: int) -> list:
    """The paths of K3 whose block takes these inputs (forced in turn where
    both do); a rerank_k over K_MAX also as the plan routes each page
    (None: the pages of kcap 256 and the last, bounded, each on the path
    its shape takes)."""
    scan, q = args[0], args[5]
    out = [None] if rerank_k > k3_mod.K_MAX else []
    for path in k3_mod.PATHS:
        try:
            k3_mod.plan_for(scan, q.shape[0], min(rerank_k, k3_mod.K_MAX),
                            path=path)
        except ValueError:
            continue
        out.append(path)
    return out


def check_k3_edges(gen) -> list[dict]:
    """K3 against its plain version at K3_EDGE for every width of K3_DIMS,
    both scan dtypes and every metric (rerank_k cycling through K3_KS),
    then the narrow copy units (bf16 D=101, int8 D=99 and D=100, a bf16
    base 8 bytes off 16), few live rows and one query, each on every path
    that takes it (`k3_paths`).  The wgmma block has two consumer
    warpgroups at most of them and one at rerank_k 256, at the paged
    cases' kcap 256 and at D = 768."""
    b, n_rows, n_live = K3_EDGE
    rows = []

    def on_paths(label, args, k, metric):
        paths = k3_paths(args, k)
        if not paths:
            raise AssertionError(f"K3 {label}: no path takes it")
        for path in paths:
            rows.append(k3_case(f"{label} [{path or 'by page'}]", args, k,
                                metric, path=path))

    cases = [(dim, dtype, metric) for dim in K3_DIMS
             for dtype in ("bf16", "int8")
             for metric in ("l2", "ip", "cosine")]
    for c, (dim, dtype, metric) in enumerate(cases):
        k = K3_KS[c % len(K3_KS)]
        on_paths(f"edge {dtype} D={dim} {metric} k={k}",
                 k3_inputs(b, n_rows, n_live, dim, dtype, metric, gen), k,
                 metric)
    for dim, dtype, off in ((101, "bf16", 0), (99, "int8", 0),
                            (100, "int8", 0), (100, "bf16", 1)):
        args = k3_inputs(b, n_rows + off, n_live, dim, dtype, "l2", gen)
        args = tuple(t[off:] for t in args[:4]) + args[4:]
        on_paths(f"narrow copies {dtype} D={dim} offset {off}", args, 97,
                 "l2")
    on_paths("few live rows", k3_inputs(37, 300, 120, 128, "bf16", "ip", gen,
                                        0.5), 97, "ip")
    on_paths("one query", k3_inputs(1, n_rows, n_live, 128, "int8", "cosine",
                                    gen), 32, "cosine")
    # rerank_k over K_MAX: pages of K_MAX, each bounded by the page before;
    # the second third of the rows repeats the first, so scores tie across
    # page edges (int8: exactly), and some queries are rows
    for dtype, metric, dim, k, bq in (("int8", "ip", 96, 600, b),
                                      ("bf16", "l2", 128, 300, b),
                                      ("int8", "cosine", 100, 257, b)):
        args = k3_inputs(bq, n_rows, n_live, dim, dtype, metric, gen)
        third = n_live // 3
        for t in args[:3]:
            t[third:2 * third] = t[:third]
        q = args[5].clone()
        q[:bq // 4] = args[0][:bq // 4].float() * (
            args[1][:bq // 4, None] if dtype == "int8" else 1.0)
        on_paths(f"paged {dtype} D={dim} {metric} k={k}, repeated rows",
                 args[:5] + (q,), k, metric)
    return rows + check_k3_adversarial(gen)


def k3_exact_flat(rows, dtype: str, gen, dead_share: float = 0.02):
    """(scan, scales, norms, deleted, n) of a flat holding the f32 `rows`
    in order, a `dead_share` of them tombstoned."""
    flat = flat_mod.empty_flat(rows.shape[1], rows.shape[0],
                               scan_dtype=dtype, device=DEV)
    flat_mod.flat_add(flat, rows, 0, rows.shape[0])
    flat.deleted[:] = torch.from_numpy(gen.random(flat.n_cap)
                                       < dead_share).to(DEV)
    return flat.scan, flat.scales, flat.norms, flat.deleted, flat.n


def check_k3_adversarial(gen) -> list[dict]:
    """K3 where its candidate path works hardest, against its plain
    version in (score, id) order (every row's plain score, sorted by
    `merge_splits`: ties to the lower id), bit for bit, at k = 32, 97, 256
    and 300 (a page of 256, then a bounded page of 44), bf16 and int8, l2.
    Values are small integers, so bf16 products and sums are exact and
    equal in both.  "ordered": rows sorted by decreasing distance to a
    centre that half the queries sit on and the other half near, so that
    nearly every tile brings candidates to every query and its queues
    fill; "duplicates": rows drawn from a pool of K3_ADV_POOL, so scores
    tie across many ids."""
    b, n, dim = K3_ADV
    centre = gen.integers(-8, 9, dim).astype(np.float32)
    off = gen.integers(-8, 9, (n, dim)).astype(np.float32)
    ordered = centre + off[np.argsort(-(off * off).sum(1), kind="stable")]
    near = np.zeros((b, dim), np.float32)
    near[b // 2:, :2] = gen.integers(-1, 2, (b - b // 2, 2))
    pool = gen.integers(-8, 9, (K3_ADV_POOL, dim)).astype(np.float32)
    data = {"ordered": (ordered, centre + near),
            "duplicates": (pool[gen.integers(0, K3_ADV_POOL, n)],
                           gen.integers(-8, 9, (b, dim)).astype(np.float32))}
    rows = []
    for name, (x, q) in data.items():
        x, q = torch.from_numpy(x).to(DEV), torch.from_numpy(q).to(DEV)
        for dtype in ("bf16", "int8"):
            args = k3_exact_flat(x, dtype, gen) + (q,)
            s_all, i_all = scan_topk_plain(*args, n, "l2")
            for k in K3_KS + (K3_ADV_PAGED,):
                s, i = scan_topk(*args, k, "l2")
                ws, wi = k3_mod.merge_splits(s_all[:, None], i_all[:, None], k)
                torch.cuda.synchronize()
                if not (torch.equal(s, ws) and torch.equal(i, wi)):
                    raise AssertionError(
                        f"K3 {name} {dtype} k={k}: {int((i != wi).sum())} "
                        "ids differ from plain in (score, id) order")
                plan = k3_mod.plan_for(args[0], b, min(k, k3_mod.K_MAX))
                rows.append(dict(case=f"{name} {dtype} k={k}",
                                 shape=[b, n, dim, k], max_abs_err=0.0,
                                 path=plan.path))
                say(f"[K3 scan_topk] adversarial {name} {dtype} l2 B={b} "
                    f"N={n} D={dim} k={k} (plan {plan.path} qt={plan.qt} "
                    f"buf={plan.buf}, "
                    f"{-(-k // k3_mod.K_MAX)} page(s)): equal to plain in "
                    f"(score, id) order, bit for bit")
            del args, s_all, i_all
    return rows


def check_k3_main(x, qps_queries, flush) -> list[dict]:
    """K3 timed at the main path's shapes on main's rows: the kNN table's
    8192-row block (k = KNN_K + 1 + 32) and the flat batch (8192 queries,
    k = 32), bf16, then G1's int8 kNN block; each as its plan runs it, and
    the bf16 rows again on the sync path (the mma.sync kernel), for the record.
    Then the flat batch at k = K_MAX (lists of 256: the one-warpgroup
    wgmma block, off the main path) as planned and on the sync path."""
    k = KNN_K + 1 + 32
    qq = torch.from_numpy(qps_queries).to(DEV)
    flat = bulk_mod.flat_from_rows(x, "l2")
    args = (flat.scan, flat.scales, flat.norms, flat.deleted, flat.n)
    rows = []
    for label, q, kk in ((f"kNN-table block {QPS_BATCH}x{N}", x[:QPS_BATCH],
                          k),
                         (f"flat batch {QPS_BATCH}x{N}", qq, 32),
                         (f"flat batch {QPS_BATCH}x{N} k={k3_mod.K_MAX}", qq,
                          k3_mod.K_MAX)):
        rows.append(k3_case(label, (*args, q), kk, "l2", flush, time_it=True))
        rows.append(k3_case(f"{label} [sync path]", (*args, q), kk, "l2",
                            flush, time_it=True, path="sync"))
    del flat, args
    flat = bulk_mod.flat_from_rows(x, "l2", scan_dtype="int8")
    rows.append(k3_case(f"G1 int8 kNN-table block {QPS_BATCH}x{N}",
                        (flat.scan, flat.scales, flat.norms, flat.deleted,
                         flat.n, x[:QPS_BATCH]), k, "l2", flush,
                        time_it=True))
    return rows


def eager_seed_scan(seeds, bias, q, e: int, metric: str):
    """The seed scan as `seed_entries` ran it before K3 took it (an f32
    product of bf16-rounded operands, the metric's score, a +inf bias at
    dead rows, a bf16 cast, `torch.topk`): timed beside K3 here, never
    called by the port."""
    mm = metrics_mod.get_metric(metric).matmul_score
    dot = torch.matmul(q.to(torch.bfloat16).float(), seeds.vecs.float().T)
    scores = mm(dot, seeds.norms[None, :]) + bias[None, :]
    return torch.topk(scores.to(torch.bfloat16), e, dim=1,
                      largest=False).indices


def seed_scan_cases(main_call, gen):
    """(label, seed_entries' arguments) of the seed scans `check_seed_scan`
    runs: the main path's own, as its packed call passed them (the main
    index's SeedIndex and the 8192 prepared queries), then SEED_SCANS' on
    clustered rows behind a seed bank whose slots past the live rows are
    dead, each made when its turn comes."""
    yield "sift1m (main index)", main_call
    for label, b, u_cap, n_live, dim, metric, e in SEED_SCANS:
        data = clustered(n_live, dim, n_clusters=max(1, n_live // 2500),
                         seed=int(gen.integers(1 << 30)))
        x = torch.from_numpy(data).to(DEV)
        q = search_mod.preprocess_queries(torch.from_numpy(
            queries_like(data, b, seed=int(gen.integers(1 << 30)))).to(DEV),
            metric)
        if metrics_mod.get_metric(metric).normalize_add:
            x = search_mod.normalize_rows(x)
        del data
        vectors, scales, norms = quantize_rows(x, "f32")
        del x
        graph = types.SimpleNamespace(vectors=vectors, scales=scales,
                                      norms=norms)
        bank = torch.full((u_cap,), -1, dtype=torch.int32, device=DEV)
        bank[:n_live] = torch.arange(n_live, dtype=torch.int32, device=DEV)
        seeds = search_mod.seed_index_from_bank(graph, bank, n_live, metric)
        yield label, (graph, seeds, q, search_mod.query_norms(q, metric), e,
                      metric)


def check_seed_scan(main_call, flush, gen) -> list[dict]:
    """`seed_entries` on the main path's own operands (`main_call`, the
    arguments its packed call passed) and at the other benchmark cells'
    seed-scan shapes (SEED_SCANS): one K3 launch a call (`kernel_scans`),
    every entry a live seed row, its distance K2's; K3's lists against its
    plain version's (`k3_agree`: equal but at f32 ties); K3, the eager scan
    it replaced (`eager_seed_scan`) and the whole `seed_entries` call timed
    cold beside K3's bound."""
    rows = []
    for label, call in seed_scan_cases(main_call, gen):
        graph, seeds, q, qn, e, metric = call
        u_cap, dim = seeds.vecs.shape
        b, n_live = q.shape[0], int(seeds.n)
        k3_args = (seeds.vecs, seeds.scales, seeds.norms, seeds.dead,
                   seeds.n, q)
        before = search_mod.seed_entries.kernel_scans
        ids, d = search_mod.seed_entries(*call)
        torch.cuda.synchronize()
        if search_mod.seed_entries.kernel_scans != before + 1:
            raise AssertionError(f"seed scan {label}: K3 did not serve it")
        if not ((ids >= 0) & torch.isin(ids, seeds.ids[~seeds.dead])).all():
            raise AssertionError(f"seed scan {label}: an entry is not a live "
                                 "seed row")
        if not torch.equal(d, gather_dists(graph.vectors, graph.scales, q,
                                           ids, metric)):
            raise AssertionError(f"seed scan {label}: entry distances are "
                                 "not K2's")
        s, i = scan_topk(*k3_args, e, metric)
        s_ref, i_ref = scan_topk_plain(*k3_args, e, metric)
        agree = k3_agree(f"seed scan {label}", seeds.vecs, q, s, i, s_ref,
                         i_ref, metric)
        same = float((i == i_ref).float().mean())
        plan = k3_mod.plan_for(seeds.vecs, b, e)
        nbytes, ops, peak = k3_cost(n_live, dim, 2, b, e)
        bms = least_seconds(nbytes, ops, peak) * 1e3
        ms = time_ms(lambda: scan_topk(*k3_args, e, metric), "read", 10,
                     flush)
        bias = torch.where(seeds.dead, float("inf"), 0.0)
        eager_ms = time_ms(lambda: eager_seed_scan(seeds, bias, q, e, metric),
                           "read", 5, flush)
        call_ms = time_ms(lambda: search_mod.seed_entries(*call), "read", 10,
                          flush)
        row = dict(case=f"seed scan {label}", shape=[b, u_cap, dim, e],
                   live=n_live, metric=metric, path=plan.path,
                   plan=dict(path=plan.path, qt=plan.qt, stages=plan.stages,
                             buf=plan.buf, producer=plan.producer,
                             splits=plan.splits),
                   ids_equal=same, bytes=nbytes, bound_ms=bms, ms=ms,
                   share=bms / ms, eager_ms=eager_ms, call_ms=call_ms)
        say(f"[seed scan] {label} B={b} U={u_cap} ({n_live} live) D={dim} "
            f"{metric} E={e} (plan {json.dumps(row['plan'])}): {agree}, "
            f"{same:.5f} of ids equal slot for slot; K3 {ms * 1e3:.1f} us "
            f"= {bms / ms:.1%} of its bound {bms * 1e3:.1f} us; eager scan "
            f"{eager_ms * 1e3:.1f} us; seed_entries {call_ms * 1e3:.1f} us")
        rows.append(row)
        del graph, seeds, q, qn, call, k3_args, bias, ids, d, s, i
    return rows


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
            for b, k in ((QPS_BATCH, 8), (QPS_BATCH, 32),
                         (QPS_BATCH, KNN_K + 1 + 32)):
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
    """Arguments of K1, of the seed scan (`seed_entries`) and of K2 in one
    8192-query knn_query."""
    with recording(packed_mod, "packed_score") as k1_calls, \
            recording(packed_mod, "seed_entries") as scans, \
            recording(packed_mod, "dists_to_ids") as rerank, \
            recording(search_mod, "dists_to_ids") as seed:
        index.knn_query(qps_queries, **QUERY_KNOBS)
    if len(k1_calls) != 2 * QUERY_KNOBS["max_iters"] or len(rerank) != 1 \
            or len(seed) != 1 or len(scans) != 1:
        raise AssertionError(f"capture: {len(k1_calls)} K1 calls, "
                             f"{len(rerank)} reranks, {len(scans)} seed "
                             f"scans, {len(seed)} seed re-scores")
    return k1_calls, scans[0], k2_args(seed[0]), k2_args(rerank[0])


def capture_knn_batch(x: torch.Tensor):
    """Arguments of K2 in one 8192-row batch (the 2nd) of the kNN table."""
    flat = bulk_mod.flat_from_rows(x, "l2")
    with recording(flat_mod, "gather_dists") as calls:
        bulk_mod.knn_table(flat, x[QPS_BATCH:2 * QPS_BATCH], KNN_K, "l2")
    (vec, scales, q, ids, metric), = calls
    return vec, scales, q, ids, metric


def kernels_only(gen) -> int:
    """Edge checks plus cold timings on synthetic data (no index)."""
    flush = torch.zeros(FLUSH_BYTES // 4, device=DEV)
    check_k1_edges(gen)
    check_k4_edges(gen, flush)
    check_k4c_edges(gen, flush)
    check_k3_edges(gen)
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


# ---------------------------------------------------------- K4 beam update
def k4_inputs(b: int, ef: int, c: int, gen, ties: bool = False,
              edges: bool = False):
    """A sorted beam (pk = 2·id + expanded, ~70% expanded, a quarter of
    the rows part empty) and C candidates a row (~30% of them beam ids,
    ~15% -1, the rest from a pool of 4·(ef + C) ids, so ids repeat), made
    with numpy from `gen`.  ties=True: distances from 16 values.
    edges=True: rows cycle through all candidates -1, one id repeated,
    every candidate in the beam, a fully expanded beam, an empty beam."""
    n = 4 * (ef + c)
    ids = np.argsort(gen.random((b, n)), axis=1)[:, :ef].astype(np.int32)

    def dists(shape):
        if ties:
            return gen.integers(0, 16, shape).astype(np.float32)
        return (gen.random(shape) * 100).astype(np.float32)

    d = np.sort(dists((b, ef)), axis=1)
    flags = (gen.random((b, ef)) < 0.7).astype(np.int32)
    part = np.where(gen.random(b) < 0.25, gen.integers(0, ef + 1, b), 0)
    empty = np.arange(ef)[None, :] >= ef - part[:, None]
    pick = gen.random((b, c))
    cid = np.where(pick < 0.3,
                   ids[np.arange(b)[:, None], gen.integers(0, ef, (b, c))],
                   np.where(pick < 0.45, -1, gen.integers(0, n, (b, c))))
    cid = cid.astype(np.int32)
    cd = dists((b, c))
    if edges:
        kind = np.arange(b) % 5
        cid[kind == 0] = -1
        cid[kind == 1] = cid[kind == 1][:, :1]
        cid[kind == 2] = ids[kind == 2][:, np.arange(c) % ef]
        flags[kind == 3] = 1
        empty[kind == 4] = True
    pk = np.where(empty, -1, ids * 2 + flags).astype(np.int32)
    d[empty] = np.inf
    cd[cid < 0] = np.inf

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)

    return put(pk), put(d), put(cid), put(cd)


def k4_cost(b: int, ef: int, c: int, e: int) -> int:
    """Bytes of one beam_update call: the beam read and written, the
    candidates read, the nodes written."""
    return b * ef * 16 + b * c * 8 + b * e * 4


def bits_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def k4_case(label: str, args, e: int, flush=None,
            time_it: bool = False) -> dict:
    """beam_update against its plain version, bit for bit: the update with
    and without the next selection, and the selection alone; each CUDA
    call must launch the kernel."""
    pk, d, cid, cd = args
    b, ef = pk.shape
    c = cid.shape[1]
    calls = [((pk, d, cid, cd), dict(expand=e)),
             ((pk, d, cid, cd), dict(expand=e, select_next=False)),
             ((pk, d), dict(expand=e))]
    for a, kw in calls:
        before = beam_update.launches
        out = beam_update(*a, **kw)
        ref = beam_update_plain(*a, **kw)
        torch.cuda.synchronize()
        if beam_update.launches != before + (b > 0):
            raise AssertionError(f"K4 {label}: a CUDA call did not launch")
        for name, x, y in zip(("beam_pk", "beam_d", "nodes"), out, ref):
            if not bits_equal(x, y):
                raise AssertionError(f"K4 {label} {kw}: {name} differs from "
                                     "plain")
    row = dict(case=label, shape=[b, ef, c, e], max_abs_err=0.0)
    if time_it:
        timed(row, lambda: beam_update(pk, d, cid, cd, expand=e),
              lambda: beam_update_plain(pk, d, cid, cd, expand=e),
              k4_cost(b, ef, c, e), 0, INT8_OPS_PER_S, flush)
    say(f"[K4 beam_update] {label} B={b} ef={ef} C={c} E={e}: equal bit for "
        f"bit (update, update without select, select alone); {fmt(row)}")
    return row


def check_k4_edges(gen, flush=None) -> list[dict]:
    """K4 on the paths' shapes (timed cold, L2 flushed) and edge shapes,
    with real-valued and tied distances, and on rows of edge cases."""
    rows = []
    for label, b, ef, c, e in K4_SHAPES + K4_EDGE_SHAPES:
        main = (label, b, ef, c, e) in K4_SHAPES
        rows.append(k4_case(f"cold {label}", k4_inputs(b, ef, c, gen), e,
                            flush, time_it=main and flush is not None))
        rows.append(k4_case(f"{label} ties", k4_inputs(b, ef, c, gen,
                                                       ties=True), e))
        rows.append(k4_case(f"{label} edge rows", k4_inputs(
            b, ef, c, gen, ties=True, edges=True), e))
    rows.append(k4_case("B=0", k4_inputs(0, 64, 64, gen), 2))
    return rows


def k1_between(k1_args, k4_args, e: int, smi: str, reps: int = 30) -> None:
    """K1's device time on the main path's own inputs, from the profiler's
    kernel records (no host time in them, as the benchmark's trace reads
    it), when what runs between two K1 calls is K4, the eager beam step K4
    replaced (~200 small kernels), or nothing on an idle card (a 200 us
    host wait after a synchronize): the means over `reps` calls, so a
    change in K1's traced time can be told from a change in K1."""
    from torch.profiler import ProfilerActivity, profile

    def one(mode):
        packed_score(*k1_args)
        if mode == "k4":
            beam_update(*k4_args, expand=e)
        elif mode == "eager":
            beam_update_plain(*k4_args, expand=e)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 200e-6:
                pass

    out = {}
    for mode in ("k4", "eager", "idle"):
        for _ in range(3):
            one(mode)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                one(mode)
            torch.cuda.synchronize()
        k1 = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and "packed_score_kernel" in ev.key]
        n = sum(ev.count for ev in k1)
        out[mode] = (sum(ev.self_device_time_total for ev in k1) / n
                     if n else float("nan"), n)
    say(f"[K4 main] K1 real B={QPS_BATCH // 2}, device time by the profiler"
        f" when between two K1 calls runs K4: {out['k4'][0]:.1f} us, the "
        f"eager step: {out['eager'][0]:.1f} us, nothing on an idle card: "
        f"{out['idle'][0]:.1f} us (means of {out['k4'][1]}, "
        f"{out['eager'][1]}, {out['idle'][1]} records) [{smi}]")


def phase_k4(smi: str, flush, gen) -> list[dict]:
    """K4 on the main path: the SIFT1M-shaped index built as main builds
    it, then 8192-query knn_query calls at the main knobs.  The call
    launches K4 2·max_iters + 2 times (each half's first selection, then
    one update an iteration), and answers exactly as the same call with
    the plain version in K4's place (the eager beam step it replaced).
    Times K4 on the main path's own inputs at the 10th iteration, and the
    two calls in alternating pairs."""
    data = clustered(N, DIM, n_clusters=400, seed=7)
    qps_queries = queries_like(data, QPS_BATCH, seed=9)
    index = Index("l2", DIM, device=DEV.type)
    index.init_index(max_elements=N, M=M, ef_construction=EFC)
    index.add_items(data)
    del data
    index.knn_query(qps_queries, **QUERY_KNOBS)  # packs, seeds, warms up
    reset_launches()
    with recording(packed_mod, "beam_update") as calls, \
            recording(packed_mod, "packed_score") as k1_calls:
        labels, dists = index.knn_query(qps_queries, **QUERY_KNOBS)
    per_call = read_launches()
    want = 2 * QUERY_KNOBS["max_iters"] + 2
    if per_call["beam_update"] != want or len(calls) != want:
        raise AssertionError(f"K4: {per_call['beam_update']} launches, "
                             f"{len(calls)} calls in an {QPS_BATCH}-query "
                             f"call, {want} expected")
    say(f"[K4 main] launches per {QPS_BATCH}-query call: "
        f"{json.dumps(per_call)}")

    def eager():
        real = packed_mod.beam_update
        packed_mod.beam_update = beam_update_plain
        try:
            return index.knn_query(qps_queries, **QUERY_KNOBS)
        finally:
            packed_mod.beam_update = real

    e_labels, e_dists = eager()
    if not (np.array_equal(labels, e_labels)
            and labels.dtype == e_labels.dtype
            and dists.tobytes() == e_dists.tobytes()):
        raise AssertionError("K4: knn_query's answers differ from the eager "
                             "beam step's")
    say(f"[K4 main] {QPS_BATCH} queries: labels and distances equal the "
        "eager beam step's bit for bit")
    e = QUERY_KNOBS["expand"]
    rows = []
    for h in (0, 1):
        args = calls[2 + 2 * CAPTURE_ITER + h]
        rows.append(k4_case(f"real sift B={QPS_BATCH // 2} half {h}", args, e,
                            flush, time_it=True))
    k1_between(k1_calls[2 * CAPTURE_ITER], calls[2 + 2 * CAPTURE_ITER], e,
               smi)
    del calls, k1_calls
    times = {"k4": [], "eager": []}
    for i in range(6):
        for side in (("k4", "eager") if i % 2 == 0 else ("eager", "k4")):
            fn = eager if side == "eager" else (
                lambda: index.knn_query(qps_queries, **QUERY_KNOBS))
            t0 = time.perf_counter()
            fn()
            times[side].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in times.items()}
    say(f"[K4 main] host-clock call, median of 6 alternating: K4 "
        f"{med['k4'] * 1e3:.1f} ms = {QPS_BATCH / med['k4']:.0f} QPS, eager "
        f"{med['eager'] * 1e3:.1f} ms = {QPS_BATCH / med['eager']:.0f} QPS; "
        f"all K4 {json.dumps([round(t * 1e3, 2) for t in times['k4']])} ms "
        f"[{smi}]")
    return rows


# ------------------------------------------------- K4's classic step
def k4c_adjacency(pool: int, ef: int, deg: int, upper: bool, gen):
    """An adjacency over `pool` node ids: a dense [pool, deg] table (~10%
    -1; the rows of nodes below ef / 2 hold ids below ef only, so a beam of
    ids 0..ef-1 finds nothing fresh), or the same rows in an upper arena:
    levels 0-2, level 1 viewed, a third of the nodes at level 0 (the sink
    row) and a few at level 1 without a row (up_base -1)."""
    table = gen.integers(0, pool, (pool, deg))
    low = max(1, ef // 2)
    table[:low] = gen.integers(0, ef, (low, deg))
    table[gen.random((pool, deg)) < 0.1] = -1
    table = table.astype(np.int32)
    if not upper:
        return torch.from_numpy(table).to(DEV)
    levels = gen.integers(0, 3, pool).astype(np.int32)
    has = (levels >= 1) & (gen.random(pool) > 0.05)
    up_base = np.full(pool, -1, np.int32)
    up_base[has] = np.concatenate([[0], np.cumsum(levels[has])[:-1]])
    arena = np.full((int(levels[has].sum()) + 1, deg), -1, np.int32)
    for v in np.nonzero(has)[0]:
        arena[up_base[v]:up_base[v] + levels[v]] = table[v]
    return UpperView(table=torch.from_numpy(arena).to(DEV),
                     up_base=torch.from_numpy(up_base).to(DEV),
                     levels=torch.from_numpy(levels).to(DEV), level=1)


def k4c_inputs(b: int, ef: int, e: int, deg: int, compact_k, upper: bool,
               gen, ties: bool = False, edges: bool = False,
               converged: bool = False):
    """K4's beam and block (`k4_inputs`: ~70% expanded, ~30% of the block
    beam ids, ~15% -1, ids repeated) with the block as wide as the step
    writes, and `k4c_adjacency` over the same pool.  edges=True: rows
    cycle through a block all -1, one block id repeated, a beam of ids
    0..ef-1 all unexpanded with no block (every adjacency id in the beam),
    a fully expanded beam, an empty beam.  converged=True: every beam fully
    expanded and no block (the live flag stays 0)."""
    c = classic_width(e, deg, compact_k)
    pool = 4 * (ef + c)
    pk, d, cid, cd = k4_inputs(b, ef, c, gen, ties=ties, edges=edges)
    if edges and b:
        kind = torch.arange(b, device=DEV) % 5
        two = kind == 2
        pk[two] = torch.arange(ef, dtype=torch.int32, device=DEV) * 2
        d[two] = torch.sort(d[two].nan_to_num(posinf=1e9), dim=1).values
        cid[two | (kind == 3)] = -1
        cd[two | (kind == 3)] = float("inf")
    if converged:
        pk = torch.where(pk < 0, -1, pk | 1)
        cid.fill_(-1)
        cd.fill_(float("inf"))
    return pk, d, cid, cd, k4c_adjacency(pool, ef, deg, upper, gen)


def k4c_cost(b: int, ef: int, c_in: int, e: int, deg: int, c: int,
             upper: bool) -> int:
    """Bytes of one classic step: the beam read and written, the block
    read, E adjacency rows (and their up_base and levels) read, the next
    block written."""
    return b * (ef * 16 + c_in * 8 + e * deg * 4 + (e * 8 if upper else 0)
                + c * 4)


def k4c_case(label: str, args, e: int, compact_k, flush=None,
             time_it: bool = False) -> dict:
    """beam_step_classic against its plain version, bit for bit (the beam,
    the next block and the live flag), with the previous block and
    without; each CUDA call must launch the kernel."""
    pk, d, cid, cd, adj = args
    b, ef = pk.shape
    deg = (adj if isinstance(adj, torch.Tensor) else adj.table).shape[1]
    c = classic_width(e, deg, compact_k)
    for block in ((cid, cd), (None, None)):
        live = torch.zeros(2, dtype=torch.int32, device=DEV)
        before = beam_step_classic.launches
        out = beam_step_classic(pk, d, *block, adj, live[0], expand=e,
                                compact_k=compact_k)
        ref = beam_step_classic_plain(pk, d, *block, adj, live[1], expand=e,
                                      compact_k=compact_k)
        torch.cuda.synchronize()
        if beam_step_classic.launches != before + (b > 0):
            raise AssertionError(f"K4 classic {label}: a CUDA call did not "
                                 "launch")
        for name, x, y in zip(("beam_pk", "beam_d", "block"), out, ref):
            if not bits_equal(x, y):
                raise AssertionError(f"K4 classic {label} (block "
                                     f"{'in' if block[0] is not None else 'none'}"
                                     f"): {name} differs from plain")
        if b and int(live[0]) != int(live[1]):
            raise AssertionError(f"K4 classic {label}: live differs")
    row = dict(case=label, shape=[b, ef, c, e, deg], max_abs_err=0.0)
    if time_it:
        live = torch.zeros((), dtype=torch.int32, device=DEV)
        timed(row, lambda: beam_step_classic(pk, d, cid, cd, adj, live,
                                             expand=e, compact_k=compact_k),
              lambda: beam_step_classic_plain(pk, d, cid, cd, adj, live,
                                              expand=e, compact_k=compact_k),
              k4c_cost(b, ef, cid.shape[1], e, deg, c,
                       not isinstance(adj, torch.Tensor)),
              0, INT8_OPS_PER_S, flush)
    say(f"[K4 classic] {label} B={b} ef={ef} C={c} E={e} deg={deg}: equal "
        f"bit for bit (with the block, without; live); {fmt(row)}")
    return row


def check_k4c_edges(gen, flush=None) -> list[dict]:
    """The classic step at laion1m.stream's shapes (timed cold, L2 flushed)
    and at edge shapes, with real-valued and tied distances, on rows of
    edge cases and on a batch with nothing left to expand."""
    rows = []
    for label, b, ef, e, deg, ck, upper in K4C_SHAPES + K4C_EDGE_SHAPES:
        main = (label, b, ef, e, deg, ck, upper) in K4C_SHAPES
        shape = (b, ef, e, deg, ck, upper)
        rows.append(k4c_case(f"cold {label}", k4c_inputs(*shape, gen), e, ck,
                             flush, time_it=main and flush is not None))
        rows.append(k4c_case(f"{label} ties", k4c_inputs(*shape, gen,
                                                         ties=True), e, ck))
        rows.append(k4c_case(f"{label} edge rows", k4c_inputs(
            *shape, gen, ties=True, edges=True), e, ck))
        rows.append(k4c_case(f"{label} converged", k4c_inputs(
            *shape, gen, converged=True), e, ck))
    rows.append(k4c_case("B=0", k4c_inputs(0, 64, 4, 16, None, False, gen),
                         4, None))
    return rows


def k4c_graph(gen):
    """A random 768-d cosine graph of K4C_N rows: unit rows, a dense level-0
    table of 32 ids a row, an upper arena (a node at level >= l with
    probability 16^-l) of 16 ids a row among the level-1 nodes."""
    g = torch.Generator(device=DEV).manual_seed(int(gen.integers(1 << 30)))
    x = torch.randn((K4C_N, K4C_DIM), device=DEV, generator=g)
    x = search_mod.normalize_rows(x)
    adj0 = torch.randint(0, K4C_N, (K4C_N, 32), device=DEV, generator=g,
                         dtype=torch.int32)
    levels = np.minimum(gen.geometric(15 / 16, K4C_N) - 1, 3).astype(np.int32)
    up = np.nonzero(levels >= 1)[0]
    up_base = np.full(K4C_N, -1, np.int32)
    up_base[up] = np.concatenate([[0], np.cumsum(levels[up])[:-1]])
    arena = up[gen.integers(0, up.size, (int(levels[up].sum()) + 1, 16))]
    arena[-1] = -1
    view = UpperView(table=torch.from_numpy(arena.astype(np.int32)).to(DEV),
                     up_base=torch.from_numpy(up_base).to(DEV),
                     levels=torch.from_numpy(levels).to(DEV), level=1)
    return x, adj0, view, up


def phase_k4c(smi: str, gen) -> None:
    """The classic loop at laion1m.stream's three shapes on `k4c_graph`:
    one beam_search_layer call each, with the launches of the step, K2 and
    K4's merge counted and the bitonic stages run (`sortmerge._stage`: the
    entries' sort only), the answer against the eager loop's (the plain
    step and merge in their places) bit for bit, and the host-clock time
    of both in turns."""
    x, adj0, view, up = k4c_graph(gen)
    ones = torch.ones(K4C_N, device=DEV)
    norms = torch.zeros(K4C_N, device=DEV)  # cosine: unused
    entry_stages = 10  # bitonic_sort at width 16: 4 * 5 / 2 stages
    for label, b, ef, e, deg, ck, upper in K4C_SHAPES:
        max_iters = None if upper else (48 if ef == 200 else 24)
        pool = up if upper else np.arange(K4C_N)
        q = search_mod.normalize_rows(torch.from_numpy(gen.standard_normal(
            (b, K4C_DIM)).astype(np.float32)).to(DEV))
        e_ids = torch.from_numpy(pool[gen.integers(
            0, pool.size, (b, K4C_ENTRIES))].astype(np.int32)).to(DEV)
        e_d = gather_dists(x, ones, q, e_ids, "cosine")
        qn = torch.zeros(b, device=DEV)

        def call():
            return search_mod.beam_search_layer(
                x, ones, norms, view if upper else adj0, q, qn, e_ids, e_d, ef,
                "cosine", max_iters, expand=e, visited_bits=0, compact_k=ck)

        def eager():
            real = search_mod.beam_step_classic, search_mod.beam_update
            search_mod.beam_step_classic = beam_step_classic_plain
            search_mod.beam_update = beam_update_plain
            try:
                return call()
            finally:
                search_mod.beam_step_classic, search_mod.beam_update = real

        call()  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        with recording(sortmerge_mod, "_stage") as stages:
            ids, dist, iters = call()
            torch.cuda.synchronize()
        got = read_launches()
        k4c, k2, k4 = (got["beam_step_classic"], got["gather_dists"],
                       got["beam_update"])
        want = ((k2 + 1, 0) if max_iters is None
                else (max_iters, 1)) if k2 else (-1, -1)
        if (k4c, k4) != want or (max_iters and k2 != max_iters) \
                or len(stages) != entry_stages:
            raise AssertionError(f"K4 classic {label}: {k4c} steps, {k2} K2, "
                                 f"{k4} merges, {len(stages)} bitonic stages "
                                 f"(max_iters {max_iters})")
        require_launches(f"K4 classic {label}", got,
                         ["beam_step_classic", "gather_dists"])
        e_ids2, e_d2, e_it = eager()
        if not (torch.equal(ids, e_ids2) and bits_equal(dist, e_d2)
                and int(iters) == int(e_it)):
            raise AssertionError(f"K4 classic {label}: the loop's answer "
                                 "differs from the eager loop's")
        times = {"kernel": [], "eager": []}
        for i in range(3):
            for side in (("kernel", "eager") if i % 2 == 0
                         else ("eager", "kernel")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (call if side == "kernel" else eager)()
                torch.cuda.synchronize()
                times[side].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) for k, v in times.items()}
        say(f"[K4 classic loop] {label} B={b} ef={ef} E={e} deg={deg} "
            f"compact_k={ck} max_iters={max_iters}: {int(iters)} iters, "
            f"launches step {k4c} K2 {k2} merge {k4}, {len(stages)} bitonic "
            f"stages (the entries'); equal to the eager loop bit for bit; "
            f"host-clock call, median of 3 in turns: kernel "
            f"{med['kernel'] * 1e3:.1f} ms, eager {med['eager'] * 1e3:.1f} "
            f"ms [{smi}]")
    del x, adj0, view


def cold_ids(gen, b: int, k: int, n: int) -> torch.Tensor:
    ids = gen.integers(-1, n, size=(b, k)).astype(np.int32)
    ids[:, 0] = -1
    return torch.from_numpy(ids).to(DEV)


# ------------------------------------------- phase F: the packed options
def paired_qps(fn_a, fn_b, q) -> dict:
    """QPS of two searches in F_PAIRS alternating pairs (a b, b a, a b,
    ...), each run by the measure_qps protocol at F_PAIR_REPS timed
    batches: the medians, b's wins, and the quartile spread of a's own
    runs, so a difference is claimed only where b wins at least nine
    pairs in ten and the medians differ by more than that spread."""
    runs = {"a": [], "b": []}
    for i in range(F_PAIRS):
        order = ("a", "b") if i % 2 == 0 else ("b", "a")
        for side in order:
            fn = fn_a if side == "a" else fn_b
            runs[side].append(harness_mod.measure_qps(
                fn, q, batch=QPS_BATCH, warmup=F_PAIR_WARMUP,
                reps=F_PAIR_REPS))
    qa, qb = runs["a"], runs["b"]
    quart = statistics.quantiles(qa, n=4)
    out = dict(median_a=statistics.median(qa), median_b=statistics.median(qb),
               b_wins=sum(b > a for a, b in zip(qa, qb)), pairs=F_PAIRS,
               a_spread=quart[2] - quart[0])
    diff = abs(out["median_b"] - out["median_a"])
    out["resolved"] = diff > out["a_spread"] and (
        out["b_wins"] >= 0.9 * F_PAIRS or out["b_wins"] <= 0.1 * F_PAIRS)
    return out


def fmt_pairs(p: dict) -> str:
    return (f"median QPS {p['median_a']:.0f} -> {p['median_b']:.0f}, the "
            f"option wins {p['b_wins']} of {p['pairs']} pairs, spread of "
            f"the full-byte runs {p['a_spread']:.0f}: "
            f"{'resolved' if p['resolved'] else 'unresolved'}")


def phase_f(index, queries, qps_queries, gt, smi: str, flush,
            gen) -> tuple[dict, list, list]:
    """The packed engine's options on main's bulk-built 1M graph, through
    `models/packed.py` and `models/refine.py` (no public entry point takes
    them, as in the JAX package): F1 fused == unfused; F2 the deg_limit
    ladder; F3 bits=4 on main's data, and its guard on a grid-aligned
    100k set; F4 the refined half-degree graph.  Then K1 at each new
    variant and K2 at refine's block, cold and on the inputs captured
    here."""
    from ocaml_hnsw_tpu_torch.models import refine as refine_mod

    g, seeds = index.graph, index._seed_index()
    packed = index._packed_index()
    q_t = torch.from_numpy(queries).to(DEV)
    qq_t = torch.from_numpy(qps_queries).to(DEV)
    k = QUERY_KNOBS["k"]
    out, launches, k1_rows, k2_rows = {}, {}, [], []

    def search(pk, q, graph=None, seed_index=None, **kw):
        return packed_mod.knn_search_packed(
            graph if graph is not None else g, pk, q, metric="l2",
            seeds=seed_index if seed_index is not None else seeds, seed_e=8,
            **{**QUERY_KNOBS, **kw})

    def rung(pk, graph=None, truth=gt, qs=q_t, qps_q=qq_t, seed_index=None,
             **kw):
        """recall@10 on `qs` and QPS (measure_qps protocol) on `qps_q`."""
        ids, d = search(pk, qs, graph, seed_index, **kw)
        rec = recall_of(ids.cpu().numpy(), truth)
        qps = harness_mod.measure_qps(
            lambda x: search(pk, x, graph, seed_index, **kw)[0], qps_q,
            batch=QPS_BATCH) if qps_q is not None else None
        return dict(recall=rec, qps=qps), ids, d

    # F1: fused layout, identical results; both timed by the measure_qps
    # protocol (the main path's own QPS adds knn_query's host copies), so
    # the unfused rung is the yardstick of F3 and F4
    reset_launches()
    fp = packed_mod.pack_graph(g, "l2", fused=True)
    base, ids_u, d_u = rung(packed)
    row_f, ids_f, d_f = rung(fp, fused=True)
    launches["F1_fused"] = read_launches()
    require_launches("F1", launches["F1_fused"],
                     ["gather_dists", "packed_score"])
    if not (torch.equal(ids_u, ids_f) and torch.equal(d_u, d_f)):
        raise AssertionError("F1: fused results differ from unfused")
    rec_u = base["recall"]
    out["fused"] = dict(recall=rec_u, qps_unfused=base["qps"],
                        qps_fused=row_f["qps"], identical=True)
    del fp
    say(f"[F1 fused] pack_graph(fused=True), chunk_w {packed.chunk_w}: ids "
        f"and distances identical to the unfused pack over {N_QUERIES} "
        f"queries, recall@10 {rec_u:.4f}; QPS unfused {base['qps']:.0f}, "
        f"fused {row_f['qps']:.0f} (measure_qps protocol) [{smi}]")

    # F2: the deg_limit ladder on the default pack (W=2048: 16 per chunk)
    reset_launches()
    ladder = []
    with recording(packed_mod, "packed_score") as calls:
        search(packed, qq_t, deg_limit=16)
    slots_call = calls[CAPTURE_ITER]
    del calls
    for dl, extra in [(dl, {}) for dl in F_DEG_LIMITS] + [
            (F_RAISED["deg_limit"], F_RAISED)]:
        kw = {**extra, "deg_limit": dl}
        row, _, _ = rung(packed, **kw)
        row.update(deg_limit=dl, slots=packed_mod.packed_slots(packed, dl),
                   max_iters=kw.get("max_iters", QUERY_KNOBS["max_iters"]))
        ladder.append(row)
        say(f"[F2 deg_limit] deg_limit={dl} -> {row['slots']} slots, "
            f"max_iters {row['max_iters']}: recall@10 {row['recall']:.4f}, "
            f"QPS {row['qps']:.0f} [{smi}]")
    launches["F2_deg_limit"] = read_launches()
    require_launches("F2", launches["F2_deg_limit"],
                     ["gather_dists", "packed_score"])
    if [r["slots"] for r in ladder[:3]] != [16, 16, 32]:
        raise AssertionError(f"F2: effective slots {ladder}")
    wide = packed_mod.pack_graph(g, "l2", max_chunk=4096)
    wide_slots = packed_mod.packed_slots(wide, 16)
    if wide.chunk_w != 4096 or wide_slots != 32:
        raise AssertionError(f"F2: max_chunk=4096 gives W={wide.chunk_w}, "
                             f"{wide_slots} slots at deg_limit=16")
    del wide
    say(f"[F2 deg_limit] repacked with max_chunk=4096: W=4096, deg_limit=16"
        f" -> {wide_slots} slots (one chunk row holds all 32)")
    out["deg_limit"] = ladder
    pairs = paired_qps(lambda x: search(packed, x, deg_limit=24)[0],
                       lambda x: search(packed, x, deg_limit=16)[0], qq_t)
    out["deg_limit_pairs"] = pairs
    say(f"[F2 deg_limit] 32 -> 16 slots, same loop, in pairs: "
        f"{fmt_pairs(pairs)} [{smi}]")

    # F3: bits=4 on main's clustered data (measured, not tuned)
    reset_launches()
    p4 = packed_mod.pack_graph(g, "l2", bits=4)
    with recording(packed_mod, "packed_score") as calls:
        search(p4, qq_t, bits=4)
    int4_call = calls[2 * CAPTURE_ITER]  # first interleaved half
    del calls
    row4, _, _ = rung(p4, bits=4)
    pairs = paired_qps(lambda x: search(packed, x)[0],
                       lambda x: search(p4, x, bits=4)[0], qq_t)
    out["int4_pairs"] = pairs
    say(f"[F3 bits=4] int8 -> int4 at the main knobs, in pairs: "
        f"{fmt_pairs(pairs)} [{smi}]")
    launches["F3_int4"] = read_launches()
    require_launches("F3", launches["F3_int4"],
                     ["gather_dists", "packed_score"])
    say(f"[F3 bits=4] main's 1M clustered data, {p4.pay.nbytes / 2**30:.2f}"
        f" GiB payload (int8 {packed.pay.nbytes / 2**30:.2f}): recall@10 "
        f"{row4['recall']:.4f}, QPS {row4['qps']:.0f} at the main knobs "
        f"[{smi}]")
    # its guard: a grid-aligned set, where int4 quantizes exactly (its own
    # seed, so the set does not depend on which phases ran before)
    grng = np.random.default_rng(F_GRID_SEED)
    grid = grng.integers(-7, 8, size=(F_GRID_N, DIM)).astype(np.float32)
    gq = grid[grng.integers(0, F_GRID_N, N_QUERIES)] + grng.integers(
        -1, 2, size=(N_QUERIES, DIM)).astype(np.float32)
    gidx = Index("l2", DIM, device=DEV.type)
    gidx.init_index(max_elements=F_GRID_N, M=M, ef_construction=EFC)
    gidx.add_items(grid)
    gq_t = torch.from_numpy(gq).to(DEV)
    ggt = device_ground_truth(torch.from_numpy(grid).to(DEV), gq_t, k, "l2")
    gseeds = search_mod.build_seed_index(gidx.graph, "l2")
    r8, _, _ = rung(packed_mod.pack_graph(gidx.graph, "l2"), gidx.graph, ggt,
                    gq_t, None, gseeds)
    r4, _, _ = rung(packed_mod.pack_graph(gidx.graph, "l2", bits=4),
                    gidx.graph, ggt, gq_t, None, gseeds, bits=4)
    del gidx
    out["int4"] = dict(main=row4, grid_int8=r8["recall"],
                       grid_int4=r4["recall"])
    say(f"[F3 bits=4 guard] grid-aligned {F_GRID_N}x{DIM} in [-7, 7], bulk "
        f"built: recall@10 int8 {r8['recall']:.4f}, int4 {r4['recall']:.4f}"
        f" (int4 >= int8 - {F_INT4_SLACK})")
    if r4["recall"] < r8["recall"] - F_INT4_SLACK:
        raise AssertionError(f"F3: int4 recall {r4['recall']:.4f} < int8 "
                             f"{r8['recall']:.4f} - {F_INT4_SLACK}")

    # F4: the refined half-degree graph
    seconds, k2_launches = {}, {}
    for hops in (0, 1):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording(refine_mod, "dists_to_ids", keep=1,
                       want=lambda a: a[5].shape[0] == 4096) as calls:
            half = refine_mod.refined_graph(g, F_REFINE_DEG, "l2", hops=hops)
        torch.cuda.synchronize()
        seconds[hops] = time.perf_counter() - t0
        k2_launches[hops] = read_launches()
        require_launches(f"F4 refine hops={hops}", k2_launches[hops],
                         ["gather_dists"])
        if hops == 0:
            refine_call, half0 = k2_args(calls[0]), half
    launches["F4_refine"] = {
        kern: k2_launches[0][kern] + k2_launches[1][kern]
        for kern in k2_launches[0]}
    reset_launches()
    hp = packed_mod.pack_graph(half0, "l2")
    rungs = {}
    with recording(packed_mod, "packed_score") as calls:
        search(hp, qq_t, half0)
    half_call = calls[2 * CAPTURE_ITER]
    del calls
    for mi in (QUERY_KNOBS["max_iters"], F_REFINE_MI):
        rungs[mi], _, _ = rung(hp, half0, max_iters=mi)
    r1, _, _ = rung(packed_mod.pack_graph(half, "l2"), half, qps_q=None,
                    max_iters=F_REFINE_MI)
    launches["F4_half_query"] = read_launches()
    require_launches("F4 query", launches["F4_half_query"],
                     ["gather_dists", "packed_score"])
    out["refine"] = dict(seconds=seconds, launches=k2_launches,
                         rungs={str(mi): r for mi, r in rungs.items()},
                         recall_hops1=r1["recall"])
    say(f"[F4 refine] refined_graph(g, {F_REFINE_DEG}, 'l2') over "
        f"{g.n_cap} slots: {seconds[0]:.2f} s, launches "
        f"{json.dumps(k2_launches[0])}; hops=1: {seconds[1]:.2f} s, "
        f"{json.dumps(k2_launches[1])}; "
        f"half-degree pack {hp.pay.nbytes / 2**30:.2f} GiB: "
        + "; ".join(f"max_iters {mi}: recall@10 {r['recall']:.4f}, QPS "
                    f"{r['qps']:.0f}" for mi, r in rungs.items())
        + f" (full degree at the main knobs: {rec_u:.4f}); hops=1 graph at "
        f"max_iters {F_REFINE_MI}: {r1['recall']:.4f} [{smi}]")
    if rungs[F_REFINE_MI]["recall"] < RECALL_FLOOR:
        raise AssertionError(f"F4: half-degree recall@10 "
                             f"{rungs[F_REFINE_MI]['recall']:.4f} < "
                             f"{RECALL_FLOOR}")
    del half
    # the unfused yardstick once more: how far the host clock moved the
    # eager loop's QPS within this phase
    again, _, _ = rung(packed)
    out["fused"]["qps_unfused_again"] = again["qps"]
    say(f"[F] main knobs on the plain pack again: QPS {again['qps']:.0f} "
        f"(first {base['qps']:.0f}) [{smi}]")

    # kernels at the new variants, cold and on the inputs captured above
    for label, args, pk, n in (
            ("F2 slots=16", slots_call, packed, N),
            ("F3 bits=4", int4_call, p4, N),
            ("F4 refined deg=16", half_call, hp, N)):
        b, e = args[0].shape
        nodes, _, _ = k1_inputs(n, b, e, pk.d_pad, gen)
        tag = f"B={b} E={e}"
        k1_rows += [k1_case(f"{label} cold {tag}", (nodes,) + tuple(args[1:]),
                            flush, time_it=True),
                    k1_case(f"{label} real {tag}", args, flush, time_it=True)]
    vec, sc, qq, ids, metric = refine_call
    k2_rows += [k2_case(f"F4 refine block cold {tuple(ids.shape)}", vec, sc,
                        qq, cold_ids(gen, *ids.shape, N), metric, flush,
                        time_it=True),
                k2_case(f"F4 refine block real {tuple(ids.shape)}", vec, sc,
                        qq, ids, metric, flush, time_it=True)]
    del p4, hp, half0
    out["launches"] = launches
    return out, k1_rows, k2_rows


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
    require_launches("A build", build_launches,
                     ["gather_dists", "beam_step_classic"])
    if index._state._packed_build or build_launches["packed_score"]:
        raise AssertionError("phase A: a 10k index took the packed build")

    knobs = dict(k=10, ef=A_EF, engine="classic")
    reset_launches()
    labels, dists = index.knn_query(queries, **knobs)
    batch_launches = read_launches()
    require_launches("A query", batch_launches,
                     ["gather_dists", "beam_step_classic"])
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
    loaded.add_items(extra)
    add_launches = read_launches()
    require_launches("A add after load", add_launches,
                     ["gather_dists", "beam_step_classic"])
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
               qps=qps, recall_after_add=rec_all,
               launches_build=build_launches, launches_per_batch=batch_launches,
               launches_add=add_launches)
    say(f"[A random10k] build {build_s:.2f} s = {A_N / build_s:.0f} vectors/s;"
        f" recall@10 {rec:.4f} (floor {A_FLOOR}) at ef={A_EF} classic; "
        f"QPS {qps:.0f} (median of 5 batches of {N_QUERIES}); save/load with"
        f" resize to {A_N + A_ADD}: identical; +{A_ADD} after load: recall@10"
        f" {rec_all:.4f}; launches build {json.dumps(build_launches)}, per "
        f"batch {json.dumps(batch_launches)} [{smi}]")
    vec, sc, qq, ids, metric = k2_args(build_call)
    rows = [k2_case(f"A build round cold ({A_RS}, {COMPACT_K})", vec, sc, qq,
                    cold_ids(gen, A_RS, COMPACT_K, A_N), metric, flush,
                    time_it=True),
            k2_case(f"A build round real ({A_RS}, {COMPACT_K})", vec, sc, qq,
                    ids, metric, flush, time_it=True)]
    return out, rows


# ------------------------------------ phases B and B8: streaming ingest
def phase_stream(tag: str, config: str, storage: str, data_dtype: str,
                 round_size: int, k2_path: str, smi: str, flush,
                 gen) -> tuple[dict, list]:
    """`config`'s shapes (768-d cosine) at B_N rows through the port's
    `run_streaming_config` with the memory plan `storage` (the graph's
    rows) / `data_dtype` (the source) and `round_size`: warm add, B_STEPS
    ingest steps, one timed B_QB-query batch per setting after each (the
    first step's batch excluded from the sustained QPS).  Every add and
    every query batch is metered: each must launch K2 on `storage` rows by
    `k2_path`, and none K1 (the index stays on the classic engine).  Then
    K2 is held and timed at the phase's query and level-0 build blocks."""
    n_warm = B_N // 2
    need = ["gather_dists", f"gather_dists/{k2_path}",
            f"gather_dists/{storage}", "beam_step_classic"]
    reset_launches()
    with metering(harness_mod.datasets, "clustered_device") as made, \
            metering(build_mod.BuildState, "add") as adds, \
            metering(harness_mod, "knn_search") as searches, \
            recording(search_mod, "dists_to_ids", keep=64, want=lambda a: (
                not adds and tuple(a[5].shape) == (round_size, COMPACT_K))) \
            as warm_blocks:
        out = harness_mod.run_streaming_config(
            config, n=B_N, dim=B_DIM, metric="cosine", n_queries=N_QUERIES,
            M=M, ef_construction=B_EFC, round_size=round_size,
            settings=B_SETTINGS, n_steps=B_STEPS, qps_batch=B_QB,
            storage=storage, data_dtype=data_dtype, verbose=False,
            device=DEV.type)
    say(f"[{tag}] run_streaming_config: {json.dumps(out)}")
    if len(adds) != 1 + B_STEPS \
            or len(searches) != (B_STEPS + 1) * len(B_SETTINGS):
        raise AssertionError(f"phase {tag}: {len(adds)} adds, "
                             f"{len(searches)} searches")
    warm_launches = sum_launches(adds[:1])
    ingest_launches = sum_launches(adds[1:])
    require_launches(f"{tag} warm", warm_launches, need)
    require_launches(f"{tag} ingest", ingest_launches, need)
    # a late warm round's level-0 build block: 64 blocks before the end
    build_call = warm_blocks[0]
    del warm_blocks
    # the last step's timed batches, one per setting
    timed = searches[-2 * len(B_SETTINGS):-len(B_SETTINGS)]
    for row, call in zip(out["sweep"], timed):
        row["launches_per_batch"] = call["launches"]
        require_launches(f"{tag} query {row['ef']}/{row['max_iters']}",
                         call["launches"], need)
    if any(c["launches"]["packed_score"] for c in adds + searches):
        raise AssertionError(f"phase {tag}: K1 ran (the packed build or "
                             f"engine): warm {warm_launches}, ingest "
                             f"{ingest_launches}")
    if out["n"] != B_N or out["backend"] != DEV.type or not all(
            0.0 <= r["recall"] <= 1.0 and r["sustained_qps_during_ingest"] > 0
            for r in out["sweep"]):
        raise AssertionError(f"phase {tag}: malformed result {out}")
    # the end-state graph, queries and answers, from the harness's last
    # search (its end-state recall at the last setting)
    (graph, queries), knobs = searches[-1]["args"], searches[-1]["kwargs"]
    found = searches[-1]["result"][0].cpu().numpy()
    source = made[-1]["result"][0]
    del adds, searches, made
    if graph.vectors.dtype != storage_dtype(storage):
        raise AssertionError(f"phase {tag}: the graph stores "
                             f"{graph.vectors.dtype}, not {storage}")
    # recall against the exact neighbours within the rows the graph stores
    # (dequantized, scored as the search scores them), and the recall of
    # those neighbours against the harness's ground truth (the source's):
    # the most any search over these rows can reach
    k = found.shape[1]
    stored = graph.vectors[:B_N].float() * graph.scales[:B_N, None]
    own = device_ground_truth(stored, search_mod.normalize_rows(
        queries.float()), k, "ip")
    del stored
    rec_own = recall_of(found, own)
    ceiling = recall_of(own, device_ground_truth(source, queries, k,
                                                 "cosine"))
    del source
    qb = queries.repeat(-(-B_QB // queries.shape[0]), 1)[:B_QB].contiguous()
    with recording(search_mod, "dists_to_ids") as calls:
        search_mod.knn_search(graph, qb, **knobs)
    # the beam's 10th candidate block
    query_call = [c for c in calls
                  if tuple(c[5].shape) == (B_QB, COMPACT_K)][9]
    del calls
    res = dict(warm_vps=out["warm_build_vps"], ingest_vps=out["ingest_vps"],
               launches_warm=warm_launches, launches_ingest=ingest_launches,
               sweep=out["sweep"], recall_own_rows=rec_own,
               recall_ceiling=ceiling)
    say(f"[{tag} {config} cut to {B_N}x{B_DIM} cosine, {storage} rows, "
        f"{data_dtype} source, round_size {round_size}] warm "
        f"{out['warm_build_vps']} vectors/s; ingest {out['ingest_vps']}"
        f" vectors/s over {B_STEPS} steps of {(B_N - n_warm) // B_STEPS}; "
        + "; ".join(
            f"ef={r['ef']} mi={r['max_iters']}: sustained QPS "
            f"{r['sustained_qps_during_ingest']}, end recall@10 "
            f"{r['recall']:.4f}" for r in out["sweep"])
        + f"; at {knobs['ef']}/{knobs['max_iters']} recall@10 against the "
        f"stored rows' own exact neighbours {rec_own:.4f}, those neighbours'"
        f" recall@10 {ceiling:.4f} (the ceiling of {storage} rows)"
        + f"; K2 launches warm "
        f"{warm_launches['gather_dists']} ({k2_path} "
        f"{warm_launches[f'gather_dists/{k2_path}']}), ingest "
        f"{ingest_launches['gather_dists']} ({k2_path} "
        f"{ingest_launches[f'gather_dists/{k2_path}']}) [{smi}]")
    # f32 rows are held to the harness's recall; quantized rows, whose
    # ceiling on this data is below the floor, to the search's recall over
    # the rows they are
    held = out["sweep"][-1]["recall"] if storage == "f32" else rec_own
    if held < B_FLOOR:
        raise AssertionError(f"phase {tag} recall@10 {held} < {B_FLOOR} at "
                             f"{B_SETTINGS[-1]} ({storage} rows)")
    rows = []
    for part, call, b, n in (("query", query_call, B_QB, B_N),
                             ("build", build_call, round_size, n_warm)):
        vec, sc, qq, ids, metric = k2_args(call)
        shape = f"({b}, {COMPACT_K}) {storage} cosine"
        rows += [k2_case(f"{tag} {part} cold {shape}", vec, sc, qq,
                         cold_ids(gen, b, COMPACT_K, n), metric, flush,
                         time_it=True, path=k2_path),
                 k2_case(f"{tag} {part} real {shape}", vec, sc, qq, ids,
                         metric, flush, time_it=True, path=k2_path)]
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


# --------------------------------------------- phase G: the build options
def phase_g(x, queries, qps_queries, gt, main: dict | None, smi: str,
            flush) -> tuple[dict, dict, list, list]:
    """G1: `bulk_build(scan_dtype="int8")` over main's rows, then the
    packed engine at main's knobs over that graph (recall against main's
    ground truth, beside main's bf16 build when `main` holds its numbers).
    G2: `models.build.build` and BuildStates with `select_scan` at phase
    A's shapes.  Returns (summary, launches by phase, K1 rows, K2 rows)."""
    dev = x.device
    k = QUERY_KNOBS["k"]
    cfg = HnswConfig(dim=DIM, M=M, ef_construction=EFC)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scans = []  # the scan dtype of each kNN table's flat
    with recording(bulk_mod, "knn_table",
                   want=lambda a: scans.append(a[0].scan.dtype)), \
            recording(flat_mod, "gather_dists",
                      want=lambda a: a[0].shape[0] >= N
                      and a[3].shape[0] == QPS_BATCH, keep=1) as knn_calls:
        g = bulk_mod.bulk_build(x, cfg, scan_dtype="int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = read_launches()
    require_launches("G1 int8 bulk build", build_launches,
                     ["gather_dists", "scan_topk", "scan_topk/int8"])
    n_tables = len(scans)
    lv = g.levels[:N].cpu().numpy()
    want = 1 + sum(int((lv >= l).sum() >= 2)  # a 1-node level has no table
                   for l in range(1, int(lv.max()) + 1))
    if set(scans) != {torch.int8} or n_tables != want:
        raise AssertionError(f"G1: {n_tables} kNN tables (want {want}) "
                             f"scanned {set(scans)}")
    (knn_call,) = knn_calls
    del knn_calls

    pk = packed_mod.pack_graph(g, "l2")
    seeds = search_mod.build_seed_index(g, "l2")
    q = torch.from_numpy(queries).to(dev)
    reset_launches()
    with recording(packed_mod, "packed_score", keep=1) as k1_calls:
        ids, d = packed_mod.knn_search_packed(g, pk, q, metric="l2",
                                              seeds=seeds, seed_e=8,
                                              **QUERY_KNOBS)
    torch.cuda.synchronize()
    query_launches = read_launches()
    require_launches("G1 query batch", query_launches,
                     ["packed_score", "gather_dists"])
    labels, dists = ids.cpu().numpy(), d.cpu().numpy()
    check_result(labels, dists, N_QUERIES, k)
    exact = torch.sum((x[ids.long()] - q[:, None, :]) ** 2, dim=-1)
    np.testing.assert_allclose(dists, exact.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    rec = recall_of(labels, gt)
    qq = torch.from_numpy(qps_queries).to(dev)

    def batch():
        packed_mod.knn_search_packed(g, pk, qq, metric="l2", seeds=seeds,
                                     seed_e=8, **QUERY_KNOBS)
        torch.cuda.synchronize()

    batch()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch()
        times.append(time.perf_counter() - t0)
    qps = QPS_BATCH / statistics.median(times)
    if main is None:
        vs_main = "main not run (--phase-g)"
    else:
        vs_main = (f"main's bf16 build {main['build_s']:.2f} s = "
                   f"{N / main['build_s']:.0f} vectors/s, recall@{k} "
                   f"{main['recall']:.4f}: difference {rec - main['recall']:+.4f}")
    say(f"[G1 int8 bulk build] {N}x{DIM} M={M} efC={EFC}: {build_s:.2f} s = "
        f"{N / build_s:.0f} vectors/s, {n_tables} kNN tables all int8-scanned;"
        f" launches {json.dumps(build_launches)}; packed queries at the main "
        f"knobs: recall@{k} {rec:.4f} (floor {RECALL_FLOOR}), QPS {qps:.0f} "
        f"(median of 3 batches of {QPS_BATCH}, queries on the card), batch "
        f"launches {json.dumps(query_launches)}; {vs_main} [{smi}]")
    if rec < RECALL_FLOOR:
        raise AssertionError(f"G1 recall@{k} {rec:.4f} < {RECALL_FLOOR}")
    k1_rows = [k1_case("G1 query step real", k1_calls[0])]
    del k1_calls, g, pk, seeds, qq
    vec, sc, qk, kid, metric = knn_call
    k2_rows = [k2_case("G1 int8 kNN-table rerank real", vec, sc, qk, kid,
                       metric, flush, time_it=True)]
    del knn_call, vec, sc, qk, kid

    # ---- G2: build() and the capped admit scan at phase A's shapes
    data_a = clustered(A_N, A_DIM, n_clusters=64, seed=7)
    q_a = torch.from_numpy(queries_like(data_a, N_QUERIES, seed=8)).to(dev)
    gt_a = device_ground_truth(torch.from_numpy(data_a).to(dev), q_a, 10,
                               "l2")
    cfg_a = HnswConfig(dim=A_DIM, M=A_M, ef_construction=A_EFC)

    def run(label: str, select_scan):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if select_scan is None:
            ga = build_mod.build(data_a, cfg_a, round_size=A_RS, device=DEV)
        else:
            st = build_mod.BuildState(cfg_a, A_N, round_size=A_RS, device=DEV)
            st.select_scan = select_scan
            st.add(data_a)
            ga = st.graph
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = read_launches()
        require_launches(label, launches, ["gather_dists"])
        seeds_a = search_mod.build_seed_index(ga, "l2")
        ids_a, d_a = search_mod.knn_search(ga, q_a, k=10, ef=A_EF,
                                           metric="l2", seeds=seeds_a,
                                           compact_k=COMPACT_K)
        check_result(ids_a.cpu().numpy(), d_a.cpu().numpy(), N_QUERIES, 10)
        r = recall_of(ids_a.cpu().numpy(), gt_a)
        if r < A_FLOOR:
            raise AssertionError(f"{label} recall@10 {r:.4f} < {A_FLOOR}")
        return dict(build_s=s, vps=A_N / s, recall=r, launches=launches), ga

    g2, base = run("G2 build()", None)
    runs = {}
    for cap in G_SELECT_SCANS:
        runs[cap], ga = run(f"G2 select_scan={cap}", cap)
        runs[cap]["same_graph"] = bool(torch.equal(ga.adj0, base.adj0)
                                       and torch.equal(ga.adj_up, base.adj_up))
    del base, ga
    say(f"[G2 build()] random10k {A_N}x{A_DIM} M={A_M} efC={A_EFC} round "
        f"{A_RS}: {g2['build_s']:.2f} s = {g2['vps']:.0f} vectors/s, recall@10"
        f" {g2['recall']:.4f} at ef={A_EF} (floor {A_FLOOR}); launches "
        f"{json.dumps(g2['launches'])} [{smi}]")
    for cap, r in runs.items():
        say(f"[G2 select_scan={cap}] {r['build_s']:.2f} s = {r['vps']:.0f} "
            f"vectors/s, recall@10 {r['recall']:.4f}: "
            f"{r['recall'] - g2['recall']:+.4f} against build() (the JAX "
            f"package measured {G_JAX_SCAN_DELTA:+.3f} for select_scan=64 at "
            f"1M, efC=200); graph identical to build()'s: {r['same_graph']}; "
            f"launches {json.dumps(r['launches'])} [{smi}]")
    out = dict(int8_build_s=build_s, int8_build_vps=N / build_s,
               int8_recall=rec, int8_qps=qps, build=g2,
               select_scan=runs)
    launches = {"G_int8_bulk_build": build_launches,
                "G_query_batch": query_launches,
                "G_build": g2["launches"],
                "G_select_scan_build": runs[G_SELECT_SCANS[0]]["launches"],
                **{f"G_select_scan{cap}_build": runs[cap]["launches"]
                   for cap in G_SELECT_SCANS[1:]}}
    return out, launches, k1_rows, k2_rows


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
        got = k3_mod.int8_dot(qi, rows).to(torch.int64)
        ref = torch.matmul(qi.double(), rows.double().T).to(torch.int64)
        if not torch.equal(got, ref):
            raise AssertionError(f"int8 scan [{b}, {n}] D={d}: "
                                 f"{int((got != ref).sum())} sums differ")
        say(f"[D int8 scan] [{b}, {n}] D={d}: equal to the int64 reference")


def harness_case(tag: str, name: str, kwargs: dict, smi: str, flush, gen,
                 kernels) -> tuple[dict, list, list]:
    """One `run_config` on the card: its result printed as JSON, every
    engine's best recall held to D_FLOOR, `kernels` required to have
    launched, and K2 and K3 held and timed at the flat engine's rerank and
    scan (the arguments of the flat sweep's last batch)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with metering(flat_mod, "gather_dists") as reranks, \
            recording(flat_mod, "scan_topk",
                      want=lambda a: a[5].shape[0] == QPS_BATCH,
                      keep=1) as scans:
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
    del vec, sc, q, ids
    (args,) = scans
    del scans
    rows3 = [k3_case(f"{tag} flat batch {args[5].shape[0]}x{args[0].shape[0]}",
                     args[:6], args[6], args[7], flush, time_it=True)]
    return dict(result=out, launches=launches, seconds=took), rows, rows3


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
        f"{json.dumps(launches)} (a registered metric launches no distance "
        f"kernel; the classic step scores nothing and serves its beam) "
        f"[{smi}]")
    if min(rec_hnsw, rec_flat) < D_FLOOR:
        raise AssertionError(f"D3: l1 recall {rec_hnsw} / {rec_flat} < "
                             f"{D_FLOOR}")
    scored = [kern for kern in ("gather_dists", "packed_score", "scan_topk")
              if launches[kern]]
    if calls <= 0 or scored:
        raise AssertionError(f"D3: l1 took {calls} registry calls and "
                             f"launches {launches}")
    return dict(l1_build_vps=D3_N / build_s, l1_recall=rec_hnsw,
                l1_flat_recall=rec_flat, bf_rows_differ=differ)


# ------------------------------------------- phase E: the sharded index
def sync_all() -> None:
    """Wait for every card (shards may sit on several)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_e(smi: str, flush, gen) -> tuple[dict, list, list]:
    """`ShardedIndex` through its public API: one shard per card, or two
    sharing the card on a one-card machine.  An add of E_FIRST rows and
    classic queries, an add of the rest and packed queries (recall, QPS by
    the `measure_qps` protocol), save -> load into a fresh index, a
    tombstone, `get_items`; then K1 and K2 held and timed on shard 0's
    captured calls."""
    cards = torch.cuda.device_count()
    mesh = make_mesh(cards if cards >= 2 else 2)
    s = len(mesh)
    data = clustered(E_N, DIM, n_clusters=400, seed=13)
    queries = queries_like(data, N_QUERIES, seed=14)
    qps_queries = queries_like(data, QPS_BATCH, seed=15)
    x = torch.from_numpy(data).to(DEV)
    q = torch.from_numpy(queries).to(DEV)
    index = ShardedIndex("l2", DIM, mesh=mesh)
    index.init_index(max_elements=E_N, M=M, ef_construction=EFC,
                     round_size=E_RS)
    g0 = index._graphs[0]
    k2_block = (E_RS, 4 * g0.adj0.shape[1])  # level-0 build beam, expand 4

    def add(rows, tag: str, **rec):
        reset_launches()
        sync_all()
        t0 = time.perf_counter()
        with recording(search_mod, "dists_to_ids", **rec) as calls:
            index.add_items(rows)
        sync_all()
        took = time.perf_counter() - t0
        launches = read_launches()
        require_launches(tag, launches, ["gather_dists"])
        if launches["packed_score"]:
            raise AssertionError(f"{tag}: the sharded build launched K1")
        return rows.shape[0] / took, launches, calls

    # the last 64 level-0 beam blocks of shard 0 in the first add
    vps1, add1, calls = add(
        data[:E_FIRST], "E first add", keep=64,
        want=lambda a: a[0] is g0.vectors and tuple(a[5].shape) == k2_block)
    build_call = calls[0]
    del calls
    if index._packed_shards() is not None:
        raise AssertionError("phase E: packed engine below the threshold")
    reset_launches()
    labels, dists = index.knn_query(queries, **E_CLASSIC)
    classic = read_launches()
    require_launches("E classic query", classic,
                     ["gather_dists", "beam_step_classic"])
    if classic["packed_score"]:
        raise AssertionError("phase E: the classic query launched K1")
    check_result(labels, dists, N_QUERIES, 10)
    rec_c = recall_of(labels, device_ground_truth(x[:E_FIRST], q, 10, "l2"))

    vps2, add2, _ = add(data[E_FIRST:], "E second add", keep=0)
    if index._packed_shards() is None:
        raise AssertionError("phase E: packed engine above the threshold")
    labels, dists = index.knn_query(queries, **E_KNOBS)
    check_result(labels, dists, N_QUERIES, 10)
    exact = torch.sum((x[torch.from_numpy(labels).to(DEV)] - q[:, None, :])
                      ** 2, dim=-1)
    np.testing.assert_allclose(dists, exact.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    rec_p = recall_of(labels, device_ground_truth(x, q, 10, "l2"))
    if min(rec_c, rec_p) < E_FLOOR:
        raise AssertionError(f"phase E recall@10 classic {rec_c:.4f}, "
                             f"packed {rec_p:.4f} < {E_FLOOR}")

    # QPS, the measure_qps protocol: 2 warm-up batches, 10 timed between
    # two synchronizes
    for _ in range(2):
        index.knn_query(qps_queries, **E_KNOBS)
    sync_all()
    t0 = time.perf_counter()
    for _ in range(10):
        index.knn_query(qps_queries, **E_KNOBS)
    sync_all()
    qps = 10 * QPS_BATCH / (time.perf_counter() - t0)
    reset_launches()
    with recording(packed_mod, "packed_score",
                   want=lambda a: a[2] is index._packed_cache[0].pay) \
            as k1_calls, \
            recording(packed_mod, "dists_to_ids",
                      want=lambda a: a[0] is g0.vectors) as rerank:
        index.knn_query(qps_queries, **E_KNOBS)
    batch = read_launches()
    require_launches("E packed query", batch,
                     ["gather_dists", "packed_score"])

    # lifecycle: save -> load, tombstone, get_items
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded.idx")
        index.save_index(path)
        loaded = ShardedIndex("l2", DIM, mesh=mesh)
        loaded.load_index(path)
    lab2, d2 = loaded.knn_query(queries, **E_KNOBS)
    del loaded
    if not (np.array_equal(labels, lab2) and np.array_equal(dists, d2)):
        raise AssertionError("phase E: results differ after save/load")
    victim = int(labels[0, 0])
    index.mark_deleted(victim)
    lab3, _ = index.knn_query(queries, **E_KNOBS)
    index.unmark_deleted(victim)
    lab4, _ = index.knn_query(queries, **E_KNOBS)
    if (lab3 == victim).any() or not np.array_equal(lab4, labels):
        raise AssertionError("phase E: tombstone not honoured or not lifted")
    some = labels[:64, 0]
    if not np.array_equal(index.get_items(some), data[some]):
        raise AssertionError("phase E: get_items differs from the rows")

    out = dict(shards=s, cards=cards, build_vps_first=vps1,
               build_vps_second=vps2, recall_classic=rec_c,
               recall_packed=rec_p, qps=qps,
               launches_first_add=add1, launches_classic_batch=classic,
               launches_second_add=add2, launches_packed_batch=batch)
    say(f"[E sharded] {s} shards on {cards} card(s), clustered {E_N}x{DIM} "
        f"l2 (cut from 1M), M={M} efC={EFC} round_size={E_RS}: first add "
        f"{E_FIRST} at {vps1:.0f} vectors/s, classic recall@10 {rec_c:.4f} "
        f"at ef={E_CLASSIC['ef']}; second add {E_N - E_FIRST} at "
        f"{vps2:.0f} vectors/s; packed recall@10 {rec_p:.4f} (floor "
        f"{E_FLOOR}), QPS {qps:.0f} in {QPS_BATCH}-query batches at "
        f"{json.dumps(E_KNOBS)}; save/load identical, tombstone honoured, "
        f"get_items "
        f"equal; launches first add {json.dumps(add1)}, classic batch "
        f"{json.dumps(classic)}, second add {json.dumps(add2)}, packed "
        f"batch {json.dumps(batch)} [{smi}]")

    # kernels at the sharded path's shapes, on shard 0's own inputs
    pk = index._packed_cache[0]
    args = k1_calls[CAPTURE_ITER]  # shard 0's 10th beam iteration
    b, e = args[0].shape
    nodes, _, _ = k1_inputs(int(index._shard_n[0]), b, e, pk.d_pad, gen)
    k1_rows = [k1_case(f"E shard beam cold B={b} E={e}",
                       (nodes,) + tuple(args[1:]), flush, time_it=True),
               k1_case(f"E shard beam real B={b} E={e}", args, flush,
                       time_it=True)]
    vec, sc, qq, ids, metric = k2_args(build_call)
    n0 = int(index._shard_n[0])
    k2_rows = [k2_case(f"E build round cold {k2_block}", vec, sc, qq,
                       cold_ids(gen, *k2_block, n0), metric, flush,
                       time_it=True),
               k2_case(f"E build round real {k2_block}", vec, sc, qq, ids,
                       metric, flush, time_it=True)]
    vec, sc, qq, ids, metric = k2_args(rerank[-1])
    k2_rows += [k2_case(f"E shard rerank cold {tuple(ids.shape)}", vec, sc,
                        qq, cold_ids(gen, *ids.shape, n0), metric, flush,
                        time_it=True),
                k2_case(f"E shard rerank real {tuple(ids.shape)}", vec, sc,
                        qq, ids, metric, flush, time_it=True)]
    return out, k1_rows, k2_rows


def headline(rows: list[dict], case: str) -> dict:
    (row,) = [r for r in rows if r["case"] == case]
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "bytes", "share")}


def main(argv: list[str]) -> int:
    name, smi = phase_device()
    logging.basicConfig(stream=sys.stdout, level=logging.WARNING,
                        format="[%(name)s] %(message)s")
    logging.getLogger("ocaml_hnsw_tpu_torch").setLevel(logging.INFO)
    phase_build_kernels()
    floor = method_floor()
    say(f"[floor] a near-empty launch (torch.cuda._sleep(1)) timed as every "
        f"kernel here: {floor['cold']:.2f} us cold, {floor['warm']:.2f} us "
        f"warm; each kernel time below includes it [{smi}]")
    gen = np.random.default_rng(3)
    if "--kernels-only" in argv:
        return kernels_only(gen)
    if "--beam-update" in argv:
        t0 = time.perf_counter()
        flush = torch.zeros(FLUSH_BYTES // 4, device=DEV)
        check_k4_edges(gen, flush)
        check_k4c_edges(gen, flush)
        phase_k4c(smi, gen)
        phase_k4(smi, flush, gen)
        say(f"[K4] phase took {time.perf_counter() - t0:.1f} s; "
            "--beam-update: stop here")
        return 0
    if "--phase-b8" in argv:
        t0 = time.perf_counter()
        phase_stream("B8", *STREAM_PHASES["B8"], smi,
                     torch.zeros(FLUSH_BYTES // 4, device=DEV), gen)
        say(f"[B8] phase took {time.perf_counter() - t0:.1f} s; --phase-b8: "
            "stop here")
        return 0

    t0 = time.perf_counter()
    data = clustered(N, DIM, n_clusters=400, seed=7)
    queries = queries_like(data, N_QUERIES, seed=8)
    qps_queries = queries_like(data, QPS_BATCH, seed=9)
    say(f"[data] clustered {N}x{DIM} + queries in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    dev = DEV
    x = torch.from_numpy(data).to(dev)
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)
    if "--phase-g" in argv:
        t0 = time.perf_counter()
        gt = device_ground_truth(x, torch.from_numpy(queries).to(dev),
                                 QUERY_KNOBS["k"], "l2")
        phase_g(x, queries, qps_queries, gt, None, smi, flush)
        say(f"[G] phase took {time.perf_counter() - t0:.1f} s; --phase-g: "
            "stop here")
        return 0
    k1_rows = check_k1_edges(gen)
    k4_rows = check_k4_edges(gen, flush)
    k4c_rows = check_k4c_edges(gen, flush)
    k2_rows = check_k2_edges(x, gen)
    k3_rows = check_k3_edges(gen)

    # ---- phases A and B: the incremental build and the classic engine
    phase_f_only = "--phase-f" in argv
    if not phase_f_only:
        t0 = time.perf_counter()
        phase_a_out, rows = phase_a(smi, flush, gen)
        k2_rows += rows
        say(f"[A] phase took {time.perf_counter() - t0:.1f} s")
        stream_out = {}
        for tag, plan in STREAM_PHASES.items():
            t0 = time.perf_counter()
            stream_out[tag], rows = phase_stream(tag, *plan, smi, flush, gen)
            k2_rows += rows
            say(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")

    # ---- main path: bulk build + packed query through the public API
    index = Index("l2", DIM, device=DEV.type)
    index.init_index(max_elements=N, M=M, ef_construction=EFC)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.add_items(data)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = read_launches()
    require_launches("main build", build_launches,
                     ["gather_dists", "scan_topk", "scan_topk/bf16"])
    t0 = time.perf_counter()
    labels, dists = index.knn_query(queries, **QUERY_KNOBS)
    query_s = time.perf_counter() - t0  # includes the one-off payload pack
    launches = {k: v for k, v in read_launches().items() if "/" not in k}
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
    if phase_f_only:
        t0 = time.perf_counter()
        phase_f(index, queries, qps_queries, gt, smi, flush, gen)
        say(f"[F] phase took {time.perf_counter() - t0:.1f} s; --phase-f: "
            "stop here")
        return 0
    reset_launches()
    k1_calls, seed_scan, seed_call, rerank_call = capture_query(index,
                                                                qps_queries)
    batch_launches = read_launches()
    say(f"[main] launches per {QPS_BATCH}-query batch: "
        f"{json.dumps(batch_launches)}")
    require_launches("main query batch", batch_launches,
                     ["packed_score", "beam_update", "gather_dists",
                      "scan_topk", "scan_topk/bf16", "seed_entries/kernel"])
    # K3's one launch in a packed call is the seed scan's
    if batch_launches["seed_entries/kernel"] != 1 \
            or batch_launches["scan_topk"] != 1:
        raise AssertionError("main query batch: K3 did not serve its one "
                             f"seed scan: {json.dumps(batch_launches)}")

    # ---- kernels at the main path's shapes, on its data and its inputs
    k1_rows += check_k1_main(index._packed_index(), qps_queries, k1_calls,
                             flush, gen)
    del k1_calls
    knn_call = capture_knn_batch(x)
    k2_rows += check_k2_main(x, qps_queries, seed_call, rerank_call, knn_call,
                             flush, gen)
    del knn_call, seed_call, rerank_call
    k3_rows += check_k3_main(x, qps_queries, flush)
    seed_rows = check_seed_scan(seed_scan, flush, gen)
    del seed_scan
    # one flat-scan batch (K3, the K2 rerank, sorts): 8192 queries over the
    # 1M rows, bf16 scan
    flat = bulk_mod.flat_from_rows(x, "l2")
    qq = torch.from_numpy(qps_queries).to(dev)
    reset_launches()
    flat_mod.flat_search(flat, qq, 10, "l2")
    flat_launches = read_launches()
    require_launches("main flat batch", flat_launches,
                     ["scan_topk", "scan_topk/bf16", "gather_dists"])
    # the trace must hold K3's kernel (the wgmma path's: the main shapes
    # all take it): any device time read from a trace counts it
    names = kernel_census(lambda: flat_mod.flat_search(flat, qq, 10, "l2"))
    if not any(K3_MAIN_KERNEL in k for k in names):
        raise AssertionError("the main flat batch's profile holds no "
                             f"{K3_MAIN_KERNEL} record: {json.dumps(names)}")
    # the batch's own time, host clock around a synchronize, median of 5
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        flat_mod.flat_search(flat, qq, 10, "l2")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    flat_ms = statistics.median(times) * 1e3
    say(f"[main flat batch] {QPS_BATCH} queries over {N}x{DIM} bf16 scan: "
        f"{flat_ms:.2f} ms = {QPS_BATCH / flat_ms * 1e3:.0f} QPS (median of "
        f"5); launches {json.dumps(flat_launches)} [{smi}]")
    del flat, qq

    for kern, n in launches.items():
        # the classic step serves the classic engine and the incremental
        # rounds: phases A, B, B8 and E require it; the main path has none
        if n <= 0 and kern != "beam_step_classic":
            raise AssertionError(f"{kern} was not launched on the main path")

    # ---- phase F: the packed options on main's graph (before C grows it)
    t0 = time.perf_counter()
    f_out, rows1, rows2 = phase_f(index, queries, qps_queries, gt, smi,
                                  flush, gen)
    k1_rows += rows1
    k2_rows += rows2
    say(f"[F] phase took {time.perf_counter() - t0:.1f} s")

    # ---- phase C: add after the bulk build (packed-build upkeep, K1)
    t0 = time.perf_counter()
    phase_c_out, rows = phase_c(index, data, queries, smi, flush, gen)
    k1_rows += rows
    say(f"[C] phase took {time.perf_counter() - t0:.1f} s")
    del index

    # ---- phase G: the build options (int8-scan bulk build, build(),
    # select_scan), while main's rows are on the card
    t0 = time.perf_counter()
    g_out, g_launches, rows1, rows2 = phase_g(
        x, queries, qps_queries, gt, dict(build_s=build_s, recall=rec), smi,
        flush)
    k1_rows += rows1
    k2_rows += rows2
    say(f"[G] phase took {time.perf_counter() - t0:.1f} s")

    # ---- phase D: the benchmark harness and the flat indexes
    t0 = time.perf_counter()
    check_int8_scan(gen)
    phase_d3(x, data, queries, gt, smi)
    del x, data
    say(f"[D3] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    d1_out, rows, rows3 = harness_case("D1", "glove1m", D1, smi, flush, gen,
                                       ["gather_dists", "packed_score",
                                        "scan_topk", "scan_topk/bf16"])
    k2_rows += rows
    k3_rows += rows3
    say(f"[D1] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    d2_out, rows, rows3 = harness_case("D2", "deep10m", D2, smi, flush, gen,
                                       ["gather_dists", "scan_topk",
                                        "scan_topk/int8"])
    k2_rows += rows
    k3_rows += rows3
    say(f"[D2] phase took {time.perf_counter() - t0:.1f} s (flat engine "
        f"only: the HNSW half of deep10m is not run)")

    # ---- phase E: the sharded index
    t0 = time.perf_counter()
    e_out, rows1, rows2 = phase_e(smi, flush, gen)
    k1_rows += rows1
    k2_rows += rows2
    say(f"[E] phase took {time.perf_counter() - t0:.1f} s")

    by_phase = {
        "main_build": build_launches,
        "main_query_batch": batch_launches,
        "main_flat_batch": flat_launches,
        "A_build": phase_a_out["launches_build"],
        "A_query_batch": phase_a_out["launches_per_batch"],
        "A_add_after_load": phase_a_out["launches_add"],
        **{f"{tag}_{part}": out[f"launches_{part}"]
           for tag, out in stream_out.items() for part in ("warm", "ingest")},
        **{f"{tag}_query_batch_ef{r['ef']}_mi{r['max_iters']}":
           r["launches_per_batch"]
           for tag, out in stream_out.items() for r in out["sweep"]},
        **f_out["launches"],
        "C_add": phase_c_out["launches_add"],
        "D1_glove1m": d1_out["launches"],
        "D2_deep10m_flat": d2_out["launches"],
        "E_first_add": e_out["launches_first_add"],
        "E_classic_query_batch": e_out["launches_classic_batch"],
        "E_second_add": e_out["launches_second_add"],
        "E_packed_query_batch": e_out["launches_packed_batch"],
        **g_launches,
    }
    shapes = ("bytes", "bound_ms", "share", "ms", "plain_ms")
    (headline_k3,) = [r for r in k3_rows
                      if r["case"] == f"kNN-table block {QPS_BATCH}x{N}"]
    k1_ring = ("stages", "registers", "warps_per_sm", "items_per_warp")
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
                      "slots": r["slots"], "bits": r["bits"],
                      **{s: r[s] for s in shapes + k1_ring}}
                     for r in k1_rows if "ms" in r]),
        dict(name="beam_update", route="cuda",
             source="ocaml_hnsw_tpu_torch/csrc/beam_update.cu",
             replaces=None, replaces_note=K4_REPLACES,
             launches=launches["beam_update"],
             launches_per_batch=batch_launches["beam_update"],
             launches_by_phase={p: c["beam_update"]
                                for p, c in by_phase.items()},
             max_abs_err=0.0, **headline(k4_rows, "cold sift B=4096"),
             library_ms=None, library_note=K4_NO_LIBRARY,
             shapes=[{"case": r["case"], "shape": r["shape"],
                      **{s: r[s] for s in shapes}}
                     for r in k4_rows if "ms" in r]),
        dict(name="beam_step_classic", route="cuda",
             source="ocaml_hnsw_tpu_torch/csrc/beam_update.cu",
             replaces=None, replaces_note=K4_REPLACES,
             launches=launches["beam_step_classic"],
             launches_per_batch=batch_launches["beam_step_classic"],
             launches_by_phase={p: c["beam_step_classic"]
                                for p, c in by_phase.items()},
             max_abs_err=0.0, **headline(k4c_rows, "cold query"),
             library_ms=None, library_note=K4_NO_LIBRARY,
             shapes=[{"case": r["case"], "shape": r["shape"],
                      **{s: r[s] for s in shapes}}
                     for r in k4c_rows if "ms" in r]),
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
             launches_by_path_by_phase={
                 p: {path: c[f"gather_dists/{path}"] for path in k2_mod.PATHS}
                 for p, c in by_phase.items() if "gather_dists/ring" in c},
             launches_by_dtype_by_phase={
                 p: {dt: c[f"gather_dists/{dt}"]
                     for dt in k2_mod.DTYPE_NAMES.values()}
                 for p, c in by_phase.items() if "gather_dists/int8" in c},
             shapes=[{"case": r["case"], "shape": r["shape"],
                      "path": r["path"], **{s: r[s] for s in shapes},
                      "requested_bytes": r["requested_bytes"]}
                     for r in k2_rows if "ms" in r]),
        dict(name="scan_topk", route="cuda",
             source="ocaml_hnsw_tpu_torch/csrc/scan_topk_wgmma.cu",
             sources=["ocaml_hnsw_tpu_torch/csrc/scan_topk_wgmma.cu",
                      "ocaml_hnsw_tpu_torch/csrc/scan_topk.cu",
                      "ocaml_hnsw_tpu_torch/csrc/scan_topk.cuh"],
             replaces="ocaml_hnsw_tpu/models/flat.py:170",
             replaces_note=K3_REPLACES,
             launches=launches["scan_topk"],
             launches_build=build_launches["scan_topk"],
             launches_per_batch=flat_launches["scan_topk"],
             launches_by_phase={p: c["scan_topk"]
                                for p, c in by_phase.items()},
             launches_by_dtype_by_phase={
                 p: {dt: c[f"scan_topk/{dt}"]
                     for dt in k3_mod.DTYPE_NAMES.values()}
                 for p, c in by_phase.items()},
             launches_by_path_by_phase={
                 p: {path: c[f"scan_topk/{path}"] for path in k3_mod.PATHS}
                 for p, c in by_phase.items()},
             plain_routes=scan_topk.plain_routes,
             max_abs_err=max(r["max_abs_err"] for r in k3_rows),
             **{k: headline_k3[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "bytes", "share")},
             library_ms=None, library_note=K3_NO_LIBRARY,
             product_ms=headline_k3["product_ms"],
             shapes=[{"case": r["case"], "shape": r["shape"],
                      "dtype": r["dtype"], "metric": r["metric"],
                      "path": r["path"], "plan": r["plan"],
                      "product_ms": r["product_ms"],
                      **{s: r[s] for s in shapes}}
                     for r in k3_rows if "ms" in r],
             seed_scans=seed_rows),
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
