"""Per-block breakdown of K3's wgmma block (`csrc/scan_topk_wgmma.cu`) on
one card.

    python -m ocaml_hnsw_tpu_torch.bench.k3_timeline [--tree DIR] [--out F]

DIR is a checkout of the repository (default: this one).  Its package is
copied into a temporary directory, where `STAMPS` puts counters into the
copy's wgmma kernel (the shipped source is never changed): per block, lane
0 of thread 0 writes `%globaltimer` and `%smid` as the block starts, the
producer warp the time it issued its last item and the `clock64` cycles it
waited on empty slots, and warp 0 (queries 0-15 of warpgroup 0) the cycles
it spent waiting on full slots, in wgmma's wait, in the epilogue (and its
candidate path, `slow`: a tile where a score is below its threshold, from
the compare to the queues and any flush; the flushes of its queues to the
buffers, `flush`, merges included; the merges), in waiting for and reading
a tile's side data and releasing its items (`release`), in its whole tile
loop, with its counts of tiles on the candidate path (`slow_entries`),
flushes, tiles with a flush (`flush_tiles`) and merges; warp 4
(warpgroup 1) its end time.  The copy's library is built there and
launched through the copy's own wrapper: on main's data shapes
(`clustered_device` 1,003,520 x 128, 400 clusters, seed 7) the kNN table's
block (its first 8192 rows as queries, k = 97) and the flat batch (8192
queries, k = 32), l2; on glove's (1,183,514 x 100 unit rows, 473 clusters,
seed 7: 200-byte rows, the `cp.async` producer) D1's flat batch (8192
queries, k = 32), cosine; each as planned.

For each case the report gives the event time of a cold call (a 128 MiB
buffer read first) and, over the blocks of one more cold call, quantiles
(min, median, max) of the start offset, the producer's and the warpgroups'
end offsets (µs) and warp 0's cycles (millions) by part; `other` is warp 0's
loop cycles outside the parts named (issuing the products and its own
loop).  The counters cost time of their own: take kernel times from
`chip_smoke.py` or `kernel_race.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
SLOTS = 20
#: where each counter goes in a block's row of SLOTS
FIELDS = {"start": 0, "smid": 1, "producer_end": 2, "producer_empty_wait": 3,
          "wg0_end": 4, "full_wait": 5, "wgmma_wait": 6, "epilogue": 7,
          "slow": 8, "merges": 9, "slow_entries": 10, "loop": 11,
          "wg1_end": 12, "release": 13, "tiles": 14, "merge": 15,
          "flush": 16, "flushes": 17, "flush_tiles": 18}
#: (old, new) source edits that put the counters in; each must fit once
STAMPS = (
    ("namespace scan_topk {\nnamespace {\n",
     "namespace scan_topk {\n"
     "__device__ unsigned long long k3_tl[8192 * 20];\n"
     "namespace {\n"
     "__device__ __forceinline__ unsigned long long* k3_row() {\n"
     "  return k3_tl + 20 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
     "}\n"),
    ("  __syncthreads();  // every barrier set before any arrival\n",
     "  __syncthreads();  // every barrier set before any arrival\n"
     "  if (tid == 0) {\n"
     "    unsigned smid;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    k3_row()[0] = globaltimer();\n"
     "    k3_row()[1] = smid;\n"
     "  }\n"),
    ("  for (int i = 0; i < nitems; ++i) {\n"
     "    mbar_wait(empty0 + 8 * s, phase ^ 1);",
     "  unsigned long long wcyc = 0;\n"
     "  for (int i = 0; i < nitems; ++i) {\n"
     "    { const long long c0 = clock64(); mbar_wait(empty0 + 8 * s, "
     "phase ^ 1); wcyc += clock64() - c0; }"),
    ("    if (++s == a.stages) s = 0, phase ^= 1;\n  }\n}\n",
     "    if (++s == a.stages) s = 0, phase ^= 1;\n  }\n"
     "  if (lane == 0) { k3_row()[2] = globaltimer(); k3_row()[3] = wcyc; }\n"
     "}\n"),
    ("  const float coef = a.l2 ? 2.f : 1.f;\n",
     "  const float coef = a.l2 ? 2.f : 1.f;\n"
     "  unsigned long long c_full = 0, c_wait = 0, c_epi = 0, c_slow = 0,\n"
     "      n_merge = 0, n_slow = 0, c_rel = 0, c_merge = 0, c_flush = 0,\n"
     "      n_flush = 0, n_tflush = 0;\n"),
    ("      merge_rank(lists + (lrow0 + r8 + 8 * h) * lstride, a.kcap, c, "
     "lane);\n",
     "      { const long long c0 = clock64();\n"
     "        merge_rank(lists + (lrow0 + r8 + 8 * h) * lstride, a.kcap, c, "
     "lane);\n"
     "        c_merge += clock64() - c0; }\n"
     "      ++n_merge;\n"),
    ("  auto flush = [&]() {\n",
     "  auto flush = [&]() {\n"
     "    const long long cf0 = clock64();\n"
     "    ++n_flush;\n"),
    ("    __syncwarp();  // the buffers written before any merge reads them\n"
     "  };\n",
     "    __syncwarp();  // the buffers written before any merge reads them\n"
     "    c_flush += clock64() - cf0;\n"
     "  };\n"),
    ("                          (last && qn_[0] + qn_[1] > 0)))\n"
     "      return;\n",
     "                          (last && qn_[0] + qn_[1] > 0)))\n"
     "      return;\n"
     "    ++n_slow;\n"
     "    const long long cs0 = clock64();\n"
     "    const unsigned long long nf0 = n_flush;\n"),
    ("      pend = still;\n    }\n  };\n",
     "      pend = still;\n    }\n"
     "    c_slow += clock64() - cs0;\n"
     "    n_tflush += n_flush != nf0;\n  };\n"),
    ("  for (int t = 0; t < ntiles; ++t) {\n    wgmma_fence();",
     "  const long long ctot0 = clock64();\n"
     "  for (int t = 0; t < ntiles; ++t) {\n    wgmma_fence();"),
    ("      mbar_wait(full0 + 8 * rs, rphase);\n      __syncwarp();",
     "      { const long long c0 = clock64(); mbar_wait(full0 + 8 * rs, "
     "rphase); c_full += clock64() - c0; }\n      __syncwarp();"),
    ("    wgmma_commit();\n    wgmma_wait<0>();",
     "    wgmma_commit();\n"
     "    { const long long c0 = clock64(); wgmma_wait<0>(); "
     "c_wait += clock64() - c0; }\n"
     "    const long long cr0 = clock64();"),
    ("    if (lane == 0) mbar_arrive(sfull0 + 8 * (kSideSlots + sl));\n"
     "    epilogue(acc, bias, rsc, t);",
     "    if (lane == 0) mbar_arrive(sfull0 + 8 * (kSideSlots + sl));\n"
     "    c_rel += clock64() - cr0;\n"
     "    { const long long c0 = clock64(); epilogue(acc, bias, rsc, t); "
     "c_epi += clock64() - c0; }"),
    ("  // every buffer in (the last tile emptied the queues), then this "
     "warp's\n",
     "  if (lane == 0 && (warp == 0 || warp == 4)) {\n"
     "    unsigned long long* r = k3_row();\n"
     "    if (warp == 4) {\n"
     "      r[12] = globaltimer();\n"
     "    } else {\n"
     "      r[4] = globaltimer(); r[5] = c_full; r[6] = c_wait;\n"
     "      r[7] = c_epi; r[8] = c_slow; r[9] = n_merge; r[10] = n_slow;\n"
     "      r[11] = clock64() - ctot0; r[13] = c_rel; r[14] = ntiles;\n"
     "      r[15] = c_merge; r[16] = c_flush; r[17] = n_flush;\n"
     "      r[18] = n_tflush;\n"
     "    }\n"
     "  }\n"
     "  // every buffer in (the last tile emptied the queues), then this "
     "warp's\n"),
    ("int wgmma_dispatch(int op, int dtype",
     "}  // namespace scan_topk\n"
     "extern \"C\" int ohnsw_k3_timeline(void* out, int clear) {\n"
     "  static unsigned long long zeros[8192 * 20];\n"
     "  return static_cast<int>(clear ? cudaMemcpyToSymbol(\n"
     "      scan_topk::k3_tl, zeros, sizeof zeros) : cudaMemcpyFromSymbol(\n"
     "      out, scan_topk::k3_tl, sizeof zeros));\n"
     "}\n"
     "namespace scan_topk {\n"
     "int wgmma_dispatch(int op, int dtype"),
)
#: (label, data: "sift" = main's rows, "glove" = glove's; queries: "rows"
#: = the first 8192 rows, else drawn; k)
CASES = (("kNN block", "sift", "rows", 97),
         ("flat batch", "sift", "drawn", 32),
         ("D1 flat batch", "glove", "drawn", 32))
#: (rows, D, clusters, metric) of each data shape
DATA = {"sift": (1_003_520, 128, 400, "l2"),
        "glove": (1_183_514, 100, 473, "cosine")}


def stamped(src: str) -> str:
    """`src` with STAMPS applied; ValueError if one does not fit once."""
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise ValueError(f"k3_timeline: a stamp does not fit the kernel "
                             f"source ({src.count(old)} matches): "
                             f"{old.splitlines()[0]!r}")
        src = src.replace(old, new)
    return src


def summarize(rows) -> dict:
    """Quantiles over blocks (rows: int64 [blocks, SLOTS]) of the start
    and end offsets (µs) and warp 0's cycles by part (millions)."""
    import numpy as np

    def q(v):
        return [float(x) for x in np.percentile(v, [0, 50, 100]).round(2)]

    t0 = rows[:, FIELDS["start"]].min()
    out = {f"{k}_us": q((rows[:, FIELDS[k]] - t0) / 1e3)
           for k in ("start", "producer_end", "wg0_end", "wg1_end")}
    parts = ("full_wait", "wgmma_wait", "release", "epilogue", "slow",
             "flush", "merge", "loop", "producer_empty_wait")
    out.update({f"{k}_Mcycles": q(rows[:, FIELDS[k]] / 1e6) for k in parts})
    named = sum(rows[:, FIELDS[k]] for k in ("full_wait", "wgmma_wait",
                                             "release", "epilogue"))
    out["other_Mcycles"] = q((rows[:, FIELDS["loop"]] - named) / 1e6)
    out.update({k: q(rows[:, FIELDS[k]]) for k in (
        "tiles", "slow_entries", "flushes", "flush_tiles", "merges")})
    # the share of warp 0's tiles in which it flushes
    out["flush_tile_share"] = q(rows[:, FIELDS["flush_tiles"]]
                                / np.maximum(rows[:, FIELDS["tiles"]], 1))
    out["sms"] = int(len(set(rows[:, FIELDS["smid"]].tolist())))
    return out


def _worker(out_path: str) -> None:
    """Runs with the stamped copy first on sys.path."""
    import ctypes

    import numpy as np
    import torch

    from ocaml_hnsw_tpu_torch.bench.datasets import clustered_device
    from ocaml_hnsw_tpu_torch.bench.kernel_race import time_ms
    from ocaml_hnsw_tpu_torch.models import bulk as bulk_mod
    from ocaml_hnsw_tpu_torch.ops.kernels import _lib
    from ocaml_hnsw_tpu_torch.ops.kernels import scan_topk as k3

    dev = torch.device("cuda")
    lib = _lib.library()
    lib.ohnsw_k3_timeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = np.zeros(8192 * SLOTS, np.uint64)
    flush = torch.zeros((128 << 20) // 4, device=dev)
    report, made = [], {}
    for label, data, which, k in CASES:
        n, d, clusters, metric = DATA[data]
        if data not in made:
            made.clear()
            x, make_queries = clustered_device(n, d, n_clusters=clusters,
                                               seed=7, device=dev)
            if metric == "cosine":
                x = x / torch.linalg.norm(x, dim=1, keepdim=True)
            flat = bulk_mod.flat_from_rows(x, metric)
            drawn = make_queries(8192, qseed=9)
            if metric == "cosine":
                drawn = drawn / torch.linalg.norm(drawn, dim=1, keepdim=True)
            made[data] = (x, flat, drawn)
        x, flat, drawn = made[data]
        args = (flat.scan, flat.scales, flat.norms, flat.deleted, flat.n)
        q = x[:8192] if which == "rows" else drawn
        plan = k3.plan_for(flat.scan, 8192, k)

        def call():
            return k3.scan_topk(*args, q, k, metric)

        ms = time_ms(call, "read", 3, flush)
        lib.ohnsw_k3_timeline(None, 1)
        flush.sum()
        call()
        torch.cuda.synchronize()
        lib.ohnsw_k3_timeline(buf.ctypes.data_as(ctypes.c_void_p), 0)
        rows = buf.reshape(-1, SLOTS)[:plan.qtiles * plan.splits]
        report.append(dict(case=label, k=k, plan=dict(
            stages=plan.stages, buf=plan.buf, qt=plan.qt,
            producer=plan.producer, splits=plan.splits,
            qtiles=plan.qtiles), ms=ms,
            **summarize(rows.astype(np.int64))))
    Path(out_path).write_text(json.dumps(report))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(HERE.parents[1]))
    ap.add_argument("--out", help="write the report as JSON here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3_timeline: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        pkg = Path(tmp) / "ocaml_hnsw_tpu_torch"
        shutil.copytree(Path(args.tree) / "ocaml_hnsw_tpu_torch", pkg,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        src = pkg / "csrc" / "scan_topk_wgmma.cu"
        src.write_text(stamped(src.read_text()))
        report = os.path.join(tmp, "report.json")
        proc = subprocess.run(
            [sys.executable, "-m", "ocaml_hnsw_tpu_torch.bench.k3_timeline",
             "--worker", report], cwd=tmp, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=tmp), timeout=1200)
        if proc.returncode != 0:
            raise SystemExit(f"k3_timeline: the stamped tree failed:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        rows = json.loads(Path(report).read_text())
    for r in rows:
        print(f"[k3 timeline] {r['case']} k={r['k']} plan {r['plan']}: "
              f"{r['ms']:.3f} ms cold [{smi}]")
        print("  " + json.dumps({k: v for k, v in r.items()
                                 if k not in ("case", "k", "plan", "ms")}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=smi, rows=rows),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
