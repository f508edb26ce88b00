"""Command-line benchmark of the torch port, the counterpart of the JAX
package's `bench.py`: QPS at recall@10 >= 0.95 on a synthetic stand-in
dataset, printed as one JSON line.

    python -m ocaml_hnsw_tpu_torch.bench --config sift1m
    python -m ocaml_hnsw_tpu_torch.bench --config random10k --device cpu

Configs: random10k, sift100k, sift1m, glove1m, deep10m, laion1m, and the
streaming ones laion-streaming and laion5m-streaming.  Runs on the CUDA
device unless `--device cpu` is given; without a CUDA device it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

# name: (n, dim, metric, round_size, ef_construction, engines, hnsw storage,
#        scan_dtype, rerank_dtype): the JAX package's bench.py table
CONFIGS = {
    "random10k": (10_000, 128, "l2", 512, 64,
                  ("hnsw", "flat"), "f32", "bf16", "f32"),
    "sift100k": (100_000, 128, "l2", 1024, 200,
                 ("hnsw", "flat"), "f32", "bf16", "f32"),
    "sift1m": (1_000_000, 128, "l2", 2048, 200,
               ("hnsw", "flat"), "f32", "bf16", "f32"),
    "glove1m": (1_183_514, 100, "cosine", 2048, 200,
                ("hnsw", "flat"), "f32", "bf16", "f32"),
    # int8-quantized distances in both engines
    "deep10m": (10_000_000, 96, "l2", 2048, 200,
                ("hnsw", "flat"), "int8", "int8", "bf16"),
    # the 768-d config's flat engine at 1M rows
    "laion1m": (1_000_000, 768, "cosine", 2048, 200,
                ("flat",), "bf16", "int8", "bf16"),
}

# the 768-d config measured as streaming (interleaved timed inserts and
# query batches); name: (n, dim, metric, storage, data_dtype, round_size).
# laion5m-streaming is the full-size run: bf16 source, int8 rows in the graph
STREAMING = {
    "laion-streaming": (1_000_000, 768, "cosine", "f32", "f32", 2048),
    "laion5m-streaming": (5_000_000, 768, "cosine", "int8", "bf16", 1024),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ocaml_hnsw_tpu_torch.bench")
    ap.add_argument("--config", default="sift1m",
                    choices=sorted(CONFIGS) + sorted(STREAMING))
    ap.add_argument("--queries", type=int, default=1000)
    # the packed sweep serves a batch of 8192 as two interleaved halves
    ap.add_argument("--qps-batch", type=int, default=8192)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from ocaml_hnsw_tpu_torch.bench.harness import (
        run_config, run_streaming_config,
    )

    if args.config in STREAMING:
        n, dim, metric, storage, data_dtype, rs = STREAMING[args.config]
        result = run_streaming_config(
            args.config, n=n, dim=dim, metric=metric,
            n_queries=args.queries, round_size=rs,
            # classic-engine streaming serves at 4096 (8192 is the packed
            # sweep's operating point, not this path's)
            qps_batch=min(args.qps_batch, 4096),
            storage=storage, data_dtype=data_dtype,
            verbose=not args.quiet, device=args.device,
        )
        line = {
            "metric": f"sustained QPS during ingest ({args.config})",
            "value": result["sustained_qps_during_ingest"],
            "unit": "qps",
            "ingest_vps": result["ingest_vps"],
            "recall": result["recall"],
            "backend": result["backend"],
        }
        print(json.dumps(line))
        return 0

    (n, dim, metric, round_size, efc, engines, storage, scan_dtype,
     rerank_dtype) = CONFIGS[args.config]
    result = run_config(
        args.config, n=n, dim=dim, metric=metric, n_queries=args.queries,
        round_size=round_size, ef_construction=efc, qps_batch=args.qps_batch,
        engines=engines, storage=storage, scan_dtype=scan_dtype,
        rerank_dtype=rerank_dtype, verbose=not args.quiet,
        device=args.device,
    )
    hnsw = result["engines"].get("hnsw", {})
    line = {
        "metric": f"QPS/chip at recall@10>={result['target_recall']} "
                  f"({args.config} synthetic)",
        "value": result["qps"],
        "unit": "qps",
        "engine": result["engine"],
        "recall": result["recall"],
        "hnsw_qps": hnsw.get("best", {}).get("qps"),
        "hnsw_recall": hnsw.get("best", {}).get("recall"),
        "hnsw_build_vectors_per_second": hnsw.get("build_vectors_per_second"),
        "backend": result["backend"],
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
