"""Readings that the limits of `limits/<cell>.json` are set from: the
numbers that decide `correct`, for the port over many seeds and for the
control over a few, each seed in turn in one process.

    python3 -m hnsw_bench.calibrate --workload <cell> --seeds 11 12 ... \
        [--seconds 3] [--control]

Without `--control`: one run of the cell per seed (harness.run, with a
window of `--seconds`), one JSON line each with the numbers compared.
With `--control`: the reference computed in bfloat16 (`reference.rows(...,
dtype=torch.bfloat16)`) answers the whole query pool in the port's place,
and the float32 reference judges it as it judges the port; for a graph
cell, the control's nearest other row of each sampled node stands in for
the node's level-0 list.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from hnsw_bench import data, harness, judge, manifest, reference


def control(cfg: dict, seed: int, graph: bool, device) -> dict:
    rows, pool = data.make(cfg, seed, device)
    k = cfg["k"]
    ref = reference.rows(rows, cfg["metric"], device)
    low = reference.rows(rows, cfg["metric"], device, dtype=torch.bfloat16)
    q, true_ids, _, scale = judge.truth(ref, pool, k)
    ids, d = reference.knn(low, reference.queries(pool, low), k)
    numbers = judge.judge_answers(
        ref, q, true_ids, scale, np.arange(pool.shape[0]),
        ids.cpu().numpy(), d.float().cpu().numpy())
    if graph:
        nodes = judge.sample_nodes(ref.n, seed)
        want = judge.nearest_other(ref, nodes)
        got = judge.nearest_other(low, nodes)
        numbers["nn1_missing"] = float((got != want).float().mean())
    return numbers


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hnsw_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hnsw_bench.calibrate: no CUDA device", file=sys.stderr)
        return harness.EXIT_NO_DEVICE
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.read_json(manifest.config_file(bench, cell["config"]))
    mix = manifest.read_json(manifest.traffic_file(cell["traffic"]))
    limits = manifest.read_json(manifest.limits_file(cell["name"]))
    reference.full_f32()
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.control:
            numbers = control(cfg, seed, "adj0_invalid" in limits, "cuda")
            line = {"seed": seed, "control": True, "numbers": numbers}
        else:
            res = harness.run(cfg, mix, limits, [], [], seed, args.seconds,
                              False, "cuda", t0)
            line = {"seed": seed, "control": False,
                    "correct": res["correct"],
                    "numbers": {k: v["value"]
                                for k, v in res["checks"].items()}}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
