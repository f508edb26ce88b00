"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result line.

    python3 -m hnsw_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Set-up (counted in `setup_s`, from process start): the rows and the
   query pool are made on the card from the seed (`data.py`) and copied to
   the host; the cell's driver (`drivers/<driver>.py`, named by the traffic
   mix) builds what the traffic needs through the port's public API and
   runs every shape once.
2. The window: the driver's step (one request, or one whole build) in a
   closed loop for `--seconds`.  With `--trace 1` the window is followed
   by the mix's traced steps under torch.profiler (`trace.py`), whose
   record the cell's per-layer readers (`layer_metrics/<metric>.py`)
   read; the window's readings are not reported then.
3. The products: what the window returned (answers; for a build, the
   last graph's level-0 lists and its answers to the query pool).  The
   device's peak memory is read, the port's state is freed, and the plain
   reference (`reference.py`, `judge.py`) judges the products.

The result is the last line of standard output; the numbers compared,
each beside its limit, are the last lines of standard error and the last
key of the result.  With no CUDA device, or fewer than the cell asks for,
the run prints no result and exits 3; if JAX or the JAX package is loaded
once the window has closed, it exits 4.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
import traceback

import numpy as np
import torch

from hnsw_bench import data, imports, judge, manifest, reference, trace

EXIT_NO_DEVICE = 3
EXIT_FORBIDDEN = 4


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell's configuration and traffic, the
    seed, the device, and the host rows and query pool."""

    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    rows: np.ndarray
    pool: np.ndarray

    @property
    def k(self) -> int:
        return self.cfg["k"]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(drv, state, run: Run, seconds: float) -> dict:
    """The closed loop: the driver's step until `seconds` have passed since
    the first began; every step runs to its end."""
    attempted = failed = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        attempted += 1
        try:
            drv.step(state, run)
        except Exception:  # the run goes on to report the failure
            failed += 1
            traceback.print_exc()
            break
    t1 = time.perf_counter()
    done = attempted > failed
    return {"attempted": attempted, "failed": failed,
            "metrics": drv.window_metrics(state, run, t1 - t0) if done
            else {}}


def traced(drv, state, run: Run, seconds: float) -> dict:
    """The window as an untraced run has it, then the mix's traced steps:
    the check judges as many answers as an untraced run's."""
    out = window(drv, state, run, seconds)
    if out["failed"]:
        return out
    steps = run.mix["trace"]
    out["attempted"] += steps["wait"] + steps["warmup"] + steps["active"]
    out["record"] = trace.run(lambda: drv.step(state, run), **steps,
                              device=run.device)
    out["record"].update(driver=run.mix["driver"], engine=run.mix["engine"])
    return out


def judged(products: dict, run: Run, limits: dict) -> tuple[dict, dict]:
    """(the numbers that have limits, every number) of the products."""
    ref = reference.rows(run.rows, run.cfg["metric"], run.device)
    q, true_ids, _, scale = judge.truth(ref, run.pool, run.k)
    pool_idx, labels, dists = products["answers"]
    numbers = judge.judge_answers(ref, q, true_ids, scale, pool_idx, labels,
                                  dists)
    if products.get("adj0") is not None:
        nodes = judge.sample_nodes(ref.n, run.seed)
        numbers.update(judge.judge_graph(
            ref, products["adj0"], nodes, judge.nearest_other(ref, nodes)))
    return {name: numbers[name] for name in limits}, numbers


def run(cfg: dict, mix: dict, limits: dict, e2e: list, layer: list,
        seed: int, seconds: float, trace_on: bool, device, t0: float) -> dict:
    """One run (module docstring); returns the result line as a dict."""
    dev = torch.device(device)
    reference.full_f32()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rows, pool = data.make(cfg, seed, dev)
    r = Run(cfg=cfg, mix=mix, seed=seed, device=dev, rows=rows, pool=pool)
    drv = manifest.driver(mix["driver"])
    state = drv.setup(r)
    sync(dev)
    gc.collect()
    gc.freeze()  # the window's collections do not scan set-up's objects
    setup_s = time.perf_counter() - t0
    out = (traced if trace_on else window)(drv, state, r, seconds)
    problems = []
    try:
        products = drv.products(state, r)
    except Exception as exc:  # a product that never came is not correct
        traceback.print_exc()
        problems.append(f"products: {exc!r}")
        products = None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks, numbers = [], {}
    if products is not None:
        compared, numbers = judged(products, r, limits)
        checks = judge.checks(compared, limits)
    correct = (products is not None and out["failed"] == 0
               and all(c["ok"] for c in checks))
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    metrics = {}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if trace_on and "record" in out:
        record = out["record"]
        for m in layer:
            v = manifest.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        t = record["trace"]
        device_info.update(busy_s=t.busy_s(), window_s=t.window_s)
        result["breakdown"] = t.breakdown()
    elif not trace_on:
        readings = dict(out["metrics"], setup_s=setup_s,
                        recall_at_10=numbers.get("recall_at_10"))
        for m in e2e:
            v = readings.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                    "op": c["op"]} for c in checks}
    if problems:
        result["checks"]["products"] = {"value": "; ".join(problems),
                                        "limit": "none missing", "op": "none"}
    return result


def check_lines(result: dict) -> list[str]:
    lines = []
    for name, c in result["checks"].items():
        sign = {"min": ">=", "max": "<="}.get(c["op"], c["op"])
        lines.append(f"check {name} = {c['value']!r} (limit {sign} "
                     f"{c['limit']!r})")
    lines.append(f"correct = {result['correct']} (attempted "
                 f"{result['attempted']}, failed {result['failed']})")
    return lines


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hnsw_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"hnsw_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_DEVICE
    cfg = manifest.read_json(manifest.config_file(bench, cell["config"]))
    mix = manifest.read_json(manifest.traffic_file(cell["traffic"]))
    limits = manifest.read_json(manifest.limits_file(cell["name"]))
    result = run(cfg, mix, limits, manifest.end_to_end(bench, cell["name"]),
                 manifest.per_layer(bench, cell["name"]), args.seed,
                 args.seconds, bool(args.trace), "cuda", t0)
    found = imports.loaded_forbidden()
    if found:
        print(f"hnsw_bench: the process has loaded {found}", file=sys.stderr)
        return EXIT_FORBIDDEN
    print(json.dumps(result), flush=True)
    print("\n".join(check_lines(result)), file=sys.stderr, flush=True)
    return 0
