"""The traced run: torch.profiler over a few steady steps, the port's kernel
calls recorded by wrappers, and the record that the per-layer readers
(`layer_metrics/<name>.py`) read.

Once a process has run for a while, torch.profiler drops the first kernel
records of a window, so every trace runs the step `wait` and `warmup` times
before the `active` steps it records (`chip_smoke.busy_share`).  The
profiler's chrome trace goes to a temporary directory that is deleted when
it has been read.

Kernel calls: while the active steps run, `packed_score` (K1) and
`scan_topk` (K3) are wrapped where the port's modules call them, and each
call's work is counted from its arguments once the steps are over
(`roofline.k1_cost`, `roofline.k3_cost`): the wrappers launch nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import json
import logging
import os
import re
import tempfile
from bisect import bisect_right
from collections import defaultdict

import torch

from hnsw_bench import roofline, stats

#: device activity in the chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host activity that names an idle gap
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STEP = "ProfilerStep#"
#: the span each traced step runs in: a gap inside it and outside any op
#: is the step's own host code between ops
STEP_SPAN = "hnsw_bench.step (host code between ops)"
#: the port's kernel entries: where the port's modules call them (module,
#: name) and the name their device kernels carry in the trace
KERNELS = {
    "k1": ("ocaml_hnsw_tpu_torch.models.packed", "packed_score",
           "packed_score_kernel"),
    "k3": ("ocaml_hnsw_tpu_torch.models.flat", "scan_topk", "scan_topk"),
}
#: stage lines of the bulk build's logger: "bulk <stage>: <seconds> s"
BULK_LOGGER = "ocaml_hnsw_tpu_torch.models.bulk"
BULK_STAGE = re.compile(r"^bulk (.+): ([0-9.]+) s$")
#: entries of each breakdown list
BREAKDOWN = 10
#: host events looked at behind a gap before the outer spans
WALK_BACK = 4000


class _Calls:
    """Wrappers around the port's kernel entries that keep each call's
    arguments while `on`."""

    def __init__(self):
        self.on = False
        self.calls = {key: [] for key in KERNELS}

    @contextlib.contextmanager
    def patched(self):
        saved = []
        try:
            for key, (mod_name, attr, _) in KERNELS.items():
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)
                saved.append((mod, attr, orig))
                setattr(mod, attr, self._wrap(key, orig))
            yield self
        finally:
            for mod, attr, orig in saved:
                setattr(mod, attr, orig)

    def _wrap(self, key, orig):
        sig = inspect.signature(orig)

        def wrapper(*args, **kwargs):
            if self.on:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                self.calls[key].append(dict(bound.arguments))
            return orig(*args, **kwargs)

        return wrapper

    def costs(self) -> dict:
        """(bytes, ops, peak) of each recorded call, per kernel."""
        out = {"k1": [], "k3": []}
        for a in self.calls["k1"]:
            pay = a["pay"]
            slots = a["slots"] if a["slots"] is not None else pay.shape[1]
            out["k1"].append(roofline.k1_cost(a["nodes"], slots, pay.shape[2],
                                              a["bits"]))
        for a in self.calls["k3"]:
            scan, deleted = a["scan"], a["deleted"]
            n = int(a["n"])
            live = n - int(deleted[:n].sum())
            out["k3"].append(roofline.k3_cost(
                live, scan.shape[1], scan.element_size(), a["q"].shape[0],
                a["rerank_k"]))
        return out


class _StageLog(logging.Handler):
    """Collects the bulk build's stage lines while `on`."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.on = False
        self.stages: list[tuple[str, float]] = []

    def emit(self, record):
        m = BULK_STAGE.match(record.getMessage())
        if self.on and m:
            self.stages.append((m.group(1), float(m.group(2))))


@dataclasses.dataclass
class Trace:
    """What one traced window holds, times in seconds."""

    lo: float  # the active steps' span on the trace's clock
    hi: float
    device: list  # (name, start, end) of every device operation
    host: list  # (name, start, end) of host events, sorted by start

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return stats.union_length([(s, e) for _, s, e in self.device],
                                  self.lo, self.hi)

    def kernels(self, part: str) -> tuple[int, float]:
        """(count, summed seconds) of the device kernels whose name holds
        `part`."""
        hit = [e - s for name, s, e in self.device if part in name]
        return len(hit), sum(hit)

    def kernel_count(self) -> int:
        return sum(1 for name, _, _ in self.device if not name.startswith(
            ("Memcpy", "Memset")))

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for name, s, e in self.device:
            by_op[name[:120]] += e - s
        by_host = defaultdict(float)
        starts = [s for _, s, _ in self.host]
        outer = [h for h in self.host if h[2] - h[1] > 1e-3]
        for g0, g1 in stats.gaps([(s, e) for _, s, e in self.device],
                                 self.lo, self.hi):
            by_host[self._host_at((g0 + g1) / 2, starts, outer)] += g1 - g0
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:BREAKDOWN]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}

    def _host_at(self, t: float, starts, outer) -> str:
        """The innermost host event running at time t."""
        i = bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - WALK_BACK), -1):
            name, s, e = self.host[j]
            if s <= t <= e:
                return name
        inside = [h for h in outer if h[1] <= t <= h[2]]
        return max(inside, key=lambda h: h[1])[0] if inside else "(no host op)"


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps, device, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "user_annotation" and name.startswith(STEP):
            steps.append((s, e))
        elif cat in DEVICE_CATS:
            device.append((name, s, e))
        elif cat in HOST_CATS:
            host.append((name, s, e))
    if not steps:
        raise RuntimeError("the profiler's trace holds no step span")
    host.sort(key=lambda h: h[1])
    return Trace(lo=min(s for s, _ in steps), hi=max(e for _, e in steps),
                 device=device, host=host)


def run(step, wait: int, warmup: int, active: int, device=None) -> dict:
    """Run `step()` wait + warmup + active times under the profiler, each
    ending in a device synchronise, and return the record: the trace of
    the active steps, the work of each kernel call they made, the bulk
    build's stage lines, and the sum of what `step()` returned in them
    (the queries they answered).  `device`: where the steps run (the card
    unless the CPU is named)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    on_card = torch.device(device or "cuda").type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])

    calls, stages = _Calls(), _StageLog()
    bulk_log = logging.getLogger(BULK_LOGGER)
    level = bulk_log.level
    work = 0
    with tempfile.TemporaryDirectory(prefix="hnsw_bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        bulk_log.addHandler(stages)
        bulk_log.setLevel(logging.INFO)
        try:
            with calls.patched(), profile(
                    activities=activities,
                    schedule=schedule(wait=wait, warmup=warmup, active=active,
                                      repeat=1),
                    on_trace_ready=lambda p: p.export_chrome_trace(path)
            ) as prof:
                for i in range(wait + warmup + active):
                    recording = i >= wait + warmup
                    calls.on = stages.on = recording
                    with torch.profiler.record_function(STEP_SPAN):
                        done = step()
                    if on_card:
                        torch.cuda.synchronize()
                    calls.on = stages.on = False
                    if recording:
                        work += done
                    prof.step()
        finally:
            bulk_log.removeHandler(stages)
            bulk_log.setLevel(level)
        trace = read_chrome_trace(path)
    n_calls = {key: len(v) for key, v in calls.calls.items()}
    return {"trace": trace, "work": work, "costs": calls.costs(),
            "calls": n_calls, "stages": stages.stages}


def roofline_pct(record: dict, key: str) -> float | None:
    """Least time over measured device time, in %, of the recorded calls of
    kernel `key`; None where no call was recorded or where the trace does
    not hold one device kernel per recorded call."""
    costs = record["costs"][key]
    if not costs:
        return None
    count, seconds = record["trace"].kernels(KERNELS[key][2])
    if count != len(costs) or seconds <= 0:
        return None
    least = sum(roofline.least_seconds(*c) for c in costs)
    return 100.0 * least / seconds


def idle_pct(record: dict) -> float | None:
    """Share of the active steps' span with no device operation running,
    in %; None where the trace holds no device operation at all."""
    t = record["trace"]
    if not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
