"""`BENCHMARK.json`: reading it, finding a cell's files by name, and
checking it against the benchmark's contract.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under `hnsw_bench/`, found by
the name `BENCHMARK.json` gives it:

- `configs/<config>.json` (the file named by the configuration's `file`),
- `traffic/<traffic>.json`, whose `driver` names `drivers/<driver>.py`,
- `limits/<cell>.json`: the limits of the numbers that decide `correct`,
- `layer_metrics/<metric>.py`: the reader of one per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}
#: what `reduced` may never name (widths of the deployment)
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|per_tok|^dim$)")


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(manifest: dict, config: str) -> Path:
    for c in manifest["configs"]:
        if c["name"] == config:
            return ROOT / c["file"]
    raise KeyError(f"no configuration {config!r} in BENCHMARK.json")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_file(traffic: str) -> Path:
    return HERE / "traffic" / f"{traffic}.json"


def limits_file(cell_name: str) -> Path:
    return HERE / "limits" / f"{cell_name}.json"


def driver(name: str):
    return importlib.import_module(f"hnsw_bench.drivers.{name}")


def reader_file(metric: str) -> Path:
    return HERE / "layer_metrics" / f"{metric}.py"


def reader(metric: str):
    """`read(record) -> float | None` of `layer_metrics/<metric>.py`."""
    path = reader_file(metric)
    spec = importlib.util.spec_from_file_location(
        f"hnsw_bench.layer_metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _listed(metric: dict, cell_name: str, reported: set) -> bool:
    """A per-layer metric is reported in the cells its `workloads` lists,
    or, without that key, in every cell that reports what it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric["moves"] in reported


def end_to_end(manifest: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics cell `cell_name` reports."""
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(manifest: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics cell `cell_name` reports in a traced run."""
    e2e = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"] if _listed(m, cell_name, e2e)]


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def validate(manifest: dict, root: Path = ROOT) -> list[str]:
    """Every way `manifest` breaks the contract or misses a file of its
    own; empty when it holds."""
    err = []
    if set(manifest) != TOP_KEYS:
        err.append(f"top-level keys {sorted(manifest)}")
    if len(json.dumps(manifest)) > 64 * 1024:
        err.append("BENCHMARK.json over 64 KiB")
    paths = manifest.get("paths", [])
    if not 1 <= len(paths) <= 16 or not all(
            PATH.match(p) and ".." not in p.split("/") for p in paths):
        err.append(f"paths {paths}")
    cmd = manifest.get("command", [])
    if not 1 <= len(cmd) <= 32 or not all(_line(w) for w in cmd) or any(
            w.startswith("/") or ".." in w.split("/") for w in cmd):
        err.append(f"command {cmd}")
    rs = manifest.get("run_seconds")
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        err.append(f"run_seconds {rs}")

    def under_paths(rel: str) -> bool:
        return any(rel == p or rel.startswith(p.rstrip("/") + "/")
                   for p in paths)

    names = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest.get(kind, []):
            n = entry.get("name", "")
            if not NAME.match(n):
                err.append(f"{kind}: bad name {n!r}")
            group = "metric" if kind in ("end_to_end", "per_layer") else kind
            if (group, n) in names:
                err.append(f"{kind}: {n!r} named twice")
            names[(group, n)] = entry

    configs = {c["name"]: c for c in manifest.get("configs", [])}
    if not 1 <= len(configs) <= 24:
        err.append(f"{len(configs)} configurations")
    files = set()
    for c in configs.values():
        if set(c) != CONFIG_KEYS:
            err.append(f"config {c['name']}: keys {sorted(c)}")
        if not _line(c.get("source")) or not _line(c.get("why")):
            err.append(f"config {c['name']}: source or why")
        f = c.get("file", "")
        if not under_paths(f) or f in files or not (root / f).is_file():
            err.append(f"config {c['name']}: file {f!r}")
        files.add(f)
        red = c.get("reduced", [])
        if len(red) > 16 or not all(NAME.match(k) and not WIDTH.search(k)
                                    for k in red):
            err.append(f"config {c['name']}: reduced {red}")

    cells = manifest.get("workloads", [])
    if not 1 <= len(cells) <= 24:
        err.append(f"{len(cells)} workloads")
    pairs = set()
    for w in cells:
        if set(w) != CELL_KEYS:
            err.append(f"workload {w['name']}: keys {sorted(w)}")
        if w.get("config") not in configs:
            err.append(f"workload {w['name']}: config {w.get('config')!r}")
        if not NAME.match(w.get("traffic", "")):
            err.append(f"workload {w['name']}: traffic name")
        elif not (root / "hnsw_bench" / "traffic"
                  / f"{w['traffic']}.json").is_file():
            err.append(f"workload {w['name']}: no traffic file")
        if not (root / "hnsw_bench" / "limits" / f"{w['name']}.json"
                ).is_file():
            err.append(f"workload {w['name']}: no limits file")
        if w.get("chips") not in (1, 4):
            err.append(f"workload {w['name']}: chips {w.get('chips')}")
        if not _line(w.get("why")):
            err.append(f"workload {w['name']}: why")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            err.append(f"workload {w['name']}: pair {pair} twice")
        pairs.add(pair)
    used = {w.get("config") for w in cells}
    for c in configs:
        if c not in used:
            err.append(f"config {c} used by no cell")
    four = sum(1 for w in cells if w.get("chips") == 4)
    if four > max(1, len(cells) // 4):
        err.append(f"{four} cells on four chips")

    cell_names = {w["name"] for w in cells}
    e2e = manifest.get("end_to_end", [])
    if not 1 <= len(e2e) <= 16:
        err.append(f"{len(e2e)} end-to-end metrics")
    if "setup_s" not in {m.get("name") for m in e2e}:
        err.append("no setup_s")
    for m in e2e:
        if not set(E2E_KEYS) <= set(m) <= E2E_KEYS | {"workloads"}:
            err.append(f"metric {m['name']}: keys {sorted(m)}")
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            err.append(f"metric {m['name']}: bound {b}")
        if m.get("source") not in E2E_SOURCES:
            err.append(f"metric {m['name']}: source {m.get('source')}")
    layers = manifest.get("per_layer", [])
    if not 1 <= len(layers) <= 128:
        err.append(f"{len(layers)} per-layer metrics")
    e2e_names = {m["name"] for m in e2e}
    for m in layers:
        if not set(LAYER_KEYS) <= set(m) <= LAYER_KEYS | {"workloads"}:
            err.append(f"metric {m['name']}: keys {sorted(m)}")
        if m.get("source") not in SOURCES or not _line(m.get("layer")):
            err.append(f"metric {m['name']}: source or layer")
        if m.get("moves") not in e2e_names:
            err.append(f"metric {m['name']}: moves {m.get('moves')!r}")
        if not (root / "hnsw_bench" / "layer_metrics"
                / f"{m['name']}.py").is_file():
            err.append(f"metric {m['name']}: no reader")
    for m in e2e + layers:
        if not UNIT.match(m.get("unit", "")):
            err.append(f"metric {m['name']}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            err.append(f"metric {m['name']}: better")
        for w in m.get("workloads", []):
            if w not in cell_names:
                err.append(f"metric {m['name']}: no cell {w!r}")
    for w in cells:
        reported = {m["name"] for m in end_to_end(manifest, w["name"])}
        if "setup_s" not in reported or len(reported) < 2:
            err.append(f"workload {w['name']}: end-to-end {sorted(reported)}")
        mine = per_layer(manifest, w["name"])
        if not mine:
            err.append(f"workload {w['name']}: no per-layer metric")
        for m in mine:
            if m.get("moves") not in reported:
                err.append(f"workload {w['name']}: {m['name']} moves "
                           f"{m.get('moves')!r}, which it does not report")
    return err
