"""What decides `correct` has to fail: the control (the reference in
bfloat16 in the port's place) against each cell's limits, and a run of
each cell with its timed path broken underneath (the run skips only the
look for a card, and runs on the CPU at a small size)."""

import copy
import time

import numpy as np
import pytest

from hnsw_bench import calibrate, harness, manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]
#: the control at the cells' own widths, on fewer rows
CONTROL_ROWS, CONTROL_QUERIES = 20000, 300
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def _run(cell):
    cfg, mix, limits, e2e, layer = cell
    return harness.run(cfg, mix, limits, e2e, layer, 2 ** 31 + 99, 0.5,
                       False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    bench = manifest.load()
    cell = manifest.cell(bench, name)
    cfg = copy.deepcopy(manifest.read_json(
        manifest.config_file(bench, cell["config"])))
    cfg.update(n=CONTROL_ROWS, n_queries=CONTROL_QUERIES)
    limits = manifest.read_json(manifest.limits_file(name))
    for seed in SEEDS:
        numbers = calibrate.control(cfg, seed, "adj0_invalid" in limits,
                                    "cpu")
        numbers.setdefault("adj0_invalid", 0)
        checks = harness.judge.checks(
            {k: numbers[k] for k in limits}, limits)
        assert not all(c["ok"] for c in checks), (seed, numbers)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    res = _run(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


def _altered(orig):
    def knn_query(self, data, *a, **kw):
        labels, dists = orig(self, data, *a, **kw)
        labels = labels.copy()
        labels[0, 0] = (labels[0, 0] + 7) % self.get_current_count()
        return labels, dists
    return knn_query


def _half(orig):
    def knn_query(self, data, *a, **kw):
        half = (len(data) + 1) // 2
        labels, dists = orig(self, data[:half], *a, **kw)
        reps = -(-len(data) // half)
        return (np.tile(labels, (reps, 1))[:len(data)],
                np.tile(dists, (reps, 1))[:len(data)])
    return knn_query


def _unchanged(orig):
    first = {}

    def knn_query(self, data, *a, **kw):
        if id(self) not in first:
            first[id(self)] = orig(self, data, *a, **kw)
        labels, dists = first[id(self)]
        n = min(len(data), len(labels))
        return labels[:n], dists[:n]
    return knn_query


QUERY_FAULTS = {"altered": _altered, "half": _half, "unchanged": _unchanged}


@pytest.mark.parametrize("fault", sorted(QUERY_FAULTS))
@pytest.mark.parametrize("name", [c for c in CELLS if not
                                  c.endswith(".build")])
def test_broken_query_path_is_not_correct(tiny_cell, monkeypatch, name,
                                          fault):
    from ocaml_hnsw_tpu_torch.api import FlatIndex, Index

    cell = tiny_cell(name)
    cls = FlatIndex if cell[1]["index"] == "FlatIndex" else Index
    monkeypatch.setattr(cls, "knn_query", QUERY_FAULTS[fault](cls.knn_query))
    res = _run(cell)
    assert not res["correct"]
    assert res["failed"] == 0  # the checks catch it, not a crash
    assert [n for n, c in res["checks"].items()
            if not harness.judge.checks({n: c["value"]}, {n: {c["op"]: c[
                "limit"]}})[0]["ok"]], res["checks"]


def _add_nothing(orig):
    def add_items(self, data, *a, **kw):
        return None
    return add_items


def _add_half(orig):
    def add_items(self, data, *a, **kw):
        return orig(self, data[:len(data) // 2], *a, **kw)
    return add_items


BUILD_FAULTS = {"unchanged": ("add_items", _add_nothing),
                "half": ("add_items", _add_half),
                "altered": ("knn_query", _altered)}


@pytest.mark.parametrize("fault", sorted(BUILD_FAULTS))
@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith(".build")])
def test_broken_build_is_not_correct(tiny_cell, monkeypatch, name, fault):
    from ocaml_hnsw_tpu_torch.api import Index

    cell = tiny_cell(name)
    attr, make = BUILD_FAULTS[fault]
    monkeypatch.setattr(Index, attr, make(getattr(Index, attr)))
    res = _run(cell)
    assert not res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.chip
def test_cell_runs_on_the_card():
    """One short run of the first cell through the command's own entry."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import io
    from contextlib import redirect_stdout
    import json

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.main(["--workload", CELLS[0], "--seed", "7",
                           "--seconds", "2"], t0=time.perf_counter())
    assert rc == 0
    assert json.loads(buf.getvalue().strip().splitlines()[-1])["correct"]
