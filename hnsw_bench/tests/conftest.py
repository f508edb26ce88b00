"""Shared fixtures of the benchmark's own tests: the cells cut to a size the
CPU runs in seconds (the port's plain kernels, thresholds lowered so the
bulk build and the packed engine still run)."""

import copy

import pytest
import torch

from hnsw_bench import manifest

TINY = {"n": 3000, "dim": 16, "n_queries": 300}
TINY_CLUSTERS = 8
TINY_REQUEST = 256
TINY_TRACE = {"wait": 1, "warmup": 1, "active": 1}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips (inside the test) "
        "without one")


@pytest.fixture
def tiny_cell(monkeypatch):
    """cell name -> (cfg, mix, limits, end_to_end, per_layer) at TINY size."""
    from ocaml_hnsw_tpu_torch import Index
    from ocaml_hnsw_tpu_torch.models.build import BuildState

    torch.set_num_threads(2)
    monkeypatch.setattr(Index, "PACKED_THRESHOLD", 1000)
    monkeypatch.setattr(Index, "SEED_THRESHOLD", 1000)
    monkeypatch.setattr(BuildState, "BULK_THRESHOLD", 1000)
    monkeypatch.setattr(BuildState, "PACKED_BUILD_THRESHOLD", 10 ** 9)
    bench = manifest.load()

    def make(name):
        cell = manifest.cell(bench, name)
        cfg = copy.deepcopy(manifest.read_json(
            manifest.config_file(bench, cell["config"])))
        cfg.update(TINY)
        cfg["generator"]["n_clusters"] = TINY_CLUSTERS
        mix = manifest.read_json(manifest.traffic_file(cell["traffic"]))
        if "request" in mix:
            mix["request"] = min(mix["request"], TINY_REQUEST)
        mix["trace"] = dict(TINY_TRACE)
        return (cfg, mix, manifest.read_json(manifest.limits_file(name)),
                manifest.end_to_end(bench, name),
                manifest.per_layer(bench, name))

    return make
