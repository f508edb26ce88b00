"""BENCHMARK.json against the contract, and every name found as a file."""

import copy

import pytest

from hnsw_bench import manifest


@pytest.fixture
def bench():
    return manifest.load()


def test_manifest_holds(bench):
    assert manifest.validate(bench) == []


@pytest.mark.parametrize("edit, needle", [
    (lambda b: b["workloads"][0].update(name="has space"), "bad name"),
    (lambda b: b["end_to_end"][0].update(unit="queries per s"), "unit"),
    (lambda b: b["per_layer"][0].update(moves="add_vps"), "does not report"),
    (lambda b: b["per_layer"][0]["workloads"].append("nowhere"), "no cell"),
    (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda b: b["end_to_end"][0].update(why="x"), "keys"),
    (lambda b: b["configs"][0].update(reduced=["dim"]), "reduced"),
    (lambda b: b["workloads"][0].update(traffic="no-such-mix"), "traffic"),
    (lambda b: b["per_layer"][0].update(name="no_reader"), "no reader"),
    (lambda b: b["workloads"][1].update(config=b["workloads"][0]["config"],
                                        traffic=b["workloads"][0]["traffic"]),
     "twice"),
])
def test_manifest_faults_are_found(bench, edit, needle):
    broken = copy.deepcopy(bench)
    edit(broken)
    assert any(needle in e for e in manifest.validate(broken))


def test_each_cell_finds_its_files(bench):
    for cell in bench["workloads"]:
        cfg = manifest.read_json(manifest.config_file(bench, cell["config"]))
        mix = manifest.read_json(manifest.traffic_file(cell["traffic"]))
        limits = manifest.read_json(manifest.limits_file(cell["name"]))
        drv = manifest.driver(mix["driver"])
        for fn in ("setup", "step", "window_metrics", "products"):
            assert callable(getattr(drv, fn))
        assert cfg["name"] == cell["config"]
        assert cfg["engines"][mix["engine"]]
        assert limits["recall_at_10"] == {"min": cfg["recall_target"]}
        assert set(mix["trace"]) == {"wait", "warmup", "active"}


def test_config_files_state_their_cuts(bench):
    for c in bench["configs"]:
        cfg = manifest.read_json(manifest.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] == []
        assert {"n", "dim", "metric", "M", "ef_construction", "source",
                "assumed", "generator"} <= set(cfg)


def test_readers_read_only_their_records(bench):
    class NoTrace:
        device = []

    record = {"driver": "other", "engine": "other", "trace": NoTrace(),
              "costs": {"k1": [], "k3": []}, "stages": [], "work": 0}
    for m in bench["per_layer"]:
        assert manifest.reader(m["name"])(record) is None


def test_cells_report_their_metrics(bench):
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(bench, cell["name"])}
        assert {"setup_s", "recall_at_10"} <= e2e
        layer = manifest.per_layer(bench, cell["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
