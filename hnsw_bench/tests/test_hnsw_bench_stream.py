"""The `laion1m.stream` cell's own files: the stream driver at a small size on
the CPU, its six readers on hand-made traces, and its entries in
`BENCHMARK.json`."""

import copy
import time

import numpy as np
import pytest

from hnsw_bench import data, harness, manifest, trace
from hnsw_bench.drivers import stream

CELL = "laion1m.stream"
READERS = ("device_idle_pct.stream", "ingest_pct.stream",
           "round_idle_pct.stream", "launches_per_row.stream",
           "classic_idle_pct.stream", "api_host_pct.stream")
TINY = {"n": 3000, "dim": 16, "n_queries": 300, "round_size": 128,
        "stream": {"rows": 640}}
REQUEST = 64


@pytest.fixture
def tiny(monkeypatch):
    """(cfg, mix) of the cell at TINY size, the port's thresholds lowered so
    the snapshot takes the bulk build and queries the seed scan."""
    import torch

    from ocaml_hnsw_tpu_torch import Index
    from ocaml_hnsw_tpu_torch.models.build import BuildState

    torch.set_num_threads(2)
    monkeypatch.setattr(Index, "SEED_THRESHOLD", 1000)
    monkeypatch.setattr(BuildState, "BULK_THRESHOLD", 1000)
    bench = manifest.load()
    cell = manifest.cell(bench, CELL)
    cfg = copy.deepcopy(manifest.read_json(
        manifest.config_file(bench, cell["config"])))
    cfg.update(TINY)
    cfg["generator"]["n_clusters"] = 8
    mix = manifest.read_json(manifest.traffic_file(cell["traffic"]))
    mix.update(request=REQUEST, trace={"wait": 1, "warmup": 1, "active": 1})
    return cfg, mix


def _run(cfg, mix, seed=2 ** 31 + 21):
    import torch

    rows, pool = data.make(cfg, seed, "cpu")
    return harness.Run(cfg=cfg, mix=mix, seed=seed,
                       device=torch.device("cpu"), rows=rows, pool=pool)


def test_steps_insert_the_stream_then_only_query(tiny):
    cfg, mix = tiny
    run = _run(cfg, mix)
    warm = stream.snapshot_rows(cfg)
    assert warm == cfg["n"] - cfg["stream"]["rows"]
    rs = cfg["round_size"]
    st = stream.setup(run)
    # the snapshot, then the set-up step's rows, none counted in the window
    assert st.index.get_current_count() == warm + rs == st.cursor
    assert (st.ingest_queries, st.t_start, st.t_last) == (0, None, None)
    left = cfg["n"] - warm - rs
    inserting = -(-left // rs)
    want = [min(rs, left - i * rs) for i in range(inserting)] + [0, 0]
    done = [stream.step(st, run) for _ in want]
    assert done == want
    assert st.sent == len(want) + 1
    assert st.ingest_queries == inserting * REQUEST
    t_last = st.t_last
    assert st.t_start < t_last
    # query-only steps stay out of qps: it ends at the last inserting step
    qps = stream.window_metrics(st, run, 123.0)["qps"]
    assert qps == pytest.approx(inserting * REQUEST / (t_last - st.t_start))
    out = stream.products(st, run)
    pool_idx, labels, dists = out["answers"]
    np.testing.assert_array_equal(pool_idx, np.arange(cfg["n_queries"]))
    assert labels.shape == dists.shape == (cfg["n_queries"], cfg["k"])
    assert out["adj0"].shape == (cfg["n"], 2 * cfg["M"])
    assert st.index is None


def test_products_insert_what_the_window_left(tiny):
    cfg, mix = tiny
    run = _run(cfg, mix)
    st = stream.setup(run)
    index = st.index
    assert stream.window_metrics(st, run, 1.0) == {}
    out = stream.products(st, run)
    assert index.get_current_count() == cfg["n"]
    assert index.get_ids_list() == list(range(cfg["n"]))
    assert (out["adj0"] >= 0).any(axis=1).all()


def test_traced_run_reads_the_ingest_share(tiny):
    """On the CPU the trace holds no device: the device-time readers are
    left out and the span shares are read; the traced steps insert rows."""
    cfg, mix = tiny
    cfg["round_size"] = 64
    bench = manifest.load()
    limits = manifest.read_json(manifest.limits_file(CELL))
    res = harness.run(cfg, mix, limits, manifest.end_to_end(bench, CELL),
                      manifest.per_layer(bench, CELL), 2 ** 31 + 22, 0.0,
                      True, "cpu", time.perf_counter())
    assert set(res["checks"]) == set(limits)
    assert res["failed"] == 0
    spans_read = {"ingest_pct.stream", "api_host_pct.stream"}
    assert set(res["metrics"]) == spans_read
    for m in spans_read:
        assert 0 < res["metrics"][m]["value"] < 100


def _record(host, device, driver="stream", work=8):
    t = trace.Trace(lo=0.0, hi=10.0, device=list(device),
                    host=sorted(host, key=lambda h: h[1]))
    return {"driver": driver, "engine": "classic", "trace": t, "work": work}


ROUND = "hnsw.build.round"
BEAM = "hnsw.classic.beam"
HOST = [(ROUND, 1.0, 3.0), (ROUND, 5.0, 9.0), (BEAM, 1.0, 3.0),
        (BEAM, 5.0, 9.0), ("hnsw.api.add", 1.0, 3.0),
        ("hnsw.api.add", 6.0, 7.0), ("hnsw.api.add", 6.5, 7.5),
        ("hnsw.build.beam", 1.0, 2.0), ("hnsw.api.prepare", 3.5, 4.0),
        ("hnsw.api.labels", 4.0, 4.5), ("hnsw.api.labels", 4.2, 4.4)]
DEVICE = [("k", 0.0, 2.0), ("k", 2.5, 2.6), ("Memcpy HtoD", 2.7, 2.8),
          ("k", 8.0, 12.0), ("m", 8.9, 9.5)]


@pytest.mark.parametrize("metric, want", [
    # busy (0, 2), (2.5, 2.6), (2.7, 2.8) and (8, 10) of 10 s
    ("device_idle_pct.stream", 100 * (1 - 4.2 / 10)),
    ("ingest_pct.stream", 100 * 3.5 / 10),  # (1, 3) and (6, 7.5)
    # busy (1, 2), (2.5, 2.6), (2.7, 2.8) and (8, 9) of the spans' 2 + 4 s
    ("round_idle_pct.stream", 100 * (1 - 2.2 / 6)),
    ("classic_idle_pct.stream", 100 * (1 - 2.2 / 6)),
    # kernels starting in (1, 3) or (5, 9): at 2.5, 8.0 and 8.9, over 8 rows
    ("launches_per_row.stream", 3 / 8),
    ("api_host_pct.stream", 100 * 1.0 / 10),  # (3.5, 4.5)
])
def test_reader_on_a_synthetic_trace(metric, want):
    assert manifest.reader(metric)(_record(HOST, DEVICE)) == \
        pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("driver", ["query", "build"])
def test_reader_is_none_for_other_drivers(metric, driver):
    assert manifest.reader(metric)(_record(HOST, DEVICE, driver)) is None


@pytest.mark.parametrize("metric", [m for m in READERS
                                    if m != "device_idle_pct.stream"])
def test_reader_is_none_without_the_spans(metric):
    """A program without the spans it reads reads nothing: the build's and
    the classic engine's spans are new, the API's since PR 15."""
    host = [("aten::mm", 1.0, 2.0), ("hnsw.api.fetch", 3.0, 4.0)]
    if metric != "api_host_pct.stream":
        host.append(("hnsw.api.prepare", 3.0, 4.0))
    assert manifest.reader(metric)(_record(host, DEVICE)) is None


def test_launches_per_row_is_none_without_rows():
    assert manifest.reader("launches_per_row.stream")(
        _record(HOST, DEVICE, work=0)) is None


def test_manifest_holds_with_the_cell():
    bench = manifest.load()
    assert manifest.validate(bench) == []
    cell = manifest.cell(bench, CELL)
    assert cell["chips"] == 1
    e2e = {m["name"] for m in manifest.end_to_end(bench, CELL)}
    assert e2e == {"qps", "recall_at_10", "setup_s"}
    layer = {m["name"] for m in manifest.per_layer(bench, CELL)}
    assert layer == set(READERS)


def test_configuration_is_laion_streaming_with_a_bulk_snapshot():
    from ocaml_hnsw_tpu_torch.bench.__main__ import STREAMING
    from ocaml_hnsw_tpu_torch.models.build import BuildState
    from ocaml_hnsw_tpu_torch.models.bulk import bulk_workspace_bytes
    from ocaml_hnsw_tpu_torch.models.graph import capacity

    bench = manifest.load()
    entry = next(c for c in bench["configs"] if c["name"] == "laion1m")
    cfg = manifest.read_json(manifest.ROOT / entry["file"])
    # the deployment as the port's bench defines it, nothing reduced
    assert cfg["reduced"] == entry["reduced"] == []
    assert (cfg["n"], cfg["dim"], cfg["metric"], cfg["storage"], "f32",
            cfg["round_size"]) == STREAMING["laion-streaming"]
    assert (cfg["M"], cfg["ef_construction"]) == (16, 200)
    rows = cfg["stream"]["rows"]
    assert rows % cfg["round_size"] == 0 and rows <= 262_144
    warm = stream.snapshot_rows(cfg)
    assert warm == cfg["n"] - rows
    # the snapshot takes the bulk build at max_elements=warm
    n_cap = capacity(warm + cfg["round_size"] + 1)
    assert bulk_workspace_bytes(n_cap, cfg["dim"], m=cfg["M"],
                                m_max0=2 * cfg["M"]) \
        < BuildState.BULK_BUDGET_BYTES
    assert set(cfg["engines"]) == {"classic"}


def test_a_configuration_cut_below_its_stream_streams_its_second_half():
    assert stream.snapshot_rows({"n": 3000, "stream": {"rows": 239_616}}) \
        == 1500
    assert stream.snapshot_rows({"n": 3000, "stream": {"rows": 640}}) == 2360
