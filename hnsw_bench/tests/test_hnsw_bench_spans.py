"""The readers of the port's own spans (`spans.py`, `beam_idle_pct.packed`,
`api_host_pct.query`, `api_host_pct.build`) on hand-made traces with known
answers, and on the record of a traced run of each cell at a small size on
the CPU."""

import time

import pytest

from hnsw_bench import harness, manifest, spans, trace

BEAM = "hnsw.packed.beam"


def _record(driver, engine, host, device=(("k", 0.0, 0.0),)):
    t = trace.Trace(lo=0.0, hi=10.0, device=list(device),
                    host=sorted(host, key=lambda h: h[1]))
    return {"driver": driver, "engine": engine, "trace": t}


def _read(metric, record):
    return manifest.reader(metric)(record)


@pytest.mark.parametrize("device, idle", [
    # busy (1, 2), (2.5, 2.6) and (8, 9) of the beams' 2 + 4 s
    ([("k", 0.0, 2.0), ("k", 2.5, 2.6), ("k", 8.0, 12.0)], 100 * (1 - 2.1 / 6)),
    ([("k", 3.5, 4.5), ("k", 9.5, 10.0)], 100.0),  # none inside
    ([("k", 0.0, 10.0), ("m", 2.0, 6.0)], 0.0),  # all of it, overlaps once
])
def test_beam_idle_clips_device_time_to_the_beam(device, idle):
    host = [(BEAM, 1.0, 3.0), (BEAM, 5.0, 9.0),
            ("hnsw.packed.beam_iter", 1.0, 2.0), ("aten::add", 0.5, 9.5)]
    rec = _record("query", "packed", host, device)
    assert _read("beam_idle_pct.packed", rec) == pytest.approx(idle)


@pytest.mark.parametrize("driver, engine, host, device", [
    ("query", "packed", [("hnsw.packed.beam_iter", 1.0, 2.0)],
     [("k", 0.0, 1.0)]),  # no beam span: a program without the spans
    ("query", "packed", [(BEAM, 1.0, 2.0)], []),  # no device in the trace
    ("query", "flat", [(BEAM, 1.0, 2.0)], [("k", 0.0, 1.0)]),
    ("build", "packed", [(BEAM, 1.0, 2.0)], [("k", 0.0, 1.0)]),
])
def test_beam_idle_is_none_without_its_spans(driver, engine, host, device):
    assert _read("beam_idle_pct.packed",
                 _record(driver, engine, host, device)) is None


API = [("hnsw.api.prepare", 1.0, 2.0), ("hnsw.api.labels", 8.0, 8.5),
       ("hnsw.api.labels", 8.2, 8.4), ("hnsw.api.fetch", 2.0, 8.0),
       ("hnsw.api.prepare", 9.8, 10.4)]  # ends past the steps: clipped


@pytest.mark.parametrize("metric, driver, engine, pct", [
    ("api_host_pct.query", "query", "packed", 17.0),
    ("api_host_pct.query", "query", "flat", 17.0),
    ("api_host_pct.build", "build", "packed", 17.0),
    ("api_host_pct.query", "build", "packed", None),
    ("api_host_pct.build", "query", "packed", None),
])
def test_api_host_share_is_its_spans_over_the_steps(metric, driver, engine,
                                                    pct):
    got = _read(metric, _record(driver, engine, API))
    assert got == (None if pct is None else pytest.approx(pct))


@pytest.mark.parametrize("metric", ["api_host_pct.query",
                                    "api_host_pct.build"])
def test_api_host_share_is_none_without_its_spans(metric):
    host = [("hnsw.api.fetch", 1.0, 2.0), ("aten::mm", 1.0, 1.5)]
    for driver in ("query", "build"):
        assert _read(metric, _record(driver, "packed", host)) is None


def test_device_busy_counts_overlaps_once():
    rec = _record("query", "packed", [],
                  [("k", 0.0, 3.0), ("m", 1.0, 4.0), ("k", 6.0, 7.0)])
    assert spans.device_busy(rec, [(2.0, 6.5), (3.0, 5.0)]) == \
        pytest.approx(2.5)
    assert spans.of(_record("q", "p", API), "hnsw.api.labels") == [
        (8.0, 8.5), (8.2, 8.4)]


CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_span_metrics(tiny_cell, name):
    """On the CPU the trace holds no device, so `beam_idle_pct.packed` is
    left out; the API's share is read in every cell that lists it."""
    cfg, mix, limits, e2e, layer = tiny_cell(name)
    res = harness.run(cfg, mix, limits, e2e, layer, 2 ** 31 + 5, 0.5, True,
                      "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    listed = {m["name"] for m in layer if m["name"].startswith("api_host")}
    assert listed and listed <= set(res["metrics"])
    for m in listed:
        assert 0 < res["metrics"][m]["value"] < 100
    assert "beam_idle_pct.packed" not in res["metrics"]
