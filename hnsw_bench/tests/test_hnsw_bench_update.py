"""The `msturing2m.update` cell's own files: the update driver at a small size
on the CPU, the judge on its products, its five readers on hand-made traces,
and its entries in `BENCHMARK.json`."""

import copy
import time

import numpy as np
import pytest

from hnsw_bench import data, harness, judge, manifest, reference, trace
from hnsw_bench.drivers import update

CELL = "msturing2m.update"
READERS = ("delete_pct.update", "ingest_pct.update",
           "classic_idle_pct.update", "device_idle_pct.update",
           "api_host_pct.update")
TINY = {"n": 3000, "dim": 16, "n_queries": 300, "round_size": 128}
STREAM = 640
REQUEST = 64
SEED = 2 ** 31 + 41


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
    cfg["stream"]["rows"] = STREAM
    cfg["generator"]["n_clusters"] = 8
    mix = manifest.read_json(manifest.traffic_file(cell["traffic"]))
    mix.update(request=REQUEST, trace={"wait": 1, "warmup": 1, "active": 1})
    return cfg, mix


def _run(cfg, mix, seed=SEED):
    import torch

    rows, pool = data.make(cfg, seed, "cpu")
    return harness.Run(cfg=cfg, mix=mix, seed=seed,
                       device=torch.device("cpu"), rows=rows, pool=pool)


def _deleted_labels(index) -> set:
    labels = np.asarray(index.get_ids_list())
    return set(labels[index.graph.deleted[:labels.shape[0]].numpy()].tolist())


def test_old_versions_are_the_rows_jittered_from_the_seed(tiny):
    cfg, mix = tiny
    run = _run(cfg, mix)
    first = cfg["n"] - STREAM
    old = update.old_versions(run, first)
    assert old.shape == (STREAM, cfg["dim"]) and old.dtype == np.float32
    np.testing.assert_array_equal(old, update.old_versions(run, first))
    noise = (old - run.rows[first:]) / cfg["stream"]["jitter"]
    assert abs(noise.std() - 1.0) < 0.05 and abs(noise.mean()) < 0.05
    other = _run(cfg, mix, SEED + 1)
    assert not np.array_equal(update.old_versions(other, first) - other.rows[
        first:], old - run.rows[first:])


def test_steps_update_the_stream_then_only_query(tiny):
    cfg, mix = tiny
    run = _run(cfg, mix)
    n, rs = cfg["n"], cfg["round_size"]
    first = n - STREAM
    assert update.snapshot_rows(cfg) == first
    st = update.setup(run)
    index = st.index
    # the snapshot and the old versions, then the set-up step's update
    assert index.get_current_count() == n + rs
    assert index.get_max_elements() == n + STREAM
    assert st.cursor == first + rs
    assert _deleted_labels(index) == set(range(n, n + rs))
    assert (st.update_queries, st.t_start, st.t_last) == (0, None, None)
    left = STREAM - rs
    updating = -(-left // rs)
    want = [min(rs, left - i * rs) for i in range(updating)] + [0, 0]
    done = []
    for _ in want:
        done.append(update.step(st, run))
        # each step inserts the new versions, then tombstones the old ones
        assert index.get_current_count() == n + (st.cursor - first)
        assert _deleted_labels(index) == set(range(n, n + st.cursor - first))
    assert done == want
    assert st.sent == len(want) + 1
    assert st.update_queries == updating * REQUEST
    t_last = st.t_last
    qps = update.window_metrics(st, run, 123.0)["qps"]
    assert qps == pytest.approx(updating * REQUEST / (t_last - st.t_start))


def test_products_hold_every_row_and_the_tombstones(tiny):
    cfg, mix = tiny
    run = _run(cfg, mix)
    n = cfg["n"]
    st = update.setup(run)
    index = st.index
    assert update.window_metrics(st, run, 1.0) == {}
    out = update.products(st, run)
    assert st.index is None
    assert index.get_current_count() == n + STREAM
    assert sorted(index.get_ids_list()) == list(range(n + STREAM))
    assert _deleted_labels(index) == set(range(n, n + STREAM))
    pool_idx, labels, dists = out["answers"]
    np.testing.assert_array_equal(pool_idx, np.arange(cfg["n_queries"]))
    assert labels.shape == dists.shape == (cfg["n_queries"], cfg["k"])
    assert (labels >= 0).all() and (labels < n).all()
    # the live lists: label-indexed, in the items' labels, every row linked
    adj0 = out["adj0"]
    assert adj0.shape == (n, 2 * cfg["M"])
    assert adj0.min() >= -1 and adj0.max() < n
    assert (adj0 >= 0).any(axis=1).all()
    ids = np.asarray(index.get_ids_list())
    item = np.where(ids < n, ids, ids - n + (n - STREAM))
    dead = index.graph.deleted[:ids.shape[0]].numpy()
    raw = index.graph.adj0.numpy()
    mapped_old = 0
    for lab in range(0, n, 7):
        row = raw[int(np.nonzero(ids == lab)[0][0])]
        live = [item[x] for x in row if x >= 0 and not dead[x]]
        old = [item[x] for x in row if x >= 0 and dead[x]]
        want = live + [i for i in old if i != lab and i not in live]
        mapped_old += len(want) - len(live)
        assert sorted(adj0[lab][adj0[lab] >= 0].tolist()) == sorted(want)
    assert mapped_old > 0  # edges to old versions stand for their items


def _judged(run, answers):
    ref = reference.rows(run.rows, run.cfg["metric"], "cpu")
    q, true_ids, _, scale = judge.truth(ref, run.pool, run.k)
    return judge.judge_answers(ref, q, true_ids, scale, *answers)


def test_judge_fails_an_answer_that_carries_a_deleted_label(tiny):
    cfg, mix = tiny
    run = _run(cfg, mix)
    st = update.setup(run)
    pool_idx, labels, dists = update.products(st, run)["answers"]
    limits = manifest.read_json(manifest.limits_file(CELL))
    good = _judged(run, (pool_idx, labels, dists))
    assert good["recall_at_10"] >= limits["recall_at_10"]["min"]
    assert good["dist_gap"] <= limits["dist_gap"]["max"]
    # the old version of row n - 1 stands in for its new version
    hit = np.argwhere(labels == cfg["n"] - 1)[0]
    bad = labels.copy()
    bad[tuple(hit)] = cfg["n"] + STREAM - 1
    numbers = _judged(run, (pool_idx, bad, dists))
    assert numbers["dist_gap"] == float("inf")
    answer_limits = {k: limits[k] for k in numbers}
    assert all(c["ok"] for c in judge.checks(good, answer_limits))
    assert not all(c["ok"] for c in judge.checks(numbers, answer_limits))


def test_traced_run_reads_the_update_shares(tiny):
    """On the CPU the trace holds no device: the device-time readers are
    left out and the span shares are read; the traced steps update."""
    cfg, mix = tiny
    cfg["round_size"] = 64
    bench = manifest.load()
    limits = manifest.read_json(manifest.limits_file(CELL))
    res = harness.run(cfg, mix, limits, manifest.end_to_end(bench, CELL),
                      manifest.per_layer(bench, CELL), SEED + 2, 0.0, True,
                      "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    spans_read = {"delete_pct.update", "ingest_pct.update",
                  "api_host_pct.update"}
    assert set(res["metrics"]) == spans_read
    for m in spans_read:
        assert 0 < res["metrics"][m]["value"] < 100


def _record(host, device, driver="update", work=8):
    t = trace.Trace(lo=0.0, hi=10.0, device=list(device),
                    host=sorted(host, key=lambda h: h[1]))
    return {"driver": driver, "engine": "classic", "trace": t, "work": work}


BEAM = "hnsw.classic.beam"
HOST = [(BEAM, 1.0, 3.0), (BEAM, 5.0, 9.0), ("hnsw.api.add", 1.0, 3.0),
        ("hnsw.api.add", 6.0, 7.0), ("hnsw.api.add", 6.5, 7.5),
        ("hnsw.api.delete", 3.0, 3.25), ("hnsw.api.delete", 3.1, 3.5),
        ("hnsw.build.beam", 1.0, 2.0), ("hnsw.api.prepare", 3.5, 4.0),
        ("hnsw.api.labels", 4.0, 4.5), ("hnsw.api.labels", 4.2, 4.4)]
DEVICE = [("k", 0.0, 2.0), ("k", 2.5, 2.6), ("Memcpy HtoD", 2.7, 2.8),
          ("k", 8.0, 12.0), ("m", 8.9, 9.5)]


@pytest.mark.parametrize("metric, want", [
    ("delete_pct.update", 100 * 0.5 / 10),  # (3, 3.5)
    ("ingest_pct.update", 100 * 3.5 / 10),  # (1, 3) and (6, 7.5)
    # busy (1, 2), (2.5, 2.6), (2.7, 2.8) and (8, 9) of the beams' 2 + 4 s
    ("classic_idle_pct.update", 100 * (1 - 2.2 / 6)),
    # busy (0, 2), (2.5, 2.6), (2.7, 2.8) and (8, 10) of 10 s
    ("device_idle_pct.update", 100 * (1 - 4.2 / 10)),
    ("api_host_pct.update", 100 * 1.0 / 10),  # (3.5, 4.5)
])
def test_reader_on_a_synthetic_trace(metric, want):
    assert manifest.reader(metric)(_record(HOST, DEVICE)) == \
        pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("driver", ["query", "build", "stream"])
def test_reader_is_none_for_other_drivers(metric, driver):
    assert manifest.reader(metric)(_record(HOST, DEVICE, driver)) is None


@pytest.mark.parametrize("metric", [m for m in READERS
                                    if m != "device_idle_pct.update"])
def test_reader_is_none_without_the_spans(metric):
    """A program without the spans it reads reads nothing: a program that
    writes each tombstone at its call opens no `hnsw.api.delete`."""
    host = [("aten::mm", 1.0, 2.0), ("hnsw.api.fetch", 3.0, 4.0)]
    assert manifest.reader(metric)(_record(host, DEVICE)) is None


def test_manifest_holds_with_the_cell():
    bench = manifest.load()
    assert manifest.validate(bench) == []
    cell = manifest.cell(bench, CELL)
    assert cell["chips"] == 1
    e2e = {m["name"] for m in manifest.end_to_end(bench, CELL)}
    assert e2e == {"qps", "recall_at_10", "setup_s"}
    layer = {m["name"] for m in manifest.per_layer(bench, CELL)}
    assert layer == set(READERS)


def test_configuration_is_the_update_deployment():
    from ocaml_hnsw_tpu_torch.models.build import BuildState
    from ocaml_hnsw_tpu_torch.models.bulk import bulk_workspace_bytes
    from ocaml_hnsw_tpu_torch.models.graph import capacity

    bench = manifest.load()
    entry = next(c for c in bench["configs"] if c["name"] == "msturing2m")
    cfg = manifest.read_json(manifest.ROOT / entry["file"])
    assert cfg["reduced"] == entry["reduced"] == ["n"]
    assert (cfg["n"], cfg["dim"], cfg["metric"], cfg["storage"],
            cfg["round_size"]) == (2_000_000, 100, "l2", "f32", 2048)
    assert (cfg["M"], cfg["ef_construction"]) == (16, 200)
    rows = cfg["stream"]["rows"]
    assert rows % cfg["round_size"] == 0 and 2 * rows <= cfg["n"]
    assert update.snapshot_rows(cfg) == cfg["n"] - rows
    # the snapshot (n rows with the old versions) takes the bulk build
    n_cap = capacity(cfg["n"] + cfg["round_size"] + 1)
    assert bulk_workspace_bytes(n_cap, cfg["dim"], m=cfg["M"],
                                m_max0=2 * cfg["M"]) \
        < BuildState.BULK_BUDGET_BYTES
    assert set(cfg["engines"]) == {"classic"}
