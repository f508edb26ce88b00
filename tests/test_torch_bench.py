"""The benchmark harness of the torch port (`bench/harness.py`,
`bench/datasets.py`, `bench/__main__.py`) on the CPU.

The two cases of tests/test_bench.py run through the port's `run_config`
with the same assertions; both result dicts carry the JAX harness's keys
(literal lists below, from `ocaml_hnsw_tpu/bench/harness.py`: the JAX
harness is not run a second time for this); the ground truth is held to the
NumPy brute force, exactly.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.models.build import (
    _normalize_rows_donated as jax_normalize_rows,
)
from ocaml_hnsw_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn, recall

from ocaml_hnsw_tpu_torch.bench import __main__ as cli
from ocaml_hnsw_tpu_torch.bench import (
    datasets, harness, k1_timeline, k3_timeline, kernel_race,
)
from ocaml_hnsw_tpu_torch.models.flat import flat_search

# One torch thread: under pytest-xdist every worker's default pool (one
# thread per core) spins against the other workers and XLA.
torch.set_num_threads(1)

RUN_KEYS = ["config", "n", "dim", "metric", "target_recall", "engine",
            "recall", "qps", "engines", "backend", "device"]
HNSW_KEYS = ["build_seconds", "pack_seconds", "build_vectors_per_second",
             "sweep", "best"]
FLAT_KEYS = ["build_seconds", "build_vectors_per_second", "sweep", "best"]
STREAM_KEYS = ["config", "n", "dim", "metric", "streaming", "target_recall",
               "met_target", "warm_build_vps", "ingest_vps",
               "sustained_qps_during_ingest", "recall", "ef", "max_iters",
               "sweep", "backend"]
CLI_KEYS = ["metric", "value", "unit", "engine", "recall", "hnsw_qps",
            "hnsw_recall", "hnsw_build_vectors_per_second", "backend"]
CLI_STREAM_KEYS = ["metric", "value", "unit", "ingest_vps", "recall",
                   "backend"]

TINY = dict(n=2048, dim=16, metric="l2", n_queries=64, M=8,
            ef_construction=40, round_size=256, ef_sweep=(16, 48),
            rerank_sweep=(32,), qps_batch=64, verbose=False, device="cpu")


@pytest.fixture(scope="module")
def tiny_result():
    return harness.run_config("tiny", **TINY)


def test_run_config_tiny(tiny_result):
    r = tiny_result
    assert r["qps"] > 0
    assert 0 <= r["recall"] <= 1
    assert r["engine"] in ("hnsw", "flat")
    assert set(r["engines"]) == {"hnsw", "flat"}
    h = r["engines"]["hnsw"]
    assert h["build_vectors_per_second"] > 0
    assert h["sweep"][0]["ef"] == 16
    f = r["engines"]["flat"]
    assert f["best"]["recall"] >= 0.9


def test_run_config_keys(tiny_result):
    r = tiny_result
    assert list(r) == RUN_KEYS
    assert list(r["engines"]["hnsw"]) == HNSW_KEYS
    assert list(r["engines"]["flat"]) == FLAT_KEYS
    assert list(r["engines"]["hnsw"]["sweep"][0]) == [
        "engine", "ef", "max_iters", "recall", "qps"]
    assert list(r["engines"]["flat"]["sweep"][0]) == [
        "rerank_k", "recall", "qps"]
    assert r["backend"] == "cpu" and r["device"] == "cpu"
    assert r["engines"]["hnsw"]["best"]["recall"] >= 0.95  # stops at ef=16
    assert len(r["engines"]["hnsw"]["sweep"]) == 1
    json.dumps(r)


def test_flat_only_int8():
    r = harness.run_config(
        "tiny8", n=4096, dim=32, metric="l2", n_queries=64,
        engines=("flat",), scan_dtype="int8", rerank_dtype="bf16",
        rerank_sweep=(32,), qps_batch=64, verbose=False, device="cpu")
    assert r["engine"] == "flat"
    assert r["recall"] >= 0.9
    assert list(r["engines"]) == ["flat"]


def test_run_streaming_config_tiny():
    r = harness.run_streaming_config(
        "stream", n=1200, dim=16, metric="cosine", n_queries=32, M=8,
        ef_construction=32, round_size=64, settings=((8, 1), (48, 16)),
        n_steps=3, qps_batch=32, verbose=False, device="cpu")
    assert list(r) == STREAM_KEYS
    assert list(r["sweep"][0]) == ["ef", "max_iters", "recall",
                                   "sustained_qps_during_ingest"]
    assert r["streaming"] is True and r["backend"] == "cpu"
    assert r["warm_build_vps"] > 0 and r["ingest_vps"] > 0
    # one iteration cannot reach the target; the second setting does, and
    # the headline is the first that does
    assert r["sweep"][0]["recall"] < 0.95 <= r["sweep"][1]["recall"]
    assert r["met_target"] and (r["ef"], r["max_iters"]) == (48, 16)
    assert r["sustained_qps_during_ingest"] > 0
    json.dumps(r)


def test_streaming_int8_rows_from_bf16_source_match_jax(monkeypatch):
    """laion5m-streaming's memory plan (int8 rows in the graph, a bf16
    source; chip_smoke.py phase B8) at a tiny size, round_size cut with n
    (1024 would cost 12 s more here and store the same rows): the
    rows and scales the graph stores equal what the JAX package stores from
    the same bf16 source rows, its in-place normalization (which keeps
    bf16) then `ops/quantize.py::quantize_rows`; the result carries the
    JAX harness's keys."""
    states, sources = [], []
    real_state, real_data = harness.BuildState, datasets.clustered_device

    def keep_state(*args, **kwargs):
        states.append(real_state(*args, **kwargs))
        return states[-1]

    def keep_data(*args, **kwargs):
        out = real_data(*args, **kwargs)
        sources.append(out[0])
        return out

    monkeypatch.setattr(harness, "BuildState", keep_state)
    monkeypatch.setattr(datasets, "clustered_device", keep_data)
    r = harness.run_streaming_config(
        "stream8", n=800, dim=16, metric="cosine", n_queries=32, M=8,
        ef_construction=32, round_size=256, settings=((48, 16),),
        n_steps=2, qps_batch=32, storage="int8", data_dtype="bf16",
        verbose=False, device="cpu")
    assert list(r) == STREAM_KEYS and r["backend"] == "cpu"
    (src,), (state,) = sources, states
    assert src.dtype == torch.bfloat16 and src.shape == (800, 16)
    unit = jax_normalize_rows(jnp.asarray(src.float().numpy()).astype(
        jnp.bfloat16))
    rows, scales, _ = jax_quantize_rows(unit.astype(jnp.float32), "int8")
    g = state.graph
    assert g.vectors.dtype == torch.int8
    np.testing.assert_array_equal(g.vectors[:800].numpy(), np.asarray(rows))
    np.testing.assert_array_equal(g.scales[:800].numpy(), np.asarray(scales))
    assert r["sweep"][0]["recall"] >= 0.9
    json.dumps(r)


def test_count_sass_ops():
    """kernel_race.py's count of int->float conversions in `cuobjdump
    -sass` text: per kernel, by opcode, predicated or not, modifiers
    aside; other opcodes and the header lines not counted."""
    sass = """
    code for sm_90a
        Function : _ZN12_GLOBAL__N_117gather_vec_kernelIaLb1ELb1ELi1EEEvv
    .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   I2F.S8 R5, R4 ;          /* 0x0 */
        /*0020*/              @!P0 I2F.S16 R6, R4 ;         /* 0x0 */
        /*0030*/                   I2FP.F32.S32 R7, R4 ;    /* 0x0 */
        Function : _Z3foov
        /*0000*/                   PRMT R2, R3, 0x7440, R4 ; /* 0x0 */
        /*0010*/                   FADD R1, R2, -8388736 ;  /* 0x0 */
"""
    assert kernel_race.count_sass_ops(sass) == {
        "_ZN12_GLOBAL__N_117gather_vec_kernelIaLb1ELb1ELi1EEEvv":
            {"I2F": 2, "I2FP": 1},
        "_Z3foov": {"I2F": 0, "I2FP": 0}}


def test_k1_timeline_stamps_fit_the_kernel():
    """k1_timeline.py's stamp patch applies to the shipped K1 source: every
    stamp once, at a line of the kernel it names; a hunk that no longer fits
    raises."""
    src = (k1_timeline.HERE.parent / "csrc" / "payload_score.cu").read_text()
    patch = (k1_timeline.HERE / "k1_stamps.patch").read_text()
    out = k1_timeline.apply_patch(src, patch)
    stamps = [line.strip() for line in out.splitlines() if "K1_STAMP(" in line]
    assert stamps == ["K1_STAMP(0);", "K1_STAMP(1);",
                      "if (i < 6) K1_STAMP(2 + 2 * i);",
                      "if (i < 6) K1_STAMP(3 + 2 * i);",
                      "if (i == count - 1) K1_STAMP(14);", "K1_STAMP(15);"]
    assert "".join(line for line in out.splitlines(keepends=True)
                   if "K1_STAMP(" not in line) == src
    with pytest.raises(ValueError, match="does not fit"):
        k1_timeline.apply_patch(src.replace("mbar_wait(&ring", "wait(&r"),
                                patch)


def test_k3_timeline_stamps_fit_the_kernel():
    """k3_timeline.py's counters go into the shipped wgmma kernel's source,
    each edit where it names, the source otherwise untouched; an edit that
    no longer fits raises."""
    src = (k3_timeline.HERE.parent / "csrc" / "scan_topk_wgmma.cu"
           ).read_text()
    out = k3_timeline.stamped(src)
    assert out.count("clock64()") == 18 and "ohnsw_k3_timeline" in out
    for _, new in k3_timeline.STAMPS:
        assert new in out  # every edit in, none undone by a later one
    with pytest.raises(ValueError, match="does not fit"):
        k3_timeline.stamped(src.replace("epilogue(acc, bias, rsc, t);",
                                        "epilogue(acc, bias, rsc);"))


def test_k3_timeline_summarize():
    """Two blocks on two SMs: the offsets (µs), warp 0's cycles by part
    (millions, `other` the loop's cycles outside the named parts) and the
    counts the report reads from their rows, with the share of tiles in
    which warp 0 flushed."""
    import numpy as np

    f = k3_timeline.FIELDS
    rows = np.zeros((2, k3_timeline.SLOTS), np.int64)
    for b, (t0, sm) in enumerate(((1_000, 3), (3_000, 9))):
        rows[b, [f["start"], f["smid"]]] = (t0, sm)
        rows[b, f["producer_end"]] = t0 + 40_000
        rows[b, f["wg0_end"]] = rows[b, f["wg1_end"]] = t0 + 50_000
        rows[b, [f["full_wait"], f["wgmma_wait"], f["release"],
                 f["epilogue"], f["loop"]]] = (1e6, 2e6, 3e6, 4e6, 12e6)
        rows[b, [f["tiles"], f["slow_entries"], f["merges"]]] = (70, 30, 5)
        rows[b, [f["flush"], f["flushes"], f["flush_tiles"]]] = (
            5e5, 8 + b, 7)
    s = k3_timeline.summarize(rows)
    assert s["start_us"] == [0.0, 1.0, 2.0] and s["sms"] == 2
    assert s["wg0_end_us"] == [50.0, 51.0, 52.0]
    assert s["other_Mcycles"] == [2.0, 2.0, 2.0]
    assert (s["tiles"], s["merges"]) == ([70.0] * 3, [5.0] * 3)
    assert s["flush_Mcycles"] == [0.5] * 3
    assert s["flushes"] == [8.0, 8.5, 9.0] and s["flush_tiles"] == [7.0] * 3
    assert s["flush_tile_share"] == [0.1] * 3


def test_k1_timeline_summarize():
    """Two warps on two SMs, two items each: the start, id, landing,
    scoring and exit offsets the report reads from their stamps."""
    buf = torch.zeros((3, k1_timeline.SLOTS, 2), dtype=torch.int64)
    for w, (t0, sm) in enumerate(((1000, 5), (1100, 7))):
        buf[w, 0] = torch.tensor([t0, sm])
        for k, dt in ((1, 50), (2, 400), (3, 500), (4, 700), (5, 760),
                      (14, 760), (15, 800)):
            buf[w, k, 0] = t0 + dt
    s = k1_timeline.summarize(buf, 4)  # row 2: a warp that never ran
    assert (s["warps"], s["sms"], s["items_per_warp"]) == (2, 2, 2.0)
    assert s["span_ns"] == 900 and s["ids_ns"]["p50"] == 50
    assert s["first_landed_ns"]["max"] == 350
    assert s["later_wait_ns"]["p50"] == 200  # item 1 landed 200 after 0
    assert s["score_ns"]["n"] == 4 and s["score_ns"]["max"] == 100
    assert s["last_item_to_exit_ns"]["p50"] == 40
    assert s["exit_at_ns"]["max"] == 900


def test_entry_points_default_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.run_config("x", n=64, dim=4, metric="l2")
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.run_streaming_config("x", n=64, dim=4, metric="l2")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", "random10k", "--quiet"])


@pytest.mark.parametrize("metric", ["l2", "cosine", "l1"])
def test_ground_truth_equals_bruteforce(metric):
    if metric == "l1":
        from ocaml_hnsw_tpu.ops import metrics as jm
        from ocaml_hnsw_tpu_torch.ops import metrics as tm

        for reg in (jm, tm):
            if not reg.is_metric("l1"):
                reg.register_metric(
                    "l1", lambda rows, q: abs(rows - q[..., None, :]).sum(-1))
    data = clustered(3000, 16, n_clusters=8, seed=3)
    q = queries_like(data, 70, seed=4)
    want, _ = bruteforce_knn(data, q, 10, metric=metric)
    # 70 queries in chunks of 32 against slabs of 1024 rows, from raw rows
    got = harness.device_ground_truth(torch.from_numpy(data), q, 10, metric,
                                      chunk=32, n_slab=1024)
    assert got.dtype == np.int32 and got.shape == (70, 10)
    assert recall(got, want) == 1.0  # order may differ at f32 ties only
    # from FlatTensors with lossy scan rows (the rerank rows are exact),
    # tombstones honoured, empty slots never returned
    flat = harness.build_flat(data, metric, scan_dtype="bf16", device="cpu")
    dead = np.unique(want[:, 0])
    flat.deleted[torch.from_numpy(dead)] = True
    keep = np.setdiff1d(np.arange(3000), dead)
    want2, _ = bruteforce_knn(data[keep], q, 10, metric=metric)
    got2 = harness.device_ground_truth(flat, q, 10, metric, n_slab=2048)
    assert recall(got2, keep[want2]) == 1.0
    assert not np.isin(got2, dead).any() and got2.max() < 3000


def test_build_flat_and_measure_qps():
    data = clustered(5000, 16, n_clusters=8, seed=5)
    flat = harness.build_flat(torch.from_numpy(data), "cosine",
                              scan_dtype="int8", rerank_dtype="bf16",
                              device="cpu")
    assert int(flat.n) == 5000 and flat.n_cap == 8192
    assert flat.scan.dtype == torch.int8 and flat.rerank.dtype == torch.bfloat16
    np.testing.assert_allclose(flat.norms[:5000].numpy(), 1.0, rtol=1e-5)
    calls = []

    def search(q):
        calls.append(tuple(q.shape))
        return flat_search(flat, q, 10, "cosine")[0]

    q = torch.from_numpy(queries_like(data, 24, seed=6))
    assert harness.measure_qps(search, q, batch=64, warmup=1, reps=3) > 0
    assert calls == [(64, 16)] * 4  # queries tiled to whole batches
    assert harness.recall_of([[1, 2], [3, 4]], [[2, 9], [3, 4]]) == 0.75


def test_clustered_device():
    data, make_q = datasets.clustered_device(1000, 8, n_clusters=4, seed=3,
                                             device="cpu")
    assert data.shape == (1000, 8) and data.dtype == torch.float32
    again, make_q2 = datasets.clustered_device(1000, 8, n_clusters=4, seed=3,
                                               device="cpu")
    assert torch.equal(data, again)
    other, _ = datasets.clustered_device(1000, 8, n_clusters=4, seed=4,
                                         device="cpu")
    assert not torch.equal(data, other)
    q = make_q(16, qseed=9)
    assert q.shape == (16, 8) and q.dtype == torch.float32
    assert torch.equal(q, make_q2(16, qseed=9))
    assert not torch.equal(q, make_q(16, qseed=10))
    # the mixture: every row within a few spreads of one of 4 centres, and
    # every query within a few jitters of a row
    near = torch.cdist(q, data).min(dim=1).values
    assert float(near.max()) < 0.1 * 8
    spread = torch.pdist(data[:200])
    assert float((spread < 0.15 * 8).float().mean()) > 0.15


def test_clustered_device_slab_path(monkeypatch):
    monkeypatch.setattr(datasets, "DEVICE_SLAB", 256)
    data, make_q = datasets.clustered_device(
        1000, 8, n_clusters=4, seed=3, dtype=torch.bfloat16, device="cpu")
    assert data.shape == (1000, 8) and data.dtype == torch.bfloat16
    again, _ = datasets.clustered_device(
        1000, 8, n_clusters=4, seed=3, dtype=torch.bfloat16, device="cpu")
    assert torch.equal(data, again)
    assert make_q(5).dtype == torch.float32
    assert float(data.float().abs().max()) > 0  # every slab written
    assert float(data[768:].float().abs().sum()) > 0


def test_numpy_generators_equal_jax_package():
    from ocaml_hnsw_tpu.bench import datasets as jd

    np.testing.assert_array_equal(datasets.random_uniform(50, 4, seed=2),
                                  jd.random_uniform(50, 4, seed=2))
    for name in ("sift_shaped", "glove_shaped", "deep_shaped",
                 "laion_shaped"):
        a, aq = getattr(datasets, name)(n=300, n_queries=7)
        b, bq = getattr(jd, name)(n=300, n_queries=7)
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(aq, bq, err_msg=name)


@pytest.mark.parametrize("config", ["tiny", "tiny-streaming"])
def test_cli_prints_one_json_line(monkeypatch, capsys, config):
    """The CLI in process, on test-only tiny configs (random10k, the
    smallest real one, builds 10k x 128 rows: too long for this lane)."""
    monkeypatch.setitem(cli.CONFIGS, "tiny", (
        1000, 16, "l2", 128, 32, ("hnsw", "flat"), "f32", "bf16", "f32"))
    monkeypatch.setitem(cli.STREAMING, "tiny-streaming", (
        240, 8, "cosine", "f32", "f32", 32))
    assert cli.main(["--config", config, "--queries", "8", "--qps-batch",
                     "8", "--device", "cpu", "--quiet"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    if config == "tiny":
        assert list(line) == CLI_KEYS
        assert line["engine"] in ("hnsw", "flat") and line["hnsw_qps"] > 0
    else:
        assert list(line) == CLI_STREAM_KEYS
    assert line["unit"] == "qps" and line["backend"] == "cpu"
    assert line["value"] > 0 and "vs_baseline" not in line


def test_cli_tables_match_bench_py():
    """CONFIGS and STREAMING are bench.py's tables (read as text: importing
    bench.py would import the JAX harness)."""
    import ast
    import pathlib

    src = (pathlib.Path(__file__).parent.parent / "bench.py").read_text()
    tree = ast.parse(src)
    tables = {t.targets[0].id: ast.literal_eval(t.value)
              for t in tree.body if isinstance(t, ast.Assign)
              and t.targets[0].id in ("CONFIGS", "STREAMING")}
    assert tables["CONFIGS"] == cli.CONFIGS
    assert tables["STREAMING"] == cli.STREAMING
