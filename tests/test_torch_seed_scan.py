"""The seed scan (`models/search.py::seed_entries`) through K3's
`scan_topk`, on the CPU (its plain version), on small port-built graphs.

  * The entry ids equal the exact top-E of a direct NumPy scan: the same
    rank-equivalent score (l2: ‖x‖² − 2·q·x, ip and cosine: −q·x) from
    bf16-rounded operands, summed in f64, ranked without rounding the
    scores.  The inputs are checked to hold no near-ties first.
  * No padding row of `build_seed_index` and no dead slot of
    `seed_index_from_bank` is ever returned, even where it scores best; a
    bank with fewer live rows than E gives -1 at +inf past them.
  * The entry distances are `dists_to_ids` on the returned ids, bit for bit.
  * `seed_entries.plain_scans` counts each scan on the CPU, also where a
    pass-through wraps `scan_topk`.
  * A registered metric with a `matmul_score` takes the plain route; one
    without raises as before.
"""

import numpy as np
import pytest
import torch

from ocaml_hnsw_tpu_torch.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu_torch.config import HnswConfig
from ocaml_hnsw_tpu_torch.models import search
from ocaml_hnsw_tpu_torch.models.build import BuildState
from ocaml_hnsw_tpu_torch.ops import metrics
from ocaml_hnsw_tpu_torch.ops.distance import dists_to_ids, query_norms
from ocaml_hnsw_tpu_torch.ops.kernels.scan_topk import scan_topk

torch.set_num_threads(1)

N, DIM, E = 500, 16, 8
METRICS = ("l2", "ip", "cosine")


@pytest.fixture(scope="module")
def graphs():
    data = clustered(N, DIM, n_clusters=8, seed=11)
    out = {}
    for metric in METRICS:
        st = BuildState(HnswConfig(dim=DIM, M=8, ef_construction=32,
                                   metric=metric), N, round_size=128,
                        device="cpu")
        st.add(data)
        out[metric] = st.graph
    return data, out


def _prep(data, metric, n=64, seed=12):
    q = search.preprocess_queries(torch.from_numpy(
        queries_like(data, n, seed=seed)), metric)
    return q, query_norms(q, metric)


def _bf16(t):
    return t.to(torch.bfloat16).double().numpy()


def numpy_scores(graph, upper, q, metric):
    """The rank-equivalent scores of q against the rows `upper`, from
    bf16-rounded operands summed in f64, and the magnitude of the sum each
    adds up (Σ|terms|): two f64[B, len(upper)]."""
    rows = graph.vectors[torch.from_numpy(upper).long()].float()
    qb, rb = _bf16(q), _bf16(rows)
    dot, mag = qb @ rb.T, 2.0 * (np.abs(qb) @ np.abs(rb).T)
    if metric != "l2":
        return -dot, mag
    norms = (rows.double().numpy() ** 2).sum(1)[None, :]
    return norms - 2.0 * dot, mag + norms


@pytest.mark.parametrize("metric", METRICS)
def test_ids_equal_exact_f32_ranking(graphs, metric):
    data, gs = graphs
    g = gs[metric]
    seeds = search.build_seed_index(g, metric)
    q, qn = _prep(data, metric)
    upper = np.nonzero(g.levels.numpy() >= 1)[0]
    assert E < upper.size < seeds.ids.shape[0]  # padding present
    s, mag = numpy_scores(g, upper, q, metric)
    order = np.argsort(s, axis=1, kind="stable")[:, :E + 1]
    top = np.take_along_axis(s, order, 1)
    # no near-ties: an f32 sum of DIM terms lies within DIM·2⁻²⁴·Σ|terms|
    # of the f64 one; each gap is over twice what two such errors make
    err = DIM * 2.0 ** -24 * np.take_along_axis(mag, order, 1).max(1)
    assert (np.diff(top, axis=1) > 4 * err[:, None]).all()
    ids, _ = search.seed_entries(g, seeds, q, qn, E, metric)
    np.testing.assert_array_equal(ids.numpy(), upper[order[:, :E]])


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_padding_rows_never_returned(graphs, metric):
    """The padding repeats the first upper node: queries at that node score
    every padding row as well as the node itself, so a padding row would
    come back as a repeat of its id."""
    data, gs = graphs
    g = gs[metric]
    seeds = search.build_seed_index(g, metric)
    first = int(seeds.ids[0])
    assert bool(seeds.dead[int(seeds.n):].all())
    assert not bool(seeds.dead[:int(seeds.n)].any())
    q = search.preprocess_queries(g.vectors[[first] * 4].float(), metric)
    ids, d = search.seed_entries(g, seeds, q, query_norms(q, metric), E,
                                 metric)
    for row in ids.numpy():
        assert row[0] == first and np.unique(row).size == E, row
    assert torch.isfinite(d).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bank_dead_slots_never_returned(graphs, metric):
    """A bank of 128 slots with 3 live rows; its dead slots hold -1, which
    reads node 0's vector, and the queries are node 0's own row: E - 3
    entries come back -1 at +inf."""
    data, gs = graphs
    g = gs[metric]
    live = np.nonzero(g.levels.numpy() >= 1)[0][1:4].astype(np.int32)
    assert 0 not in live
    bank = torch.full((128,), -1, dtype=torch.int32)
    bank[:3] = torch.from_numpy(live)
    seeds = search.seed_index_from_bank(g, bank, 3, metric)
    assert int(seeds.n) == 3 and bool(seeds.dead[3:].all())
    q = search.preprocess_queries(g.vectors[[0] * 4].float(), metric)
    ids, d = search.seed_entries(g, seeds, q, query_norms(q, metric), E,
                                 metric)
    for row, drow in zip(ids.numpy(), d.numpy()):
        assert sorted(row[:3].tolist()) == sorted(live.tolist()), row
        assert (row[3:] == -1).all() and np.isinf(drow[3:]).all()
        assert np.isfinite(drow[:3]).all()


@pytest.mark.parametrize("metric", METRICS)
def test_entry_distances_are_dists_to_ids(graphs, metric):
    data, gs = graphs
    g = gs[metric]
    q, qn = _prep(data, metric, seed=13)
    ids, d = search.seed_entries(g, search.build_seed_index(g, metric), q,
                                 qn, E, metric)
    ref = dists_to_ids(g.vectors, g.scales, g.norms, q, qn, ids, metric)
    assert torch.equal(d, ref)


def test_plain_scans_count_each_cpu_call(graphs):
    data, gs = graphs
    g = gs["l2"]
    seeds = search.build_seed_index(g, "l2")
    q, qn = _prep(data, "l2", n=8)
    before = (search.seed_entries.plain_scans,
              search.seed_entries.kernel_scans)
    for i in range(1, 4):
        search.seed_entries(g, seeds, q, qn, E, "l2")
        assert search.seed_entries.plain_scans == before[0] + i
    assert search.seed_entries.kernel_scans == before[1]


def test_pass_through_wrapper_of_scan_topk(graphs, monkeypatch):
    """A pass-through in place of `scan_topk` where `models.search` calls it
    (as a tracer or a recorder installs) has no launch counters: the seed
    scan goes through it and reads none of them."""
    data, gs = graphs
    g = gs["l2"]
    seeds = search.build_seed_index(g, "l2")
    q, qn = _prep(data, "l2", n=8)
    want = search.seed_entries(g, seeds, q, qn, E, "l2")
    calls = []

    def passing(*args, **kwargs):
        calls.append(args)
        return scan_topk(*args, **kwargs)

    monkeypatch.setattr(search, "scan_topk", passing)
    plain = search.seed_entries.plain_scans
    got = search.seed_entries(g, seeds, q, qn, E, "l2")
    assert len(calls) == 1
    assert search.seed_entries.plain_scans == plain + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _neg_dot(rows, q):
    return -(rows * q[..., None, :]).sum(-1)


@pytest.mark.parametrize("with_matmul", [True, False])
def test_registry_metric(graphs, with_matmul):
    """With a matmul_score the scan takes K3's plain route (on any device)
    and ranks as the built-in ip does; without one seed_entries raises."""
    data, gs = graphs
    g = gs["ip"]
    name = f"seed_scan_test_{int(with_matmul)}"
    metrics.register_metric(
        name, _neg_dot,
        matmul_score=(lambda dot, xn: -dot) if with_matmul else None)
    try:
        seeds = search.build_seed_index(g, name)
        q, qn = _prep(data, "ip", seed=14)
        if not with_matmul:
            with pytest.raises(ValueError, match="matmul_score"):
                search.seed_entries(g, seeds, q, qn, E, name)
            return
        routes = scan_topk.plain_routes
        ids, d = search.seed_entries(g, seeds, q, qn, E, name)
        assert scan_topk.plain_routes == routes + 1
        ref_ids, _ = search.seed_entries(g, seeds, q, qn, E, "ip")
        np.testing.assert_array_equal(ids.numpy(), ref_ids.numpy())
        torch.testing.assert_close(
            d, _neg_dot(g.vectors[ids.long()].float(), q))
    finally:
        metrics.unregister_metric(name)
