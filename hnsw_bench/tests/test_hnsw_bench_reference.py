"""The plain reference against brute force in NumPy, and the judge."""

import numpy as np
import pytest
import torch

from hnsw_bench import judge, reference


def _brute(x, q, k, metric):
    x, q = x.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = 1.0 - q @ x.T
    else:
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d, ids, 1)


@pytest.fixture
def data():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((700, 24)).astype(np.float32),
            rng.standard_normal((90, 24)).astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_knn_matches_brute_force(data, metric, monkeypatch):
    monkeypatch.setattr(reference, "SLAB", 256)  # several slabs
    monkeypatch.setattr(reference, "CHUNK", 32)
    x, q = data
    ref = reference.rows(x, metric, "cpu")
    ids, d = reference.knn(ref, reference.queries(q, ref), 10)
    want_ids, want_d = _brute(x, q, 10, metric)
    assert (ids.numpy() == want_ids).all()
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-5, atol=1e-5)


def test_knn_excludes_own_row(data):
    x, _ = data
    ref = reference.rows(x, "l2", "cpu")
    nodes = torch.arange(20)
    got = reference.knn(ref, ref.x[nodes], 1, exclude=nodes)[0][:, 0]
    want = _brute(x, x[:20], 2, "l2")[0][:, 1]
    assert (got.numpy() == want).all()


def test_recall_counts_each_found_id_once():
    found = torch.tensor([[1, 1, 2, -1], [5, 6, 7, 8]])
    true = torch.tensor([[1, 2, 3, 4], [8, 7, 6, 5]])
    assert reference.recall(found, true).tolist() == [2, 4]


def _answers(x, q, metric):
    ids, d = _brute(x, q, 10, metric)
    return np.arange(q.shape[0]), ids, d.astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_judge_passes_exact_answers_and_fails_altered(data, metric):
    x, q = data
    ref = reference.rows(x, metric, "cpu")
    qd, true_ids, _, scale = judge.truth(ref, q, 10)
    idx, ids, d = _answers(x, q, metric)
    good = judge.judge_answers(ref, qd, true_ids, scale, idx, ids, d)
    assert good["recall_at_10"] == 1.0 and good["dist_gap"] < 1e-5
    bad = ids.copy()
    bad[3, 0] = (bad[3, 0] + 1) % x.shape[0]
    worse = judge.judge_answers(ref, qd, true_ids, scale, idx, bad, d)
    assert worse["dist_gap"] > 1e-2
    missing = ids.copy()
    missing[0, 0] = -1
    assert judge.judge_answers(ref, qd, true_ids, scale, idx, missing,
                               d)["dist_gap"] == float("inf")


def test_judge_graph_counts_bad_lists(data):
    x, _ = data
    ref = reference.rows(x, "l2", "cpu")
    nn = _brute(x, x, 9, "l2")[0][:, 1:]  # each row's 8 nearest others
    adj0 = np.full((x.shape[0], 12), -1, np.int32)
    adj0[:, :8] = nn
    nodes = judge.sample_nodes(x.shape[0], 1)
    nearest = judge.nearest_other(ref, nodes)
    ok = judge.judge_graph(ref, adj0, nodes, nearest)
    assert ok == {"adj0_invalid": 0, "nn1_missing": 0.0}
    adj0[0, 8] = 0  # self loop
    adj0[1, 8] = adj0[1, 0]  # repeat
    adj0[2, 8] = x.shape[0]  # out of range
    adj0[3] = -1  # empty list
    adj0[nodes[:10], 0] = -1  # the nearest neighbour dropped
    bad = judge.judge_graph(ref, adj0, nodes, nearest)
    assert bad["adj0_invalid"] == 4
    assert bad["nn1_missing"] >= 10 / len(nodes)


def test_checks_compare_each_number_with_its_limit():
    out = judge.checks({"a": 0.96, "b": 2e-3},
                       {"a": {"min": 0.95}, "b": {"max": 1e-3}})
    assert [c["ok"] for c in out] == [True, False]
    with pytest.raises(ValueError):
        judge.checks({"a": 1.0}, {"a": {"min": 0.5}, "b": {"max": 1}})
