"""Percentiles, unions of intervals and roofline counting."""

import numpy as np
import pytest
import torch

from hnsw_bench import roofline, stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy(q):
    xs = np.random.default_rng(3).exponential(size=101)
    assert stats.percentile(xs.tolist(), q) == pytest.approx(
        np.percentile(xs, q))


def test_union_counts_overlaps_once():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 7)]
    assert stats.merge_intervals(iv) == [(0, 3), (5, 6)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.union_length(iv, lo=1, hi=5.5) == pytest.approx(2.5)


def test_gaps_are_the_uncovered_parts():
    assert stats.gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [
        (0, 1), (3, 4), (5, 6)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def test_k1_cost_counts_distinct_nodes_once():
    nodes = torch.tensor([[0, 1], [1, -1], [2, 2]], dtype=torch.int32)
    slots, d_pad = 4, 16
    nbytes, ops, peak = roofline.k1_cost(nodes, slots, d_pad)
    # 3 distinct nodes, 3 queries, 6 node ids, 6·4 outputs of 8 bytes
    assert nbytes == 3 * (4 * 16 + 8 * 4) + 3 * (16 + 4) + 6 * 4 + 6 * 4 * 8
    assert ops == 2 * 5 * slots * d_pad  # 5 live node entries
    assert peak == roofline.INT8_OPS_PER_S


def test_k3_cost_is_the_scan_work():
    nbytes, ops, peak = roofline.k3_cost(1000, 128, 2, 64, 32)
    assert nbytes == 1000 * (256 + 5) + 64 * 128 * 4 + 64 * 32 * 12
    assert ops == 2 * 64 * 1000 * 128
    assert peak == roofline.BF16_FLOPS_PER_S
    assert roofline.k3_cost(10, 96, 1, 2, 3)[0] == 10 * (96 + 9) + 2 * 96 * 4 \
        + 2 * 3 * 12


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0, 1.0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 989e12, 989e12) == pytest.approx(1.0)
