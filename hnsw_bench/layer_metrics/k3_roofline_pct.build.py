"""K3 (scan_topk) in one traced whole build (every kNN table's scan): Σ
least time of the scans' work ÷ its kernels' device time, in %."""

from hnsw_bench import trace


def read(record):
    if record["driver"] != "build":
        return None
    return trace.roofline_pct(record, "k3")
