"""K1 (packed_score) in the traced requests: Σ least time of its recorded
calls (`roofline.k1_cost`) ÷ its kernels' device time, in %."""

from hnsw_bench import trace


def read(record):
    if record["driver"] != "query" or record["engine"] != "packed":
        return None
    return trace.roofline_pct(record, "k1")
