"""K3 (scan_topk) in the traced flat requests: Σ least time of the scans'
work (`roofline.k3_cost`) ÷ its kernels' device time, in %."""

from hnsw_bench import trace


def read(record):
    if record["driver"] != "query" or record["engine"] != "flat":
        return None
    return trace.roofline_pct(record, "k3")
