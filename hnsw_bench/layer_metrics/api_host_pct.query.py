"""The public API's own host work in the traced requests: the length of its
`hnsw.api.prepare` spans (input checks, padding, the pageable H2D) and
`hnsw.api.labels` spans (the label map) ÷ the traced steps' span, in %."""

from hnsw_bench import spans


def read(record):
    if record["driver"] != "query":
        return None
    return spans.host_pct(record, "hnsw.api.prepare", "hnsw.api.labels")
