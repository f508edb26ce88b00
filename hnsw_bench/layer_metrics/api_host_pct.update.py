"""The public API's own host work in the traced update steps: the length of
its `hnsw.api.prepare` spans (input checks, the queries' pageable H2D) and
`hnsw.api.labels` spans (the label checks and fills of `add_items`, the
label map of `knn_query`) ÷ the traced steps' span, in %."""

from hnsw_bench import spans


def read(record):
    if record["driver"] != "update":
        return None
    return spans.host_pct(record, "hnsw.api.prepare", "hnsw.api.labels")
