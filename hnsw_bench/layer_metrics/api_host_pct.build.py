"""The public API's own host work in one traced whole build: the length of
`Index.add_items`' `hnsw.api.prepare` span (input checks) and
`hnsw.api.labels` spans (the duplicate check, the label-to-id fill loop)
÷ the traced step's span, in %."""

from hnsw_bench import spans


def read(record):
    if record["driver"] != "build":
        return None
    return spans.host_pct(record, "hnsw.api.prepare", "hnsw.api.labels")
