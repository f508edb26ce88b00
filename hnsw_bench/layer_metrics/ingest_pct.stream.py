"""How much of the traced stream steps is ingest: the union of the
`hnsw.api.add` spans (`Index.add_items`' call into the build, here one
insert round each) ÷ the active steps' span, in %.  The rest is the query
batch and the API's own host work around both calls."""

from hnsw_bench import spans


def read(record):
    if record["driver"] != "stream":
        return None
    return spans.host_pct(record, "hnsw.api.add")
