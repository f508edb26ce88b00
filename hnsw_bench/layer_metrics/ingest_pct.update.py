"""How much of the traced update steps is the insert of the new versions:
the union of the `hnsw.api.add` spans (`Index.add_items`' call into the
build, here one insert round each) ÷ the active steps' span, in %."""

from hnsw_bench import spans


def read(record):
    if record["driver"] != "update":
        return None
    return spans.host_pct(record, "hnsw.api.add")
