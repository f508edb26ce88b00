"""How much of the traced update steps goes to writing tombstones: the union
of the `hnsw.api.delete` spans (`Index._apply_tombstones`: the pending
`mark_deleted` calls' one copy and one scatter into `graph.deleted`) ÷ the
active steps' span, in %.  A program that writes each tombstone in its own
call opens no such span and reads nothing."""

from hnsw_bench import spans


def read(record):
    if record["driver"] != "update":
        return None
    return spans.host_pct(record, "hnsw.api.delete")
