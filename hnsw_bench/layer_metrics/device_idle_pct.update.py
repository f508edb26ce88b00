"""Share of the traced update steps' wall time in which no operation ran on
the device (1 − union of device intervals ÷ the active steps' span), in %."""

from hnsw_bench import trace


def read(record):
    if record["driver"] != "update":
        return None
    return trace.idle_pct(record)
