"""Share of one traced whole build's wall time in which no operation ran on
the device (1 − union of device intervals ÷ the step's span), in %."""

from hnsw_bench import trace


def read(record):
    if record["driver"] != "build":
        return None
    return trace.idle_pct(record)
