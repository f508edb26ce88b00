"""The incremental build's insert rounds in the traced stream steps: 1 −
the device's busy time inside the `hnsw.build.round` spans ÷ their length,
in %.

Device intervals are clipped to the span that was open when they ran,
which is exact while the round is host-bound and the launch queue short
(`beam_idle_pct.packed` says more)."""

from hnsw_bench import spans, stats

SPAN = "hnsw.build.round"


def read(record):
    if record["driver"] != "stream" or not record["trace"].device:
        return None
    rounds = spans.of(record, SPAN)
    if not rounds:
        return None
    return 100.0 * (1.0 - spans.device_busy(record, rounds)
                    / stats.union_length(rounds))
