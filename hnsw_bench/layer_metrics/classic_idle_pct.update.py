"""The classic engine's layer-0 beam in the traced update steps, over a
graph that holds tombstones: 1 − the device's busy time inside the
`hnsw.classic.beam` spans ÷ their length, in %.  Device intervals are
clipped to the span that was open when they ran (`beam_idle_pct.packed`
says when that is exact)."""

from hnsw_bench import spans, stats

SPAN = "hnsw.classic.beam"


def read(record):
    if record["driver"] != "update" or not record["trace"].device:
        return None
    beams = spans.of(record, SPAN)
    if not beams:
        return None
    return 100.0 * (1.0 - spans.device_busy(record, beams)
                    / stats.union_length(beams))
