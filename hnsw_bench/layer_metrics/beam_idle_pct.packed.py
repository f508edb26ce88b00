"""The packed engine's layer-0 beam loop in the traced requests: 1 − the
device's busy time inside the `hnsw.packed.beam` spans ÷ their length, in %.

Device intervals are clipped to the host span that was open when they ran.
That is exact when the loop is host-bound and the launch queue short, as
in a loop the card idles through most of: a kernel then runs within a few
microseconds of its launch, inside the span that launched it.  With a
long queue, work launched in the beam would run after its span closed, and
the beam would read as idle."""

from hnsw_bench import spans, stats

SPAN = "hnsw.packed.beam"


def read(record):
    if record["driver"] != "query" or record["engine"] != "packed" \
            or not record["trace"].device:
        return None
    beams = spans.of(record, SPAN)
    if not beams:
        return None
    return 100.0 * (1.0 - spans.device_busy(record, beams)
                    / stats.union_length(beams))
