"""Device kernels that start inside the traced steps' `hnsw.build.round`
spans per stream row those steps inserted: the eager insert round's
launches.  A kernel is counted by its start on the device, so one queued
behind the round's last host call and started after the span closed is
missed; the round is host-bound and its queue short."""

from bisect import bisect_left

from hnsw_bench import spans, stats

SPAN = "hnsw.build.round"


def read(record):
    t = record["trace"]
    if record["driver"] != "stream" or not record["work"] or not t.device:
        return None
    rounds = stats.merge_intervals(spans.of(record, SPAN))
    if not rounds:
        return None
    starts = sorted(s for name, s, _ in t.device
                    if not name.startswith(("Memcpy", "Memset")))
    kernels = sum(bisect_left(starts, hi) - bisect_left(starts, lo)
                  for lo, hi in rounds)
    return kernels / record["work"]
