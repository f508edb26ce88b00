"""The port's own spans in a traced run's record: `hnsw.*` regions that
`ocaml_hnsw_tpu_torch/utils/profiling.py::annotate` opens while the
profiler records.  They are `user_annotation` events of the same trace as
the kernels, so they share the device's clock (PERF.md lists them).

A program without those spans leaves none in the trace: each reader that
uses them then returns None.
"""

from __future__ import annotations

from hnsw_bench import stats


def of(record: dict, *names: str) -> list[tuple[float, float]]:
    """(start, end) of every host span whose name is one of `names`."""
    return [(s, e) for name, s, e in record["trace"].host if name in names]


def device_busy(record: dict, spans) -> float:
    """Seconds in which a device operation ran inside the spans: the union
    of device intervals clipped to each span, over the spans' union."""
    device = stats.merge_intervals((s, e) for _, s, e in record["trace"].device)
    return sum(stats.union_length(device, lo, hi)
               for lo, hi in stats.merge_intervals(spans))


def host_pct(record: dict, *names: str) -> float | None:
    """Share of the traced steps' span that the named spans cover, in %;
    None where the trace holds none of them."""
    found = of(record, *names)
    if not found:
        return None
    t = record["trace"]
    return 100.0 * stats.union_length(found, t.lo, t.hi) / t.window_s
