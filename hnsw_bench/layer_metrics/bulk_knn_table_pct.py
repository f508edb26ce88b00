"""The bulk build's layer-0 kNN table: its stage line's seconds over the
sum of the build's stage lines (the bulk logger at INFO, each stage ending
in a device synchronise), in %."""


def read(record):
    stages = record["stages"]
    total = sum(s for _, s in stages)
    knn = sum(s for name, s in stages if name.startswith("layer0 kNN"))
    if total <= 0 or not knn:
        return None
    return 100.0 * knn / total
