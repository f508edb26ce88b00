"""Device kernels launched in the traced packed requests per query they
answered (the eager beam loop's launches)."""


def read(record):
    if record["driver"] != "query" or record["engine"] != "packed" \
            or not record["work"] or not record["trace"].device:
        return None
    return record["trace"].kernel_count() / record["work"]
