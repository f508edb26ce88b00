import time

T0 = time.perf_counter()  # the run's set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: no idle OpenMP workers spin beside the
# thread that drives the card
os.environ.setdefault("OMP_NUM_THREADS", "1")

from hnsw_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
