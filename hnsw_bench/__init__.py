"""The benchmark of `ocaml_hnsw_tpu_torch` on one NVIDIA H100.

    python3 -m hnsw_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` (harness.py) and prints one JSON line.
"""
