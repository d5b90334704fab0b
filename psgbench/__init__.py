"""The benchmark of ``openpsg_tpu_torch``: ``python3 -m psgbench.run`` runs one cell of ``BENCHMARK.json``."""
