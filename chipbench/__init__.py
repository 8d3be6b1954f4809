"""The benchmark of ``repro_torch`` on one NVIDIA H100: ``run.py`` runs one
cell of ``BENCHMARK.json`` once (see ``harness.py``)."""
