"""The benchmark of the PyTorch and CUDA simulator (``repro_torch``).

``python simbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Cells,
configurations, traffic mixes and metrics are files found by name under
``workloads/``, ``configs/``, ``traffic/`` and ``metrics/``; the plain
reference that decides ``correct`` is ``reference/``.
"""
