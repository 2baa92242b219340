"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, graph kind, app, traffic mix, mode, kernel
or per-layer metric is a file of its own, found by name (``configs/``,
``graphs/``, ``reference/<app>.py``, ``costs/model_<app>.py``,
``workloads/``, ``modes/``, ``costs/``, ``metrics/``), so a new cell,
app or metric is added by adding files. ``reference/`` is the plain
PyTorch reference that decides ``correct``; it imports nothing of the
port.
"""
