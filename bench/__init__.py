"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json``; everything a cell
needs is found by name: ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json``, ``bench/metrics/<metric>.py``.  The plain
reference that decides ``correct`` lives in ``bench/reference`` and
imports nothing of the program.
"""
