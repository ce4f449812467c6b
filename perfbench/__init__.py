"""The benchmark of ``xmca_tpu_torch`` (the PyTorch and CUDA package).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON result line.  Everything a cell needs is
found by name: its configuration in ``configs/``, its check in
``workloads/``, its traffic in ``traffic/`` and each per-layer metric's
reader in ``metrics/``.  ``reference/`` holds the plain PyTorch
computation that decides ``correct``; it imports nothing of the package
under test.
"""
