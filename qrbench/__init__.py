"""qrbench: the benchmark of the PyTorch/CUDA port (``cuda_qr_tpu_torch``).

    python -m qrbench --workload NAME --seed N --seconds S --trace 0|1

One run measures one cell of ``BENCHMARK.json``.  Everything a cell needs
is found by name: its configuration (``configs/``), its traffic mix
(``traffic/``), its limits (``limits/``), the reference that judges its
answers (``reference/``) and its per-layer metrics (``metrics/``).  See
README.md.  Importing this package imports neither torch nor the program.
"""
