"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card;
``harness.py`` says how cells, configurations, traffic mixes and metrics are
found by name.  The yardstick lives here and nowhere in the program: the
stream and query generators (``traffic/``), the plain reference and the
comparison that decides ``correct`` (``reference/``), the chip's peaks and
the kernels' work (``roofline.py``), and the reduction of a profiled slice
(``trace.py``).  Nothing here imports JAX or the JAX package ``repro``.
"""
