"""The benchmark of the PyTorch and CUDA port (``apsim_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything that belongs to one configuration, traffic kind, cell or
per-layer metric sits in a file of its own (``configs/``, ``traffic/``,
``workloads/``, ``metrics/``), found by the name ``BENCHMARK.json`` gives.
The yardstick lives here too: the corpus generator (``corpus.py``), the
rate and tail arithmetic (``stats.py``), the trace reduction
(``profile.py``), the card's peaks (``peaks.py``) and the plain reference
with the comparison that decides ``correct`` (``reference/``).  Nothing
here imports ``jax`` or the JAX package.
"""
