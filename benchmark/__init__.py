"""The benchmark of ``jaderaytracerendering_tpu_torch`` (the PyTorch and
CUDA port) on one NVIDIA H100.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

``BENCHMARK.json`` at the root names the cells; ``cells.py`` finds each
cell's configuration (``configs/``), traffic (``traffic/``) and metric
readers (``metrics/``) by name. ``clients/`` holds the client loops,
``scene.py`` the scene maker, ``reference/`` the plain reference that
decides ``correct`` (``check.py``), ``profiling.py`` and ``roofline.py``
the trace reading and the yardstick, ``control.py`` the readings the
comparison's limits were set from. Only ``program.py`` imports the port;
nothing here imports JAX or the JAX package.
"""
