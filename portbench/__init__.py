"""The benchmark of ``repro_torch``, the PyTorch + CUDA serving port.

One run drives one cell of ``BENCHMARK.json`` (a model configuration under
a traffic mix) through the port's ``ServingEngine`` on one card and prints
one JSON line. Everything a cell needs lives in files found by name:

* ``configs/<config>.json``: the model as it is run, with its source, its
  cuts (``reduced``), departures and assumptions;
* ``traffic/<workload>.json``: the traffic mix and engine settings, read
  by one generator (``traffic.py``), and the limit of its correctness
  check;
* ``metrics/<metric>.py``: one reader a metric, ``read(run)`` returning a
  number or None.

The yardstick lives here too, so the program cannot move it: the traffic
generator (a copy of ``repro_torch/serve/traffic.py``'s, timed in wall
seconds), the kernels' bytes and FLOPs (``cost.py``), the kernel families
(``families.py``), the card's peaks (``peaks.py``) and the plain fp32
reference the served tokens are judged against (``reference/``).

Nothing here imports ``jax`` or the JAX package ``repro``; ``reference/``
imports nothing of ``repro_torch`` either.
"""
