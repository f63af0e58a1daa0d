"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON result line.  Everything that belongs to one
configuration, traffic mix or metric sits in a file of its own, found by the
name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the deployment (scale, k, delta, engine
  options), what was cut from the source, and the limits of the check;
* ``traffic/<traffic>.json``: the mix, read by ``generator.py`` and run by the
  driver it names, ``drivers/<driver>.py``;
* ``metrics/<metric>.py``: one reader a metric, with the program hooks it
  needs (``layers.py`` holds the common ones);
* ``drivers/<driver>.py`` also works out the plain reference of its
  traffic (``reference/``) and reads the program's outputs against it;
  ``check.py`` decides ``correct`` from those readings and the
  configuration's limits; ``rooflines.py``: the card's peaks and each
  kernel's operations and bytes.

Nothing here imports ``jax`` or the JAX package ``repro``; the harness
refuses to print a result if either is loaded.
"""
