"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix, cell or metric is a file of its
own under this folder, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model's sizes, precision and buckets;
* ``mixes/<traffic>.json``: the parameters the general generator
  (``lib/traffic.py``) reads; two of them name the traffic's code,
  ``arrivals/<name>.py`` (the request stream from the seed) and
  ``loops/<name>.py`` (how the window offers it to the system);
* ``cells/<workload>.json``: the cell's own parameters (a fixed rate, the
  image pool) and the limits of its correctness check;
* ``metrics/<metric>.py``: one reader, ``read(art)``, of a run's artefacts;
* ``reference/<family>.py``: the plain PyTorch forward and its parameters.

Only ``lib/system.py`` imports the port.
"""
