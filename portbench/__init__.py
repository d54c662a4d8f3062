"""The port's benchmark: cells of ``BENCHMARK.json`` run against ``repro_torch``
on the card (``run.py``), each held to a plain float32 reference
(``reference/``).  See ``README.md``."""
