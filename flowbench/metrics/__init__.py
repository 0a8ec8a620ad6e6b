"""One reader a metric: ``<name>.py`` exposes ``read(run)``, which takes a
``trace.Run`` and returns the metric's value, or None where the run has
nothing to read for it (the harness then leaves the metric out of the
line).  ``spec.reader`` finds a reader by the metric's name in
``BENCHMARK.json``."""
