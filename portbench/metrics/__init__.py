"""One reader a per-layer metric, ``<metric name>.py``, found by the name
in ``BENCHMARK.json``. A reader defines ``read(trace)`` (a
:class:`..trace.Trace`) and returns the metric's value, or ``None`` where
the trace holds nothing for it to read."""
