"""Per-layer metrics, one reader a file, named as in ``BENCHMARK.json``:
``read(view)`` takes the traced window (``trace.TraceView``) and returns
the number, or None where the window holds nothing to read."""
