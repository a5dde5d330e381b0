"""One reader a per-layer metric, named by the metric: ``read(rec)``."""
