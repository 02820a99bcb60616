"""Per-layer metrics, one reader a metric (``<metric>.py`` with ``read(ctx)``)."""
