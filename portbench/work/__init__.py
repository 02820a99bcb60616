"""Work functions, ``<name>.py`` with ``work(ctx) -> (bytes, operations)``
of one call, counted from the inputs whatever implements them."""
