"""Plain references of the index kinds, one file a kind (``<kind>.py``)."""
