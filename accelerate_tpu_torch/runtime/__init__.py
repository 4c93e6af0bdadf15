"""Host runtime of the port: the native load-path helpers (``native.py``)."""
