"""Per-frame request tracing (``observe/trace.py``)."""
