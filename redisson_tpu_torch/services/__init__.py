"""Services over the object layer: MapReduce (``services/mapreduce.py``)."""
