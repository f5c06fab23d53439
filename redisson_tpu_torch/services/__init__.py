"""Services over the object layer: MapReduce (``services/mapreduce.py``) and
search with vector KNN (``services/search.py``, ``services/vector.py``)."""
