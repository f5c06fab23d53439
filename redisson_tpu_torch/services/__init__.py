"""Services over the object layer: MapReduce (``services/mapreduce.py``),
search with vector KNN (``services/search.py``, ``services/vector.py``) and
transactions (``services/transactions.py``)."""
