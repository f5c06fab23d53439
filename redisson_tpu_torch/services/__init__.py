"""Services over the object layer: MapReduce (``services/mapreduce.py``),
search with vector KNN (``services/search.py``, ``services/vector.py``),
transactions (``services/transactions.py``), scripts and functions
(``services/script.py``), the executor and scheduled executor
(``services/executor.py``, run by ``node.py``'s worker nodes), the remote
service (``services/remote.py``), live objects (``services/liveobject.py``)
and the elements subscribe service (``services/elements.py``)."""
