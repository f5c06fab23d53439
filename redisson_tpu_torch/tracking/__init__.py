"""Server-assisted client tracking: the per-node ``TrackingTable`` of
``tracking/table.py`` that pushes RESP3 invalidations, and the client near
cache it feeds (``tracking/nearcache.py``)."""
