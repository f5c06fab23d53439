"""The wire layer: RESP framing (``resp``), its host library loader
(``_native``), the command table (``commands``), the client stack
(``client``: connections, pools, node clients) with its failure detectors
(``detectors``) and retry schedules (``retry``), and the restricted pickle
of wire payloads (``safe_pickle``)."""
