"""The wire layer: RESP framing (``resp``), its host library loader
(``_native``), the command table (``commands``) and the client connection
(``client``)."""
