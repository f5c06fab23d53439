"""RESP error replies: a copy of ``RespError`` from
``redisson_tpu/net/resp.py``.  The framing (encoder and incremental parser)
comes with the server slice."""
from __future__ import annotations


class RespError(Exception):
    """Server-signalled error reply (-ERR ...)."""

    @property
    def code(self) -> str:
        msg = self.args[0] if self.args else ""
        return msg.split(" ", 1)[0] if msg else ""
