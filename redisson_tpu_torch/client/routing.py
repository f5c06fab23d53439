"""Frame run shapes for the server's coalescing plane.

A trimmed copy of ``redisson_tpu/client/routing.py``: the server finds a
frame's runs of same-verb BF blob commands here.  The cluster routing core
(slots, MOVED/ASK classification, CLUSTER SLOTS view parsing, slot
grouping) comes with the cluster client and cluster mode (ROADMAP M8).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

# stacked-bank kernel dispatch (server/verbs/sketch.py coalesce_bloom_run —
# the adaptive coalescing plane).  Listed HERE because run shape is
# routing-adjacent pure logic: clients that order a shard's frame to keep
# same-verb commands adjacent (the natural order of a fan-out batch) get
# maximal runs server-side for free.
COALESCIBLE_BLOB_VERBS = frozenset((b"BF.MADD64", b"BF.MEXISTS64"))


def _verb_of(cmd) -> Optional[bytes]:
    # malformed frames carry non-bytes elements (nested arrays, ints);
    # they are NOT runs — the per-command path replies their errors
    if isinstance(cmd, list) and cmd and isinstance(cmd[0], (bytes, bytearray)):
        return bytes(cmd[0]).upper()
    return None


def coalescible_frame_runs(cmds: List[Any]) -> List[Tuple[int, int]]:
    """Maximal [start, end) runs (len >= 2) of CONSECUTIVE same-verb
    coalescible blob commands in one pipelined frame.  Pure scan: the server
    frame loop replaces each run with a single fused dispatch; everything
    outside the runs dispatches per command, so frame order is untouched."""
    out: List[Tuple[int, int]] = []
    i, n = 0, len(cmds)
    while i < n:
        verb = _verb_of(cmds[i])
        if verb not in COALESCIBLE_BLOB_VERBS:
            i += 1
            continue
        j = i + 1
        while j < n and _verb_of(cmds[j]) == verb:
            j += 1
        if j - i >= 2:
            out.append((i, j))
        i = j
    return out

