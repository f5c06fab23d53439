"""Shared verb preludes: record-handle accessors, argument parsing, reply
formatting and the blocking-wait loop used across verb families (a copy of
``redisson_tpu/server/verbs/common.py``): the one home for helpers more
than one family needs, so numkeys and syntax validation cannot diverge
between families."""

import threading
from typing import List

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import _int, _s

# EXEC bodies run handlers inline on one worker; blocking verbs inside an
# EXEC degrade to a single poll (Redis semantics) via this flag.  Nothing
# sets it until MULTI/EXEC is ported (ROADMAP M7).
_exec_tls = threading.local()


def _typed_handle(server, factory: str, name: str):
    from redisson_tpu_torch.client.codec import BytesCodec

    return getattr(server.local_client(), factory)(name, codec=BytesCodec())


def _deque(server, name: str):
    return _typed_handle(server, "get_deque", name)


def _zset(server, name: str):
    return _typed_handle(server, "get_scored_sorted_set", name)


def _bitset(server, name: str):
    from redisson_tpu_torch.client.objects.bitset import BitSet

    return BitSet(server.engine, name)


def _fnum(x: float) -> bytes:
    """Redis float reply formatting: integral values print without '.0'."""
    return (str(int(x)) if float(x) == int(x) else repr(float(x))).encode()


def _glob_match(pattern: str, value: str) -> bool:
    import fnmatch

    return fnmatch.fnmatchcase(value, pattern)


def _scan_page(items: List[bytes], cursor: int, count: int):
    """Cursor = offset into the sorted item list (stable enough under the
    weakly-consistent SCAN contract the reference also provides)."""
    nxt = cursor + count
    page = items[cursor:nxt]
    return [b"0" if nxt >= len(items) else str(nxt).encode(), page]


def _scan_opts(args, start: int):
    pattern, count, novalues = None, 10, False
    i = start
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"MATCH":
            pattern = _s(args[i + 1])
            i += 2
        elif opt == b"COUNT":
            count = max(1, _int(args[i + 1]))
            i += 2
        elif opt == b"NOVALUES":
            novalues = True
            i += 1
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    return pattern, count, novalues


def _znumkeys(server, args, at=0):
    n = _int(args[at])
    if n <= 0:
        raise RespError("ERR numkeys should be greater than 0")
    if len(args) < at + 1 + n:
        raise RespError("ERR Number of keys can't be greater than number of args")
    names = [_s(k) for k in args[at + 1 : at + 1 + n]]
    return n, names, at + 1 + n


def _signal_waiters(server, name: str) -> None:
    """Wake queue-family waiters (pushes through Deque handles signal
    automatically; ZADD must wake BZPOP*)."""
    server.engine.signal_queue_waiters(name)


def _block_loop(server, first_key: str, poll_once, timeout: float):
    """Shared BLPOP/BRPOP/BZPOP/BLMOVE wait loop.  timeout<=0 = forever
    (the reference marks these isBlockingCommand: they bypass ping timeouts
    and hold their connection; here they hold one slow-pool worker)."""
    import time as _t

    if getattr(_exec_tls, "in_exec", False):
        # blocking verbs inside MULTI/EXEC act as an immediate-timeout poll
        return poll_once()
    deadline = None if timeout <= 0 else _t.time() + timeout
    entry = server.engine.queue_wait_entry(first_key)
    while not getattr(server, "_closing", False):
        r = poll_once()
        if r is not None:
            return r
        remaining = None if deadline is None else deadline - _t.time()
        if remaining is not None and remaining <= 0:
            return None
        entry.wait_for(min(0.05, remaining) if remaining is not None else 0.05)
    return None  # server stopping: unpark, reply nil
