"""Shared verb preludes: record-handle accessors, argument parsing and reply
formatting used across verb families (a copy of the parts of
``redisson_tpu/server/verbs/common.py`` the ported families need)."""

from typing import List

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import _int, _s


def _typed_handle(server, factory: str, name: str):
    from redisson_tpu_torch.client.codec import BytesCodec

    return getattr(server.local_client(), factory)(name, codec=BytesCodec())


def _bitset(server, name: str):
    from redisson_tpu_torch.client.objects.bitset import BitSet

    return BitSet(server.engine, name)


def _fnum(x: float) -> bytes:
    """Redis float reply formatting: integral values print without '.0'."""
    return (str(int(x)) if float(x) == int(x) else repr(float(x))).encode()


def _glob_match(pattern: str, value: str) -> bool:
    import fnmatch

    return fnmatch.fnmatchcase(value, pattern)


def _norm_range(start: int, end: int, n: int):
    """Redis negative-index normalization of an inclusive [start, end]
    range over n items (``scoredsortedset._norm_range`` of the reference,
    which GETRANGE shares)."""
    if start < 0:
        start = max(0, n + start)
    if end < 0:
        end = n + end
    return start, min(end, n - 1)


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
