"""Sync client connection: `Connection` (RedisConnection.java: framed send,
reply matching).  Sync request/response over one socket; replies arrive in
send order (CommandsQueue FIFO discipline holds because the server executes
one connection's commands in order).

Addresses are "tpu://host:port" (RedisURI analog); "tpus://" (and
"rediss://") selects TLS, mirroring the reference's scheme-driven SSL
(client/handler/RedisChannelInitializer.java:110-219).

The part of ``redisson_tpu/net/client.py`` that drives one server:
`Connection` with its pipelined forms, the TLS helpers and the orphaned-push
count.  `PubSubConnection`, `ConnectionPool` and `NodeClient` (with the
failure detectors and retry schedules of ``net/detectors.py`` and
``net/retry.py`` they use) serve cluster links and clients, which come with
the multi-device slice; the chaos plane's transport fault hooks come with
the operations slice.
"""
from __future__ import annotations

import socket
import ssl as _ssl
import time
from typing import Any, Callable, List, Optional, Tuple

from redisson_tpu_torch.net import resp
from redisson_tpu_torch.net.resp import Push, RespError

# Process-global count of ORPHANED pushes: RESP3 push frames that arrived on
# a connection with no push_handler installed.  The old behavior consumed
# such a frame as the next pipeline reply — desyncing every subsequent
# command on the connection.  Now they drop, visibly:
# per-connection `dropped_pushes` plus this aggregate, exposed as a census/
# metrics gauge via dropped_push_count().
PUSH_DROPS = {"count": 0}


def dropped_push_count() -> int:
    return PUSH_DROPS["count"]


def parse_address(addr: str) -> Tuple[str, int]:
    """tpu://host:port (also accepts tpus://, redis://, rediss://, bare)."""
    for prefix in ("tpus://", "tpu://", "rediss://", "redis://"):
        if addr.startswith(prefix):
            addr = addr[len(prefix) :]
            break
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def address_uses_tls(addr: str) -> bool:
    return addr.startswith(("tpus://", "rediss://"))


def client_ssl_context(
    ca_file: Optional[str] = None,
    cert_file: Optional[str] = None,
    key_file: Optional[str] = None,
    verify_hostname: bool = True,
) -> _ssl.SSLContext:
    """Client-side TLS context (BaseConfig SSL knobs analog): `ca_file`
    pins the trust root (self-signed deployments), `cert_file`/`key_file`
    present a client certificate (mTLS), `verify_hostname=False` mirrors
    sslEnableEndpointIdentification=false for nodes addressed by IP."""
    ctx = _ssl.create_default_context(
        cafile=ca_file
    ) if ca_file else _ssl.create_default_context()
    if cert_file:
        ctx.load_cert_chain(cert_file, key_file)
    if not verify_hostname:
        ctx.check_hostname = False
    return ctx


class ConnectionError_(ConnectionError):
    pass


class CommandTimeoutError(TimeoutError):
    """Response didn't arrive within `timeout` (RedisResponseTimeoutException
    analog — message mirrors the reference's tuning advice style,
    command/RedisExecutor.java:214-248)."""


class Connection:
    """One plain socket connection; NOT thread-safe (callers own exclusion,
    normally via ConnectionPool)."""

    def __init__(
        self,
        host: str,
        port: int,
        connect_timeout: float = 10.0,
        timeout: float = 3.0,
        password: Optional[str] = None,
        client_name: Optional[str] = None,
        username: Optional[str] = None,
        ssl_context: Optional[_ssl.SSLContext] = None,
        ssl_hostname: Optional[str] = None,
    ):
        self.host, self.port = host, port
        self.timeout = timeout
        self._parser = resp.RespParser()
        # deque: read_reply consumes from the FRONT once per reply — a list
        # pop(0) is O(pending) per reply, quadratic across a large pipelined
        # frame's reply drain (hot for execute_many)
        from collections import deque

        self._pending: "deque" = deque()  # decoded frames awaiting delivery
        self.push_handler: Optional[Callable[[Push], None]] = None
        self.dropped_pushes = 0  # orphaned pushes dropped (no handler)
        self._sock = socket.create_connection((host, port), timeout=connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if ssl_context is not None:
            # TLS handshake before any byte of RESP (the SslHandler sits
            # FIRST in the reference pipeline, RedisChannelInitializer)
            self._sock = ssl_context.wrap_socket(
                self._sock, server_hostname=ssl_hostname or host
            )
        self._sock.settimeout(timeout)
        self.closed = False
        # handshake (BaseConnectionHandler.java:59-122): AUTH [user], SETNAME
        if password is not None:
            if username is not None:
                self._check(self.execute("AUTH", username, password))
            else:
                self._check(self.execute("AUTH", password))
        if client_name:
            self.execute("CLIENT", "SETNAME", client_name)

    @staticmethod
    def _check(reply):
        if isinstance(reply, RespError):
            raise reply
        return reply

    def close(self) -> None:
        self.closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    def send(self, *args) -> None:
        try:
            self._sock.sendall(resp.encode_command(*args))
        except (OSError, ValueError) as e:
            self.close()
            raise ConnectionError_(f"send to {self.host}:{self.port} failed: {e}") from e

    def read_reply(self, timeout: Optional[float] = None) -> Any:
        """Next non-push reply; push frames route to push_handler."""
        deadline = time.monotonic() + (timeout if timeout is not None else self.timeout)
        while True:
            while self._pending:
                value = self._pending.popleft()
                if isinstance(value, Push):
                    if self.push_handler is not None:
                        self.push_handler(value)
                    else:
                        # orphaned push (no handler): consuming it as the
                        # next pipeline reply would desync every later
                        # command on this connection — drop it, counted
                        self.dropped_pushes += 1
                        PUSH_DROPS["count"] += 1
                    continue
                return value
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise CommandTimeoutError(
                    f"no response from {self.host}:{self.port} within "
                    f"{timeout if timeout is not None else self.timeout}s; "
                    "consider increasing 'timeout' or checking server load"
                )
            self._sock.settimeout(remaining)
            try:
                data = self._sock.recv(1 << 16)
            except socket.timeout:
                raise CommandTimeoutError(
                    f"no response from {self.host}:{self.port} within budget"
                ) from None
            except OSError as e:
                self.close()
                raise ConnectionError_(f"read from {self.host}:{self.port} failed: {e}") from e
            if not data:
                self.close()
                raise ConnectionError_(f"connection to {self.host}:{self.port} closed by peer")
            self._pending.extend(self._parser.feed(data))

    def execute(self, *args, timeout: Optional[float] = None) -> Any:
        self.send(*args)
        return self.read_reply(timeout)

    def send_many(self, commands: List[Tuple]) -> int:
        """Write a whole pipelined frame in one syscall WITHOUT reading any
        reply; returns the number of commands written.  The upload half of
        the client-side overlap plane: pair with read_replies() to keep the
        next wave's frame in flight while the server's readback of the
        previous wave drains (core/ioplane discipline at the wire layer).
        Callers own the FIFO: every sent command's reply must be consumed,
        in order, before any other use of this connection."""
        if not commands:
            return 0
        payload = resp.encode_commands(commands)
        try:
            self._sock.sendall(payload)
        except OSError as e:
            self.close()
            raise ConnectionError_(f"send to {self.host}:{self.port} failed: {e}") from e
        return len(commands)

    def read_replies(self, n: int, timeout: Optional[float] = None) -> List[Any]:
        """Read the next `n` non-push replies in order (the drain half of
        send_many)."""
        return [self.read_reply(timeout) for _ in range(n)]

    def execute_many(self, commands: List[Tuple], timeout: Optional[float] = None) -> List[Any]:
        """Pipelined send: all frames in one write, replies read in order
        (the CommandBatchEncoder one-flush discipline)."""
        return self.read_replies(self.send_many(commands), timeout)

    def execute_many_lazy(self, commands: List[Tuple]) -> "PipelinedReplies":
        """Overlapped pipelined send: the frame is written NOW, replies are
        read only when demanded (PipelinedReplies.get()).  A sync caller can
        submit wave k+1 while the server still drains wave k's readback
        futures — the client face of the overlapped device I/O plane.  The
        handle OWNS this connection's FIFO until get() completes."""
        return PipelinedReplies(self, self.send_many(commands))


class PipelinedReplies:
    """Deferred replies of one pipelined frame (RFuture-of-a-frame): created
    by Connection.execute_many_lazy after the frame's single write; get()
    performs the FIFO reply drain on first demand and caches.  NOT
    thread-safe (it borrows its Connection's exclusion rules)."""

    __slots__ = ("_conn", "_n", "_values", "_error")

    def __init__(self, conn: Connection, n: int):
        self._conn = conn
        self._n = n
        self._values: Optional[List[Any]] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._values is not None or self._error is not None

    def get(self, timeout: Optional[float] = None) -> List[Any]:
        if self._values is None:
            if self._error is not None:
                raise self._error
            try:
                self._values = self._conn.read_replies(self._n, timeout)
            except BaseException as e:
                self._error = e
                raise
        return self._values
