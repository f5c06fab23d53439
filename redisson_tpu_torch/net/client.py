"""Sync client connection stack: Connection, pools, keepalive, watchdog.

Parity targets (SURVEY.md §2.1-2.2):
  * `Connection` — RedisConnection.java: framed send, reply matching.
    Sync request/response over one socket; replies arrive in send order
    (CommandsQueue FIFO discipline holds because the server executes one
    connection's commands in order).
  * `PubSubConnection` — RedisPubSubConnection.java: dedicated connection
    with a background reader routing push frames to listeners.
  * `ConnectionPool` — connection/pool/ConnectionPool.java:47-120: bounded
    acquire with warm minimum-idle.
  * `NodeClient` — RedisClient.java + ConnectionWatchdog.java:58-175 +
    PingConnectionHandler.java:60-104: execute() with retry/backoff
    reconnect, periodic ping, failure-detector feed.

Addresses are "tpu://host:port" (RedisURI analog); "tpus://" (and
"rediss://") selects TLS, mirroring the reference's scheme-driven SSL
(client/handler/RedisChannelInitializer.java:110-219).

A copy of ``redisson_tpu/net/client.py``.  One difference: closing joins the threads a client started (the
pool's idle reaper, the ping loop, the pub/sub reader), so a client that
was shut down leaves no thread behind.
"""
from __future__ import annotations

import socket
import ssl as _ssl
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from redisson_tpu_torch.net import resp
from redisson_tpu_torch.net.detectors import FailedNodeDetector
from redisson_tpu_torch.net.resp import Push, RespError
from redisson_tpu_torch.utils import metrics as _metrics

# Process-global transport fault plane (chaos/faults.py FaultPlane): every
# Connection consults it at its three event sites (connect, send, recv), so
# injected faults flow through the real failure paths (pool discard, retry
# machinery, detector feeds) instead of bypassing them.
#
# Zero-cost contract (tests/test_torch_faults.py and
# tools/chaos_overhead_bench.py): with no plane installed an event costs one
# module-global load and one `is None` branch: no attribute chase, no call,
# no allocation.  Every event site reads `_fault_plane` into a local once
# and branches; nothing else may be added to the disarmed path.
_fault_plane = None


def install_fault_plane(plane):
    """Install (or clear, with None) the process-global fault plane.
    Returns the previously installed plane so callers can restore it."""
    global _fault_plane
    prev = _fault_plane
    _fault_plane = plane
    return prev

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
        plane = _fault_plane
        if plane is not None:
            plane.on_connect(host, port)  # may raise ConnectionRefusedError
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
            plane = _fault_plane
            if plane is not None and not plane.on_send(self):
                return  # one-way partition (out): frame never leaves
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
            plane = _fault_plane
            if plane is not None:
                data = plane.on_recv(self, data)
                if data is None:
                    continue  # one-way partition (in): reply silently lost
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
            plane = _fault_plane
            if plane is not None and not plane.on_send(self):
                payload = b""  # partition (out): the whole frame is lost
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


class PubSubConnection:
    """Dedicated subscription connection with a reader thread
    (RedisPubSubConnection.java + CommandPubSubDecoder routing)."""

    def __init__(
        self,
        host: str,
        port: int,
        password: Optional[str] = None,
        username: Optional[str] = None,
        ssl_context: Optional[_ssl.SSLContext] = None,
        ssl_hostname: Optional[str] = None,
    ):
        self._conn = Connection(
            host, port, password=password, username=username,
            ssl_context=ssl_context, ssl_hostname=ssl_hostname,
        )
        self._listeners: Dict[str, List[Callable[[str, bytes], None]]] = {}
        self._plisteners: Dict[str, List[Callable[[str, str, bytes], None]]] = {}
        # CLIENT TRACKING invalidation listeners: fn(keys) with keys =
        # [bytes, ...] or None (flush-everything).  This dedicated reader-
        # thread connection is the natural REDIRECT target — its stable
        # client id is captured BEFORE the reader starts (after that, the
        # reader owns all replies on this socket).
        self._inv_listeners: List[Callable] = []
        # fired (once) when this connection stops being able to deliver
        # pushes — transport error OR explicit close().  The near-cache
        # plane's reconnection-CLEAR hook: an invalidation stream that ENDS
        # (for any reason: node death, topology refresh retiring the entry)
        # leaves every cache fed by it uninvalidatable, so the plane must
        # flush either way; it distinguishes its own shutdown itself.
        self.on_disconnect: Optional[Callable[["PubSubConnection"], None]] = None
        self._disc_fired = False
        self._lock = threading.RLock()
        # Serializes all I/O on the shared socket between the reader thread
        # and subscriber sends.  An SSL object is NOT safe under a
        # concurrent read+write (one thread in recv, another in sendall
        # corrupts the TLS stream — reproduced as SSLEOFError / a silently
        # dead subscription, the test_tls_pubsub_connection full-suite
        # flake).  The reader waits for READABILITY outside this lock and
        # holds it only for the short non-blocking-ish recv, so a
        # subscribe() send waits at most the in-lock read timeout (50ms),
        # never the 250ms poll interval.  RLock: a push listener may
        # legitimately (un)subscribe on its own connection.
        self._io_lock = threading.RLock()
        # pre-CLIENT-ID servers reply an error value -> feed works, just
        # not usable as a REDIRECT target.  Transport failures (timeout,
        # reset) must PROPAGATE instead: a live feed stuck with
        # client_id=None would make every tracking conn_setup against this
        # node fail with no recovery path, since _ensure_feed keeps
        # handing back the same poisoned feed until its socket dies
        try:
            reply = self._conn.execute("CLIENT", "ID")
        except BaseException:
            self._conn.close()  # constructor aborts: do not leak the socket
            raise
        self.client_id: Optional[int] = (
            None if isinstance(reply, RespError) else int(reply)
        )
        self._conn.push_handler = self._on_push
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._reader, daemon=True, name="rtpu-pubsub")
        self._thread.start()

    def add_invalidation_listener(self, fn: Callable) -> Callable:
        with self._lock:
            self._inv_listeners.append(fn)
        return fn

    def remove_invalidation_listener(self, fn: Callable) -> None:
        with self._lock:
            try:
                self._inv_listeners.remove(fn)
            except ValueError:
                pass

    def send_locked(self, *args) -> None:
        """The ONLY legal way to write this connection's socket once the
        reader thread is running (see _io_lock)."""
        with self._io_lock:
            self._conn.send(*args)

    def subscribe(self, channel: str, listener: Callable[[str, bytes], None]) -> None:
        # the send happens OUTSIDE self._lock: the reader thread dispatches
        # pushes under _io_lock -> _lock, so a sender holding _lock while
        # waiting on _io_lock would deadlock the pair
        with self._lock:
            fresh = channel not in self._listeners
            self._listeners.setdefault(channel, []).append(listener)
        if fresh:
            self.send_locked("SUBSCRIBE", channel)

    def psubscribe(self, pattern: str, listener: Callable[[str, str, bytes], None]) -> None:
        with self._lock:
            fresh = pattern not in self._plisteners
            self._plisteners.setdefault(pattern, []).append(listener)
        if fresh:
            self.send_locked("PSUBSCRIBE", pattern)

    def unsubscribe(self, channel: str) -> None:
        with self._lock:
            gone = self._listeners.pop(channel, None) is not None
        if gone:
            self.send_locked("UNSUBSCRIBE", channel)

    def remove_listener(self, channel: str, listener) -> None:
        """Detach ONE listener; unsubscribes only when the last one goes
        (handles sharing a channel on one connection keep receiving)."""
        unsub = False
        with self._lock:
            listeners = self._listeners.get(channel)
            if listeners is None:
                return
            try:
                listeners.remove(listener)
            except ValueError:
                return
            if not listeners:
                del self._listeners[channel]
                unsub = True
        if unsub:
            self.send_locked("UNSUBSCRIBE", channel)

    def channels(self) -> List[str]:
        with self._lock:
            return list(self._listeners)

    def _on_push(self, push: Push) -> None:
        kind = bytes(push[0])
        if kind == b"message":
            channel = push[1].decode()
            with self._lock:
                listeners = list(self._listeners.get(channel, ()))
            for fn in listeners:
                fn(channel, push[2])
        elif kind == b"pmessage":
            pattern, channel = push[1].decode(), push[2].decode()
            with self._lock:
                listeners = list(self._plisteners.get(pattern, ()))
            for fn in listeners:
                fn(pattern, channel, push[3])
        elif kind == b"invalidate":
            # CLIENT TRACKING invalidation frame: >2 invalidate [key...]
            # (payload None = FLUSHALL / flush-everything)
            keys = push[1] if len(push) > 1 else None
            with self._lock:
                listeners = list(self._inv_listeners)
            for fn in listeners:
                try:
                    fn(keys)
                except Exception:  # noqa: BLE001 — listener bugs must not
                    pass           # kill push delivery for the connection

    def _reader(self) -> None:
        import select as _select

        conn = self._conn
        while not self._stop.is_set() and not conn.closed:
            try:
                # wait for readability OUTSIDE the I/O lock (holding it
                # across a blocking recv would stall subscribe sends for
                # the whole poll interval); SSL sockets may hold decrypted
                # bytes the kernel fd no longer shows — check pending()
                sock = conn._sock
                if not (
                    conn._pending
                    or getattr(sock, "pending", lambda: 0)()
                ):
                    readable, _, _ = _select.select([sock], [], [], 0.25)
                    if not readable:
                        continue
                # in-lock: ONE immediate recv + parse, never a timed wait —
                # a sender (subscribe/unsubscribe) must only ever block for
                # this, not for a read budget (a 50ms in-lock wait showed up
                # whole in lock-handoff latency via UNSUBSCRIBE-on-close)
                batch = []
                with self._io_lock:
                    if not conn._pending:
                        sock.settimeout(0.05)  # partial-TLS-record bound
                        try:
                            data = sock.recv(1 << 16)
                        except socket.timeout:
                            data = None
                        finally:
                            # the 50ms budget is the READER's only; leaving
                            # it on the shared socket would put every
                            # subscribe/unsubscribe sendall under it
                            sock.settimeout(conn.timeout)
                        if data is not None:
                            if not data:
                                conn.close()
                                raise ConnectionError_(
                                    "pubsub connection closed by peer"
                                )
                            plane = _fault_plane
                            if plane is not None:
                                # chaos parity with read_reply: injected
                                # drops and truncation hit the push feed too
                                data = plane.on_recv(conn, data)
                            if data is not None:
                                conn._pending.extend(conn._parser.feed(data))
                    while conn._pending:
                        batch.append(conn._pending.popleft())
                # route pushes OUTSIDE the lock: listener callbacks may be
                # slow or (re)subscribe on this very connection
                for value in batch:
                    if isinstance(value, Push):
                        if conn.push_handler is not None:
                            conn.push_handler(value)
                    # else: subscribe/unsubscribe confirmations; ignore
            except CommandTimeoutError:
                continue
            except ValueError:
                # select on a fd closed mid-wait (close() raced the loop)
                if not self._stop.is_set():
                    self._fire_disconnect()
                return
            except (ConnectionError, OSError):
                # watchdog (NodeClient) owns reconnect; the tracking plane's
                # reconnection-CLEAR discipline hangs off this edge (a feed
                # that died may have dropped invalidations — near caches
                # must flush, not serve through the gap)
                if not self._stop.is_set():
                    self._fire_disconnect()
                return

    def _fire_disconnect(self) -> None:
        with self._lock:
            if self._disc_fired:
                return
            self._disc_fired = True
            cb = self.on_disconnect
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — hook bugs stay contained
                pass

    def close(self) -> None:
        self._stop.set()
        self._conn.close()
        self._thread.join(timeout=2)
        # an ARMED feed closing for ANY reason ends its invalidation stream:
        # the plane must hear about it (it ignores the event once the whole
        # facade is shutting down) — a topology refresh retiring this
        # node's entry would otherwise strand every cache entry whose
        # server-side registration redirected here, silently stale
        self._fire_disconnect()


class ConnectionPool:
    """Bounded blocking pool with min-idle warmup
    (connection/pool/ConnectionPool.java:47-120 — AsyncSemaphore acquire)
    and an idle reaper (connection/IdleConnectionWatcher.java: pooled
    connections idle beyond `idle_timeout` close, down to `min_idle`)."""

    def __init__(
        self,
        factory: Callable[[], Connection],
        size: int = 8,
        min_idle: int = 1,
        idle_timeout: float = 60.0,
        defer_warmup: bool = False,
    ):
        self._factory = factory
        self._size = size
        self._min_idle = min(min_idle, size)
        self._idle_timeout = idle_timeout
        # release-time admission filter: return False to RETIRE the
        # connection instead of pooling it (the tracking plane uses this to
        # drain connections armed against a dead invalidation feed — their
        # server-side tracking state is gone, so pooling them would let
        # untracked reads populate near caches invisibly)
        self.release_filter: Optional[Callable[[Connection], bool]] = None
        self._sem = threading.Semaphore(size)
        self._idle: List[Tuple[Connection, float]] = []  # (conn, idle-since)
        self._lock = threading.Lock()
        self.in_use = 0  # CommandsLoadBalancer feed (least in-flight picks)
        self._closed = False
        if not defer_warmup:
            self.warm()
        self._reaper: Optional[threading.Timer] = None
        if idle_timeout and idle_timeout > 0:
            self._schedule_reap()

    def warm(self) -> None:
        """Best-effort min-idle warm-up: a client to a temporarily-down
        node must still construct (failure detectors, coordinators, and
        the watchdog all hold clients to nodes that may be down right
        now) — the connect error surfaces on first acquire() instead.
        Deferred (``defer_warmup=True``) by owners whose connection factory
        needs the pool attribute already assigned (NodeClient's conn_setup
        hook runs inside the factory)."""
        for _ in range(self._min_idle - self.idle_count()):
            try:
                conn = self._factory()
            except (ConnectionError, OSError):
                break
            # the reaper may already be armed (defer_warmup path): an
            # unlocked append racing _reap's list reassignment would drop
            # the conn from tracking with its socket open
            with self._lock:
                if self._closed:
                    conn.close()
                    break
                self._idle.append((conn, time.monotonic()))

    def _schedule_reap(self) -> None:
        # the timer must not keep an abandoned pool alive: hold the pool by
        # weakref so a dropped-without-close() NodeClient can still be GC'd
        # (the timer chain ends when the ref dies)
        import weakref

        ref = weakref.ref(self)

        def fire():
            pool = ref()
            if pool is not None:
                pool._reap()

        with self._lock:
            if self._closed:
                return
            self._reaper = threading.Timer(max(self._idle_timeout / 2, 1.0), fire)
            self._reaper.daemon = True
            self._reaper.start()

    def _reap(self) -> None:
        now = time.monotonic()
        victims: List[Connection] = []
        with self._lock:
            if self._closed:
                return
            keep: List[Tuple[Connection, float]] = []
            for conn, since in self._idle:
                if (
                    len(self._idle) - len(victims) > self._min_idle
                    and now - since > self._idle_timeout
                ):
                    victims.append(conn)
                else:
                    keep.append((conn, since))
            self._idle = keep
        for conn in victims:
            conn.close()
        self._schedule_reap()

    def acquire(self, timeout: float = 10.0) -> Connection:
        if not self._sem.acquire(timeout=timeout):
            raise CommandTimeoutError(
                f"connection pool exhausted ({self._size} busy); increase "
                "'connection_pool_size' or reduce concurrency"
            )
        with self._lock:
            # a CLOSED pool must never mint connections: a retired shard
            # entry (topology refresh) is unreachable from shutdown(), so a
            # socket opened here would outlive the client — and keep its
            # server-side tracking state pinned (a census leak)
            if self._closed:
                self._sem.release()
                raise ConnectionError("connection pool is closed")
            self.in_use += 1
            while self._idle:
                conn, _since = self._idle.pop()
                if not conn.closed:
                    return conn
        try:
            return self._factory()
        except Exception:
            with self._lock:
                self.in_use -= 1
            self._sem.release()
            raise

    def release(self, conn: Connection) -> None:
        if not conn.closed and self.release_filter is not None:
            try:
                if not self.release_filter(conn):
                    conn.close()
            except Exception:  # noqa: BLE001 — a filter bug must not leak slots
                pass
        retire = False
        with self._lock:
            self.in_use -= 1
            if not conn.closed:
                if self._closed:
                    # released after close() (holder raced a topology-refresh
                    # retirement): the idle sweep already ran, nothing will
                    # ever close this conn again — retire it now
                    retire = True
                else:
                    self._idle.append((conn, time.monotonic()))
        if retire:
            conn.close()
        self._sem.release()

    def clear_idle(self) -> None:
        """Close every idle connection NOW (fresh acquires reconnect through
        the factory).  The re-arm half of the tracking plane's reconnection
        discipline: after the invalidation feed changes, pooled connections
        must re-handshake so their CLIENT TRACKING REDIRECT points at the
        live feed."""
        with self._lock:
            victims = [c for c, _since in self._idle]
            self._idle.clear()
        for c in victims:
            c.close()

    def discard(self, conn: Connection) -> None:
        conn.close()
        with self._lock:
            self.in_use -= 1
        self._sem.release()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for c, _since in self._idle:
                c.close()
            self._idle.clear()
            reaper = self._reaper
        if reaper is not None:
            reaper.cancel()
            if reaper is not threading.current_thread():
                reaper.join(timeout=2)

    def idle_count(self) -> int:
        with self._lock:
            return len(self._idle)


class NodeClient:
    """Client to ONE server node: pooled commands, retry w/ reconnect
    backoff, ping keepalive, failure-detector feed.

    execute() is the RedisExecutor retry state machine
    (command/RedisExecutor.java:113-205): up to `retry_attempts` attempts,
    `retry_interval` apart, transparent across reconnects.
    """

    def __init__(
        self,
        address: str,
        password: Optional[str] = None,
        client_name: Optional[str] = None,
        pool_size: int = 8,
        min_idle: int = 1,
        timeout: float = 3.0,
        connect_timeout: float = 10.0,
        retry_attempts: int = 3,
        retry_interval: float = 1.5,
        retry_policy=None,
        ping_interval: float = 30.0,
        detector: Optional[FailedNodeDetector] = None,
        hooks: Optional[List] = None,
        username: Optional[str] = None,
        ssl_context: Optional[_ssl.SSLContext] = None,
        ssl_hostname: Optional[str] = None,
        events_hub=None,
        credentials_resolver=None,
        command_mapper=None,
        conn_setup=None,
        readonly: bool = False,
    ):
        self.address = address
        # READONLY handshake: every pooled connection of this
        # client arms replica reads right after connect — BEFORE conn_setup,
        # which the tracking plane overwrites, so replica-read admission and
        # tracking arming compose instead of clobbering each other
        self.readonly = readonly
        # CredentialsResolver SPI (config/CredentialsResolver): resolved PER
        # CONNECTION ATTEMPT so rotated secrets apply without a restart
        self._credentials_resolver = credentials_resolver
        # CommandMapper SPI (config/CommandMapper): renamed-command support
        # for managed deployments; applied just before the wire write
        self._command_mapper = command_mapper
        self.host, self.port = parse_address(address)
        # ConnectionEventsHub (detectors.py): edge-triggered connect/
        # disconnect fan-out shared by every NodeClient of one facade
        self.events_hub = events_hub
        self._password = password
        self._username = username
        # a tpus:// address with no explicit context gets the system default
        # (scheme-driven SSL like the reference's rediss://)
        if ssl_context is None and address_uses_tls(address):
            ssl_context = client_ssl_context()
        self._ssl_context = ssl_context
        self._ssl_hostname = ssl_hostname
        self._client_name = client_name
        self.timeout = timeout
        self._connect_timeout = connect_timeout
        self.retry_attempts = retry_attempts
        self.retry_interval = retry_interval
        # net/retry.py RetryPolicy: bounded exponential backoff + jitter +
        # deadline propagation.  When set it REPLACES the legacy
        # retry_attempts/retry_interval schedule (same detector feeds, same
        # pool discard — only the retry cadence changes); an explicit
        # per-call retry_attempts= still overrides both.
        self.retry_policy = retry_policy
        self.detector = detector or FailedNodeDetector()
        self.hooks = list(hooks or [])  # CommandHook SPI (utils/metrics.py)
        # per-connection post-handshake hook, called as conn_setup(self,
        # conn) on every FRESH pooled connection (the tracking plane arms
        # CLIENT TRACKING REDIRECT here); installable after construction
        self.conn_setup = conn_setup
        self._closed = threading.Event()
        # pubsub state BEFORE the pool: the pool's min-idle warm-up calls
        # _connect, whose conn_setup hook (tracking plane) may need
        # self.pubsub() — the invalidation-feed connection
        self._pubsub: Optional[PubSubConnection] = None
        self._pubsub_lock = threading.Lock()
        self.pool = ConnectionPool(
            self._connect, size=pool_size, min_idle=min_idle, defer_warmup=True
        )
        # warm AFTER self.pool exists: the conn_setup hook (tracking plane)
        # touches node.pool from inside the connection factory
        self.pool.warm()
        self._ping_interval = ping_interval
        self._ping_thread: Optional[threading.Thread] = None
        if ping_interval and ping_interval > 0:
            self._ping_thread = threading.Thread(
                target=self._ping_loop, daemon=True, name=f"rtpu-ping-{self.port}"
            )
            self._ping_thread.start()

    def _connect(self) -> Connection:
        username, password = self._username, self._password
        if self._credentials_resolver is not None:
            creds = self._credentials_resolver(self.address)
            if creds is not None:
                username, password = creds
        try:
            conn = Connection(
                self.host,
                self.port,
                connect_timeout=self._connect_timeout,
                timeout=self.timeout,
                password=password,
                username=username,
                client_name=self._client_name,
                ssl_context=self._ssl_context,
                ssl_hostname=self._ssl_hostname,
            )
        except OSError as e:
            self.detector.on_connect_failed()
            if self.events_hub is not None:
                self.events_hub.node_disconnected(self.address)
            raise ConnectionError_(f"cannot connect to {self.address}: {e}") from e
        self.detector.on_connect_successful()
        if self.events_hub is not None:
            self.events_hub.node_connected(self.address)
        if self.readonly:
            try:
                conn.execute("READONLY")
            except BaseException:
                # a connection that failed to arm must not enter the pool:
                # its keyed reads would bounce -MOVED on a cluster replica
                conn.close()
                raise
        setup = self.conn_setup
        if setup is not None:
            try:
                setup(self, conn)
            except BaseException:
                # a half-armed connection must not enter the pool: reads on
                # it would look tracked to the caller but be invisible to
                # the server's invalidation plane
                conn.close()
                raise
        return conn

    # -- command path --------------------------------------------------------

    def _mapped(self, args: tuple) -> tuple:
        if self._command_mapper is None or not args:
            return args
        cmd = args[0]
        name = cmd.decode() if isinstance(cmd, (bytes, bytearray)) else str(cmd)
        return (self._command_mapper.map(name), *args[1:])

    def execute(
        self, *args, timeout: Optional[float] = None,
        retry_attempts: Optional[int] = None,
    ) -> Any:
        """`retry_attempts=0` makes this a single-shot probe — topology
        refreshes ping candidate nodes this way so a dead master costs one
        refused connect, not retries-with-backoff under the refresh lock."""
        args = self._mapped(args)
        if not self.hooks:
            return self._with_retry(
                lambda c: c.execute(*args, timeout=timeout), retry_attempts
            )
        return self._hooked(
            str(args[0]), args[1:],
            lambda: self._with_retry(
                lambda c: c.execute(*args, timeout=timeout), retry_attempts
            ),
        )

    def _hooked(self, name: str, args, fn: Callable[[], Any]) -> Any:
        tokens = _metrics.run_hooks_start(self.hooks, name, args)
        try:
            result = fn()
        except BaseException as e:
            _metrics.run_hooks_end(tokens, name, e)
            raise
        _metrics.run_hooks_end(tokens, name, None)
        return result

    def execute_many(self, commands: List[Tuple], timeout: Optional[float] = None) -> List[Any]:
        if self._command_mapper is not None:
            commands = [self._mapped(tuple(c)) for c in commands]
        if not self.hooks:
            return self._with_retry(lambda c: c.execute_many(commands, timeout=timeout))
        # the batch is ONE wire round trip: record it as one PIPELINE[n]
        # dispatch rather than n synthetic per-command timings — per-command
        # timers must stay comparable with the single-dispatch path
        return self._hooked(
            "PIPELINE", (len(commands),),
            lambda: self._with_retry(lambda c: c.execute_many(commands, timeout=timeout)),
        )

    def _with_retry(
        self, fn: Callable[[Connection], Any], retry_attempts: Optional[int] = None
    ) -> Any:
        last: Optional[BaseException] = None
        # a RetryPolicy (net/retry.py) replaces the legacy fixed schedule:
        # bounded exponential backoff + seeded jitter, and an overall
        # deadline the acquire timeout is clamped to (deadline propagation);
        # an explicit per-call retry_attempts= keeps the legacy schedule
        policy = self.retry_policy if retry_attempts is None else None
        clock = policy.start() if policy is not None else None
        if policy is not None:
            attempts = policy.max_attempts - 1
        else:
            attempts = self.retry_attempts if retry_attempts is None else retry_attempts
        for attempt in range(attempts + 1):
            if self._closed.is_set():
                raise ConnectionError_("client is closed")
            if attempt:
                if clock is not None:
                    clock.attempt = attempt
                    try:
                        clock.sleep()
                    except TimeoutError:
                        break  # deadline gone: surface the last real error
                else:
                    # exponential backoff on reconnect attempts
                    # (ConnectionWatchdog.java: timeout = 2 << attempts ms floor)
                    time.sleep(min(self.retry_interval * attempt, 10.0))
            acquire_timeout = self._connect_timeout
            if clock is not None:
                acquire_timeout = clock.attempt_timeout(self._connect_timeout)
            try:
                conn = self.pool.acquire(timeout=acquire_timeout)
            except (ConnectionError, OSError) as e:
                last = e
                continue
            try:
                result = fn(conn)
            except CommandTimeoutError as e:
                # command was WRITTEN; retrying could double-apply it.  The
                # reference stops retrying once the write completed
                # (RedisExecutor response-timeout path) — same rule here.
                self.detector.on_command_timeout()
                if self.events_hub is not None and self.detector.is_node_failed():
                    # a hung-but-accepting node never refuses connects; the
                    # DETECTOR's verdict is what should flip listeners to
                    # disconnected (one slow reply must not)
                    self.events_hub.node_disconnected(self.address)
                self.pool.discard(conn)
                raise
            except (ConnectionError, OSError) as e:
                self.detector.on_command_failed(e)
                if self.events_hub is not None:
                    self.events_hub.node_disconnected(self.address)
                self.pool.discard(conn)
                last = e
                continue
            self.pool.release(conn)
            if isinstance(result, RespError):
                self.detector.on_command_failed(result)
                raise result
            self.detector.on_command_successful()
            if self.events_hub is not None:
                # a benign single-connection drop fired node_disconnected;
                # any subsequent success re-marks the node up (edge-triggered
                # — a no-op while already connected)
                self.events_hub.node_connected(self.address)
            return result
        if last is None:
            from redisson_tpu_torch.net.retry import DeadlineExceeded

            raise DeadlineExceeded(
                f"retry budget exhausted talking to {self.address}"
            )
        raise last

    def in_flight(self) -> int:
        """Commands currently holding a pooled connection (CommandsLoadBalancer feed)."""
        return self.pool.in_use

    # -- pubsub --------------------------------------------------------------

    def pubsub(self) -> PubSubConnection:
        with self._pubsub_lock:
            if self._pubsub is None or self._pubsub._conn.closed:
                username, password = self._username, self._password
                if self._credentials_resolver is not None:
                    # pubsub connects/reconnects resolve like data conns:
                    # a rotated secret must not strand re-subscriptions
                    creds = self._credentials_resolver(self.address)
                    if creds is not None:
                        username, password = creds
                fresh = PubSubConnection(
                    self.host, self.port, password=password,
                    username=username, ssl_context=self._ssl_context,
                    ssl_hostname=self._ssl_hostname,
                )
                if self._pubsub is not None:
                    # carry listeners over (watchdog pubsub re-attach)
                    fresh._listeners = self._pubsub._listeners
                    fresh._plisteners = self._pubsub._plisteners
                    for channel in fresh._listeners:
                        fresh.send_locked("SUBSCRIBE", channel)
                    for pattern in fresh._plisteners:
                        fresh.send_locked("PSUBSCRIBE", pattern)
                self._pubsub = fresh
            return self._pubsub

    # -- keepalive -----------------------------------------------------------

    def _ping_loop(self) -> None:
        while not self._closed.wait(self._ping_interval):
            try:
                reply = self.execute("PING", timeout=self.timeout)
                if reply in (b"PONG", "PONG"):
                    self.detector.on_ping_successful()
                else:  # pragma: no cover — unexpected reply
                    self.detector.on_ping_failed()
            except Exception:  # noqa: BLE001
                self.detector.on_ping_failed()

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self._closed.set()
        if self._pubsub is not None:
            self._pubsub.close()
        self.pool.close()
        ping = self._ping_thread
        if ping is not None and ping is not threading.current_thread():
            ping.join(timeout=self.timeout + 1.0)
