"""Async (asyncio) client API — the reference's async/reactive facade analog.

Parity target: Redisson exposes every object in sync, Async, Reactive and
RxJava variants generated by proxy builders (``reactive/ReactiveProxyBuilder
.java``, ``rx/RxProxyBuilder.java``; SURVEY.md §1-L6).  Per SURVEY.md §7.4,
one native-async Python API replaces all three JVM mirrors: the sync client
(`client/remote.py`) is the blocking facade; this module is the async one.

The transport is a single multiplexed pipelined connection per node: command
futures enqueue in send order and a reader task completes them FIFO — the
asyncio re-expression of the reference's `CommandsQueue` in-flight FIFO
(``client/handler/CommandsQueue.java:41-103``), which is exactly what makes
pipelining safe on one socket.  Delivery is AT-MOST-ONCE: only
connection-establishment failures retry — once a command is written, a
timeout or connection loss raises instead of re-sending (a shared
multiplexed connection would otherwise replay non-idempotent ops).

A copy of ``redisson_tpu/client/aio.py``, the slot-routed
``AsyncClusterRedisson`` included; pickled frames go through
``net/safe_pickle`` as the sync client's do.
"""
from __future__ import annotations

import asyncio
from typing import Any, Callable, Dict, List, Optional, Tuple

from redisson_tpu_torch.client.codec import DEFAULT_CODEC, Codec
from redisson_tpu_torch.client.remote import _GENERIC_FACTORIES, _unwrap, _unwrap_many
from redisson_tpu_torch.net import commands as C
from redisson_tpu_torch.net import resp, safe_pickle
from redisson_tpu_torch.net.client import parse_address
from redisson_tpu_torch.net.resp import Push, RespError


class AsyncConnection:
    """One pipelined asyncio connection: send never waits for replies;
    a background reader completes pending futures in FIFO order.  TLS and
    the AUTH user-pass form mirror the sync Connection (net/client.py)."""

    def __init__(
        self,
        host: str,
        port: int,
        password: Optional[str] = None,
        username: Optional[str] = None,
        ssl_context=None,
        ssl_hostname: Optional[str] = None,
    ):
        self.host, self.port = host, port
        self._password = password
        self._username = username
        self._ssl_context = ssl_context
        self._ssl_hostname = ssl_hostname
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: "asyncio.Queue[asyncio.Future]" = asyncio.Queue()
        self._parser = resp.RespParser()
        self._reader_task: Optional[asyncio.Task] = None
        self.push_handler: Optional[Callable[[Push], None]] = None
        self.closed = False

    async def connect(self) -> "AsyncConnection":
        kw = {}
        if self._ssl_context is not None:
            kw["ssl"] = self._ssl_context
            kw["server_hostname"] = self._ssl_hostname or self.host
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, **kw
        )
        self._reader_task = asyncio.create_task(self._read_loop())
        if self._password is not None:
            try:
                if self._username is not None:
                    fut = self.execute("AUTH", self._username, self._password)
                else:
                    fut = self.execute("AUTH", self._password)
                await self.drain()
                reply = await fut
                if isinstance(reply, RespError):
                    raise reply
            except BaseException:
                await self.close()  # no socket/reader-task leak on bad AUTH
                raise
        return self

    async def _read_loop(self) -> None:
        try:
            while True:
                data = await self._reader.read(1 << 16)
                if not data:
                    raise ConnectionError("connection closed by peer")
                for value in self._parser.feed(data):
                    if isinstance(value, Push):
                        if self.push_handler is not None:
                            self.push_handler(value)
                        continue
                    try:
                        fut = self._pending.get_nowait()
                    except asyncio.QueueEmpty:
                        # reply to a send()-fired command (e.g. a SUBSCRIBE
                        # rejected with an error frame): no positional future
                        # exists — surface via the push handler, never kill
                        # the reader
                        if self.push_handler is not None:
                            self.push_handler(Push(["orphan-reply", value]))
                        continue
                    if not fut.done():
                        fut.set_result(value)
        except (ConnectionError, asyncio.IncompleteReadError, OSError) as e:
            await self._fail_pending(e)
        except asyncio.CancelledError:
            await self._fail_pending(ConnectionError("connection closing"))
            raise

    async def _fail_pending(self, exc: BaseException) -> None:
        self.closed = True
        while not self._pending.empty():
            fut = self._pending.get_nowait()
            if not fut.done():
                fut.set_exception(ConnectionError(str(exc)))

    def execute(self, *args) -> "asyncio.Future":
        """Pipeline one command; returns an awaitable for its reply."""
        if self.closed or self._writer is None:
            raise ConnectionError("connection is closed")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending.put_nowait(fut)
        self._writer.write(resp.encode_command(*args))
        return fut

    def send(self, *args) -> None:
        """Fire-and-forget (SUBSCRIBE-style commands whose confirmation
        arrives as a push frame, not a positional reply)."""
        if self.closed or self._writer is None:
            raise ConnectionError("connection is closed")
        self._writer.write(resp.encode_command(*args))

    async def drain(self) -> None:
        if self._writer is not None:
            await self._writer.drain()

    async def close(self) -> None:
        self.closed = True
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except asyncio.CancelledError:
                pass
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass


class AsyncNodeClient:
    """Reconnecting pipelined client to one node (async RedisExecutor)."""

    def __init__(
        self,
        address: str,
        password: Optional[str] = None,
        timeout: float = 30.0,
        retry_attempts: int = 3,
        retry_interval: float = 0.5,
        username: Optional[str] = None,
        ssl_context=None,
        ssl_hostname: Optional[str] = None,
    ):
        from redisson_tpu_torch.net.client import address_uses_tls, client_ssl_context

        self.address = address
        self.host, self.port = parse_address(address)
        self._password = password
        self._username = username
        if ssl_context is None and address_uses_tls(address):
            ssl_context = client_ssl_context()  # scheme-driven default TLS
        self._ssl_context = ssl_context
        self._ssl_hostname = ssl_hostname
        self.timeout = timeout
        self.retry_attempts = retry_attempts
        self.retry_interval = retry_interval
        self._conn: Optional[AsyncConnection] = None
        self._connect_lock = asyncio.Lock()
        self._closed = False
        # blocking-verb connections (execute_blocking): idle free-list +
        # in-flight set so close() can tear down parked pops
        self._dedicated_idle: List[AsyncConnection] = []
        self._dedicated_active: set = set()

    def _make_connection(self) -> AsyncConnection:
        """Unconnected AsyncConnection carrying this node's full transport
        config (TLS, credentials) — also used for pubsub connections."""
        return AsyncConnection(
            self.host,
            self.port,
            password=self._password,
            username=self._username,
            ssl_context=self._ssl_context,
            ssl_hostname=self._ssl_hostname,
        )

    async def _connection(self) -> AsyncConnection:
        async with self._connect_lock:
            if self._conn is None or self._conn.closed:
                self._conn = await self._make_connection().connect()
            return self._conn

    async def execute(self, *args, timeout: Optional[float] = None) -> Any:
        """At-most-once delivery: only connection-ESTABLISHMENT failures
        retry.  Once the command is handed to the transport it is never
        re-sent — a non-idempotent op could double-apply (the sync client's
        no-retry-after-write rule; amplified here because the multiplexed
        connection is shared, so another task's failure must not make THIS
        task's already-written command replay)."""
        last: Optional[BaseException] = None
        for attempt in range(self.retry_attempts + 1):
            if self._closed:
                raise ConnectionError("client is closed")
            if attempt:
                await asyncio.sleep(min(self.retry_interval * attempt, 5.0))
            try:
                conn = await self._connection()
            except (ConnectionError, OSError) as e:
                last = e  # nothing reached the server: safe to retry
                continue
            try:
                fut = conn.execute(*args)
            except ConnectionError as e:
                last = e  # conn raced closed before the write: safe to retry
                continue
            try:
                await conn.drain()
                reply = await asyncio.wait_for(fut, timeout or self.timeout)
            except asyncio.TimeoutError:
                # the FIFO stays aligned (the reader completes this cancelled
                # future positionally when the late reply lands), so the
                # shared connection stays usable for other tasks
                raise TimeoutError(
                    f"no response from {self.address} within "
                    f"{timeout or self.timeout}s (command was written; not retried)"
                ) from None
            except (ConnectionError, OSError) as e:
                raise ConnectionError(
                    f"connection to {self.address} failed with the command in "
                    f"flight (not retried: delivery unknown): {e}"
                ) from e
            if isinstance(reply, RespError):
                raise reply
            return reply
        assert last is not None
        raise last

    _DEDICATED_IDLE_MAX = 4  # small free-list; parked pops dominate anyway

    @staticmethod
    def _block_budget(args) -> Optional[float]:
        """The command's OWN server-side block timeout in seconds; None if
        it blocks forever (0) or can't be parsed."""
        try:
            cu = (args[0].decode() if isinstance(args[0], (bytes, bytearray))
                  else str(args[0])).upper()
            if cu in C.BLOCK_TIMEOUT_FIRST:
                block = float(args[1])
            elif cu in C.BLOCKING_COMMANDS:
                block = float(args[-1])
            else:  # XREAD/XREADGROUP: BLOCK <ms>
                uppers = [
                    (a.decode() if isinstance(a, (bytes, bytearray)) else str(a)).upper()
                    for a in args
                ]
                block = float(args[uppers.index("BLOCK") + 1]) / 1000.0
        except (ValueError, IndexError):
            return None
        return None if block <= 0 else block

    async def execute_blocking(self, *args, timeout: Optional[float] = None,
                               asking: bool = False) -> Any:
        """Blocking verbs get a DEDICATED connection (the reference's
        isBlockingCommand discipline): a parked BLPOP on the shared
        multiplexed FIFO would head-of-line-block every other pipelined
        reply until it woke.  Dedicated connections come from a small
        free-list so a poll loop doesn't pay connect/TLS/AUTH per
        iteration, and are tracked so close() tears down parked ones.

        The client-side wait derives from the command's OWN block timeout
        (`BLPOP k 0` = park forever) unless `timeout` overrides it —
        the shared-connection default must not cut a legal park short.
        `asking` prefixes the one-shot ASKING admission for redirected
        slots (paired on this private connection, so no interleaving)."""
        if self._closed:
            raise ConnectionError("client is closed")
        if timeout is None:
            block = self._block_budget(args)
            # None = park forever (bounded only by the caller/server);
            # otherwise give the server's own budget headroom to reply
            timeout = None if block is None else max(self.timeout, block + 5.0)
        conn = None
        while self._dedicated_idle:
            cand = self._dedicated_idle.pop()
            if not cand.closed:
                conn = cand
                break
        if conn is None:
            # establishment failures retry like execute(): nothing has
            # reached the server yet, so a re-connect is always safe
            last: Optional[BaseException] = None
            for attempt in range(self.retry_attempts + 1):
                if attempt:
                    await asyncio.sleep(min(self.retry_interval * attempt, 5.0))
                try:
                    conn = await self._make_connection().connect()
                    break
                except (ConnectionError, OSError) as e:
                    last = e
            else:
                assert last is not None
                raise last
        self._dedicated_active.add(conn)
        if self._closed:  # close() raced our registration: don't park
            self._dedicated_active.discard(conn)
            await conn.close()
            raise ConnectionError("client is closed")
        clean = False
        try:
            ask_fut = conn.execute("ASKING") if asking else None
            fut = conn.execute(*args)
            await conn.drain()
            try:
                reply = await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                # normalize to the builtin (they only merged in 3.11) so
                # callers catch ONE TimeoutError family across client modes
                raise TimeoutError(
                    f"no response from {self.address} within {timeout}s "
                    "(blocking command was written; connection discarded)"
                ) from None
            if ask_fut is not None:
                await ask_fut  # already resolved: it preceded `reply` in FIFO
            # the reply was fully consumed, so the FIFO is aligned and the
            # connection is reusable even when the reply is an error
            clean = True
            if isinstance(reply, RespError):
                raise reply
            return reply
        finally:
            self._dedicated_active.discard(conn)
            if clean and not conn.closed and not self._closed and len(
                self._dedicated_idle
            ) < self._DEDICATED_IDLE_MAX:
                self._dedicated_idle.append(conn)
            else:
                # a timed-out wait leaves a reply in flight on this socket:
                # never reuse it, the FIFO would misalign
                await conn.close()

    async def execute_pipeline(
        self, commands: List[Tuple], timeout: Optional[float] = None
    ) -> List[Any]:
        """All commands in one write burst; replies awaited together (the
        RBatch executeAsync shape — one round trip for the whole batch)."""
        return await asyncio.wait_for(
            asyncio.gather(*await self.execute_pipeline_nowait(commands)),
            timeout or self.timeout,
        )

    async def execute_pipeline_nowait(
        self, commands: List[Tuple]
    ) -> List["asyncio.Future"]:
        """Overlapped pipeline submission (the async face of the device I/O
        plane): the frame is written and the per-command reply futures are
        returned WITHOUT awaiting them — a caller can keep wave k+1's upload
        in flight while the server drains wave k's readback futures, then
        gather both.  Reply order is the connection's FIFO; the futures
        resolve as the server's writer task flushes each frame."""
        conn = await self._connection()
        futs = [conn.execute(*c) for c in commands]
        await conn.drain()
        return futs

    async def close(self) -> None:
        self._closed = True
        if self._conn is not None:
            await self._conn.close()
        for conn in [*self._dedicated_idle, *list(self._dedicated_active)]:
            await conn.close()  # parked pops die with the client
        self._dedicated_idle.clear()


class AsyncObjectProxy:
    """obj.method(...) -> awaitable OBJCALL (async RemoteObjectProxy)."""

    def __init__(self, client: "AsyncRemoteRedisson", factory: str, name: str):
        self._client = client
        self._factory = factory
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    async def drain_to(self, collection: list, max_elements=None) -> int:
        """Out-param shape can't cross RPC (see RemoteObjectProxy.drain_to):
        one poll_many wire call, filled into the caller's list locally."""
        items = await self._client.objcall(
            self._factory, self._name, "poll_many",
            (max_elements if max_elements is not None else 1 << 62,), {},
        )
        collection.extend(items)
        return len(items)

    def __getattr__(self, method: str):
        async def call(*args, **kwargs):
            return await self._client.objcall(self._factory, self._name, method, args, kwargs)

        return call


class _AsyncObjectSurface:
    """Shared async facade plumbing (single-node AND cluster clients):
    client identity, the generic OBJCALL handle factory, and pubsub push
    parsing — extracted so the two flavors cannot drift (same motivation
    as client/routing.py for the routing core)."""

    _PROXY_FACTORIES = (
        "get_bucket", "get_bit_set", "get_hyper_log_log", "get_topic",
    )

    def get_bloom_filter(self, name: str) -> "AsyncBloomFilter":
        return AsyncBloomFilter(self, name)

    def caller_id(self) -> str:
        import uuid as _uuid

        if not hasattr(self, "_client_uuid"):
            self._client_uuid = _uuid.uuid4().hex
        # one identity per client instance: asyncio tasks share the event
        # loop thread, so thread-id is meaningless for lock ownership here
        return f"{self._client_uuid}:aio"

    def __getattr__(self, factory: str):
        if factory in _GENERIC_FACTORIES or factory in self._PROXY_FACTORIES:

            def make(name: str, *args, **kwargs) -> AsyncObjectProxy:
                if args or kwargs:
                    # OBJCALL proxies execute on the server with ITS codec;
                    # silently dropping a client-side codec would decode wrong
                    raise TypeError(
                        f"{factory} over the async OBJCALL proxy takes only a "
                        "name; per-object codecs apply at the server (embedded "
                        "client) — got extra arguments"
                    )
                return AsyncObjectProxy(self, factory, name)

            return make
        raise AttributeError(factory)

    def _dispatch_message_push(self, p: Push, sub_queues) -> None:
        # Push is a list: [kind, channel, payload]; reader tasks run on the
        # client's loop, so put_nowait is safe without a threadsafe hop
        if len(p) >= 3 and p[0] in (b"message", "message"):
            ch = p[1].decode() if isinstance(p[1], bytes) else p[1]
            for q in sub_queues.get(ch, ()):
                q.put_nowait((p[1], p[2]))


class AsyncRemoteRedisson(_AsyncObjectSurface):
    """Async facade over a (single-node) tpu server.

    Usage::

        client = await AsyncRemoteRedisson.connect("tpu://127.0.0.1:6390")
        m = client.get_map("m")
        await m.put("k", 1)
        assert await m.get("k") == 1
        await client.aclose()
    """

    def __init__(self, address: str, password: Optional[str] = None, timeout: float = 30.0, **node_kw):
        self.node = AsyncNodeClient(address, password=password, timeout=timeout, **node_kw)
        self.codec: Codec = DEFAULT_CODEC
        self._pubsub: Optional[AsyncConnection] = None
        self._pubsub_lock: Optional[asyncio.Lock] = None
        self._sub_queues: Dict[str, List["asyncio.Queue"]] = {}
        self._closing = False

    @classmethod
    async def connect(cls, address: str, **kw) -> "AsyncRemoteRedisson":
        client = cls(address, **kw)
        reply = await client.node.execute("PING")
        if reply not in (b"PONG", "PONG"):
            raise ConnectionError(f"unexpected PING reply: {reply!r}")
        return client

    async def execute(self, *args, timeout: Optional[float] = None) -> Any:
        if args and C.is_blocking(args[0], args[1:]):  # normalizes str|bytes
            return await self.node.execute_blocking(*args, timeout=timeout)
        return await self.node.execute(*args, timeout=timeout)

    async def objcall(self, factory: str, name: str, method: str, args, kwargs) -> Any:
        payload = safe_pickle.dumps((args, kwargs))
        reply = await self.node.execute(
            "OBJCALL", factory, name, method, payload, self.caller_id()
        )
        return _unwrap(reply, self)

    # -- transactions ---------------------------------------------------------

    def create_transaction(self, options=None) -> "AsyncTransaction":
        return AsyncTransaction(self, options)

    def tx_groups(self, names: List[str]) -> Dict[Any, List[str]]:
        return {None: list(names)}

    async def txexec(self, group_key, versions, ops, timeout=None) -> List[Any]:
        reply = await self.node.execute(
            "TXEXEC", safe_pickle.dumps(versions), safe_pickle.dumps(ops),
            self.caller_id(), timeout=timeout,
        )
        return _unwrap_many(reply, self)

    # handles + caller_id come from _AsyncObjectSurface

    def _on_pubsub_push(self, p: Push) -> None:
        self._dispatch_message_push(p, self._sub_queues)

    async def _pubsub_connection(self) -> AsyncConnection:
        """ONE multiplexed pubsub connection for every channel (the sync
        client's PubSubConnection discipline) — re-opened with all active
        subscriptions re-attached if it drops (watchdog re-attach via the
        reader task's done-callback)."""
        if self._pubsub_lock is None:
            self._pubsub_lock = asyncio.Lock()
        async with self._pubsub_lock:  # concurrent first subscribes: one conn
            if self._closing:
                # aclose() racing a background reconnect: opening a fresh
                # connection here would leak it (nothing closes it afterwards)
                raise ConnectionError("client is closing")
            if self._pubsub is None or self._pubsub.closed:
                # carries the node's FULL transport config (TLS, username)
                conn = await self.node._make_connection().connect()
                conn.push_handler = self._on_pubsub_push
                for ch in self._sub_queues:
                    conn.send("SUBSCRIBE", ch)
                await conn.drain()
                conn._reader_task.add_done_callback(self._on_pubsub_dropped)
                self._pubsub = conn
            return self._pubsub

    def _on_pubsub_dropped(self, _task) -> None:
        """Reader task ended => the pubsub socket died.  Re-open in the
        background so existing subscriber queues keep receiving (the
        ConnectionWatchdog pubsub re-attach role)."""
        if self._closing or not self._sub_queues:
            return

        async def reconnect():
            delay = 0.2
            while not self._closing and self._sub_queues:
                try:
                    await self._pubsub_connection()
                    return
                except (ConnectionError, OSError):
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 5.0)

        try:
            asyncio.get_running_loop().create_task(reconnect())
        except RuntimeError:  # loop already closed (interpreter teardown)
            pass

    async def subscribe(self, channel: str) -> "asyncio.Queue":
        """Subscribe; returns a queue of (channel, payload) messages — the
        async analog of RTopic.addListener."""
        q: asyncio.Queue = asyncio.Queue()
        conn = await self._pubsub_connection()
        fresh = channel not in self._sub_queues
        self._sub_queues.setdefault(channel, []).append(q)
        if fresh:
            conn.send("SUBSCRIBE", channel)  # confirmation arrives as a push
            await conn.drain()
        return q

    async def unsubscribe(self, channel: str, queue: Optional["asyncio.Queue"] = None) -> None:
        """Detach one queue (or all) from a channel; sends UNSUBSCRIBE when
        the last queue goes."""
        queues = self._sub_queues.get(channel)
        if queues is None:
            return
        if queue is not None:
            try:
                queues.remove(queue)
            except ValueError:
                pass
        else:
            queues.clear()
        if not queues:
            self._sub_queues.pop(channel, None)
            if self._pubsub is not None and not self._pubsub.closed:
                self._pubsub.send("UNSUBSCRIBE", channel)
                await self._pubsub.drain()

    async def aclose(self) -> None:
        self._closing = True
        if self._pubsub is not None:
            await self._pubsub.close()
        await self.node.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.aclose()
        return False


class AsyncClusterRedisson(_AsyncObjectSurface):
    """Async slot-routed facade: the async counterpart of
    ClusterRedisson, consuming the SAME pure routing core
    (client/routing.py) — slot table from CLUSTER SLOTS, MOVED/ASK/TRYAGAIN
    redirect loop, per-shard pipeline grouping — over multiplexed
    AsyncNodeClients (one pipelined connection per master).

    Usage::

        client = await AsyncClusterRedisson.connect(["tpu://h1:p", "tpu://h2:p"])
        await client.execute("SET", "k", "v")
        m = client.get_map("m"); await m.put("a", 1)
        await client.aclose()
    """

    def __init__(
        self,
        seeds: List[str],
        password: Optional[str] = None,
        timeout: float = 30.0,
        max_redirects: int = 5,
        scan_interval: float = 5.0,
        username: Optional[str] = None,
        ssl_context=None,
        ssl_hostname: Optional[str] = None,
        nat_mapper=None,
    ):
        from redisson_tpu_torch.client import routing
        from redisson_tpu_torch.net.client import address_uses_tls, client_ssl_context

        self._routing = routing
        self._nat_mapper = nat_mapper  # NatMapper SPI (advertised -> reachable)
        self._seeds = list(seeds)
        self._password = password
        self._username = username
        if ssl_context is None and any(address_uses_tls(s) for s in seeds):
            ssl_context = client_ssl_context()  # scheme-driven default TLS
        self._ssl_context = ssl_context
        self._ssl_hostname = ssl_hostname
        self.timeout = timeout
        self.max_redirects = max_redirects
        self._scan_interval = scan_interval
        self._nodes: Dict[str, AsyncNodeClient] = {}  # "host:port" -> client
        self._slots: List[Optional[str]] = []
        self._masters: List[str] = []  # every master in the current view
        self._refresh_lock: Optional[asyncio.Lock] = None
        self._scan_task: Optional[asyncio.Task] = None
        self._closing = False
        self.codec: Codec = DEFAULT_CODEC
        self._pubsubs: Dict[str, AsyncConnection] = {}  # addr -> pubsub conn
        self._pubsub_locks: Dict[str, asyncio.Lock] = {}
        self._sub_queues: Dict[str, List["asyncio.Queue"]] = {}

    @classmethod
    async def connect(cls, seeds: List[str], **kw) -> "AsyncClusterRedisson":
        client = cls(seeds, **kw)
        if not await client.refresh_topology():
            await client.aclose()
            raise ConnectionError(f"no reachable cluster node among {seeds}")
        if client._scan_interval and client._scan_interval > 0:
            client._scan_task = asyncio.create_task(client._scan_loop())
        return client

    # -- topology -------------------------------------------------------------

    def _node(self, addr: str) -> AsyncNodeClient:
        node = self._nodes.get(addr)
        if node is None:
            node = self._nodes[addr] = AsyncNodeClient(
                addr,
                password=self._password,
                username=self._username,
                timeout=self.timeout,
                ssl_context=self._ssl_context,
                ssl_hostname=self._ssl_hostname,
            )
        return node

    async def refresh_topology(self) -> bool:
        if self._refresh_lock is None:
            self._refresh_lock = asyncio.Lock()
        async with self._refresh_lock:
            view = None
            for addr in list(self._nodes) + self._seeds:
                try:
                    view = await self._node_for_probe(addr).execute(
                        "CLUSTER", "SLOTS", timeout=5.0
                    )
                    break
                except Exception:  # noqa: BLE001 — try the next node
                    continue
            if view is None:
                return False
            new_slots, masters = self._routing.parse_view(view)
            nat = self._nat_mapper
            if nat is not None:
                table = {a: nat.map(a) for a in masters}
                new_slots = [None if a is None else table.get(a, a) for a in new_slots]
                masters = {table[a]: None for a in masters}
            stale = [a for a in self._nodes if a not in masters]
            self._slots = new_slots
            self._masters = list(masters)  # ALL masters, not just contacted
            for a in stale:
                node = self._nodes.pop(a)
                try:
                    await node.close()
                except Exception:  # noqa: BLE001
                    pass
            return True

    def _node_for_probe(self, addr: str) -> AsyncNodeClient:
        if addr in self._nodes:
            return self._nodes[addr]
        from redisson_tpu_torch.net.client import parse_address as _pa

        host, port = _pa(addr)
        return self._node(f"{host}:{port}")

    async def _scan_loop(self) -> None:
        while not self._closing:
            await asyncio.sleep(self._scan_interval)
            try:
                await self.refresh_topology()
            except Exception:  # noqa: BLE001 — keep scanning
                pass

    def _owner(self, slot: int) -> AsyncNodeClient:
        addr = self._slots[slot] if self._slots else None
        if addr is None:
            raise ConnectionError(f"no entry serves slot {slot}")
        return self._node(addr)

    # -- command path (async RedisExecutor redirect machine) -------------------

    async def execute(self, *cmd_args, timeout: Optional[float] = None) -> Any:
        R = self._routing
        cmd = str(cmd_args[0]).upper()
        if cmd in R.ALL_SHARD:
            return await self._execute_all_shards(cmd, cmd_args, timeout)
        slot, write = R.route(cmd, cmd_args[1:])
        if slot == R.SPLIT:
            return await self._execute_split_keys(cmd_args, timeout)
        last: Optional[BaseException] = None
        for attempt in range(self.max_redirects + 1):
            if self._closing:
                raise ConnectionError("client is closed")
            try:
                if slot is None:
                    if not self._nodes and not await self.refresh_topology():
                        raise ConnectionError("no cluster entries")
                    node = next(iter(self._nodes.values()))
                else:
                    node = self._owner(slot)
                if C.is_blocking(cmd_args[0], cmd_args[1:]):
                    # dedicated connection: a park must not head-of-line-
                    # block the shard's shared multiplexed FIFO
                    return await node.execute_blocking(*cmd_args, timeout=timeout)
                return await node.execute(*cmd_args, timeout=timeout)
            except RespError as e:
                kind, target = self._routing.classify_redirect(e)
                if kind == "moved":
                    last = e
                    await self.refresh_topology()
                    continue
                if kind == "ask":
                    try:
                        return await self._execute_asking(target, cmd_args, timeout)
                    except RespError as e2:
                        if self._routing.is_redirect(e2):
                            last = e2
                            await self.refresh_topology()
                            continue
                        raise
                    except (ConnectionError, OSError, TimeoutError) as e2:
                        if write and isinstance(e2, TimeoutError):
                            raise
                        last = e2
                        await self.refresh_topology()
                        await asyncio.sleep(min(0.1 * (attempt + 1), 1.0))
                        continue
                if kind == "tryagain":
                    last = e
                    await asyncio.sleep(min(0.05 * (attempt + 1), 0.5))
                    continue
                raise
            except (ConnectionError, OSError, TimeoutError) as e:
                if write and isinstance(e, TimeoutError):
                    # at-most-once for writes (the sync client's
                    # no-retry-after-write rule; see AsyncNodeClient.execute)
                    raise
                last = e
                await self.refresh_topology()
                await asyncio.sleep(min(0.1 * (attempt + 1), 1.0))
                continue
        assert last is not None
        raise last

    async def _execute_asking(self, target: str, cmd_args, timeout) -> Any:
        """ASKING + command back-to-back on the importing node.  Both frames
        are written in ONE event-loop step (no await between the two
        writes), so no other task's command can interleave on the shared
        multiplexed connection — the one-shot ASKING admission stays paired
        with OUR command."""
        node = self._node(target)
        if C.is_blocking(cmd_args[0], cmd_args[1:]):
            # a redirected BLPOP must not park the shard's shared FIFO
            return await node.execute_blocking(*cmd_args, timeout=timeout, asking=True)
        replies = await node.execute_pipeline(
            [("ASKING",), tuple(cmd_args)], timeout=timeout
        )
        reply = replies[1]
        if isinstance(reply, RespError):
            raise reply
        return reply

    async def _execute_all_shards(self, cmd: str, cmd_args, timeout) -> Any:
        mode = self._routing.ALL_SHARD[cmd]
        if not self._masters and not await self.refresh_topology():
            raise ConnectionError("no cluster entries")
        # fan out over EVERY master in the view — lazily-contacted nodes
        # alone would return partial KEYS/DBSIZE and partial FLUSHALL
        nodes = [self._node(a) for a in self._masters]
        replies = await asyncio.gather(
            *(n.execute(*cmd_args, timeout=timeout) for n in nodes)
        )
        if mode == "concat":
            out: List[Any] = []
            for r in replies:
                out.extend(r or [])
            return out
        if mode == "sum":
            return sum(int(r or 0) for r in replies)
        return "+OK"

    async def _execute_split_keys(self, cmd_args, timeout) -> Any:
        """Cross-slot DEL/UNLINK: ONE multi-key sub-command per slot (the
        sync client's grouping, never one round trip per key), slot groups
        concurrent, counts summed.  Each group re-enters execute() so the
        full redirect machinery applies per slot."""
        cmd, keys = str(cmd_args[0]), list(cmd_args[1:])
        groups = self._routing.group_by_slot(keys)
        counts = await asyncio.gather(
            *(self.execute(cmd, *ks, timeout=timeout) for ks in groups.values())
        )
        return sum(int(c or 0) for c in counts)

    async def execute_pipeline(
        self, commands: List[Tuple], timeout: Optional[float] = None
    ) -> List[Any]:
        """Per-shard grouped pipeline (the async executeBatchedAsync): one
        write burst per owning master, groups concurrent, results in
        submission order.  Rows that come back MOVED/ASK re-route through
        the single-command path."""
        cmds = [tuple(c) for c in commands]
        groups: Dict[Optional[str], List[int]] = {}
        for i, c in enumerate(cmds):
            slot, _w = self._routing.route(str(c[0]), c[1:])
            addr = None if slot in (None, self._routing.SPLIT) else (
                self._slots[slot] if self._slots else None
            )
            groups.setdefault(addr, []).append(i)
        results: List[Any] = [None] * len(cmds)

        async def run_group(addr, idxs):
            if addr is None:
                for i in idxs:
                    try:
                        results[i] = await self.execute(*cmds[i], timeout=timeout)
                    except Exception as e:  # noqa: BLE001 — errors stay as data
                        results[i] = e
                return
            node = self._node(addr)
            try:
                replies = await node.execute_pipeline([cmds[i] for i in idxs], timeout=timeout)
            except (ConnectionError, OSError) as e:
                for i in idxs:
                    try:
                        results[i] = await self.execute(*cmds[i], timeout=timeout)
                    except Exception as e2:  # noqa: BLE001
                        results[i] = e2
                return
            for i, r in zip(idxs, replies):
                if isinstance(r, RespError) and self._routing.is_redirect(r):
                    try:
                        r = await self.execute(*cmds[i], timeout=timeout)
                    except Exception as e:  # noqa: BLE001
                        r = e
                results[i] = r

        await asyncio.gather(*(run_group(a, idxs) for a, idxs in groups.items()))
        return results

    # -- object surface --------------------------------------------------------

    async def objcall(self, factory: str, name: str, method: str, args, kwargs) -> Any:
        payload = safe_pickle.dumps((args, kwargs))
        return _unwrap(
            await self.execute(
                "OBJCALL", factory, name, method, payload, self.caller_id()
            ),
            self,
        )

    async def objcall_many(self, ops: List[Tuple]) -> List[Any]:
        """Per-shard OBJCALLM grouping, groups concurrent (the async twin of
        ClusterRedisson.objcall_many; same at-most-once timeout rule)."""
        ops = [tuple(op) for op in ops]
        groups = self._routing.group_by_slot_owner(
            self._slots, [op[1] for op in ops]
        )
        results: List[Any] = [None] * len(ops)

        async def run_group(addr, idxs):
            node = self._node(addr) if addr else next(iter(self._nodes.values()))
            payload = safe_pickle.dumps([ops[i] for i in idxs])
            try:
                replies = _unwrap_many(
                    await node.execute("OBJCALLM", payload, self.caller_id()),
                    self,
                )
            except TimeoutError:
                raise  # frame may have executed: no per-op re-run (double-apply)
            except (ConnectionError, OSError):
                replies = []
                for i in idxs:
                    f, n, m, a, kw = ops[i][:5]
                    try:
                        replies.append(await self.objcall(f, n, m, a, kw))
                    except Exception as e:  # noqa: BLE001
                        replies.append(e)
            for i, r in zip(idxs, replies):
                if isinstance(r, RespError) and self._routing.is_redirect(r):
                    f, n, m, a, kw = ops[i][:5]
                    try:
                        r = await self.objcall(f, n, m, a, kw)
                    except Exception as e:  # noqa: BLE001
                        r = e
                results[i] = r

        await asyncio.gather(*(run_group(a, idxs) for a, idxs in groups.items()))
        return results

    # -- transactions ---------------------------------------------------------

    def create_transaction(self, options=None) -> "AsyncTransaction":
        return AsyncTransaction(self, options)

    def tx_groups(self, names: List[str]) -> Dict[Any, List[str]]:
        """One TXEXEC frame per slot owner (ClusterRedisson.tx_groups twin)."""
        names = list(names)
        groups = self._routing.group_by_slot_owner(self._slots, names)
        return {addr: [names[i] for i in idxs] for addr, idxs in groups.items()}

    async def txexec(self, group_key, versions, ops, timeout=None) -> List[Any]:
        node = (
            self._node(group_key) if group_key
            else next(iter(self._nodes.values()))
        )
        reply = await node.execute(
            "TXEXEC", safe_pickle.dumps(versions), safe_pickle.dumps(ops),
            self.caller_id(), timeout=timeout,
        )
        return _unwrap_many(reply, self)

    # handles + caller_id come from _AsyncObjectSurface

    # -- pubsub (slot-routed: subscriptions ride the channel owner) -----------

    def _on_push(self, p: Push) -> None:
        self._dispatch_message_push(p, self._sub_queues)

    def _channels_owned_by(self, addr: str) -> List[str]:
        from redisson_tpu_torch.utils.crc16 import calc_slot as _cs

        return [
            ch
            for ch in self._sub_queues
            if self._slots and self._slots[_cs(ch.encode())] == addr
        ]

    async def _pubsub_connection(self, addr: str) -> AsyncConnection:
        """Per-master pubsub connection, built under a per-address lock
        (concurrent first subscribes must not leak a connection) and
        re-attached with EVERY channel the address currently owns when
        rebuilt — the AsyncRemoteRedisson reconnect discipline, per shard."""
        lock = self._pubsub_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            if self._closing:
                raise ConnectionError("client is closing")
            conn = self._pubsubs.get(addr)
            if conn is None or conn.closed:
                from redisson_tpu_torch.net.client import parse_address as _pa

                host, port = _pa(addr)
                conn = await AsyncConnection(
                    host,
                    port,
                    password=self._password,
                    username=self._username,
                    ssl_context=self._ssl_context,
                    ssl_hostname=self._ssl_hostname,
                ).connect()
                conn.push_handler = self._on_push
                for ch in self._channels_owned_by(addr):
                    conn.send("SUBSCRIBE", ch)
                await conn.drain()
                conn._reader_task.add_done_callback(
                    lambda _t, a=addr: self._on_pubsub_dropped(a)
                )
                self._pubsubs[addr] = conn
            return conn

    def _on_pubsub_dropped(self, addr: str) -> None:
        if self._closing or not self._channels_owned_by(addr):
            return

        async def reconnect():
            delay = 0.2
            while not self._closing and self._channels_owned_by(addr):
                try:
                    await self._pubsub_connection(addr)
                    return
                except (ConnectionError, OSError):
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 5.0)

        try:
            asyncio.get_running_loop().create_task(reconnect())
        except RuntimeError:  # loop already closed
            pass

    async def subscribe(self, channel: str) -> "asyncio.Queue":
        """Subscribe on the channel's slot-owner master (SSUBSCRIBE
        semantics — publishes route to the same node, so fan-out holds)."""
        from redisson_tpu_torch.utils.crc16 import calc_slot as _cs

        addr = self._slots[_cs(channel.encode())] if self._slots else None
        if addr is None:
            raise ConnectionError(f"no owner for channel {channel!r}")
        q: asyncio.Queue = asyncio.Queue()
        fresh = channel not in self._sub_queues
        self._sub_queues.setdefault(channel, []).append(q)
        conn = await self._pubsub_connection(addr)
        if fresh and not conn.closed:
            # a brand-new channel on a LIVE connection still needs its
            # SUBSCRIBE; if _pubsub_connection just rebuilt the connection it
            # already attached this channel — the duplicate SUBSCRIBE is
            # idempotent server-side (per-connection subscription set)
            conn.send("SUBSCRIBE", channel)
            await conn.drain()
        return q

    async def aclose(self) -> None:
        self._closing = True
        if self._scan_task is not None:
            self._scan_task.cancel()
            try:
                await self._scan_task
            except asyncio.CancelledError:
                pass
        for conn in self._pubsubs.values():
            await conn.close()
        for node in self._nodes.values():
            await node.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.aclose()
        return False




class AsyncBloomFilter:
    """Async hot-path bloom handle: int batches ride blob commands
    (BF.MADD64/BF.MEXISTS64 — one frame per flush, the north-star wire
    form) instead of pickled OBJCALL round trips; everything else falls
    through to the generic proxy surface."""

    def __init__(self, client, name: str):
        self._client = client
        self.name = name
        self._proxy = AsyncObjectProxy(client, "get_bloom_filter", name)

    async def try_init(self, expected_insertions: int, false_probability: float) -> bool:
        from redisson_tpu_torch.client.remote import reserve_exists

        try:
            await self._client.execute(
                "BF.RESERVE", self.name, repr(false_probability), expected_insertions
            )
            return True
        except RespError as e:
            if reserve_exists(e):
                return False  # already initialized: the documented False
            raise  # bad params / routing exhaustion must not masquerade

    async def add_each(self, keys):
        import numpy as np

        from redisson_tpu_torch.client.remote import bool_reply, int64_blob

        if isinstance(keys, np.ndarray) and keys.dtype.kind in "iu":
            out = await self._client.execute("BF.MADD64", self.name, int64_blob(keys))
            return bool_reply(out)
        return np.asarray(await self._proxy.add_each(keys), dtype=bool)

    async def add_all(self, keys) -> int:
        return int((await self.add_each(keys)).sum())

    async def contains_each(self, keys):
        import numpy as np

        from redisson_tpu_torch.client.remote import bool_reply, int64_blob

        if isinstance(keys, np.ndarray) and keys.dtype.kind in "iu":
            out = await self._client.execute("BF.MEXISTS64", self.name, int64_blob(keys))
            return bool_reply(out)
        return np.asarray(await self._proxy.contains_each(keys), dtype=bool)

    def __getattr__(self, method: str):
        # count(), is_exists(), delete(), ... ride the generic OBJCALL proxy
        return getattr(self._proxy, method)


# -- transactions (async facade) ----------------------------------------------


class AsyncTransaction:
    """Optimistic transaction for the async clients — the awaitable shell of
    services/transactions.RemoteTransaction (RTransactionReactive/Rx role,
    re-expressed as ONE native-async API per SURVEY.md §7.4): reads ride
    OBJCALLV and record the observed record version; commit ships version
    preconditions + buffered ops as per-owner TXEXEC frames (check-only
    phase first when the commit spans shards, so a conflict anywhere aborts
    with nothing applied anywhere)."""

    def __init__(self, client, options=None):
        from redisson_tpu_torch.services.transactions import TransactionOptions

        self._client = client
        self._options = options or TransactionOptions.defaults()
        self._ops: List[tuple] = []  # wire op tuples
        self._op_names: List[str] = []
        self._read_versions: Dict[str, int] = {}
        self._local: Dict[Tuple[str, Any], Any] = {}
        self._deleted: set = set()
        self._state = "active"
        self._created_at = None  # stamped lazily (loop time needs a loop)
        import time as _time

        self._created_at = _time.time()

    # -- views ---------------------------------------------------------------

    def get_bucket(self, name: str) -> "AsyncTxBucket":
        return AsyncTxBucket(self, name)

    def get_buckets(self) -> "AsyncTxBuckets":
        return AsyncTxBuckets(self)

    def get_map(self, name: str) -> "AsyncTxMap":
        return AsyncTxMap(self, "get_map", name)

    def get_map_cache(self, name: str) -> "AsyncTxMapCache":
        return AsyncTxMapCache(self, "get_map_cache", name)

    def get_set(self, name: str) -> "AsyncTxSet":
        return AsyncTxSet(self, "get_set", name)

    def get_set_cache(self, name: str) -> "AsyncTxSetCache":
        return AsyncTxSetCache(self, "get_set_cache", name)

    # -- plumbing ------------------------------------------------------------

    def _check_active(self):
        import time as _time

        from redisson_tpu_torch.services.transactions import TransactionException

        if self._state != "active":
            raise TransactionException(f"transaction is {self._state}")
        if _time.time() - self._created_at > self._options.timeout:
            self._state = "timed_out"
            self._ops.clear()
            self._local.clear()
            raise TransactionException("transaction timed out")

    def _buffer(self, factory, name, method, *args, **kwargs):
        self._check_active()
        self._ops.append((factory, name, method, args, kwargs))
        self._op_names.append(name)

    async def _read(self, factory, name, method, *args, **kwargs):
        self._check_active()
        payload = safe_pickle.dumps((args, kwargs))
        reply = await self._client.execute(
            "OBJCALLV", factory, name, method, payload,
            self._client.caller_id(),
            timeout=self._options.response_timeout,
        )
        version, result = _unwrap(reply, self._client)
        self._read_versions.setdefault(name, version)
        return result

    # -- lifecycle -----------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    async def commit(self) -> None:
        from redisson_tpu_torch.services.transactions import TransactionException

        self._check_active()
        try:
            await self._commit_frames()
        except TransactionException:
            self._state = "rolled_back"
            raise
        self._state = "committed"

    async def rollback(self) -> None:
        self._check_active()
        self._ops.clear()
        self._local.clear()
        self._deleted.clear()
        self._read_versions.clear()
        self._state = "rolled_back"

    async def __aenter__(self):
        return self

    async def __aexit__(self, exc_type, exc, tb):
        if exc_type is None and self._state == "active":
            await self.commit()
        elif self._state == "active":
            await self.rollback()
        return False

    # -- commit frames -------------------------------------------------------

    async def _commit_frames(self) -> None:
        """Awaitable shell around the SHARED CommitPlan (services/
        transactions.py): frame planning, check-phase eligibility,
        no-re-send-of-applied-frames retry, and partial-commit
        classification all live in the one sync planner — only the awaiting
        differs from RemoteTransaction._commit_frames."""
        from redisson_tpu_torch.services.transactions import (
            CommitPlan,
            TransactionException,
        )

        versions = dict(self._read_versions)
        all_names = sorted(set(versions) | set(self._op_names))
        if not all_names:
            return
        plan = CommitPlan(versions, list(self._ops), list(self._op_names), all_names)
        attempts = max(1, self._options.retry_attempts)
        timeout = self._options.response_timeout
        for attempt in range(attempts):
            frames = plan.frames(self._client.tx_groups(plan.remaining()))
            if not frames:
                return
            try:
                if plan.needs_check_phase(frames):
                    for key, _names, vsub, _osub in frames:
                        if vsub:
                            await self._client.txexec(key, vsub, [], timeout=timeout)
                results: List[Any] = []
                for key, names, vsub, osub in frames:
                    results.extend(
                        await self._client.txexec(key, vsub, osub, timeout=timeout)
                    )
                    plan.done.update(names)
                errs = [r for r in results if isinstance(r, BaseException)]
                if errs:
                    raise TransactionException(
                        f"transaction op failed: {errs[0]!r}"
                    ) from errs[0]
                return
            except RespError as e:
                action = plan.classify(str(e), attempt, attempts)
                if action == "conflict":
                    raise TransactionException(
                        str(e).replace("TXCONFLICT ", "", 1)
                    ) from None
                if action == "partial":
                    raise plan.partial_error(str(e)) from None
                if action == "retry":
                    refresh = getattr(self._client, "refresh_topology", None)
                    if refresh is not None:
                        await refresh()
                    await asyncio.sleep(
                        min(self._options.retry_interval, 0.25 * (attempt + 1))
                    )
                    continue
                raise


class _AsyncTxView:
    def __init__(self, tx: AsyncTransaction, factory: str, name: str):
        self._tx = tx
        self._factory = factory
        self._name = name
        self._enc = DEFAULT_CODEC

    @property
    def name(self) -> str:
        return self._name


class AsyncTxBucket(_AsyncTxView):
    def __init__(self, tx: AsyncTransaction, name: str):
        super().__init__(tx, "get_bucket", name)

    def _key(self):
        return (self._name, None)

    async def get(self):
        self._tx._check_active()
        key = self._key()
        if key in self._tx._deleted:
            return None
        if key in self._tx._local:
            return self._tx._local[key]
        return await self._tx._read(self._factory, self._name, "get")

    async def set(self, value) -> None:
        key = self._key()
        self._tx._local[key] = value
        self._tx._deleted.discard(key)
        self._tx._buffer(self._factory, self._name, "set", value)

    async def try_set(self, value) -> bool:
        if await self.get() is not None:
            return False
        await self.set(value)
        return True

    async def compare_and_set(self, expect, update) -> bool:
        if await self.get() != expect:
            return False
        await self.set(update)
        return True

    async def get_and_set(self, value):
        cur = await self.get()
        await self.set(value)
        return cur

    async def delete(self) -> None:
        key = self._key()
        self._tx._deleted.add(key)
        self._tx._local.pop(key, None)
        self._tx._buffer(self._factory, self._name, "delete")


class AsyncTxBuckets:
    def __init__(self, tx: AsyncTransaction):
        self._tx = tx

    async def get(self, *names: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for nm in names:
            v = await AsyncTxBucket(self._tx, nm).get()
            if v is not None:
                out[nm] = v
        return out

    async def set(self, values: Dict[str, Any]) -> None:
        for nm, v in values.items():
            await AsyncTxBucket(self._tx, nm).set(v)

    async def try_set(self, values: Dict[str, Any]) -> bool:
        buckets = {nm: AsyncTxBucket(self._tx, nm) for nm in sorted(values)}
        for b in buckets.values():
            if await b.get() is not None:
                return False
        for nm, b in buckets.items():
            await b.set(values[nm])
        return True


class AsyncTxMap(_AsyncTxView):
    def _key(self, k):
        return (self._name, self._enc.encode_map_key(k))

    async def get(self, k):
        self._tx._check_active()
        key = self._key(k)
        if key in self._tx._deleted:
            return None
        if key in self._tx._local:
            return self._tx._local[key]
        return await self._tx._read(self._factory, self._name, "get", k)

    async def contains_key(self, k) -> bool:
        return await self.get(k) is not None

    async def put(self, k, v):
        prev = await self.get(k)
        await self.fast_put(k, v)
        return prev

    async def fast_put(self, k, v) -> None:
        key = self._key(k)
        self._tx._local[key] = v
        self._tx._deleted.discard(key)
        self._tx._buffer(self._factory, self._name, "fast_put", k, v)

    async def put_all(self, entries: Dict) -> None:
        for k, v in entries.items():
            await self.fast_put(k, v)

    async def put_if_absent(self, k, v):
        prev = await self.get(k)
        if prev is not None:
            return prev
        await self.fast_put(k, v)
        return None

    async def replace(self, k, v):
        prev = await self.get(k)
        if prev is None:
            return None
        await self.fast_put(k, v)
        return prev

    async def remove(self, k):
        prev = await self.get(k)
        if prev is not None:
            await self.fast_remove(k)
        return prev

    async def fast_remove(self, *keys) -> None:
        for k in keys:
            key = self._key(k)
            self._tx._deleted.add(key)
            self._tx._local.pop(key, None)
        self._tx._buffer(self._factory, self._name, "fast_remove", *keys)


class AsyncTxMapCache(AsyncTxMap):
    async def put_with_ttl(self, k, v, ttl: Optional[float] = None):
        prev = await self.get(k)
        key = self._key(k)
        self._tx._local[key] = v
        self._tx._deleted.discard(key)
        self._tx._buffer(self._factory, self._name, "put_with_ttl", k, v, ttl=ttl)
        return prev


class AsyncTxSet(_AsyncTxView):
    def _key(self, v):
        return (self._name, self._enc.encode(v))

    async def contains(self, v) -> bool:
        self._tx._check_active()
        key = self._key(v)
        if key in self._tx._deleted:
            return False
        if key in self._tx._local:
            return True
        return bool(await self._tx._read(self._factory, self._name, "contains", v))

    async def add(self, v) -> None:
        key = self._key(v)
        self._tx._local[key] = v
        self._tx._deleted.discard(key)
        self._tx._buffer(self._factory, self._name, "add", v)

    async def remove(self, v) -> None:
        key = self._key(v)
        self._tx._deleted.add(key)
        self._tx._local.pop(key, None)
        self._tx._buffer(self._factory, self._name, "remove", v)


class AsyncTxSetCache(AsyncTxSet):
    async def add(self, v, ttl: Optional[float] = None) -> None:
        key = self._key(v)
        self._tx._local[key] = v
        self._tx._deleted.discard(key)
        if ttl is None:
            self._tx._buffer(self._factory, self._name, "add", v)
        else:
            self._tx._buffer(self._factory, self._name, "add", v, ttl)


# -- typed async sketch fast paths ---------------------------------------------
# Mirror the sync client's coalesced blob forms so the async facade's hot
# sketch paths (bloom bank, HLL bank, bitset blobs) ride ONE blob frame +
# ONE fused kernel per flush instead of the generic OBJCALL pickle path.


class AsyncBloomFilterArray:
    """Async multi-tenant bloom bank (BFA.* blob commands — the config2
    serving shape)."""

    def __init__(self, client, name: str):
        self._client = client
        self.name = name
        self._proxy = AsyncObjectProxy(client, "get_bloom_filter_array", name)

    async def try_init(self, tenants: int, expected_insertions: int,
                       false_probability: float) -> bool:
        try:
            await self._client.execute(
                "BFA.RESERVE", self.name, tenants, expected_insertions,
                repr(false_probability),
            )
            return True
        except RespError:
            return False

    @staticmethod
    def _blobs(tenant_ids, keys):
        import numpy as np

        t = np.ascontiguousarray(np.asarray(tenant_ids), dtype="<i4").tobytes()
        k = np.ascontiguousarray(np.asarray(keys), dtype="<i8").tobytes()
        return t, k

    async def add_each(self, tenant_ids, keys):
        import numpy as np

        t, k = self._blobs(tenant_ids, keys)
        out = await self._client.execute("BFA.MADD64", self.name, t, k)
        return np.frombuffer(out, np.uint8).astype(bool)

    async def contains(self, tenant_ids, keys):
        import numpy as np

        t, k = self._blobs(tenant_ids, keys)
        out = await self._client.execute("BFA.MEXISTS64", self.name, t, k)
        return np.frombuffer(out, np.uint8).astype(bool)

    def __getattr__(self, method: str):
        return getattr(self._proxy, method)


class AsyncHyperLogLogArray:
    """Async multi-tenant HLL bank (HLLA.* blob commands)."""

    def __init__(self, client, name: str):
        self._client = client
        self.name = name
        self._proxy = AsyncObjectProxy(client, "get_hyper_log_log_array", name)

    async def try_init(self, tenants: int) -> bool:
        return bool(await self._client.execute("HLLA.RESERVE", self.name, tenants))

    async def add(self, tenant_ids, keys) -> None:
        import numpy as np

        t = np.ascontiguousarray(np.asarray(tenant_ids), dtype="<i4").tobytes()
        k = np.ascontiguousarray(np.asarray(keys), dtype="<i8").tobytes()
        await self._client.execute("HLLA.MADD64", self.name, t, k)

    async def merge_rows(self, dst_ids, src_ids) -> None:
        import numpy as np

        d = np.ascontiguousarray(np.asarray(dst_ids), dtype="<i4").tobytes()
        s = np.ascontiguousarray(np.asarray(src_ids), dtype="<i4").tobytes()
        await self._client.execute("HLLA.MERGEROWS", self.name, d, s)

    async def estimate_all(self):
        import numpy as np

        out = await self._client.execute("HLLA.ESTIMATE", self.name)
        return np.frombuffer(out, "<f8").copy()

    async def estimate_union_pairs(self, a_ids, b_ids):
        import numpy as np

        a = np.ascontiguousarray(np.asarray(a_ids), dtype="<i4").tobytes()
        b = np.ascontiguousarray(np.asarray(b_ids), dtype="<i4").tobytes()
        out = await self._client.execute("HLLA.ESTPAIRS", self.name, a, b)
        return np.frombuffer(out, "<f8").copy()

    def __getattr__(self, method: str):
        return getattr(self._proxy, method)


class AsyncBitSet:
    """Async bitset with the blob batch forms (SETBITSB/GETBITSB: one i32
    index buffer up, one byte blob back)."""

    def __init__(self, client, name: str):
        self._client = client
        self.name = name
        self._proxy = AsyncObjectProxy(client, "get_bit_set", name)

    async def set(self, index: int, value: bool = True) -> bool:
        return bool(await self._client.execute(
            "SETBIT", self.name, index, 1 if value else 0
        ))

    async def get(self, index: int) -> bool:
        return bool(await self._client.execute("GETBIT", self.name, index))

    async def set_each(self, indexes, value: bool = True):
        import numpy as np

        if not value:
            return await self._proxy.set_each(np.asarray(indexes), False)
        blob = np.ascontiguousarray(np.asarray(indexes), dtype="<i4").tobytes()
        out = await self._client.execute("SETBITSB", self.name, blob)
        return np.frombuffer(out, np.uint8).astype(bool)

    async def get_each(self, indexes):
        import numpy as np

        blob = np.ascontiguousarray(np.asarray(indexes), dtype="<i4").tobytes()
        out = await self._client.execute("GETBITSB", self.name, blob)
        return np.frombuffer(out, np.uint8).astype(bool)

    async def cardinality(self) -> int:
        return int(await self._client.execute("BITCOUNT", self.name))

    def __getattr__(self, method: str):
        return getattr(self._proxy, method)


def _surface_get_bloom_filter_array(self, name: str) -> AsyncBloomFilterArray:
    return AsyncBloomFilterArray(self, name)


def _surface_get_hyper_log_log_array(self, name: str) -> AsyncHyperLogLogArray:
    return AsyncHyperLogLogArray(self, name)


def _surface_get_bit_set(self, name: str) -> AsyncBitSet:
    return AsyncBitSet(self, name)


_AsyncObjectSurface.get_bloom_filter_array = _surface_get_bloom_filter_array
_AsyncObjectSurface.get_hyper_log_log_array = _surface_get_hyper_log_log_array
_AsyncObjectSurface.get_bit_set = _surface_get_bit_set
