"""ClusterSupervisor: one server OS process per node, for real.

Parity target: the reference's ``RedisRunner.java`` — spawn/stop/restart
actual ``redis-server`` processes and form clusters out of them.  A copy of
``redisson_tpu/cluster/supervisor.py`` on the port's server
(``python -m redisson_tpu_torch.server``):

  * each node is a real subprocess with its own log file and its own GIL;
  * readiness is a **ready-line protocol** (``--ready-fd``): the child
    writes ``READY <host> <port> <pid>`` to an inherited pipe once its
    listener is bound — no sleep-polling, and port 0 round-trips the
    kernel-chosen port back to the supervisor;
  * chaos is delivered as actual signals — ``kill(node)`` defaults to
    SIGKILL, SIGSTOP/SIGCONT freeze/thaw a live process, SIGTERM is the
    graceful path;
  * every reap records the exit code on the node
    (``NodeProc.exit_codes``), and ``log_tail`` surfaces the child's
    output for post-mortems: the port's server logs the device it serves
    on at start and its kernel launches at a graceful stop;
  * topology wiring goes through :mod:`redisson_tpu_torch.cluster.topology`
    — the SAME slot-assignment program the in-process harness uses;
  * replicas (``replicas_per_master > 0``) are processes of their own,
    placed off their master's host when ``hosts`` allows (anti-affinity),
    attached by REPLICAOF at start and re-attached by ``restart`` (a
    restarted replica re-syncs; a restarted master's replicas re-register).

Devices: ``platform=None`` (the default) starts every child on the CUDA
card; ``platform="cpu"`` passes ``--device cpu``.  A child asked for the
card that finds none exits non-zero and ``wait_ready`` raises
:class:`NodeStartupError` with its log tail; nothing falls back to the CPU.
A node killed while it holds the card is fine: CUDA frees a dead process's
context.

WHERE a node runs is a :class:`~redisson_tpu_torch.cluster.hostdriver.HostDriver`
decision: :class:`LocalHostDriver` (default) spawns subprocesses,
:class:`SshHostDriver` spawns nodes over a command transport with the same
ready-line/signal/reap contract, and a fleet with any genuinely remote host
arms TLS by default.

Checkpoints: every node has its own checkpoint path
(``<base_dir>/<node>/ckpt/head.ckpt``, passed as ``--checkpoint``), where
SAVE and ``SHUTDOWN SAVE`` write, and ``checkpoint_interval > 0`` arms each
node's ``AutoCheckpointer`` (``--checkpoint-interval``), which also takes a
final snapshot when the node is SIGTERM'd.  ``restart`` passes ``--restore`` once the
node's checkpoint exists, so the fresh process comes back with the records
of its last snapshot.  ``scrape`` merges every live node's METRICS with
``node=`` labels.

Left out until their slice, each raising NotImplementedError:
``promote_replica`` and ``rolling_restart`` (ROADMAP M11 part 4); no
``--journal-dir`` is passed (the port's server refuses it until part 4).  ``start_qos_rebalance`` runs the fleet's
tenant budget loop (``cluster/qos_control.py``) over the masters, and
``shutdown`` stops it.
"""
from __future__ import annotations

import ipaddress
import os
import select
import signal
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from redisson_tpu_torch.cluster import topology
from redisson_tpu_torch.cluster.hostdriver import (
    HostDriver, LocalHostDriver, NodeHandle,
)
from redisson_tpu_torch.net.client import Connection
from redisson_tpu_torch.net.retry import RetryPolicy, call_with_retry

#: the implicit single-domain label a host-unaware supervisor places on
_LOCAL_HOST_LABEL = "local"

_M11 = "comes with the migration slice (ROADMAP M11 part 4)"

#: the view-learning schedule for a node rejoining the fleet: its peers may
#: themselves be restarting, so a refused connect retries instead of failing
#: the whole restart
_REJOIN_RETRY = RetryPolicy(max_attempts=5, base_delay=0.1, max_delay=1.0,
                            jitter=0.2, deadline_s=20.0)


class NodeStartupError(RuntimeError):
    """A spawned node died (or went silent) before reporting ready; carries
    the exit code and a log tail so the failure is diagnosable."""


class NodeProc:
    """One supervised server process: identity, liveness, history.  The
    process itself lives behind a :class:`NodeHandle` — local child or
    ssh'd remote, the supervisor's contract is the same."""

    def __init__(self, name: str, role: str, base_dir: str,
                 master_index: Optional[int] = None,
                 host_label: str = _LOCAL_HOST_LABEL):
        self.name = name
        self.role = role  # "master" | "replica"
        self.master_index = master_index
        self.base_dir = base_dir
        self.host_label = host_label  # failure domain (driver-interpreted)
        self.checkpoint_path = os.path.join(base_dir, "ckpt", "head.ckpt")
        self.log_path = os.path.join(base_dir, "server.log")
        self.host = "127.0.0.1"
        self.port = 0            # learned from the first ready line, then pinned
        self.node_id: Optional[str] = None  # CLUSTER MYID (fresh per process)
        self.handle: Optional[NodeHandle] = None
        self.generation = 0      # +1 per successful spawn
        self.exit_codes: List[int] = []  # every reaped exit status, in order

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def pid(self) -> Optional[int]:
        return self.handle.pid if self.handle is not None else None

    def alive(self) -> bool:
        return self.handle is not None and self.handle.poll() is None

    def reap(self) -> Optional[int]:
        """Collect the exit code of a dead process (no-op while alive)."""
        if self.handle is None:
            return self.exit_codes[-1] if self.exit_codes else None
        rc = self.handle.poll()
        if rc is None:
            return None
        self.exit_codes.append(rc)
        self.handle.release()
        self.handle = None
        return rc




class ClusterSupervisor:
    """Spawn, wire, kill, and restart a multi-process server cluster.

    Usage::

        sup = ClusterSupervisor(masters=2).start()   # every node on the card
        try:
            client = sup.client()          # slot-routed, real TCP
            sup.kill(sup.masters[0])       # SIGKILL — a real dead process
            sup.restart(sup.masters[0])    # same port, fresh process,
                                           # --restore from its checkpoint
        finally:
            sup.shutdown()

    Cross-host: ``ClusterSupervisor(masters=2, replicas_per_master=1,
    hosts=("hostA", "hostB"), driver=SshHostDriver(...))`` places masters
    round-robin and replicas off their master's host, spawns over the
    driver, and arms fleet TLS automatically (``tls=False`` opts out,
    ``tls=True`` forces it for local fleets)."""

    def __init__(
        self,
        masters: int = 2,
        replicas_per_master: int = 0,
        base_dir: Optional[str] = None,
        password: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        server_args: Sequence[str] = (),
        platform: Optional[str] = None,
        checkpoint_interval: float = 0.0,
        ready_timeout: float = 90.0,
        driver: Optional[HostDriver] = None,
        hosts: Optional[Sequence[str]] = None,
        tls: Optional[bool] = None,
    ):
        self.n_masters = masters
        self.replicas_per_master = replicas_per_master
        self.password = password
        self.extra_env = dict(env or {})
        self.server_args = list(server_args)
        # None = the card (the child's own default); "cpu" = --device cpu
        self.platform = platform
        self.checkpoint_interval = checkpoint_interval
        # covers a child's import of torch and its CUDA start
        self.ready_timeout = ready_timeout
        self.driver = driver if driver is not None else LocalHostDriver()
        self.tls = tls  # None = auto: on iff any host is remote
        self._tls_cert: Optional[str] = None
        self._tls_key: Optional[str] = None
        self._client_ssl = None
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="rtpu-cluster-")
        self.slot_ranges = topology.split_slots(masters)
        # failure-domain placement: explicit hosts= engages anti-affinity
        # (loudly degraded when impossible); a host-unaware supervisor is
        # ONE implicit domain
        if hosts:
            self.hosts = list(hosts)
            self._master_hosts, self._replica_hosts = topology.assign_hosts(
                self.hosts, masters, replicas_per_master
            )
        else:
            self.hosts = [_LOCAL_HOST_LABEL]
            self._master_hosts = [_LOCAL_HOST_LABEL] * masters
            self._replica_hosts = {
                (mi, r): _LOCAL_HOST_LABEL
                for mi in range(masters) for r in range(replicas_per_master)
            }
        self.masters: List[NodeProc] = []
        self.replicas: List[NodeProc] = []
        self._qos_rebalancer = None

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "ClusterSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def nodes(self) -> List[NodeProc]:
        return self.masters + self.replicas

    def nodes_on(self, host: str) -> List[NodeProc]:
        """Every node placed in failure domain ``host``."""
        return [n for n in self.nodes() if n.host_label == host]

    def start(self) -> "ClusterSupervisor":
        try:
            self._arm_tls()
            for i in range(self.n_masters):
                node = self._make_node(
                    f"m{i}", "master", host_label=self._master_hosts[i]
                )
                self.masters.append(node)
                self._spawn(node)
            for mi in range(self.n_masters):
                for r in range(self.replicas_per_master):
                    node = self._make_node(
                        f"r{mi}-{r}", "replica", master_index=mi,
                        host_label=self._replica_hosts[(mi, r)],
                    )
                    self.replicas.append(node)
                    self._spawn(node)
            for node in self.nodes():
                self.wait_ready(node)
            self.install_topology()
        except BaseException:
            # a half-started fleet must not leak OS processes OR driver-held
            # remote resources (ssh channels, emitted specs): reap everything
            # already spawned, then let the driver drop what only IT can see,
            # before surfacing the failure
            self.shutdown()
            self.driver.on_start_failure()
            raise
        return self

    def shutdown(self) -> None:
        """SIGTERM everything (graceful), escalate to SIGKILL on stragglers,
        reap every exit code.  Bounded end to end: a wedged node
        (SIGSTOPped) cannot stall the teardown — SIGKILL reaps even a
        stopped process.  Driver-held resources (ssh channels) are released
        last.  The QoS rebalancer stops first."""
        self.stop_qos_rebalance()
        for node in self.nodes():
            if node.alive():
                node.handle.signal(signal.SIGTERM)
        deadline = time.monotonic() + 15.0
        for node in self.nodes():
            if node.handle is None:
                continue
            self._reap_escalating(
                node, max(0.1, deadline - time.monotonic())
            )
        self.driver.close()

    def _reap_escalating(self, node: NodeProc, grace: float) -> Optional[int]:
        """Bounded reap of a process that was just signalled: wait `grace`
        for a voluntary exit, SIGKILL on expiry, bound the post-kill wait
        too.  Records the exit code (it still lands in ``exit_codes`` on the
        escalated path); returns None only if even SIGKILL cannot reap in
        time (uninterruptible D-state) — the next ``reap()`` collects it."""
        if node.handle is None:
            return node.exit_codes[-1] if node.exit_codes else None
        if node.handle.wait(grace) is None:
            node.handle.force_kill()
            if node.handle.wait(10.0) is None:
                node.handle.close_ready()
                return None
        node.handle.close_ready()
        return node.reap()

    # -- spawning ------------------------------------------------------------

    def _make_node(self, name: str, role: str,
                   master_index: Optional[int] = None,
                   host_label: str = _LOCAL_HOST_LABEL) -> NodeProc:
        base = os.path.join(self.base_dir, name)
        os.makedirs(base, exist_ok=True)
        return NodeProc(
            name, role, base, master_index=master_index,
            host_label=host_label,
        )

    def _server_cli(self, node: NodeProc, restore: bool = False) -> List[str]:
        """The full server CLI for one node — everything except
        ``--ready-fd``, which the driver owns (local: inherited pipe fd;
        ssh: fd 3 dup'd onto the channel's stdout)."""
        bind = self.driver.bind_host(node.host_label)
        cmd = [
            "--host", bind if bind is not None else node.host,
            "--port", str(node.port),
        ]
        connect = self.driver.connect_address(node.host_label)
        if connect is not None and connect != (bind or node.host):
            # cross-host nodes bind wide but are NAMED by their routable
            # address everywhere (views, READY)
            cmd += ["--advertise-host", connect]
        cmd += ["--checkpoint", node.checkpoint_path]
        if self.checkpoint_interval > 0:
            cmd += ["--checkpoint-interval", str(self.checkpoint_interval)]
        if restore and os.path.exists(node.checkpoint_path):
            cmd.append("--restore")
        if self.password:
            cmd += ["--password", self.password]
        if self.platform:
            cmd += ["--device", self.platform]
        if self.tls_armed:
            # every node gets the fleet cert: client listeners refuse
            # plaintext fleet-wide, not just on the remote hops
            cmd += ["--tls-cert", self._tls_cert, "--tls-key", self._tls_key]
        cmd += self.server_args
        return cmd

    def _spawn(self, node: NodeProc, restore: bool = False) -> None:
        node.handle = self.driver.spawn(
            node.name, node.host_label, self._server_cli(node, restore),
            node.log_path, dict(self.extra_env),
            ensure_dirs=(os.path.dirname(node.checkpoint_path),),
        )
        node.generation += 1

    def wait_ready(self, node: NodeProc, timeout: Optional[float] = None) -> NodeProc:
        """Block until the node's ready line arrives (no sleep-polling: the
        child writes ``READY <host> <port> <pid>`` the moment its listener
        is bound).  Learns the kernel-assigned port on first boot and the
        fresh node id every boot.  A child that dies first raises
        :class:`NodeStartupError` with its exit code and log tail."""
        deadline = time.monotonic() + (timeout or self.ready_timeout)
        buf = b""
        handle = node.handle
        assert handle is not None, f"{node.name}: no spawn in flight"
        rfd = handle.ready_fd()
        assert rfd is not None, f"{node.name}: ready channel already closed"
        try:
            while b"\n" not in buf:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise NodeStartupError(
                        f"{node.name}: no ready line within "
                        f"{timeout or self.ready_timeout:.0f}s\n"
                        + self.log_tail(node)
                    )
                ready, _, _ = select.select([rfd], [], [], min(remain, 0.25))
                if not ready:
                    if not node.alive():
                        rc = node.reap()
                        raise NodeStartupError(
                            f"{node.name}: died before ready (exit {rc})\n"
                            + self.log_tail(node)
                        )
                    continue
                chunk = os.read(rfd, 4096)
                if not chunk:  # EOF without a ready line
                    rc = node.reap() if not node.alive() else None
                    raise NodeStartupError(
                        f"{node.name}: ready pipe closed before READY "
                        f"(exit {rc})\n" + self.log_tail(node)
                    )
                buf += chunk
        finally:
            handle.close_ready()
        line = buf.split(b"\n", 1)[0].decode(errors="replace").split()
        if len(line) < 3 or line[0] != "READY":
            raise NodeStartupError(f"{node.name}: bad ready line {line!r}")
        if len(line) >= 4:
            # remote handles learn their signal target (the REMOTE pid) here
            handle.note_ready(line[1], int(line[2]), int(line[3]))
        # connect address: the driver's word beats the READY line's bind
        # host (a remote node binding 0.0.0.0 is reached by its host's
        # routable address, not by what it bound)
        node.host = handle.connect_host or line[1]
        node.port = int(line[2])
        with self.conn(node) as c:
            node.node_id = topology._s(
                topology.check_reply(c.execute("CLUSTER", "MYID"))
            )
        return node

    # -- TLS (cross-host bus) -------------------------------------------------

    @property
    def tls_armed(self) -> bool:
        return self._tls_cert is not None

    def _arm_tls(self) -> None:
        """TLS-by-default for fleets that leave the machine: ``tls=None``
        arms iff the driver reports any host as remote (plaintext stays
        the loopback default), ``tls=True`` forces arming.  The supervisor
        generates ONE self-signed fleet cert (openssl CLI) that every node
        loads — servers refuse plaintext at the handshake.  Ssh nodes read
        the cert over the shared filesystem (see hostdriver module docs)."""
        want = self.tls if self.tls is not None else any(
            self.driver.is_remote(h) for h in self.hosts
        )
        if not want:
            return
        tls_dir = os.path.join(self.base_dir, "tls")
        cert = os.path.join(tls_dir, "fleet.crt")
        key = os.path.join(tls_dir, "fleet.key")
        if not (os.path.exists(cert) and os.path.exists(key)):
            os.makedirs(tls_dir, exist_ok=True)
            sans = ["DNS:localhost", "IP:127.0.0.1"]
            for h in self.hosts:
                try:
                    ipaddress.ip_address(h)
                    sans.append(f"IP:{h}")
                except ValueError:
                    sans.append(f"DNS:{h}")
            subprocess.run(
                ["openssl", "req", "-x509", "-newkey", "rsa:2048",
                 "-keyout", key, "-out", cert, "-days", "2", "-nodes",
                 "-subj", "/CN=rtpu-fleet",
                 "-addext", "subjectAltName=" + ",".join(dict.fromkeys(sans))],
                check=True, capture_output=True,
            )
        self._tls_cert, self._tls_key = cert, key

    def client_ssl_context(self):
        """The coordinator/client-side SSL context for this fleet's bus
        (None when plaintext): trusts the fleet cert as its own root,
        hostname checks off — fleet peers are addressed by IP/labels, and
        the chain pin is what keeps plaintext and foreign certs out."""
        if not self.tls_armed:
            return None
        if self._client_ssl is None:
            from redisson_tpu_torch.net.client import client_ssl_context

            self._client_ssl = client_ssl_context(
                ca_file=self._tls_cert, verify_hostname=False,
            )
        return self._client_ssl

    # -- chaos / process control ----------------------------------------------

    def kill(self, node: NodeProc, sig: int = signal.SIGKILL) -> Optional[int]:
        """Deliver a real signal.  SIGKILL (the default) reaps and returns
        the exit code — the process is DEAD, its GIL, sockets, and device
        state gone with it.  SIGSTOP/SIGCONT return None (still alive)."""
        if node.handle is None:
            return node.exit_codes[-1] if node.exit_codes else None
        node.handle.signal(sig)
        if sig in (signal.SIGSTOP, signal.SIGCONT):
            return None
        return self._reap_escalating(node, 30.0)

    def kill_host(self, host: str,
                  sig: int = signal.SIGKILL) -> Dict[str, Optional[int]]:
        """A whole failure domain dies AT ONCE: signal every
        node on ``host`` first — concurrently dead, the way a machine
        loses power — then reap them under one shared deadline.  Returns
        ``{node name: exit code}`` (None entries for SIGSTOP/SIGCONT,
        which leave the domain frozen/thawed rather than dead)."""
        victims = [n for n in self.nodes_on(host) if n.handle is not None]
        for n in victims:
            n.handle.signal(sig)
        if sig in (signal.SIGSTOP, signal.SIGCONT):
            return {n.name: None for n in victims}
        deadline = time.monotonic() + 30.0
        return {
            n.name: self._reap_escalating(
                n, max(0.1, deadline - time.monotonic())
            )
            for n in victims
        }

    def stop(self, node: NodeProc, timeout: float = 15.0) -> Optional[int]:
        """Graceful SIGTERM, escalating to SIGKILL after the `timeout` grace
        period — a wedged node (SIGSTOPped) cannot stall a teardown; its
        exit code is still recorded.  Returns the exit code."""
        if node.handle is None:
            return node.exit_codes[-1] if node.exit_codes else None
        node.handle.signal(signal.SIGTERM)
        return self._reap_escalating(node, timeout)

    def pause(self, node: NodeProc) -> None:
        """SIGSTOP: the real hung-but-accepting failure mode — the kernel
        keeps the listen socket, the process answers nothing."""
        self.kill(node, signal.SIGSTOP)

    def resume(self, node: NodeProc) -> None:
        self.kill(node, signal.SIGCONT)

    def wait_exit(self, node: NodeProc, timeout: float = 30.0) -> Optional[int]:
        if node.handle is not None:
            node.handle.wait(timeout)
        return node.reap()


    def restart(self, node: NodeProc, restore: bool = True,
                force: bool = False) -> NodeProc:
        """Bring a dead node back on the SAME address.  **Idempotent**: a
        node that is still alive is left untouched (double restart is a
        no-op — the supervisor never kills a healthy process by accident)
        unless ``force=True``, which first stops it through the escalating
        SIGTERM→SIGKILL path.  The fresh process ``--restore``\\ s its
        checkpoint (when one exists) and relearns the cluster view from a
        live peer, retried under :class:`~redisson_tpu_torch.net.retry.RetryPolicy`:
        the view is re-fetched inside every attempt across ALL live nodes,
        so a peer that died between attempts costs one retry, not the
        restart.  The replica links the death severed are re-wired: a
        replica re-syncs from its master, a master's replicas re-register
        with the fresh process."""
        if node.alive():
            if not force:
                return node
            self.stop(node)
        node.reap()  # capture the exit code before respawning
        self._spawn(node, restore=restore)
        self.wait_ready(node)

        def _relearn_view() -> None:
            # fetched INSIDE the retry: each attempt re-selects a live peer
            view = self.current_view()
            if view:
                topology.install_view([self._conn_factory(node)], view)

        call_with_retry(_REJOIN_RETRY, _relearn_view)
        if node.role == "replica" and node.master_index is not None:
            master = self.masters[node.master_index]
            if master.alive():
                call_with_retry(
                    _REJOIN_RETRY,
                    lambda: topology.wire_replica(
                        self._conn_factory(node), master.host, master.port
                    ),
                )
        elif node.role == "master":
            # replicas of THIS master lost their push registration with the
            # old process: re-attach them
            for rep in self.replicas:
                if rep.master_index is not None \
                        and self.masters[rep.master_index] is node \
                        and rep.alive():
                    call_with_retry(
                        _REJOIN_RETRY,
                        lambda rep=rep: topology.wire_replica(
                            self._conn_factory(rep), node.host, node.port
                        ),
                    )
        return node

    # -- fleet lifecycle (ROADMAP M11) -----------------------------------------

    def promote_replica(self, master: NodeProc) -> Optional[NodeProc]:
        raise NotImplementedError(f"promote_replica {_M11}")

    def rolling_restart(self, nodes=None, grace: float = 15.0,
                        health_timeout: float = 60.0):
        raise NotImplementedError(f"rolling_restart {_M11}")

    # -- topology -------------------------------------------------------------

    def planned_view(self) -> List[topology.ViewRow]:
        return topology.view_tuples(
            self.slot_ranges,
            [
                (m.host, m.port, m.node_id) if m.node_id else None
                for m in self.masters
            ],
        )

    def current_view(self) -> List[topology.ViewRow]:
        """The view as the LIVE cluster knows it: asked from any live node
        that has one installed, falling back to the plan.  Each peer probe
        is BOUNDED (5s) so one wedged-but-accepting node — SIGSTOPped —
        degrades to the next peer, not a 30s stall per restart."""
        for node in self.nodes():
            if not node.alive():
                continue
            try:
                with self.conn(node, timeout=5.0) as c:
                    view = topology.fetch_view(c)
            except Exception:  # noqa: BLE001 — try the next node
                continue
            # a node with no installed view reports the single-node default
            # (itself owning 0..16383): not a cluster view, keep looking
            if len(view) == 1 and view[0][0] == 0 and len(self.masters) > 1 \
                    and (view[0][2], view[0][3]) == (node.host, node.port):
                continue
            if view:
                return view
        return self.planned_view()

    def install_topology(self) -> None:
        """Initial wiring: push the planned view everywhere, attach replicas
        — the same program ClusterRunner runs, through cluster/topology."""
        topology.install_view(
            [self._conn_factory(n) for n in self.nodes() if n.alive()],
            self.planned_view(),
        )
        for rep in self.replicas:
            master = self.masters[rep.master_index]
            if rep.alive() and master.alive():
                topology.wire_replica(
                    self._conn_factory(rep), master.host, master.port
                )

    # -- access ---------------------------------------------------------------

    def conn(self, node: NodeProc, timeout: float = 30.0):
        """Context-managed admin connection to one node (real TCP; TLS when
        the fleet bus is armed)."""
        from contextlib import closing

        return closing(Connection(
            node.host, node.port, timeout=timeout, password=self.password,
            ssl_context=self.client_ssl_context(),
        ))

    def _conn_factory(self, node: NodeProc):
        return lambda: self.conn(node)

    def seeds(self) -> List[str]:
        return [n.address for n in self.nodes() if n.alive()]

    def client(self, **kw):
        """Slot-routed cluster client over the live processes."""
        from redisson_tpu_torch.client.cluster import ClusterRedisson

        kw.setdefault("timeout", 60.0)
        if self.password is not None:
            kw.setdefault("password", self.password)
        if self.tls_armed:
            kw.setdefault("ssl_context", self.client_ssl_context())
        return ClusterRedisson(self.seeds(), **kw)

    def start_qos_rebalance(self, global_rate: float, *,
                            global_burst: Optional[float] = None,
                            interval: float = 1.0,
                            min_share: float = 0.05,
                            tenant_weights: Optional[Dict[str, float]] = None):
        """Arm the fleet-wide tenant budget loop (``cluster/qos_control.py``,
        reference ``cluster/supervisor.py:839-880``): scrape every master's
        ``CLUSTER QOS`` tenant table and re-split each tenant's
        ``global_rate`` (times its weight, ``tenant_weights``) across the
        masters by observed demand, pushed by ``CLUSTER QOS REBALANCE``.
        Masters only: replicas admit no writes.  The connections are the
        fleet's own (TLS and password included).  Idempotent; stopped by
        ``stop_qos_rebalance`` and by ``shutdown``."""
        from redisson_tpu_torch.cluster.qos_control import QosRebalancer

        if self._qos_rebalancer is not None:
            return self._qos_rebalancer
        factories = {n.address: self._conn_factory(n) for n in self.masters}
        self._qos_rebalancer = QosRebalancer(
            factories, global_rate, global_burst=global_burst,
            interval=interval, min_share=min_share,
            tenant_weights=tenant_weights,
        ).start()
        return self._qos_rebalancer

    def stop_qos_rebalance(self) -> None:
        rb, self._qos_rebalancer = self._qos_rebalancer, None
        if rb is not None:
            rb.stop()

    def scrape(self) -> str:
        """Fleet-wide Prometheus scrape: pull ``METRICS`` from every live
        node and merge the expositions with per-node ``node="host:port"``
        labels (the ``METRICS CLUSTER`` verb is the wire half; both ride
        ``utils.metrics.merge_prometheus_texts``).  Dead or unreachable
        nodes contribute nothing rather than failing the scrape."""
        from redisson_tpu_torch.utils.metrics import merge_prometheus_texts

        texts: Dict[str, str] = {}
        for node in self.nodes():
            if not node.alive():
                continue
            try:
                with self.conn(node, timeout=10.0) as c:
                    texts[node.address] = bytes(c.execute("METRICS")).decode()
            except Exception:  # noqa: BLE001 — scrape the rest of the fleet
                continue
        return merge_prometheus_texts(texts)

    def log_tail(self, node: NodeProc, max_bytes: int = 4096) -> str:
        try:
            with open(node.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - max_bytes))
                return f.read().decode(errors="replace")
        except OSError:
            return "<no log>"
