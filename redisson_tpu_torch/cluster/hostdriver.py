"""Host drivers: WHERE a supervised server node runs.

Every fleet this repo ever killed, rolled, promoted, or resharded ran its
nodes as subprocesses of ONE operating system.  The fleet-lifecycle
machinery (``ClusterSupervisor``, journaled migration, promotion, rolling
restart) was deliberately written against an abstract node — spawn it,
learn its READY line, signal it, reap its exit code — so breaking the
single-machine wall is an *extraction*, not a rewrite: this module names
that abstract node :class:`NodeHandle` and the thing that makes one a
:class:`HostDriver`.

  * :class:`LocalHostDriver` — the subprocess path:
    ``python -m redisson_tpu_torch.server`` children with an inherited ready-fd
    pipe, per-node log files, signals via ``os.kill``.  Host labels are
    *logical* failure domains (anti-affinity placement and
    ``kill_host`` still mean something on one box — that is how the host
    soak runs in CI).
  * :class:`SshHostDriver` — spawns the node on a REMOTE host over ssh.
    The ready-line protocol rides the ssh channel (remote fd 3 is the
    channel's stdout, the server's own stdout/stderr are redirected to a
    remote log), signals are delivered as remote ``kill`` commands against
    the pid the READY line reported.  The transport is pluggable
    (:class:`SshTransport` for a real sshd, :class:`LoopbackTransport` to
    run the identical command pipeline through ``/bin/sh`` on this
    machine), so the whole codepath — remote spawn, ready-over-channel,
    signal-by-command, exit propagation — is CI-testable with no sshd.
  * :class:`K8sDriver` — pure codegen: emits one deterministic pod spec
    (JSON, ``kubectl apply``-able) per node, with host anti-affinity
    expressed as ``podAntiAffinity`` on master/replica labels and TLS
    certs mounted from a named secret.  It supervises nothing; it exists
    so a fleet plan renders to manifests that are golden-file tested.

Shared-filesystem note: ``SshHostDriver`` assumes the checkout, checkpoint
directories, and (when TLS is armed) the cert files are visible on the
remote host at the same paths — true for loopback CI and NFS-backed pods;
shipping artifacts to genuinely disjoint filesystems is named in the
README as what remains.

A copy of ``redisson_tpu/cluster/hostdriver.py`` whose drivers start the
port's server (``python -m redisson_tpu_torch.server``).  A node asked for
the card (no ``--device cpu`` among its arguments) that finds none exits
non-zero before its ready line, and the supervisor raises
``NodeStartupError``: nothing falls back to the CPU.
"""
from __future__ import annotations

import json
import os
import shlex
import signal as _signal
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def _default_repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


class NodeHandle:
    """One spawned node, however it runs: readiness fd, liveness, signals.

    The supervisor only ever talks to this interface — ``NodeProc`` holds
    one and ``ClusterSupervisor`` never touches a ``Popen`` directly, so
    the same kill/restart/promotion code drives local children and ssh'd
    remotes."""

    #: address clients should connect to; None = trust the READY line's
    #: host field (the local-subprocess convention)
    connect_host: Optional[str] = None

    def ready_fd(self) -> Optional[int]:
        """Readable fd the READY line will arrive on (None once closed)."""
        raise NotImplementedError

    def close_ready(self) -> None:
        raise NotImplementedError

    def note_ready(self, host: str, port: int, pid: int) -> None:
        """The parsed READY line — remote handles learn their signal
        target (the REMOTE pid) here."""

    @property
    def pid(self) -> Optional[int]:
        raise NotImplementedError

    def poll(self) -> Optional[int]:
        """Exit code if the node is dead, else None."""
        raise NotImplementedError

    def wait(self, timeout: float) -> Optional[int]:
        """Bounded wait; None on timeout (never raises TimeoutExpired)."""
        raise NotImplementedError

    def signal(self, sig: int) -> None:
        raise NotImplementedError

    def force_kill(self) -> None:
        """SIGKILL-equivalent, the escalation terminus."""
        raise NotImplementedError

    def release(self) -> None:
        """Close every resource this handle holds (fds, channels).  Safe
        to call twice; does not touch the process."""
        raise NotImplementedError


class HostDriver:
    """Spawns nodes on hosts.  One driver serves a whole supervisor."""

    name = "abstract"

    def spawn(self, node_name: str, host: str, args: Sequence[str],
              log_path: str, env: Dict[str, str],
              ensure_dirs: Sequence[str] = ()) -> NodeHandle:
        """Start the server with ``args`` (the full CLI *except*
        ``--ready-fd``, which the driver owns) on ``host``; stdout/stderr
        go to ``log_path``; ``env`` entries are applied ON TOP of the
        host's inherited environment."""
        raise NotImplementedError

    def is_remote(self, host: str) -> bool:
        """True when nodes on ``host`` are reached over a network hop —
        the supervisor arms TLS-by-default for fleets with any remote
        host (plaintext only for loopback)."""
        return False

    def connect_address(self, host: str) -> Optional[str]:
        """Address clients use for nodes on ``host`` (None = whatever the
        READY line says, i.e. the node's own bind host)."""
        return None

    def bind_host(self, host: str) -> Optional[str]:
        """Listener bind address for nodes on ``host`` (None = the
        supervisor's per-node default, 127.0.0.1)."""
        return None

    def on_start_failure(self) -> None:
        """Called (before the raise) when a supervisor ``start()`` dies
        half-way: release driver-held resources the per-node reap cannot
        see — open channels, emitted specs (the half-started-fleet
        discipline, extended to remote resources)."""

    def close(self) -> None:
        """Terminal cleanup; every handle this driver spawned is already
        released by the supervisor's reap path."""


# -- local subprocesses -------------------------------------------------------

class LocalNodeHandle(NodeHandle):
    def __init__(self, proc: subprocess.Popen, ready_rfd: int):
        self.proc = proc
        self._ready_rfd: Optional[int] = ready_rfd

    def ready_fd(self) -> Optional[int]:
        return self._ready_rfd

    def close_ready(self) -> None:
        if self._ready_rfd is not None:
            try:
                os.close(self._ready_rfd)
            except OSError:
                pass
            self._ready_rfd = None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def wait(self, timeout: float) -> Optional[int]:
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def signal(self, sig: int) -> None:
        try:
            os.kill(self.proc.pid, sig)
        except ProcessLookupError:
            pass

    def force_kill(self) -> None:
        self.proc.kill()

    def release(self) -> None:
        self.close_ready()


class LocalHostDriver(HostDriver):
    """Today's supervisor spawn path, behavior-preserving: a child
    ``python -m redisson_tpu_torch.server`` with the ready-pipe write end
    inherited, appended-to log file, its own session (signals hit THIS
    pid only), and the repo root prepended to the child's PYTHONPATH.
    Host labels are logical failure domains only — everything runs on
    this OS."""

    name = "local"

    def __init__(self, repo_root: Optional[str] = None):
        self.repo_root = repo_root or _default_repo_root()

    def spawn(self, node_name: str, host: str, args: Sequence[str],
              log_path: str, env: Dict[str, str],
              ensure_dirs: Sequence[str] = ()) -> NodeHandle:
        for d in ensure_dirs:
            os.makedirs(d, exist_ok=True)
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = self.repo_root + (
            os.pathsep + child_env["PYTHONPATH"]
            if child_env.get("PYTHONPATH") else ""
        )
        child_env.update(env)
        rfd, wfd = os.pipe()
        try:
            cmd = [sys.executable, "-m", "redisson_tpu_torch.server",
                   *args, "--ready-fd", str(wfd)]
            with open(log_path, "ab") as log:
                proc = subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT,
                    pass_fds=(wfd,), env=child_env,
                    start_new_session=True,  # our signals hit THIS pid only
                )
        except BaseException:
            # spawn failed before the child owned the pipe: close both ends
            # here or repeated failed restarts leak fds until EMFILE
            for fd in (rfd, wfd):
                try:
                    os.close(fd)
                except OSError:
                    pass
            raise
        os.close(wfd)  # child holds the write end now
        return LocalNodeHandle(proc, rfd)


# -- ssh-spawned remotes ------------------------------------------------------

class SshTransport:
    """Run remote commands through a real ssh client (BatchMode: no
    interactive auth — CI keys or agent only)."""

    def argv(self, host: str, remote_cmd: str) -> List[str]:
        return ["ssh", "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=accept-new",
                host, remote_cmd]


class LoopbackTransport:
    """The command-transport fake: 'remote' commands run through
    ``/bin/sh -c`` on this machine, so the ENTIRE ssh codepath — spawn
    pipeline, ready-over-channel-stdout, signal-by-remote-kill, exit
    propagation — exercises in CI with no sshd.  The host label is
    ignored (everything is this box)."""

    def argv(self, host: str, remote_cmd: str) -> List[str]:
        return ["/bin/sh", "-c", remote_cmd]


class SshNodeHandle(NodeHandle):
    """A node reached through a command transport: the local child is the
    ssh client (or ``/bin/sh`` for the loopback fake), the node is the
    REMOTE process the READY line names.  Liveness tracks the transport
    child — ssh exits when the remote command does, propagating its exit
    status (128+signal becomes the Popen-style negative signal number so
    kill assertions read the same as local handles)."""

    def __init__(self, driver: "SshHostDriver", host: str,
                 proc: subprocess.Popen, connect_host: str):
        self.driver = driver
        self.host = host
        self.proc = proc
        self.connect_host = connect_host
        self.remote_pid: Optional[int] = None
        self._ready_closed = False

    def ready_fd(self) -> Optional[int]:
        if self._ready_closed or self.proc.stdout is None:
            return None
        return self.proc.stdout.fileno()

    def close_ready(self) -> None:
        if not self._ready_closed and self.proc.stdout is not None:
            try:
                self.proc.stdout.close()
            except OSError:
                pass
            self._ready_closed = True

    def note_ready(self, host: str, port: int, pid: int) -> None:
        self.remote_pid = pid

    @property
    def pid(self) -> Optional[int]:
        # the NODE's identity is the remote pid; before READY it is unknown
        return self.remote_pid if self.remote_pid is not None else self.proc.pid

    @staticmethod
    def _map_rc(rc: Optional[int]) -> Optional[int]:
        # a remote command killed by signal N surfaces as exit 128+N
        # through a real sshd; normalize to the Popen convention (-N) so
        # `rc == -SIGKILL` assertions hold on both transports
        if rc is not None and rc > 128 and rc <= 128 + 64:
            return -(rc - 128)
        return rc

    def poll(self) -> Optional[int]:
        return self._map_rc(self.proc.poll())

    def wait(self, timeout: float) -> Optional[int]:
        try:
            return self._map_rc(self.proc.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            return None

    def signal(self, sig: int) -> None:
        if self.remote_pid is None:
            return  # never became ready: nothing addressable to signal
        self.driver._run_remote(
            self.host, f"kill -{int(sig)} {self.remote_pid}"
        )

    def force_kill(self) -> None:
        if self.remote_pid is not None:
            self.driver._run_remote(
                self.host, f"kill -{int(_signal.SIGKILL)} {self.remote_pid}"
            )
            if self.wait(5.0) is not None:
                return
        # channel wedged or node never ready: last resort is the local
        # transport child (a real remote may orphan; the reap stays bounded)
        try:
            self.proc.kill()
        except OSError:
            pass

    def release(self) -> None:
        self.close_ready()
        if self.proc.stderr is not None:
            try:
                self.proc.stderr.close()
            except OSError:
                pass
        self.driver._forget(self)


class SshHostDriver(HostDriver):
    """Spawn the server on remote hosts over a command transport.

    The remote pipeline (one ``sh`` line, see :meth:`_remote_script`):
    duplicate the channel's stdout onto fd 3, redirect the server's own
    stdout/stderr into a remote log file, then ``exec`` the server with
    ``--ready-fd 3`` — so the READY line is the ONLY thing that ever
    travels the channel's stdout and the protocol the supervisor reads is
    byte-identical to the local pipe's."""

    name = "ssh"

    def __init__(self, transport=None, python: Optional[str] = None,
                 repo_root: Optional[str] = None, bind_host: str = "0.0.0.0",
                 connect_addresses: Optional[Dict[str, str]] = None):
        self.transport = transport or SshTransport()
        self.python = python or sys.executable
        self.repo_root = repo_root or _default_repo_root()
        self._bind_host = bind_host
        self._connect = dict(connect_addresses or {})
        self._handles: List[SshNodeHandle] = []
        self._lock = threading.Lock()

    # loopback labels stay plaintext-eligible even through this driver
    def is_remote(self, host: str) -> bool:
        return host not in _LOOPBACK

    def connect_address(self, host: str) -> Optional[str]:
        if host in self._connect:
            return self._connect[host]
        # the loopback fake runs every "remote" node on this box: whatever
        # the host label says, the node is reachable only at 127.0.0.1
        if isinstance(self.transport, LoopbackTransport):
            return "127.0.0.1"
        return host

    def bind_host(self, host: str) -> Optional[str]:
        return self._bind_host

    def _remote_script(self, args: Sequence[str], log_path: str,
                       env: Dict[str, str],
                       ensure_dirs: Sequence[str]) -> str:
        mkdirs = " ".join(
            shlex.quote(d)
            for d in [*ensure_dirs, os.path.dirname(log_path) or "."]
        )
        envs = " ".join(
            f"{k}={shlex.quote(v)}" for k, v in sorted({
                "PYTHONPATH": self.repo_root, **env,
            }.items())
        )
        argv = " ".join(shlex.quote(str(a)) for a in args)
        return (
            f"mkdir -p {mkdirs} && "
            # fd 3 = the channel's stdout (READY only); server output -> log
            f"exec 3>&1 && exec >>{shlex.quote(log_path)} 2>&1 && "
            f"exec env {envs} {shlex.quote(self.python)} "
            f"-m redisson_tpu_torch.server {argv} --ready-fd 3"
        )

    def spawn(self, node_name: str, host: str, args: Sequence[str],
              log_path: str, env: Dict[str, str],
              ensure_dirs: Sequence[str] = ()) -> NodeHandle:
        script = self._remote_script(args, log_path, env, ensure_dirs)
        proc = subprocess.Popen(
            self.transport.argv(host, script),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            stdin=subprocess.DEVNULL, start_new_session=True,
        )
        handle = SshNodeHandle(self, host, proc, self.connect_address(host))
        with self._lock:
            self._handles.append(handle)
        return handle

    def _run_remote(self, host: str, cmd: str) -> int:
        try:
            return subprocess.run(
                self.transport.argv(host, cmd),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                stdin=subprocess.DEVNULL, timeout=15.0, check=False,
            ).returncode
        except (OSError, subprocess.TimeoutExpired):
            return -1

    def _forget(self, handle: "SshNodeHandle") -> None:
        with self._lock:
            if handle in self._handles:
                self._handles.remove(handle)

    def on_start_failure(self) -> None:
        self.close()

    def close(self) -> None:
        """Release every channel still held (half-started fleets included:
        the supervisor's failure path lands here via on_start_failure)."""
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            h.close_ready()
            if h.proc.stderr is not None:
                try:
                    h.proc.stderr.close()
                except OSError:
                    pass
        with self._lock:
            self._handles.clear()


# -- kubernetes pod-spec emission (pure codegen) ------------------------------

class K8sDriver(HostDriver):
    """Render a fleet plan to Kubernetes pod specs — deterministic JSON
    (``kubectl apply -f`` accepts JSON), one pod per node, golden-file
    tested.  This driver supervises nothing: :meth:`spawn` refuses loudly.

    The failure-domain story maps onto the scheduler instead of the
    supervisor: every pod carries ``rtpu/role`` + ``rtpu/master`` labels
    and each replica pod a REQUIRED ``podAntiAffinity`` against its
    master's pod on ``kubernetes.io/hostname`` — the same invariant
    :func:`redisson_tpu_torch.cluster.topology.assign_hosts` enforces for
    driver-placed fleets, expressed in the dialect k8s enforces natively."""

    name = "k8s"

    def __init__(self, image: str = "redisson-tpu:latest",
                 namespace: str = "default", app: str = "rtpu",
                 tls_secret: Optional[str] = None):
        self.image = image
        self.namespace = namespace
        self.app = app
        self.tls_secret = tls_secret
        self._emitted: List[str] = []

    def spawn(self, node_name, host, args, log_path, env, ensure_dirs=()):
        raise NotImplementedError(
            "K8sDriver is codegen-only: emit() pod specs and apply them; "
            "the kubelet is the process supervisor"
        )

    def pod_spec(self, name: str, role: str, port: int,
                 args: Sequence[str] = (),
                 master: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None) -> dict:
        labels = {"app": self.app, "rtpu/role": role, "rtpu/node": name}
        if master is not None:
            labels["rtpu/master"] = master
        container = {
            "name": "tpu-server",
            "image": self.image,
            "args": ["--host", "0.0.0.0", "--port", str(port), *map(str, args)],
            "ports": [{"containerPort": port, "name": "resp"}],
            # the READY-line analog: routable only once the listener binds
            "readinessProbe": {
                "tcpSocket": {"port": port},
                "periodSeconds": 1,
                "failureThreshold": 60,
            },
            "volumeMounts": [
                {"name": "ckpt", "mountPath": "/var/lib/rtpu/ckpt"},
            ],
        }
        if env:
            container["env"] = [
                {"name": k, "value": v} for k, v in sorted(env.items())
            ]
        volumes: List[dict] = [{"name": "ckpt", "emptyDir": {}}]
        if self.tls_secret:
            container["volumeMounts"].append(
                {"name": "tls", "mountPath": "/var/lib/rtpu/tls",
                 "readOnly": True}
            )
            container["args"] += [
                "--tls-cert", "/var/lib/rtpu/tls/tls.crt",
                "--tls-key", "/var/lib/rtpu/tls/tls.key",
            ]
            volumes.append(
                {"name": "tls", "secret": {"secretName": self.tls_secret}}
            )
        spec: dict = {"containers": [container], "volumes": volumes}
        if role == "replica" and master is not None:
            # host anti-affinity, REQUIRED: a replica pod never schedules
            # onto its master's kubelet host (assign_hosts' invariant in
            # the scheduler's own dialect)
            spec["affinity"] = {
                "podAntiAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": [{
                        "labelSelector": {"matchLabels": {
                            "app": self.app, "rtpu/node": master,
                        }},
                        "topologyKey": "kubernetes.io/hostname",
                    }],
                },
            }
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"{self.app}-{name}",
                "namespace": self.namespace,
                "labels": labels,
            },
            "spec": spec,
        }

    def manifest(self, plan: Sequence[dict]) -> str:
        """One deterministic ``v1/List`` document for a whole fleet plan
        (rows: ``{"name", "role", "port", "args"?, "master"?, "env"?}``).
        Byte-stable for identical plans — the golden-file contract."""
        items = [
            self.pod_spec(
                row["name"], row["role"], int(row["port"]),
                args=row.get("args", ()), master=row.get("master"),
                env=row.get("env"),
            )
            for row in plan
        ]
        doc = {"apiVersion": "v1", "kind": "List", "items": items}
        return json.dumps(doc, indent=2, sort_keys=True) + "\n"

    def emit(self, plan: Sequence[dict], out_dir: str) -> List[str]:
        """Write one ``<app>-<name>.json`` per node; returns the paths.
        Emitted paths are tracked so a half-started orchestration can
        :meth:`discard` them (the boot-failure cleanup discipline)."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for row in plan:
            spec = self.pod_spec(
                row["name"], row["role"], int(row["port"]),
                args=row.get("args", ()), master=row.get("master"),
                env=row.get("env"),
            )
            path = os.path.join(out_dir, f"{self.app}-{row['name']}.json")
            with open(path, "w") as f:
                json.dump(spec, f, indent=2, sort_keys=True)
                f.write("\n")
            paths.append(path)
            self._emitted.append(path)
        return paths

    def discard(self) -> List[str]:
        """Remove every spec this driver emitted (partial-start cleanup);
        returns what was removed."""
        removed = []
        for path in self._emitted:
            try:
                os.unlink(path)
                removed.append(path)
            except OSError:
                pass
        self._emitted.clear()
        return removed

    def on_start_failure(self) -> None:
        self.discard()
