"""Config system: typed knobs + YAML/JSON loading with env-var substitution.

A copy of ``redisson_tpu/config.py``.  Parity target:
``org/redisson/config/Config.java:57-99`` (global knobs with defaults:
threads=16, lockWatchdogTimeout=30s, eviction delays) plus the per-mode
server configs (``config/BaseConfig.java``,
``BaseMasterSlaveServersConfig.java``, ``ClusterServersConfig.java``:
retryAttempts=3, retryInterval, timeout, pingConnectionInterval,
scanInterval, pool sizes) and the YAML/JSON loaders with ``${ENV_VAR}``
substitution (``config/Config.java:601-631``, ``ConfigSupport.java``).

What the port reads: the engine's expiry sweep (``core/eviction.py``) its
two cleanup delays, every object handle and ``Keys`` map names through
``name_mapper``, the wire clients the single-server and cluster sections
and the ``command_mapper``, ``credentials_resolver`` and ``nat_mapper``
SPI slots (``client/remote.py``, ``client/cluster.py``).  The replicated
section parses, but its client (``client/replicated.py``) comes with the
replication slice (ROADMAP M11); the batching knobs parse for config-file
parity and are read by nothing yet.  The mesh knobs drive the sharded
objects' mesh (``parallel/manager.MeshManager``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_ENV_PATTERN = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::([^}]*))?\}")


def _substitute_env(text: str) -> str:
    """``${VAR}`` / ``${VAR:default}`` substitution (ConfigSupport analog)."""

    def repl(m: re.Match) -> str:
        var, default = m.group(1), m.group(2)
        val = os.environ.get(var)
        if val is None:
            if default is not None:
                return default
            raise KeyError(f"environment variable '{var}' is not set and has no default")
        return val

    return _ENV_PATTERN.sub(repl, text)


@dataclass
class SingleServerConfig:
    """Client/remote mode target (SingleServerConfig analog)."""

    address: str = "tpu://127.0.0.1:6379"
    database: int = 0
    username: Optional[str] = None
    password: Optional[str] = None
    client_name: Optional[str] = None
    # connection behavior (BaseConfig defaults)
    connect_timeout: float = 10.0            # connectTimeout 10s
    timeout: float = 3.0                     # command response timeout 3s
    retry_attempts: int = 3                  # retryAttempts=3
    retry_interval: float = 1.5              # retryInterval=1500ms
    ping_connection_interval: float = 30.0   # pingConnectionInterval=30s
    keep_alive: bool = True
    # pool sizing (connection pool analog)
    connection_pool_size: int = 8            # reference default 64 (JVM); net thread count here
    connection_minimum_idle_size: int = 1
    subscription_connection_pool_size: int = 2
    # TLS (BaseConfig SSL knobs; active for tpus://-scheme addresses or
    # whenever a CA/cert is configured — RedisChannelInitializer.java:110-219)
    ssl_ca_file: Optional[str] = None               # sslTruststore analog
    ssl_cert_file: Optional[str] = None             # sslKeystore (client cert)
    ssl_key_file: Optional[str] = None
    ssl_verify_hostname: bool = True                # sslEnableEndpointIdentification

    def build_ssl_context(self):
        """SSLContext when TLS applies (scheme or explicit knobs), else None."""
        from redisson_tpu_torch.net.client import address_uses_tls, client_ssl_context

        if not (address_uses_tls(self.address) or self.ssl_ca_file or self.ssl_cert_file):
            return None
        return client_ssl_context(
            self.ssl_ca_file, self.ssl_cert_file, self.ssl_key_file,
            self.ssl_verify_hostname,
        )


@dataclass
class ClusterServersConfig:
    """Cluster mode (ClusterServersConfig analog)."""

    node_addresses: List[str] = field(default_factory=list)
    scan_interval: float = 5.0               # scanInterval=5000ms topology poll
    username: Optional[str] = None
    password: Optional[str] = None
    client_name: Optional[str] = None
    connect_timeout: float = 10.0
    timeout: float = 3.0
    retry_attempts: int = 3
    retry_interval: float = 1.5
    ping_connection_interval: float = 30.0
    connection_pool_size: int = 8
    read_mode: str = "MASTER"                # MASTER | SLAVE | MASTER_SLAVE
    dns_monitoring_interval: float = 5.0     # dnsMonitoringInterval; <=0 disables
    # TLS (see SingleServerConfig).  Hostname verification defaults ON like
    # the reference's sslEnableEndpointIdentification — IP-addressed nodes
    # need IP SANs in their certs or an explicit opt-out, never a silent one
    ssl_ca_file: Optional[str] = None
    ssl_cert_file: Optional[str] = None
    ssl_key_file: Optional[str] = None
    ssl_verify_hostname: bool = True

    def build_ssl_context(self):
        from redisson_tpu_torch.net.client import address_uses_tls, client_ssl_context

        tls = any(address_uses_tls(a) for a in self.node_addresses)
        if not (tls or self.ssl_ca_file or self.ssl_cert_file):
            return None
        return client_ssl_context(
            self.ssl_ca_file, self.ssl_cert_file, self.ssl_key_file,
            self.ssl_verify_hostname,
        )


@dataclass
class ReplicatedServersConfig(ClusterServersConfig):
    """Replicated mode (ReplicatedServersConfig analog): N plain endpoints,
    master discovered by the client's ROLE scan — the Azure Redis Cache /
    ElastiCache topology (connection/ReplicatedConnectionManager.java).
    Same knob set as cluster mode; only the defaults differ: a tighter
    scan (master flips are externally driven and the group is small) and
    replica-first reads (the reference's replicated default)."""

    scan_interval: float = 1.0
    read_mode: str = "SLAVE"


@dataclass
class MeshConfig:
    """Device-mesh layout for the embedded data plane (L3', SURVEY §7.1-3).

    The reference has no analog — the closest is the cluster slot layout;
    here it's (dp, shard) axis sizes over the local positions
    (``parallel/mesh.local_devices``), read by ``parallel/manager``.
    ``n_devices`` is the count of local positions (round robin over the
    cards; None: one a card, or the CPU's configured count); ``platform`` is
    parsed and read by nothing: the engine's device picks the positions.
    """

    dp: int = 1                  # data-parallel axis size (1 = no dp split)
    shard: Optional[int] = None  # state-parallel axis; None = all remaining devices
    platform: Optional[str] = None  # force a platform; None = the default
    n_devices: Optional[int] = None  # cap device count; None = all


@dataclass
class Config:
    """Global framework config (org/redisson/config/Config.java analog)."""

    # -- reference-named knobs (same semantics) ------------------------------
    threads: int = 16                         # service executor pool
    lock_watchdog_timeout: float = 30.0       # lockWatchdogTimeout=30_000ms
    check_lock_synced_slaves: bool = True
    reliable_topic_watchdog_timeout: float = 600.0   # Config.java:77
    min_cleanup_delay: float = 5.0            # eviction min delay (Config.java:83-87)
    max_cleanup_delay: float = 1800.0         # eviction max delay 30min
    clean_up_keys_amount: int = 100
    use_script_cache: bool = True
    netty_threads: int = 0                    # accepted for config-file parity; unused

    # -- TPU-first knobs (batching engine replaces Netty tuning) -------------
    batch_flush_window_us: int = 200          # micro-batch collect window
    batch_max_ops: int = 65536                # flush threshold
    min_shape_bucket: int = 256               # pow2 padding floor (kernels.MIN_BUCKET)

    # -- mode sections --------------------------------------------------------
    single_server_config: Optional[SingleServerConfig] = None
    cluster_servers_config: Optional[ClusterServersConfig] = None
    replicated_servers_config: Optional[ReplicatedServersConfig] = None
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # -- SPI slots (reference extension points, §5.6) -------------------------
    # name_mapper: logical object name -> stored key, applied at handle
    # construction (NameMapper SPI).  Must expose map(name) and unmap(key);
    # see NameMapper below for the prefix convenience implementation.
    name_mapper: Any = None
    # command_mapper: wire verb rename (CommandMapper SPI — managed Redis
    # deployments rename dangerous commands).  map(name) -> name, applied
    # just before the frame is written.
    command_mapper: Any = None
    # credentials_resolver: callable(address) -> (username, password) | None,
    # resolved PER CONNECTION ATTEMPT so rotated secrets apply live
    # (CredentialsResolver SPI).
    credentials_resolver: Any = None
    # nat_mapper: advertised cluster address -> reachable address
    # ("host:port" -> "host:port"), applied to CLUSTER SLOTS discoveries
    # (NatMapper SPI — container/NAT topologies).
    nat_mapper: Any = None
    # engine hooks: instrumentation callbacks (NettyHook analog, §5.1)
    hooks: List[Any] = field(default_factory=list)

    # ------------------------------------------------------------------------

    def use_single_server(self) -> SingleServerConfig:
        if self.single_server_config is None:
            self.single_server_config = SingleServerConfig()
        return self.single_server_config

    def use_cluster_servers(self) -> ClusterServersConfig:
        if self.cluster_servers_config is None:
            self.cluster_servers_config = ClusterServersConfig()
        return self.cluster_servers_config

    def use_replicated_servers(self) -> ReplicatedServersConfig:
        if self.replicated_servers_config is None:
            self.replicated_servers_config = ReplicatedServersConfig()
        return self.replicated_servers_config

    # -- loaders (Config.fromYAML / fromJSON analogs) ------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Config":
        data = dict(data)
        single = data.pop("singleServerConfig", data.pop("single_server_config", None))
        cluster = data.pop("clusterServersConfig", data.pop("cluster_servers_config", None))
        replicated = data.pop(
            "replicatedServersConfig", data.pop("replicated_servers_config", None)
        )
        mesh = data.pop("mesh", None)
        cfg = cls(**{_snake(k): v for k, v in data.items() if _known_field(cls, _snake(k))})
        if single:
            cfg.single_server_config = _build(SingleServerConfig, single)
        if cluster:
            cfg.cluster_servers_config = _build(ClusterServersConfig, cluster)
        if replicated:
            cfg.replicated_servers_config = _build(ReplicatedServersConfig, replicated)
        if mesh:
            cfg.mesh = _build(MeshConfig, mesh)
        return cfg

    @classmethod
    def from_yaml(cls, text_or_path) -> "Config":
        import yaml

        text = _read_maybe_path(text_or_path)
        return cls.from_dict(yaml.safe_load(_substitute_env(text)) or {})

    @classmethod
    def from_json(cls, text_or_path) -> "Config":
        text = _read_maybe_path(text_or_path)
        return cls.from_dict(json.loads(_substitute_env(text)))

    @classmethod
    def from_file(cls, path) -> "Config":
        """A config file by its extension: ``.json`` as JSON, else YAML."""
        if str(path).endswith(".json"):
            return cls.from_json(str(path))
        return cls.from_yaml(str(path))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _read_maybe_path(text_or_path) -> str:
    s = str(text_or_path)
    if "\n" not in s and (s.endswith((".yaml", ".yml", ".json")) or os.path.exists(s)):
        with open(s, "r", encoding="utf-8") as f:
            return f.read()
    return s


_SNAKE1 = re.compile(r"(.)([A-Z][a-z]+)")
_SNAKE2 = re.compile(r"([a-z0-9])([A-Z])")


def _snake(name: str) -> str:
    return _SNAKE2.sub(r"\1_\2", _SNAKE1.sub(r"\1_\2", name)).lower()


def _known_field(cls, name: str) -> bool:
    return name in {f.name for f in dataclasses.fields(cls)}


def _build(cls, data: Dict[str, Any]):
    kwargs = {}
    for k, v in data.items():
        sk = _snake(k)
        if _known_field(cls, sk):
            kwargs[sk] = v
    return cls(**kwargs)


class NameMapper:
    """Prefix/suffix NameMapper (the reference ships the same convenience:
    org/redisson/api/NameMapper.direct()/prefix()).  Custom mappers only
    need map(name) -> stored key and unmap(key) -> logical name."""

    def __init__(self, prefix: str = "", suffix: str = ""):
        self.prefix = prefix
        self.suffix = suffix

    def map(self, name: str) -> str:
        return f"{self.prefix}{name}{self.suffix}"

    def unmap(self, key: str) -> str:
        out = key
        if self.prefix and out.startswith(self.prefix):
            out = out[len(self.prefix):]
        if self.suffix and out.endswith(self.suffix):
            out = out[: -len(self.suffix)]
        return out
