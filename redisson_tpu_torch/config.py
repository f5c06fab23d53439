"""Config: the knobs the port reads.

A trimmed copy of ``redisson_tpu/config.py`` (``org/redisson/config/
Config.java:57-99``): the engine's expiry sweep (``core/eviction.py``) reads
its two cleanup delays, every object handle and ``Keys`` map names through
``name_mapper``, and the wire client (``client/remote.py``) reads the
single-server section (``SingleServerConfig``: ``config/BaseConfig.java``'s
timeouts, retries, pool sizes and TLS) and the ``command_mapper`` and
``credentials_resolver`` SPI slots.  The cluster, replicated and mesh
sections and the YAML/JSON loaders come with ROADMAP M8; asking for them
raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

_M8 = "comes with the multi-device slice (ROADMAP M8)"


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
class Config:
    """Global framework config (org/redisson/config/Config.java analog)."""

    min_cleanup_delay: float = 5.0      # eviction min delay (Config.java:83-87)
    max_cleanup_delay: float = 1800.0   # eviction max delay 30min

    single_server_config: Optional[SingleServerConfig] = None

    # -- SPI slots (reference extension points, §5.6) -------------------------
    # name_mapper: logical object name -> stored key, applied at handle
    # construction (NameMapper SPI).  Must expose map(name) and unmap(key).
    name_mapper: Any = None
    # command_mapper: wire verb rename (CommandMapper SPI — managed Redis
    # deployments rename dangerous commands).  map(name) -> name, applied
    # just before the frame is written.
    command_mapper: Any = None
    # credentials_resolver: callable(address) -> (username, password) | None,
    # resolved PER CONNECTION ATTEMPT so rotated secrets apply live
    # (CredentialsResolver SPI).
    credentials_resolver: Any = None

    def use_single_server(self) -> SingleServerConfig:
        if self.single_server_config is None:
            self.single_server_config = SingleServerConfig()
        return self.single_server_config

    def use_cluster_servers(self):
        raise NotImplementedError(f"cluster servers config {_M8}")

    def use_replicated_servers(self):
        raise NotImplementedError(f"replicated servers config {_M8}")

    @classmethod
    def from_dict(cls, data):
        raise NotImplementedError(f"config loading {_M8}")

    from_yaml = from_json = from_dict
