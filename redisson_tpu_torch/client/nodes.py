"""Nodes admin API: per-node PING / INFO / TIME / MEMORY.

A copy of ``redisson_tpu/client/nodes.py``, the counterpart of the
reference's ``org/redisson/redisnode/`` (RedisNodes, RedisNode): a surface
that lists the topology's nodes and runs health and metrics calls on each.

  * EmbeddedNode: one a mesh position of the engine's device kind
    (``parallel/mesh.local_devices``).  INFO reports the position's torch
    device, its memory statistics on a card (``torch.cuda.memory_stats``)
    and the store's record count; PING round-trips a known answer through
    the device (arange(4) on it sums to 6), so it proves the dispatch path,
    not only the process.
  * RemoteNode: wraps a NodeClient and sends the wire PING, INFO, TIME and
    MEMORY commands.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class BaseNode:
    id: str
    address: str

    def ping(self, timeout: float = 5.0) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def time(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def info(self) -> Dict[str, Any]:  # pragma: no cover - interface
        raise NotImplementedError

    def memory(self) -> Dict[str, Any]:  # pragma: no cover - interface
        raise NotImplementedError


class EmbeddedNode(BaseNode):
    """One local mesh position viewed as a topology node."""

    def __init__(self, engine, device):
        self._engine = engine
        self.device = device
        self.id = f"{device.platform}:{device.id}"
        self.address = f"device://{device.platform}/{device.id}"

    def ping(self, timeout: float = 5.0) -> bool:
        """A known-answer op on the position's card, on its lane's stream
        with placement on (under the lane's occupancy)."""
        import contextlib

        import torch

        lanes = self._engine.lanes
        lane = lanes.lane(self.device) if lanes is not None else None
        gate = (lane.occupy(1) if lane is not None and lane.torch_device == self.device.device
                else contextlib.nullcontext())
        try:
            with gate:
                x = torch.arange(4, dtype=torch.int32, device=self.device.device)
                return int(x.sum()) == 6
        except Exception:  # noqa: BLE001 — a failed dispatch is a failed ping
            return False

    def time(self) -> float:
        return time.time()

    def info(self) -> Dict[str, Any]:
        d = self.device
        out: Dict[str, Any] = {
            "id": self.id,
            "platform": d.platform,
            "device_kind": _device_kind(d.device),
            "process_index": 0,
            "keys": len(self._engine.store),
        }
        out.update(self.memory())
        return out

    def memory(self) -> Dict[str, Any]:
        import torch

        stats: Dict[str, Any] = {}
        if d_is_cuda(self.device.device):
            ms = torch.cuda.memory_stats(self.device.device)
            stats["bytes_in_use"] = ms.get("allocated_bytes.all.current")
            stats["bytes_limit"] = torch.cuda.get_device_properties(self.device.device).total_memory
            stats["peak_bytes_in_use"] = ms.get("allocated_bytes.all.peak")
        # the CPU keeps no such statistics: report nothing rather than lie
        return stats


def d_is_cuda(device) -> bool:
    return device.type == "cuda"


def _device_kind(device) -> str:
    if d_is_cuda(device):
        import torch

        return torch.cuda.get_device_name(device)
    return "cpu"


class RemoteNode(BaseNode):
    """A server process reached over the wire protocol."""

    def __init__(self, node_client):
        self._nc = node_client
        self.address = getattr(node_client, "address", "?")
        self.id = self.address

    def ping(self, timeout: float = 5.0) -> bool:
        try:
            return self._nc.execute("PING", timeout=timeout) in (b"PONG", "PONG")
        except Exception:  # noqa: BLE001 — an unreachable node fails the ping
            return False

    def time(self) -> float:
        reply = self._nc.execute("TIME")
        # RESP TIME returns [seconds, microseconds]
        sec, usec = (int(x) for x in reply)
        return sec + usec / 1e6

    def info(self) -> Dict[str, Any]:
        raw = self._nc.execute("INFO")
        text = raw.decode() if isinstance(raw, (bytes, bytearray)) else str(raw)
        out: Dict[str, Any] = {}
        for line in text.splitlines():
            if ":" in line and not line.startswith("#"):
                k, _, v = line.partition(":")
                out[k.strip()] = v.strip()
        return out

    def memory(self) -> Dict[str, Any]:
        reply = self._nc.execute("MEMORY", "STATS")
        if isinstance(reply, (list, tuple)):
            it = iter(reply)
            return {
                (k.decode() if isinstance(k, (bytes, bytearray)) else str(k)): v
                for k, v in zip(it, it)
            }
        return {"raw": reply}


class NodesGroup:
    """RedisNodes analog: enumerate and health-check the topology's nodes."""

    def __init__(self, nodes: List[BaseNode]):
        self._nodes = list(nodes)

    @classmethod
    def embedded(cls, engine) -> "NodesGroup":
        from redisson_tpu_torch.parallel.mesh import local_devices

        return cls([EmbeddedNode(engine, d) for d in local_devices(engine.device)])

    @classmethod
    def remote(cls, *node_clients) -> "NodesGroup":
        return cls([RemoteNode(nc) for nc in node_clients])

    def nodes(self) -> List[BaseNode]:
        return list(self._nodes)

    def node(self, node_id: str) -> Optional[BaseNode]:
        for n in self._nodes:
            if n.id == node_id:
                return n
        return None

    def ping_all(self, timeout: float = 5.0) -> bool:
        """True iff EVERY node answers (RedisNodes.pingAll contract)."""
        return all(n.ping(timeout) for n in self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def __iter__(self):
        return iter(self._nodes)
