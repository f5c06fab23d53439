"""Slot -> local-position placement: one server process owning the mesh.

A copy of ``redisson_tpu/server/placement.py``.  The 16384-slot table maps
onto the local mesh positions (``parallel/mesh.local_devices``: one a GPU,
or as many as asked, round robin over the cards), contiguous ranges as in
``cluster/topology.split_slots``, and each record is owned by the position
of its slot: frames routed to different positions dispatch down different
lanes (``core/ioplane.LaneSet``) at the same time.

Rebalancing is online and FENCED: a device move is a slot handoff inside
one process, with the epoch discipline of the journaled slot migrations:
``fence()`` refuses a lower epoch with STALEEPOCH, and a re-issue at the
recorded epoch is idempotent.  The journaled rebalance driver is
``server/migration.rebalance_devices`` (with ``resume_device_rebalances``
and ``evacuate_device``).

Placement is opt-in (``Engine.enable_placement`` / ``devices=`` /
``--devices``): with it off, nothing here runs.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from redisson_tpu_torch.utils.crc16 import MAX_SLOT, calc_slot


class PlacementStaleEpoch(RuntimeError):
    """A device move arrived with a fencing epoch BELOW the highest one the
    slot accepted — a stale coordinator's late write.  Message leads with
    STALEEPOCH so the wire projection matches the slot-migration fence."""

    def __init__(self, slot: int, accepted: int, got: int):
        super().__init__(
            f"STALEEPOCH slot {slot} device placement fenced at epoch "
            f"{accepted}; got {got}"
        )
        self.slot, self.accepted, self.got = slot, accepted, got


def _contiguous_owner_table(n_slots: int, n_devices: int) -> np.ndarray:
    """slot -> device index, contiguous ranges (the split_slots discipline:
    device i owns [i*S/D, (i+1)*S/D))."""
    return (np.arange(n_slots, dtype=np.int64) * n_devices // n_slots).astype(
        np.int32
    )


class SlotPlacement:
    """Consistent slot -> device assignment over the local device list.

    ``_owner`` is the authoritative routing table (which lane a frame's
    commands schedule onto, which device a NEW record's plane commits to).
    A record's owner may briefly be the PREVIOUS position mid-move: kernels
    follow the record's tensors, so correctness never depends on the table,
    and the moving window only costs fused-run eligibility
    (``core/coalesce`` refuses a run over mixed positions).
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None,
                 n_devices: Optional[int] = None):
        if devices is None:
            from redisson_tpu_torch.parallel.mesh import local_devices

            devices = local_devices()
        devices = list(devices)
        if n_devices is not None:
            if not 1 <= n_devices <= len(devices):
                raise ValueError(
                    f"n_devices {n_devices} outside 1..{len(devices)}"
                )
            devices = devices[:n_devices]
        if not devices:
            raise ValueError("placement needs at least one device")
        self.devices: List[Any] = devices
        self._lock = threading.Lock()
        self._owner = _contiguous_owner_table(MAX_SLOT, len(devices))
        # per-slot fencing epoch for device moves (the slot-migration
        # fencing discipline applied to intra-process handoffs)
        self._epochs: Dict[int, int] = {}
        self.moves = 0  # observability: completed slot handoffs

    # -- lookup ---------------------------------------------------------------

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def device_id_for_slot(self, slot: int) -> int:
        return int(self._owner[slot])

    def device_for_slot(self, slot: int):
        return self.devices[int(self._owner[slot])]

    def device_for_name(self, name: str):
        return self.device_for_slot(calc_slot(
            name if isinstance(name, bytes) else name.encode()
        ))

    def device_id_for_name(self, name: str) -> int:
        return self.device_id_for_slot(calc_slot(
            name if isinstance(name, bytes) else name.encode()
        ))

    def slot_counts(self) -> List[int]:
        """Slots owned per device (CLUSTER DEVICES / census gauge)."""
        with self._lock:
            counts = np.bincount(self._owner, minlength=self.n_devices)
        return [int(c) for c in counts]

    def owner_snapshot(self) -> np.ndarray:
        with self._lock:
            return self._owner.copy()

    def epoch_of(self, slot: int) -> int:
        with self._lock:
            return self._epochs.get(slot, 0)

    # -- fenced moves ---------------------------------------------------------

    def fence(self, slot: int, epoch: Optional[int]) -> None:
        """Accept-or-reject a device move's fencing epoch for one slot.
        Epoch-less moves (manual admin) pass unfenced; a lower epoch than
        the highest accepted is refused loudly (PlacementStaleEpoch)."""
        if epoch is None:
            return
        with self._lock:
            cur = self._epochs.get(slot, 0)
            if epoch < cur:
                raise PlacementStaleEpoch(slot, cur, epoch)
            self._epochs[slot] = epoch

    def assign(self, slot: int, dev_index: int,
               epoch: Optional[int] = None) -> bool:
        """Point `slot` at device `dev_index` (fenced).  Returns True iff
        the owner actually changed.  This updates ROUTING only: the records
        move under their record locks in Engine.move_slot_records."""
        if not 0 <= dev_index < self.n_devices:
            raise ValueError(f"device index {dev_index} outside placement")
        self.fence(slot, epoch)
        with self._lock:
            changed = int(self._owner[slot]) != dev_index
            self._owner[slot] = dev_index
            if changed:
                self.moves += 1
        return changed

    def device_span(self, base: int, n: int) -> List[int]:
        """Target device ids for an n-member record CONSTELLATION anchored
        at device `base` (the sharded vector banks): the ring walk
        (base + i) % n_devices, distinct devices while n <= device count,
        wrapping evenly past it."""
        from redisson_tpu_torch.parallel.mesh import device_ring

        return device_ring(self.n_devices, base, n)

    def spread_plan(self, n_active: int) -> Dict[int, int]:
        """The 4->8->4 rebalance shape: target owner for every slot when
        only the first `n_active` devices serve.  Returns {slot: dev_index}
        for the slots whose owner CHANGES (the move set)."""
        if not 1 <= n_active <= self.n_devices:
            raise ValueError(
                f"n_active {n_active} outside 1..{self.n_devices}"
            )
        target = _contiguous_owner_table(MAX_SLOT, n_active)
        with self._lock:
            diff = np.nonzero(target != self._owner)[0]
            return {int(s): int(target[s]) for s in diff}

    # -- frame scheduling -----------------------------------------------------

    # Verbs whose frame entries may dispatch on per-device queues: single
    # batch-data commands whose ONLY cross-command ordering contract is
    # per-key (keys map to exactly one device, so per-device FIFO queues
    # preserve every observable ordering).  Everything else — admin,
    # transactions, pubsub, blocking verbs, multi-slot reads — is a barrier.
    PARALLEL_VERBS = frozenset(
        v.encode() for v in (
            "BF.RESERVE", "BF.ADD", "BF.MADD", "BF.EXISTS", "BF.MEXISTS",
            "BF.MADD64", "BF.MEXISTS64", "BF.INFO",
            "BFA.RESERVE", "BFA.MADD64", "BFA.MEXISTS64",
            "HLLA.RESERVE", "HLLA.MADD64", "HLLA.MERGEROWS",
            "HLLA.ESTIMATE", "HLLA.ESTPAIRS",
            "SETBIT", "GETBIT", "BITCOUNT", "BITOP",
            "SETBITS", "GETBITS", "SETBITSB", "GETBITSB",
            # PFCOUNT is NOT here: its key spec names only the first key,
            # so a multi-key union could shard on partial knowledge and
            # race a later queue's write — it barriers instead
            "PFADD", "PFADD64", "PFMERGE",
            "SET", "GET", "SETNX", "GETSET", "APPEND", "STRLEN",
            "INCR", "DECR", "INCRBY", "DECRBY",
        )
    )

    def device_index_for_command(self, cmd, owner=None) -> Optional[int]:
        """Owning device index of one whitelisted single-device command,
        else None (non-parallel verb, malformed, keyless, or keys spanning
        devices).  The shared eligibility test of plan_frame and the
        sequential path's per-command lane accounting.

        ``owner``: resolve against this owner-table SNAPSHOT instead of the
        live table — plan_frame passes one snapshot for the whole frame so
        a rebalance racing the planner cannot split same-key commands into
        different concurrently-dispatched buckets."""
        from redisson_tpu_torch.net import commands as C

        if not (
            isinstance(cmd, list)
            and cmd
            and all(isinstance(a, (bytes, bytearray)) for a in cmd)
        ):
            return None
        verb = bytes(cmd[0]).upper()
        if verb not in self.PARALLEL_VERBS:
            return None
        try:
            keys = C.command_keys(verb.decode(), cmd[1:])
        except Exception:  # noqa: BLE001 — malformed: not laneable
            return None
        if not keys:
            return None
        table = self._owner if owner is None else owner
        ids = {
            int(table[calc_slot(
                k if isinstance(k, bytes) else str(k).encode()
            )])
            for k in keys
        }
        return next(iter(ids)) if len(ids) == 1 else None

    def plan_frame(self, commands: List[List[bytes]],
                   single_device_ok: bool = False):
        """Partition one pipelined frame into dispatch segments:

            ("sharded", {dev_index: [cmd_index, ...]})  — per-device queues
                                                          dispatch CONCURRENTLY
            ("serial", [cmd_index, ...])                — in-order barrier run

        Returns None when the frame has no cross-device parallelism to
        exploit (single device touched, or too small) — callers keep the
        plain sequential loop, byte-identical behavior.  Eligibility per
        command: whitelisted verb AND every key on ONE device (a cross-
        device multi-key command is a barrier; correctness never depends
        on the plan — ineligible commands simply serialize).

        ``single_device_ok`` returns a plan even when everything lands on
        ONE device — the bench A/B's 1-device leg (the server sets it while
        the CPU-replica occupancy model is armed), so both legs run the
        SAME dispatch code and differ only in lane count."""
        if (self.n_devices <= 1 and not single_device_ok) or len(commands) < 2:
            return None
        # ONE owner-table snapshot for the whole frame: a rebalance racing
        # the planner must not split same-key commands into different
        # concurrently-dispatched buckets (per-key order would break)
        owner = self.owner_snapshot()
        segments: List[Tuple[str, Any]] = []
        cur_sharded: Optional[Dict[int, List[int]]] = None
        cur_serial: Optional[List[int]] = None
        devs_touched: set = set()

        def flush_sharded():
            nonlocal cur_sharded
            if cur_sharded:
                segments.append(("sharded", cur_sharded))
            cur_sharded = None

        def flush_serial():
            nonlocal cur_serial
            if cur_serial:
                segments.append(("serial", cur_serial))
            cur_serial = None

        for i, cmd in enumerate(commands):
            if (
                isinstance(cmd, list) and cmd
                and isinstance(cmd[0], (bytes, bytearray))
                and bytes(cmd[0]).upper() == b"MULTI"
            ):
                # MULTI arms queueing MID-frame: every later command of the
                # frame must append to the transaction queue in frame order,
                # which concurrent per-device buckets cannot guarantee —
                # the whole frame stays on the sequential path
                return None
            dev = self.device_index_for_command(cmd, owner=owner)
            if dev is None:
                flush_sharded()
                if cur_serial is None:
                    cur_serial = []
                cur_serial.append(i)
            else:
                flush_serial()
                if cur_sharded is None:
                    cur_sharded = {}
                cur_sharded.setdefault(dev, []).append(i)
                devs_touched.add(dev)
        flush_sharded()
        flush_serial()
        if len(devs_touched) <= 1 and not single_device_ok:
            return None  # one lane: the sequential loop is already optimal
        if not devs_touched:
            return None  # nothing shardable at all: keep the plain loop
        return segments
