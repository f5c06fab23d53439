"""LiveObject service: objects whose attributes live in the grid — on EVERY
facade.

Parity target (SURVEY.md §2.6): ``org/redisson/RedissonLiveObjectService.java``
(929 LoC) + ``liveobject/core/AccessorInterceptor.java`` + LiveObjectSearch
(``liveobject/LiveObjectSearch.java``) — the reference generates a ByteBuddy
proxy per @REntity class whose field accessors read/write an RMap hash; @RId
names the primary key; @RIndex'd fields maintain index structures enabling
condition search over the full tree ``liveobject/condition/{EQ,GT,GE,LT,LE,
IN,AND,OR}Condition.java``.

Design here: `@entity` marks a Python class (with `id_field`); `attach/
persist/get` return a proxy whose __getattr__/__setattr__ hit the backing
Map.  `@indexed` fields maintain TWO index structures per the reference's
split: a per-value Set (EQ/IN membership) and, for numeric values, ONE
ScoredSortedSet per field scoring rid -> value (GT/GE/LT/LE ranges ride
ZRANGEBYSCORE instead of scanning per-value sets).

The service talks ONLY through a client facade's object factories
(get_map/get_set/get_scored_sorted_set), so the same code serves the
embedded client, RemoteRedisson, and ClusterRedisson — every key carries a
{Cls:...} hashtag and routes per key, exactly how the reference's live
objects work against a cluster.

A copy of ``redisson_tpu/services/liveobject.py`` for the port.
"""
from __future__ import annotations

import math
from typing import Any, Iterable, List, Optional, Type


def entity(id_field: str = "id", indexed: tuple = ()):  # decorator
    """@REntity analog; `indexed` lists fields kept in search indexes."""

    def wrap(cls):
        cls.__rid_field__ = id_field
        cls.__rindexed__ = tuple(indexed)
        return cls

    return wrap


# -- condition tree (liveobject/condition/*.java) -----------------------------


class Condition:
    """Search-condition node; combine with & / | like Conditions.and_/or_."""

    def __and__(self, other: "Condition") -> "ANDCondition":
        return ANDCondition(self, other)

    def __or__(self, other: "Condition") -> "ORCondition":
        return ORCondition(self, other)


class _FieldCondition(Condition):
    def __init__(self, field: str, value: Any):
        self.field = field
        self.value = value

    def __repr__(self):
        return f"{type(self).__name__}({self.field!r}, {self.value!r})"


class EQCondition(_FieldCondition):
    pass


class GTCondition(_FieldCondition):
    pass


class GECondition(_FieldCondition):
    pass


class LTCondition(_FieldCondition):
    pass


class LECondition(_FieldCondition):
    pass


class INCondition(Condition):
    def __init__(self, field: str, values: Iterable[Any]):
        self.field = field
        self.values = tuple(values)


class ANDCondition(Condition):
    def __init__(self, *conditions: Condition):
        self.conditions = tuple(conditions)


class ORCondition(Condition):
    def __init__(self, *conditions: Condition):
        self.conditions = tuple(conditions)


class Conditions:
    """org.redisson.api.condition.Conditions static-factory analog."""

    @staticmethod
    def eq(field: str, value: Any) -> EQCondition:
        return EQCondition(field, value)

    @staticmethod
    def gt(field: str, value: float) -> GTCondition:
        return GTCondition(field, value)

    @staticmethod
    def ge(field: str, value: float) -> GECondition:
        return GECondition(field, value)

    @staticmethod
    def lt(field: str, value: float) -> LTCondition:
        return LTCondition(field, value)

    @staticmethod
    def le(field: str, value: float) -> LECondition:
        return LECondition(field, value)

    @staticmethod
    def in_(field: str, values: Iterable[Any]) -> INCondition:
        return INCondition(field, values)

    @staticmethod
    def and_(*conditions: Condition) -> ANDCondition:
        return ANDCondition(*conditions)

    @staticmethod
    def or_(*conditions: Condition) -> ORCondition:
        return ORCondition(*conditions)


def _is_numeric(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class LiveObjectProxy:
    """Field-accessor proxy (AccessorInterceptor analog): every attribute
    read/write goes straight to the backing map — no local state besides the
    identity."""

    __slots__ = ("__dict__",)

    def __init__(self, service: "LiveObjectService", cls: Type, rid: Any):
        object.__setattr__(self, "__dict__", {"_svc": service, "_cls": cls, "_rid": rid})

    def _map(self):
        d = object.__getattribute__(self, "__dict__")
        return d["_svc"]._backing_map(d["_cls"], d["_rid"])

    def __getattr__(self, name: str):
        d = object.__getattribute__(self, "__dict__")
        if name == d["_cls"].__rid_field__:
            return d["_rid"]
        v = self._map().get(name)
        return v

    def __setattr__(self, name: str, value):
        d = object.__getattribute__(self, "__dict__")
        cls, rid, svc = d["_cls"], d["_rid"], d["_svc"]
        if name == cls.__rid_field__:
            raise AttributeError("@RId field is immutable (reference rejects id writes)")
        old = self._map().get(name)
        self._map().fast_put(name, value)
        if name in cls.__rindexed__:
            svc._index_update(cls, name, rid, old, value)

    def __eq__(self, other):
        if not isinstance(other, LiveObjectProxy):
            return NotImplemented
        a = object.__getattribute__(self, "__dict__")
        b = object.__getattribute__(other, "__dict__")
        return a["_cls"] is b["_cls"] and a["_rid"] == b["_rid"]

    def __hash__(self):
        d = object.__getattribute__(self, "__dict__")
        return hash((d["_cls"].__name__, d["_rid"]))


class LiveObjectService:
    """RLiveObjectService analog: persist/get/delete/is_exists/find.

    Accepts either a client facade (embedded/remote/cluster — anything with
    get_map/get_set/get_scored_sorted_set) or a bare Engine (back-compat:
    wrapped in the embedded facade)."""

    def __init__(self, client_or_engine):
        from redisson_tpu_torch.core.engine import Engine

        if isinstance(client_or_engine, Engine):
            from redisson_tpu_torch.client.redisson import RedissonTpu

            client_or_engine = RedissonTpu(client_or_engine)
        self._client = client_or_engine

    # -- key naming (every key hashtags by its own identity) ------------------

    def _map_name(self, cls: Type, rid: Any) -> str:
        return f"redisson_live_object:{{{cls.__name__}:{rid!r}}}"

    def _index_name(self, cls: Type, field: str, value: Any) -> str:
        return f"redisson_live_object_index:{{{cls.__name__}:{field}:{value!r}}}"

    def _score_name(self, cls: Type, field: str) -> str:
        return f"redisson_live_object_score:{{{cls.__name__}:{field}}}"

    def _ids_name(self, cls: Type) -> str:
        return f"redisson_live_object_ids:{{{cls.__name__}}}"

    def _backing_map(self, cls: Type, rid: Any):
        return self._client.get_map(self._map_name(cls, rid))

    def _ids_set(self, cls: Type):
        return self._client.get_set(self._ids_name(cls))

    def _value_set(self, cls: Type, field: str, value: Any):
        return self._client.get_set(self._index_name(cls, field, value))

    def _score_set(self, cls: Type, field: str):
        return self._client.get_scored_sorted_set(self._score_name(cls, field))

    def _index_update(self, cls: Type, field: str, rid: Any, old: Any, new: Any):
        if old is not None:
            self._value_set(cls, field, old).remove(rid)
            if _is_numeric(old) and not _is_numeric(new):
                self._score_set(cls, field).remove(rid)
        if new is not None:
            self._value_set(cls, field, new).add(rid)
            if _is_numeric(new):
                # rid -> value: GT/GE/LT/LE ride one ZRANGEBYSCORE
                self._score_set(cls, field).add(float(new), rid)

    # -- lifecycle (RLiveObjectService.persist/attach/get/delete) ------------

    def persist(self, instance: Any) -> LiveObjectProxy:
        """Copy a detached instance's fields into the grid; returns the proxy.
        Fails if an entity with the same id already exists (reference
        persist() semantics)."""
        cls = type(instance)
        rid = getattr(instance, cls.__rid_field__)
        if rid is None:
            raise ValueError("@RId field must be set before persist")
        if self.is_exists(cls, rid):
            raise ValueError(f"{cls.__name__}({rid!r}) already exists")
        proxy = LiveObjectProxy(self, cls, rid)
        self._ids_set(cls).add(rid)
        for k, v in vars(instance).items():
            if k != cls.__rid_field__ and not k.startswith("_"):
                setattr(proxy, k, v)
        return proxy

    def attach(self, cls: Type, rid: Any) -> LiveObjectProxy:
        """Proxy without existence check (reference attach())."""
        return LiveObjectProxy(self, cls, rid)

    def merge(self, instance: Any) -> LiveObjectProxy:
        """RLiveObjectService.merge: persist-or-update — existing entities
        get the detached instance's non-None fields written over them,
        absent ones are persisted fresh (RLiveObjectService.java:145)."""
        cls = type(instance)
        rid = getattr(instance, cls.__rid_field__)
        if rid is None:
            raise ValueError("@RId field must be set before merge")
        if not self.is_exists(cls, rid):
            return self.persist(instance)
        proxy = LiveObjectProxy(self, cls, rid)
        for k, v in vars(instance).items():
            if k != cls.__rid_field__ and not k.startswith("_") and v is not None:
                setattr(proxy, k, v)
        return proxy

    def merge_all(self, *instances: Any) -> List[LiveObjectProxy]:
        return [self.merge(i) for i in instances]

    def detach(self, proxy: LiveObjectProxy) -> Any:
        """RLiveObjectService.detach: materialize a plain instance carrying a
        snapshot of the grid state (RLiveObjectService.java:195)."""
        d = object.__getattribute__(proxy, "__dict__")
        cls, rid = d["_cls"], d["_rid"]
        inst = cls.__new__(cls)
        setattr(inst, cls.__rid_field__, rid)
        for k, v in self._backing_map(cls, rid).read_all_map().items():
            setattr(inst, k, v)
        return inst

    @staticmethod
    def is_live_object(instance: Any) -> bool:
        return isinstance(instance, LiveObjectProxy)

    def delete_by_ids(self, cls: Type, *rids: Any) -> int:
        """RLiveObjectService.delete(entityClass, ids...): count deleted."""
        return sum(1 for rid in rids if self.delete(cls, rid))

    def get(self, cls: Type, rid: Any) -> Optional[LiveObjectProxy]:
        if not self.is_exists(cls, rid):
            return None
        return LiveObjectProxy(self, cls, rid)

    def is_exists(self, cls: Type, rid: Any) -> bool:
        return self._ids_set(cls).contains(rid)

    def delete(self, cls: Type, rid: Any) -> bool:
        if not self.is_exists(cls, rid):
            return False
        proxy = LiveObjectProxy(self, cls, rid)
        for field in cls.__rindexed__:
            val = getattr(proxy, field)
            if val is not None:
                self._index_update(cls, field, rid, val, None)
        self._backing_map(cls, rid).delete()
        self._ids_set(cls).remove(rid)
        return True

    # -- search (LiveObjectSearch over liveobject/condition/*) ----------------

    def _check_indexed(self, cls: Type, field: str) -> None:
        if field not in cls.__rindexed__:
            raise ValueError(f"field {field!r} is not indexed on {cls.__name__}")

    def _resolve(self, cls: Type, cond: Condition) -> set:
        """Condition tree -> id set (LiveObjectSearch.traverseAnd/Or)."""
        if isinstance(cond, EQCondition):
            self._check_indexed(cls, cond.field)
            return set(self._value_set(cls, cond.field, cond.value).read_all())
        if isinstance(cond, INCondition):
            self._check_indexed(cls, cond.field)
            out: set = set()
            for v in cond.values:
                out |= set(self._value_set(cls, cond.field, v).read_all())
            return out
        if isinstance(cond, (GTCondition, GECondition, LTCondition, LECondition)):
            self._check_indexed(cls, cond.field)
            inf = math.inf
            lo, lo_inc, hi, hi_inc = -inf, True, inf, True
            if isinstance(cond, GTCondition):
                lo, lo_inc = float(cond.value), False
            elif isinstance(cond, GECondition):
                lo, lo_inc = float(cond.value), True
            elif isinstance(cond, LTCondition):
                hi, hi_inc = float(cond.value), False
            else:
                hi, hi_inc = float(cond.value), True
            return set(
                self._score_set(cls, cond.field).value_range_by_score(
                    lo, lo_inc, hi, hi_inc
                )
            )
        if isinstance(cond, ANDCondition):
            ids: Optional[set] = None
            for c in cond.conditions:
                sub = self._resolve(cls, c)
                ids = sub if ids is None else (ids & sub)
                if not ids:
                    return set()
            return ids if ids is not None else set()
        if isinstance(cond, ORCondition):
            out = set()
            for c in cond.conditions:
                out |= self._resolve(cls, c)
            return out
        raise TypeError(f"unknown condition: {cond!r}")

    def find(self, cls: Type, *conditions: Condition, **eq_conditions) -> List[LiveObjectProxy]:
        """RLiveObjectService.find(cls, condition).  Positional `Condition`
        nodes AND-combine with keyword EQ shorthands; no conditions = all
        instances.  Full tree support: EQ/GT/GE/LT/LE/IN/AND/OR
        (liveobject/condition/*.java, LiveObjectSearch.java)."""
        conds = list(conditions) + [
            EQCondition(f, v) for f, v in eq_conditions.items()
        ]
        if not conds:
            ids = set(self._ids_set(cls).read_all())
        else:
            ids = self._resolve(
                cls, conds[0] if len(conds) == 1 else ANDCondition(*conds)
            )
        return [LiveObjectProxy(self, cls, rid) for rid in sorted(ids, key=repr)]

    def count(self, cls: Type, *conditions: Condition, **eq_conditions) -> int:
        return len(self.find(cls, *conditions, **eq_conditions))
