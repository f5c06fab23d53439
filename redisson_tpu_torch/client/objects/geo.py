"""Geo: geospatial member index.

Parity target: RGeo — ``org/redisson/RedissonGeo.java`` (984 LoC): GEOADD,
GEODIST (m/km/mi/ft), GEOPOS, GEOHASH, GEOSEARCH by radius/box around a
member or a point, with count/order options, and ...StoreTo variants.

Design: distance evaluation is a *vectorized haversine over all members*
(numpy, on the host) — the data-parallel re-expression of the
server-side geo index walk.

A copy of ``redisson_tpu/client/objects/geo.py`` on the port's engine.
One difference, in host cost only: a search reuses the record's packed
member coordinates (``_points``, keyed by the record's creation nonce and
version) until the record changes, where the reference packs every
member's coordinates again for each query.  Replies are the same.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord

EARTH_RADIUS_M = 6372797.560856  # Redis' constant (geohash_helper.c)

_UNITS = {"m": 1.0, "km": 1000.0, "mi": 1609.34, "ft": 0.3048}

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"

# record nonce -> (version, members, (n, 2) float64 coordinates): the last
# _POINTS_KEEP geo records searched, each valid until its version moves
_POINTS: "OrderedDict[int, tuple]" = OrderedDict()
_POINTS_KEEP = 64
_POINTS_LOCK = threading.Lock()


def _points(rec) -> Tuple[List[Any], np.ndarray]:
    """The record's members and their (lon, lat) rows, packed once a
    version.  The version is read before the members, so a write racing
    the pack leaves an entry the next version replaces."""
    version = rec.version
    with _POINTS_LOCK:
        hit = _POINTS.get(rec.nonce)
        if hit is not None and hit[0] == version:
            _POINTS.move_to_end(rec.nonce)
            return hit[1], hit[2]
    members = list(rec.host.keys())
    pts = np.asarray([rec.host[m] for m in members], np.float64).reshape(-1, 2)
    with _POINTS_LOCK:
        _POINTS[rec.nonce] = (version, members, pts)
        _POINTS.move_to_end(rec.nonce)
        while len(_POINTS) > _POINTS_KEEP:
            _POINTS.popitem(last=False)
    return members, pts


def _haversine_m(lon1, lat1, lon2, lat2):
    """Vectorized great-circle distance in meters."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(x, np.float64)) for x in (lon1, lat1, lon2, lat2))
    u = np.sin((lat2 - lat1) / 2)
    v = np.sin((lon2 - lon1) / 2)
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(u * u + np.cos(lat1) * np.cos(lat2) * v * v))


def geohash(lon: float, lat: float, precision: int = 11) -> str:
    """Standard geohash (GEOHASH reply format)."""
    lat_r, lon_r = [-90.0, 90.0], [-180.0, 180.0]
    bits, out, ch, even = 0, [], 0, True
    while len(out) < precision:
        if even:
            mid = (lon_r[0] + lon_r[1]) / 2
            if lon >= mid:
                ch = ch * 2 + 1
                lon_r[0] = mid
            else:
                ch *= 2
                lon_r[1] = mid
        else:
            mid = (lat_r[0] + lat_r[1]) / 2
            if lat >= mid:
                ch = ch * 2 + 1
                lat_r[0] = mid
            else:
                ch *= 2
                lat_r[1] = mid
        even = not even
        bits += 1
        if bits == 5:
            out.append(_BASE32[ch])
            bits, ch = 0, 0
    return "".join(out)


class GeoSearchArgs:
    """Builder mirroring ``api/geo/GeoSearchArgs`` (the reference's modern
    search surface): origin = point or member; shape = radius or box; plus
    count/order.  Construct via ``from_coords``/``from_member`` and chain."""

    def __init__(self):
        self._point: Optional[Tuple[float, float]] = None
        self._member = None
        self._radius: Optional[Tuple[float, str]] = None
        self._box: Optional[Tuple[float, float, str]] = None
        self.count: Optional[int] = None
        self.order: Optional[str] = None

    @classmethod
    def from_coords(cls, lon: float, lat: float) -> "GeoSearchArgs":
        a = cls()
        a._point = (float(lon), float(lat))
        return a

    @classmethod
    def from_member(cls, member) -> "GeoSearchArgs":
        a = cls()
        a._member = member
        return a

    def radius(self, r: float, unit: str = "m") -> "GeoSearchArgs":
        self._radius = (float(r), unit)
        return self

    def box(self, width: float, height: float, unit: str = "m") -> "GeoSearchArgs":
        self._box = (float(width), float(height), unit)
        return self

    def with_count(self, n: int) -> "GeoSearchArgs":
        self.count = int(n)
        return self

    def with_order(self, order: str) -> "GeoSearchArgs":
        order = order.upper()
        if order not in ("ASC", "DESC"):
            raise ValueError("order must be ASC or DESC")
        self.order = order
        return self


class Geo(RExpirable):
    _kind = "geo"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host={})
        )

    def _e(self, v) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw):
        return self._codec.decode(raw)

    def add(self, lon: float, lat: float, member) -> int:
        """GEOADD one member; returns 1 if new."""
        if not (-180 <= lon <= 180 and -85.05112878 <= lat <= 85.05112878):
            raise ValueError(f"invalid longitude/latitude ({lon}, {lat})")
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            e = self._e(member)
            fresh = e not in rec.host
            rec.host[e] = (float(lon), float(lat))
            self._touch_version(rec)
            return int(fresh)

    def add_all(self, entries: Dict[Any, Tuple[float, float]]) -> int:
        return sum(self.add(lon, lat, m) for m, (lon, lat) in entries.items())

    def add_if_exists(self, lon: float, lat: float, member) -> bool:
        """GEOADD XX (RGeo.addIfExists): update an existing member's
        position only; returns True when the position CHANGED."""
        if not (-180 <= lon <= 180 and -85.05112878 <= lat <= 85.05112878):
            raise ValueError(f"invalid longitude/latitude ({lon}, {lat})")
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            e = self._e(member)
            old = rec.host.get(e)
            if old is None:
                return False
            new = (float(lon), float(lat))
            if old == new:
                return False
            rec.host[e] = new
            self._touch_version(rec)
            return True

    def try_add(self, lon: float, lat: float, member) -> bool:
        """GEOADD NX (RGeo.tryAdd): add only when ABSENT."""
        if not (-180 <= lon <= 180 and -85.05112878 <= lat <= 85.05112878):
            raise ValueError(f"invalid longitude/latitude ({lon}, {lat})")
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            e = self._e(member)
            if e in rec.host:
                return False
            rec.host[e] = (float(lon), float(lat))
            self._touch_version(rec)
            return True

    def search_with_position(
        self, *a, **kw
    ) -> Dict[Any, Tuple[float, float]]:
        """GEOSEARCH ... WITHCOORD (RGeo.searchWithPosition): member ->
        (lon, lat), nearest-first.  Accepts a GeoSearchArgs (the modern
        surface) or legacy (lon, lat, radius[, unit, count, order])."""
        if len(a) == 1 and isinstance(a[0], GeoSearchArgs):
            return self.search_with_position_args(a[0])
        if len(a) >= 3:
            lon, lat, radius = a[:3]
        else:
            # pre-r5 named-parameter signature: lon/lat/radius may arrive as
            # keywords — fall back to kw when the positionals run short
            # instead of raising an opaque unpack ValueError
            try:
                lon = a[0] if len(a) > 0 else kw["lon"]
                lat = a[1] if len(a) > 1 else kw["lat"]
                radius = kw["radius"]
            except KeyError as e:
                raise TypeError(
                    f"search_with_position() missing required argument: {e.args[0]!r}"
                ) from None
        unit = a[3] if len(a) > 3 else kw.get("unit", "m")
        count = a[4] if len(a) > 4 else kw.get("count")
        order = a[5] if len(a) > 5 else kw.get("order", "ASC")
        members = self.search_radius(lon, lat, radius, unit=unit, count=count, order=order)
        positions = self.pos(*members)
        return {m: positions[m] for m in members if positions.get(m) is not None}

    def remove(self, member) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if rec.host.pop(self._e(member), None) is None:
                return False
            self._touch_version(rec)
            return True

    def pos(self, *members) -> Dict[Any, Tuple[float, float]]:
        """GEOPOS."""
        rec = self._engine.store.get(self._name)
        out = {}
        if rec is None:
            return out
        for m in members:
            p = rec.host.get(self._e(m))
            if p is not None:
                out[m] = p
        return out

    def dist(self, member1, member2, unit: str = "m") -> Optional[float]:
        """GEODIST."""
        rec = self._engine.store.get(self._name)
        if rec is None:
            return None
        p1 = rec.host.get(self._e(member1))
        p2 = rec.host.get(self._e(member2))
        if p1 is None or p2 is None:
            return None
        d = float(_haversine_m(p1[0], p1[1], p2[0], p2[1]))
        return d / _UNITS[unit]

    def hash(self, *members) -> Dict[Any, str]:
        """GEOHASH."""
        out = {}
        for m, (lon, lat) in self.pos(*members).items():
            out[m] = geohash(lon, lat)
        return out

    def _search_point(
        self, lon: float, lat: float, radius_m: float, count: Optional[int], order: Optional[str]
    ) -> List[Tuple[Any, float]]:
        rec = self._engine.store.get(self._name)
        if rec is None or not rec.host:
            return []
        members, pts = _points(rec)
        d = _haversine_m(lon, lat, pts[:, 0], pts[:, 1])
        sel = np.nonzero(d <= radius_m)[0]
        pairs = [(members[i], float(d[i])) for i in sel]
        if order == "DESC":
            pairs.sort(key=lambda p: -p[1])
        else:
            pairs.sort(key=lambda p: p[1])
        if count is not None:
            pairs = pairs[:count]
        return pairs

    def search_radius(
        self,
        lon: float,
        lat: float,
        radius: float,
        unit: str = "m",
        count: Optional[int] = None,
        order: Optional[str] = "ASC",
    ) -> List:
        """GEOSEARCH FROMLONLAT BYRADIUS."""
        pairs = self._search_point(lon, lat, radius * _UNITS[unit], count, order)
        return [self._d(m) for m, _ in pairs]

    def search_radius_with_distance(
        self, lon, lat, radius, unit: str = "m", count=None, order="ASC"
    ) -> Dict[Any, float]:
        pairs = self._search_point(lon, lat, radius * _UNITS[unit], count, order)
        u = _UNITS[unit]
        return {self._d(m): d / u for m, d in pairs}

    def search_member_radius(self, member, radius: float, unit: str = "m", count=None, order="ASC") -> List:
        """GEOSEARCH FROMMEMBER."""
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        p = rec.host.get(self._e(member))
        if p is None:
            raise KeyError(f"could not decode requested zset member {member!r}")
        return self.search_radius(p[0], p[1], radius, unit, count, order)

    def search_box(self, lon: float, lat: float, width: float, height: float, unit: str = "m") -> List:
        """GEOSEARCH BYBOX (width/height centered on the point)."""
        rec = self._engine.store.get(self._name)
        if rec is None or not rec.host:
            return []
        w_m, h_m = width * _UNITS[unit] / 2, height * _UNITS[unit] / 2
        members, pts = _points(rec)
        dx = _haversine_m(lon, pts[:, 1], pts[:, 0], pts[:, 1])  # along-lat distance
        dy = _haversine_m(lon, lat, lon, pts[:, 1])
        sel = np.nonzero((dx <= w_m) & (dy <= h_m))[0]
        return [self._d(members[i]) for i in sel]

    def store_search_radius_to(self, dest_name: str, lon, lat, radius, unit: str = "m") -> int:
        """GEOSEARCHSTORE: store hits (as a geo set) into dest."""
        return self.store_search_to(
            dest_name, GeoSearchArgs.from_coords(lon, lat).radius(radius, unit)
        )

    # -- GeoSearchArgs surface (api/geo/GeoSearchArgs parity) ----------------

    def _eval_args(self, args: GeoSearchArgs) -> List[Tuple[bytes, float]]:
        """(encoded member, distance_m) pairs for any origin/shape combo,
        ordered per args (nearest-first by default)."""
        rec = self._engine.store.get(self._name)
        if args._member is not None:
            # a missing FROMMEMBER origin errors even on an empty key
            # (Redis: "could not decode requested zset member")
            p = rec.host.get(self._e(args._member)) if rec is not None else None
            if p is None:
                raise KeyError(
                    f"could not decode requested zset member {args._member!r}"
                )
            lon, lat = p
        else:
            lon, lat = args._point
        if rec is None or not rec.host:
            return []
        members, pts = _points(rec)
        d = _haversine_m(lon, lat, pts[:, 0], pts[:, 1])
        if args._radius is not None:
            r, unit = args._radius
            sel = np.nonzero(d <= r * _UNITS[unit])[0]
        elif args._box is not None:
            w, h, unit = args._box
            w_m, h_m = w * _UNITS[unit] / 2, h * _UNITS[unit] / 2
            dx = _haversine_m(lon, pts[:, 1], pts[:, 0], pts[:, 1])
            dy = _haversine_m(lon, lat, lon, pts[:, 1])
            sel = np.nonzero((dx <= w_m) & (dy <= h_m))[0]
        else:
            raise ValueError("GeoSearchArgs needs .radius() or .box()")
        pairs = [(members[i], float(d[i])) for i in sel]
        pairs.sort(key=lambda p: -p[1] if args.order == "DESC" else p[1])
        if args.count is not None:
            pairs = pairs[: args.count]
        return pairs

    def _result_unit(self, args: GeoSearchArgs) -> float:
        shape = args._radius or args._box
        return _UNITS[shape[-1] if shape else "m"]

    def search(self, args: GeoSearchArgs) -> List:
        """RGeo.search(GeoSearchArgs) (RedissonGeo.java search surface)."""
        return [self._d(m) for m, _ in self._eval_args(args)]

    def search_with_distance(self, args: GeoSearchArgs) -> Dict[Any, float]:
        u = self._result_unit(args)
        return {self._d(m): d / u for m, d in self._eval_args(args)}

    def search_with_position_args(self, args: GeoSearchArgs) -> Dict[Any, Tuple[float, float]]:
        members = self.search(args)
        positions = self.pos(*members)
        return {m: positions[m] for m in members if positions.get(m) is not None}

    def store_search_to(self, dest_name: str, args: GeoSearchArgs) -> int:
        """GEOSEARCHSTORE (RGeo.storeSearchTo): hits land in dest, replacing
        it — Redis GEOSEARCHSTORE overwrites the destination key."""
        pairs = self._eval_args(args)
        dest = Geo(self._engine, dest_name, self._codec)  # maps dest_name
        with self._engine.locked_many((self._name, dest._name)):
            # re-fetch the source UNDER the lock: members matched by the
            # pre-lock evaluation may have been concurrently removed — skip
            # them instead of raising KeyError after dest was already cleared
            rec = self._engine.store.get(self._name)
            src = rec.host if rec is not None else {}
            drec = dest._rec_or_create()
            drec.host.clear()
            stored = 0
            for m, _ in pairs:
                p = src.get(m)
                if p is None:
                    continue  # vanished between evaluation and the lock
                drec.host[m] = p
                stored += 1
            self._touch_version(drec)
        return stored

    def store_sorted_search_to(self, dest_name: str, args: GeoSearchArgs) -> int:
        """GEOSEARCHSTORE STOREDIST analog: dest iterates nearest-first
        (RGeo.storeSortedSearchTo; read_all order is insertion order here,
        which _eval_args makes distance-ascending unless args order says
        otherwise)."""
        return self.store_search_to(dest_name, args)

    def read_all(self) -> List:
        """Every member, in stored (insertion / store-order) sequence."""
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [self._d(m) for m in rec.host.keys()]

    def size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host)
