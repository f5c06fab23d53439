"""Redis-stack module verbs: JSON.* (RedisJSON role) and FT.* (RediSearch role).

One module per verb family, shared preludes in verbs/common.py so
numkeys/syntax validation cannot diverge between families.

A copy of ``redisson_tpu/server/verbs/modules.py`` for the port's server.
KNN replies (FT.SEARCH, FT.MSEARCH) are ``LazyReply``s over the vector
kernels' outputs, read back with the rest of the frame; a kernel that fails
replies an error, never a slower path.  A VECTOR field with SHARDS n > 1 is
a sharded bank (``services/vector.ShardedEmbeddingBank``): FT.INFO lists
its shards.
"""


from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import register, _s, _int
from redisson_tpu_torch.server.verbs.common import _fnum

# -- redis-stack module verbs: JSON.* (RedisJSON role — RedissonJsonBucket
# -- drives these same verbs in the reference) -------------------------------

def _json(server, name: str):
    from redisson_tpu_torch.client.objects.binarystream import JsonBucket

    return JsonBucket(server.engine, name)  # codec-free: documents are parsed JSON


def _json_cmd(fn):
    """Map JsonBucket exceptions (bad paths, type mismatches) to ERR replies."""
    import functools

    @functools.wraps(fn)
    def wrapper(server, ctx, args):
        import json as _j

        try:
            return fn(server, ctx, args, _j)
        except (KeyError, IndexError) as e:
            raise RespError(f"ERR Path does not exist: {e.args[0] if e.args else e}")
        except (TypeError, ValueError) as e:
            raise RespError(f"ERR {e}")

    return wrapper


@register("JSON.SET")
@_json_cmd
def cmd_json_set(server, ctx, args, _j):
    """JSON.SET key path json [NX|XX]."""
    name, path = _s(args[0]), _s(args[1])
    value = _j.loads(bytes(args[2]))
    mode = bytes(args[3]).upper() if len(args) > 3 else None
    jb = _json(server, name)
    if mode in (b"NX", b"XX"):
        existing = jb.get(path)  # returns None for missing paths, never raises
        if (mode == b"NX" and existing is not None) or (mode == b"XX" and existing is None):
            return None
    elif mode is not None:
        raise RespError("ERR syntax error")
    jb.set(path, value)
    return "+OK"


@register("JSON.GET")
@_json_cmd
def cmd_json_get(server, ctx, args, _j):
    """JSON.GET key [path ...] — one path returns its value; several return
    a {path: value} object (RedisJSON reply shape)."""
    jb = _json(server, _s(args[0]))
    paths = [_s(p) for p in args[1:]] or ["$"]
    # JsonBucket.get swallows path errors and returns None; reply nil like
    # RedisJSON (a stored JSON null also reads nil — simplified path
    # semantics, the same trade the handle itself makes)
    if len(paths) == 1:
        v = jb.get(paths[0])
        return None if v is None else _j.dumps(v).encode()
    return _j.dumps({p: jb.get(p) for p in paths}).encode()


@register("JSON.DEL")
@_json_cmd
def cmd_json_del(server, ctx, args, _j):
    jb = _json(server, _s(args[0]))
    return 1 if jb.delete(_s(args[1]) if len(args) > 1 else "$") else 0


@register("JSON.TYPE")
@_json_cmd
def cmd_json_type(server, ctx, args, _j):
    t = _json(server, _s(args[0])).type(_s(args[1]) if len(args) > 1 else "$")
    return None if t is None else t.encode()


@register("JSON.NUMINCRBY")
@_json_cmd
def cmd_json_numincrby(server, ctx, args, _j):
    v = _json(server, _s(args[0])).increment_and_get(_s(args[1]), _j.loads(bytes(args[2])))
    return _j.dumps(v).encode()


@register("JSON.STRAPPEND")
@_json_cmd
def cmd_json_strappend(server, ctx, args, _j):
    return _json(server, _s(args[0])).string_append(_s(args[1]), _j.loads(bytes(args[2])))


@register("JSON.STRLEN")
@_json_cmd
def cmd_json_strlen(server, ctx, args, _j):
    return _json(server, _s(args[0])).string_size(_s(args[1]) if len(args) > 1 else "$")


@register("JSON.ARRAPPEND")
@_json_cmd
def cmd_json_arrappend(server, ctx, args, _j):
    vals = [_j.loads(bytes(a)) for a in args[2:]]
    return _json(server, _s(args[0])).array_append(_s(args[1]), *vals)


@register("JSON.ARRINSERT")
@_json_cmd
def cmd_json_arrinsert(server, ctx, args, _j):
    vals = [_j.loads(bytes(a)) for a in args[3:]]
    return _json(server, _s(args[0])).array_insert(_s(args[1]), _int(args[2]), *vals)


@register("JSON.ARRLEN")
@_json_cmd
def cmd_json_arrlen(server, ctx, args, _j):
    return _json(server, _s(args[0])).array_size(_s(args[1]) if len(args) > 1 else "$")


@register("JSON.ARRPOP")
@_json_cmd
def cmd_json_arrpop(server, ctx, args, _j):
    idx = _int(args[2]) if len(args) > 2 else -1
    v = _json(server, _s(args[0])).array_pop(_s(args[1]) if len(args) > 1 else "$", idx)
    return None if v is None else _j.dumps(v).encode()


@register("JSON.ARRTRIM")
@_json_cmd
def cmd_json_arrtrim(server, ctx, args, _j):
    return _json(server, _s(args[0])).array_trim(_s(args[1]), _int(args[2]), _int(args[3]))


@register("JSON.ARRINDEX")
@_json_cmd
def cmd_json_arrindex(server, ctx, args, _j):
    start = _int(args[3]) if len(args) > 3 else 0
    stop = _int(args[4]) if len(args) > 4 else 0
    return _json(server, _s(args[0])).array_index_of(
        _s(args[1]), _j.loads(bytes(args[2])), start, stop
    )


@register("JSON.OBJKEYS")
@_json_cmd
def cmd_json_objkeys(server, ctx, args, _j):
    ks = _json(server, _s(args[0])).object_keys(_s(args[1]) if len(args) > 1 else "$")
    return None if ks is None else [k.encode() for k in ks]


@register("JSON.OBJLEN")
@_json_cmd
def cmd_json_objlen(server, ctx, args, _j):
    return _json(server, _s(args[0])).object_size(_s(args[1]) if len(args) > 1 else "$")


@register("JSON.CLEAR")
@_json_cmd
def cmd_json_clear(server, ctx, args, _j):
    return _json(server, _s(args[0])).clear(_s(args[1]) if len(args) > 1 else "$")


@register("JSON.TOGGLE")
@_json_cmd
def cmd_json_toggle(server, ctx, args, _j):
    v = _json(server, _s(args[0])).toggle(_s(args[1]))
    return None if v is None else int(v)


@register("JSON.MERGE")
@_json_cmd
def cmd_json_merge(server, ctx, args, _j):
    _json(server, _s(args[0])).merge(_s(args[1]), _j.loads(bytes(args[2])))
    return "+OK"


# -- redis-stack module verbs: FT.* (RediSearch role — RedissonSearch.java
# -- drives these same verbs in the reference) -------------------------------

def _ft(server):
    from redisson_tpu_torch.services.search import SearchService

    return server.engine.service("search", lambda: SearchService(server.engine))


import re as _knn_re

# `(<filter>)=>[KNN <k> @<field> $<param> [AS <alias>]]` — the RediSearch
# vector-query arm (dialect 2).  The filter half feeds the ordinary query
# planner; its candidate set lowers onto the score matrix as an additive
# -inf bias (services/search.knn), so hybrid queries stay ONE kernel.
_KNN_ARM = _knn_re.compile(
    r"^\s*(?:\((?P<filt>.*)\)|(?P<star>\*))\s*=>\s*\[\s*KNN\s+"
    r"(?P<k>\d+)\s+@(?P<field>\w+)\s+\$(?P<param>\w+)"
    r"(?:\s+AS\s+(?P<alias>\w+))?\s*\]\s*$",
    _knn_re.IGNORECASE | _knn_re.DOTALL,
)


def _ft_split_knn(q: str):
    """Split a query into (filter-query, knn-spec|None).  Non-KNN queries
    pass through unchanged."""
    m = _KNN_ARM.match(q)
    if m is None:
        return q, None
    filt = "*" if m.group("star") else (m.group("filt") or "*")
    return filt, {
        "k": int(m.group("k")),
        "field": m.group("field"),
        "param": m.group("param"),
        "alias": m.group("alias"),
    }


def _ft_parse_query(q: str, schema: dict):
    """RediSearch query subset -> Condition tree: `*`, `@f:[lo hi]` numeric
    ranges ('(' = exclusive, ±inf), `@f:{tag|tag}`, `@f:text`, `@f:(txt)`,
    bare words (full-text across every TEXT field); top-level terms AND."""
    import re as _re

    from redisson_tpu_torch.services.search import And, Eq, In, Or, Range, Text

    q = q.strip()
    if q in ("*", ""):
        return None
    tokens = _re.findall(
        r"@\w+:\[[^\]]*\]|@\w+:\{[^}]*\}|@\w+:\([^)]*\)|@\w+:\S+|\S+", q
    )

    def bound(s):
        inc = not s.startswith("(")
        s = s.lstrip("(")
        if s in ("-inf", "inf", "+inf"):
            return (float("-inf") if s == "-inf" else float("inf")), inc
        return float(s), inc

    terms = []
    for t in tokens:
        if t.startswith("@"):
            fld, _, rest = t[1:].partition(":")
            if rest.startswith("["):
                body = rest[1:-1].split()
                if len(body) != 2:
                    raise RespError("ERR Syntax error in numeric range")
                (lo, lo_inc), (hi, hi_inc) = bound(body[0]), bound(body[1])
                terms.append(Range(fld, lo, hi, lo_inc, hi_inc))
            elif rest.startswith("{"):
                vals = [v.strip() for v in rest[1:-1].split("|") if v.strip()]
                if not vals:
                    raise RespError("ERR syntax error: empty tag set")
                terms.append(Eq(fld, vals[0]) if len(vals) == 1 else In(fld, vals))
            elif rest.startswith("("):
                terms.append(Text(fld, rest[1:-1]))
            else:
                terms.append(Text(fld, rest))
        else:
            text_fields = [f for f, ty in schema.items() if ty == "TEXT"]
            if not text_fields:
                raise RespError(f"ERR no TEXT field for bare term '{t}'")
            parts = [Text(f, t) for f in text_fields]
            terms.append(parts[0] if len(parts) == 1 else Or(parts))
    return terms[0] if len(terms) == 1 else And(terms)


def _ft_invalidate(server, ctx, index_name: str) -> None:
    """Index DDL / ingest invalidates the index's synthetic QUERY KEY
    (services/search.query_key): tracked FT.SEARCH results near-cache
    client-side and must go stale whenever the index can change.  Plain
    writes under the index prefixes invalidate through the TrackingTable
    post-dispatch hook; DDL verbs call this directly."""
    track = getattr(server, "tracking", None)
    if track is None or not track.active:
        return
    svc = _ft(server)
    try:
        track.note_write([svc.query_key(svc.resolve(index_name))], None)
    except Exception:  # noqa: BLE001 — invalidation must not fail the verb
        pass


def _ft_track_read(server, ctx, index_name: str) -> None:
    """Register a tracked connection's interest in the index's query key —
    the FT analog of the pre-dispatch read registration (FT.* is keyless,
    so the generic hook never sees it)."""
    track = getattr(server, "tracking", None)
    if track is None or not track.active or ctx.tracking is None:
        return
    svc = _ft(server)
    try:
        track.note_read(ctx, [svc.query_key(svc.resolve(index_name))])
    except Exception:  # noqa: BLE001
        pass


def _ft_cmd(fn):
    """Map malformed FT arguments/queries to syntax errors, missing indexes
    to the RediSearch wording — never 'ERR internal'."""
    import functools

    @functools.wraps(fn)
    def wrapper(server, ctx, args):
        try:
            return fn(server, ctx, args)
        except KeyError:
            raise RespError("ERR Unknown Index name")
        except (ValueError, IndexError) as e:
            raise RespError(f"ERR syntax error: {e}")

    return wrapper


@register("FT.CREATE")
@_ft_cmd
def cmd_ft_create(server, ctx, args):
    """FT.CREATE idx [ON HASH] [PREFIX n p...] SCHEMA f TYPE [SORTABLE] ...

    VECTOR attributes use the RediSearch shape:
    ``f VECTOR {FLAT|IVF} <nargs> TYPE {FLOAT32|FLOAT16|INT8} DIM d
    DISTANCE_METRIC {L2|COSINE|IP} [NLIST n] [NPROBE p] [TRAIN_MIN t]
    [SHARDS s]``
    (the nargs pairs may arrive in any order).  IVF routes queries through
    a trained coarse-centroid bank and scores only the top-NPROBE cells;
    FLOAT16/INT8 compress the bank at upload and dequantize in-kernel;
    SHARDS s > 1 splits the bank row-wise across s mesh positions with an
    on-device top-k merge; all three axes compose (services/vector.py).
    Each VECTOR field gets an embedding bank owned by the index's slot
    position (by each shard's, sharded)."""
    name = _s(args[0])
    prefixes = [""]
    i = 1
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"ON":
            if bytes(args[i + 1]).upper() != b"HASH":
                raise RespError("ERR only ON HASH indexes are supported")
            i += 2
        elif opt == b"PREFIX":
            n = _int(args[i + 1])
            prefixes = [_s(p) for p in args[i + 2 : i + 2 + n]]
            i += 2 + n
        elif opt == b"SCHEMA":
            i += 1
            break
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    else:
        raise RespError("ERR SCHEMA is required")
    schema = {}
    vector = {}
    while i < len(args):
        fld = _s(args[i])
        ty = bytes(args[i + 1]).upper().decode()
        if ty == "VECTOR":
            algo = _s(args[i + 2]).upper()
            nargs = _int(args[i + 3])
            if nargs % 2 or i + 4 + nargs > len(args):
                raise RespError("ERR bad vector attribute count")
            attrs = {}
            for j in range(i + 4, i + 4 + nargs, 2):
                attrs[_s(args[j]).upper()] = _s(args[j + 1])
            missing = {"TYPE", "DIM", "DISTANCE_METRIC"} - set(attrs)
            if missing:
                raise RespError(
                    f"ERR vector attribute(s) missing: {sorted(missing)}"
                )
            vector[fld] = {
                "dim": _int(attrs["DIM"].encode()),
                "metric": attrs["DISTANCE_METRIC"],
                "dtype": attrs["TYPE"],
                "algo": algo,
            }
            for opt_attr, key in (("NLIST", "nlist"), ("NPROBE", "nprobe"),
                                  ("TRAIN_MIN", "train_min"),
                                  ("SHARDS", "shards")):
                if opt_attr in attrs:
                    vector[fld][key] = _int(attrs[opt_attr].encode())
            schema[fld] = "VECTOR"
            i += 4 + nargs
        elif ty in ("TEXT", "TAG", "NUMERIC"):
            schema[fld] = ty
            i += 2
        else:
            raise RespError(f"ERR unsupported field type '{ty}'")
        if i < len(args) and bytes(args[i]).upper() == b"SORTABLE":
            i += 1  # everything is sortable here
    try:
        _ft(server).create(name, schema, prefixes, doc_mode="hash",
                           vector=vector)
    except ValueError as e:
        raise RespError(f"ERR {e}")
    _ft_invalidate(server, ctx, name)
    return "+OK"


@register("FT.DROPINDEX")
@_ft_cmd
def cmd_ft_dropindex(server, ctx, args):
    _ft_invalidate(server, ctx, _s(args[0]))  # before the name resolves away
    if not _ft(server).drop_index(_s(args[0])):
        raise RespError("ERR Unknown Index name")
    return "+OK"


@register("FT._LIST")
@_ft_cmd
def cmd_ft_list(server, ctx, args):
    return [n.encode() for n in _ft(server).index_names()]


@register("FT.INFO")
@_ft_cmd
def cmd_ft_info(server, ctx, args):
    svc = _ft(server)
    idx = svc._idx(_s(args[0]))  # KeyError -> Unknown Index via _ft_cmd
    svc.sync(_s(args[0]))
    info = svc.info(_s(args[0]))
    vec_rows = {r["field"]: r for r in info.get("vector_fields", [])}
    flat_schema = []
    for f, ty in info["schema"].items():
        row = [f.encode(), b"type", ty.encode()]
        vr = vec_rows.get(f)
        if vr is not None:
            # the vector attribute's full shape: dim/metric/rows/bytes —
            # the per-field half of the HBM ledger FT.INFO exposes.
            # device_bytes is the QUANTIZED (actual) residency, not the
            # logical f32 size — compressed banks report what they hold
            row += [
                b"algorithm", vr["algo"].encode(),
                b"data_type", vr["dtype"].encode(),
                b"dim", vr["dim"],
                b"distance_metric", vr["metric"].encode(),
                b"rows", vr["rows"],
                b"device_bytes", vr["device_bytes"],
            ]
            if vr["algo"] == "IVF":
                row += [
                    b"nlist", vr["nlist"],
                    b"nprobe", vr["nprobe"],
                    b"trained", 1 if vr["trained"] else 0,
                    b"index_device_bytes", vr["index_device_bytes"],
                ]
            if "shards" in vr:
                # sharded bank: shard count + one nested
                # row per shard — rows / owning device / residency, the
                # per-shard half of the HBM ledger
                row += [
                    b"shards", vr["shards"],
                    b"shard_rows", [
                        [
                            b"shard", sr["shard"],
                            b"rows", sr["rows"],
                            b"device", sr["device"],
                            b"device_bytes", sr["device_bytes"],
                            b"index_device_bytes",
                            sr["index_device_bytes"],
                        ]
                        for sr in vr.get("shard_rows", [])
                    ],
                ]
        flat_schema.append(row)
    out = [
        b"index_name", info["name"].encode(),
        b"num_docs", info["num_docs"],
        b"attributes", flat_schema,
        b"prefixes", [p.encode() for p in info["prefixes"]],
    ]
    if "vector_device_bytes" in info:
        out += [b"vector_device_bytes", info["vector_device_bytes"]]
        out += [b"vector_index_bytes", info.get("vector_index_bytes", 0)]
    return out


def _ft_field_blob(v) -> bytes:
    """Reply encoding of one stored field value — raw bytes (vector blobs)
    pass through untouched, everything else stringifies."""
    return bytes(v) if isinstance(v, (bytes, bytearray)) else str(v).encode()


def _ft_score_bytes(d: float) -> bytes:
    """Distance formatting for KNN replies: fixed 4-decimal text, so the
    armed (device f32) and disarmed (NumPy f32) paths — which may differ in
    the last ulp from reduction order — encode identically on the wire."""
    return (b"%.4f" % d)


def _ft_parse_search_opts(args, i):
    """Shared FT.SEARCH/FT.MSEARCH option tail: NOCONTENT / SORTBY / LIMIT /
    PARAMS / DIALECT / NPROBE / WITHCURSOR [COUNT n]."""
    opts = {
        "nocontent": False, "sort_by": None, "desc": False,
        "off": 0, "lim": 10, "params": {}, "withcursor": False,
        "cursor_count": 10, "nprobe": None,
    }
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"NOCONTENT":
            opts["nocontent"] = True
            i += 1
        elif opt == b"SORTBY":
            opts["sort_by"] = _s(args[i + 1])
            i += 2
            if i < len(args) and bytes(args[i]).upper() in (b"ASC", b"DESC"):
                opts["desc"] = bytes(args[i]).upper() == b"DESC"
                i += 1
        elif opt == b"LIMIT":
            opts["off"], opts["lim"] = _int(args[i + 1]), _int(args[i + 2])
            i += 3
        elif opt == b"PARAMS":
            n = _int(args[i + 1])
            if n % 2:
                raise RespError("ERR PARAMS count must be even")
            for j in range(i + 2, i + 2 + n, 2):
                opts["params"][_s(args[j])] = bytes(args[j + 1])
            i += 2 + n
        elif opt == b"DIALECT":
            i += 2  # accepted for driver compatibility; grammar is fixed
        elif opt == b"NPROBE":
            # per-query IVF probe width (the recall/latency dial); rejected
            # downstream for non-IVF fields
            opts["nprobe"] = _int(args[i + 1])
            if opts["nprobe"] <= 0:
                raise RespError("ERR NPROBE must be positive")
            i += 2
        elif opt == b"WITHCURSOR":
            opts["withcursor"] = True
            i += 1
            if i + 1 < len(args) and bytes(args[i]).upper() == b"COUNT":
                opts["cursor_count"] = _int(args[i + 1])
                i += 2
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    return opts


def _ft_knn_query_vectors(server, idx, knn, params, expect_multiple=False):
    """Decode the KNN arm's $param blob into (Q, dim) float32 queries."""
    import numpy as np

    spec = idx.vector_specs.get(knn["field"])
    if spec is None:
        raise RespError(
            f"ERR '{knn['field']}' is not a VECTOR field of '{idx.name}'"
        )
    blob = params.get(knn["param"])
    if blob is None:
        raise RespError(f"ERR missing PARAMS value for ${knn['param']}")
    if len(blob) == 0 or len(blob) % (spec.dim * 4):
        raise RespError(
            f"ERR vector blob of {len(blob)} bytes does not pack DIM "
            f"{spec.dim} float32 vectors"
        )
    q = np.frombuffer(blob, dtype="<f4").reshape(-1, spec.dim)
    if not expect_multiple and q.shape[0] != 1:
        raise RespError("ERR FT.SEARCH KNN takes exactly one query vector")
    return np.ascontiguousarray(q, np.float32)


def _ft_knn_reply(idx, hits, opts, score_field):
    """One query's [(doc_id, dist), ...] -> the FT.SEARCH reply rows.

    Plain mode returns the flat RediSearch shape
    ``[total, id, [f, v, ..., score_field, score], ...]`` (LIMIT applies to
    the k hits).  WITHCURSOR returns ``[[n, [id, flds], ...], cid]`` — rows
    nest so FT.CURSOR READ pages the SAME shape (k > COUNT spills into the
    cursor; services/search cursor expiry/cap applies)."""
    rows = []
    for doc_id, dist in hits:
        fields = idx.docs.get(doc_id)
        if opts["nocontent"]:
            flat = [score_field.encode(), _ft_score_bytes(dist)]
        else:
            flat = []
            for k, v in (fields or {}).items():
                flat += [str(k).encode(), _ft_field_blob(v)]
            flat += [score_field.encode(), _ft_score_bytes(dist)]
        rows.append([doc_id.encode(), flat])
    return rows


@register("FT.SEARCH")
@_ft_cmd
def cmd_ft_search(server, ctx, args):
    """FT.SEARCH idx query [NOCONTENT] [SORTBY f [ASC|DESC]] [LIMIT off n]
    [PARAMS n k v ...] [DIALECT d] [WITHCURSOR [COUNT n]]
    -> [total, id, [f, v, ...], ...] (RediSearch reply shape).

    The KNN arm ``(filter)=>[KNN k @f $vec]`` scores on the index's
    device-resident embedding bank as ONE matmul-top-k kernel and replies
    lazily: the (dist, idx) kernel outputs ride the frame-grouped readback
    (LazyReply), so M concurrent KNN frames cost <= M+1 blocking syncs.
    Results carry ``__<field>_score`` (distance, 4 decimals, ascending).
    WITHCURSOR pages k > COUNT hits through FT.CURSOR READ (nested-row
    shape, see _ft_knn_reply)."""
    from redisson_tpu_torch.server.registry import LazyReply

    svc = _ft(server)
    idx = svc._idx(_s(args[0]))  # KeyError -> Unknown Index via _ft_cmd
    _ft_track_read(server, ctx, _s(args[0]))
    svc.sync(svc.resolve(_s(args[0])))
    qstr, knn = _ft_split_knn(_s(args[1]))
    opts = _ft_parse_search_opts(args, 2)
    cond = _ft_parse_query(qstr, idx.schema)

    if knn is None:
        if opts["withcursor"]:
            raise RespError("ERR WITHCURSOR requires a KNN query")
        res = svc.search(_s(args[0]), cond, sort_by=opts["sort_by"],
                         descending=opts["desc"], offset=opts["off"],
                         limit=opts["lim"])
        out = [res.total]
        for doc_id, fields in res.docs:
            out.append(doc_id.encode())
            if not opts["nocontent"]:
                flat = []
                for k, v in fields.items():
                    flat += [str(k).encode(), _ft_field_blob(v)]
                out.append(flat)
        return out

    # -- KNN path -------------------------------------------------------------
    if knn["k"] <= 0:
        raise RespError("ERR KNN k must be positive")
    if opts["sort_by"] is not None and opts["sort_by"] != (
        knn["alias"] or f"__{knn['field']}_score"
    ):
        raise RespError("ERR KNN results sort by the vector score")
    q = _ft_knn_query_vectors(server, idx, knn, opts["params"])
    try:
        device, finish = svc.knn(
            _s(args[0]), knn["field"], q, knn["k"], condition=cond,
            nprobe=opts["nprobe"],
        )
    except ValueError as e:
        raise RespError(f"ERR {e}")
    score_field = knn["alias"] or f"__{knn['field']}_score"

    def encode(vals):
        hits = finish(vals)[0]
        if opts["desc"]:
            hits = hits[::-1]  # SORTBY <score> DESC: farthest-first paging
        rows = _ft_knn_reply(idx, hits, opts, score_field)
        if opts["withcursor"]:
            count = max(1, opts["cursor_count"])
            batch, rest = rows[:count], rows[count:]
            cid = svc.cursor_create(rest) if rest else 0
            return [[len(batch)] + batch, cid]
        rows = rows[opts["off"] : opts["off"] + opts["lim"]]
        out = [len(hits)]
        for doc_id, flat in rows:
            out.append(doc_id)
            out.append(flat)
        return out

    if device is None:  # disarmed (RTPU_NO_VECTOR) or empty index/filter
        return encode(None)
    return LazyReply(device=device, finish=encode)


@register("FT.MSEARCH")
@_ft_cmd
def cmd_ft_msearch(server, ctx, args):
    """FT.MSEARCH idx query [PARAMS ...] — the batched multi-query KNN
    path: the $param blob packs Q stacked float32 vectors (Q*dim*4 bytes)
    and the whole batch scores as ONE stacked matmul-top-k dispatch (a
    coalesced run of same-index KNN frames in a single command).  Reply:
    ``[Q, [id, score, id, score, ...] per query]`` — ids+scores only, the
    throughput projection."""
    from redisson_tpu_torch.server.registry import LazyReply

    svc = _ft(server)
    idx = svc._idx(_s(args[0]))
    _ft_track_read(server, ctx, _s(args[0]))
    svc.sync(svc.resolve(_s(args[0])))
    qstr, knn = _ft_split_knn(_s(args[1]))
    if knn is None:
        raise RespError("ERR FT.MSEARCH requires a KNN query")
    opts = _ft_parse_search_opts(args, 2)
    if opts["withcursor"]:
        raise RespError("ERR FT.MSEARCH does not support WITHCURSOR")
    cond = _ft_parse_query(qstr, idx.schema)
    q = _ft_knn_query_vectors(server, idx, knn, opts["params"],
                              expect_multiple=True)
    try:
        device, finish = svc.knn(
            _s(args[0]), knn["field"], q, knn["k"], condition=cond,
            nprobe=opts["nprobe"],
        )
    except ValueError as e:
        raise RespError(f"ERR {e}")

    def encode(vals):
        per_query = finish(vals)
        out = [len(per_query)]
        for hits in per_query:
            flat = []
            for doc_id, dist in hits:
                flat += [doc_id.encode(), _ft_score_bytes(dist)]
            out.append(flat)
        return out

    if device is None:
        return encode(None)
    return LazyReply(device=device, finish=encode)


@register("FT.AGGREGATE")
@_ft_cmd
def cmd_ft_aggregate(server, ctx, args):
    """FT.AGGREGATE idx query [GROUPBY 1 @f REDUCE op n [@f] AS name ...]
    [SORTBY n @f [ASC|DESC]] [LIMIT off n] [WITHCURSOR [COUNT n]]."""
    svc = _ft(server)
    idx = svc._idx(_s(args[0]))  # KeyError -> Unknown Index via _ft_cmd
    svc.sync(svc.resolve(_s(args[0])))
    cond = _ft_parse_query(_s(args[1]), idx.schema)
    group_by, reducers = None, {}
    sort_by, desc = None, False
    off, lim = 0, None
    withcursor, cursor_count = False, 1000
    i = 2
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"WITHCURSOR":
            withcursor = True
            i += 1
            if i + 1 < len(args) and bytes(args[i]).upper() == b"COUNT":
                cursor_count = _int(args[i + 1])
                i += 2
        elif opt == b"GROUPBY":
            if _int(args[i + 1]) != 1:
                raise RespError("ERR GROUPBY supports exactly one property")
            group_by = _s(args[i + 2]).lstrip("@")
            i += 3
        elif opt == b"REDUCE":
            op = _s(args[i + 1]).lower()
            if op not in ("count", "sum", "avg", "min", "max"):
                raise RespError(f"ERR unsupported reducer '{op}'")
            nargs = _int(args[i + 2])
            fld = _s(args[i + 3]).lstrip("@") if nargs else None
            i += 3 + nargs
            name = f"{op}({fld or ''})"
            if i < len(args) and bytes(args[i]).upper() == b"AS":
                name = _s(args[i + 1])
                i += 2
            reducers[name] = (op, fld)
        elif opt == b"SORTBY":
            n = _int(args[i + 1])
            sort_by = _s(args[i + 2]).lstrip("@")
            if n > 1:
                desc = bytes(args[i + 3]).upper() == b"DESC"
            i += 2 + n
        elif opt == b"LIMIT":
            off, lim = _int(args[i + 1]), _int(args[i + 2])
            i += 3
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    rows = svc.aggregate(_s(args[0]), cond, group_by=group_by,
                         reducers=reducers or None, sort_by=sort_by,
                         descending=desc, offset=off, limit=lim)
    flat_rows = []
    for row in rows:
        flat = []
        for k, v in row.items():
            flat += [str(k).encode(), str(v).encode()]
        flat_rows.append(flat)
    if withcursor:
        batch, rest = flat_rows[:cursor_count], flat_rows[cursor_count:]
        cid = svc.cursor_create(rest) if rest else 0
        return [[len(batch)] + batch, cid]
    return [len(flat_rows)] + flat_rows


@register("FT.CURSOR")
@_ft_cmd
def cmd_ft_cursor(server, ctx, args):
    """FT.CURSOR READ idx cid [COUNT n] | FT.CURSOR DEL idx cid — pages a
    WITHCURSOR aggregation (RediSearch cursor API)."""
    svc = _ft(server)
    sub = bytes(args[0]).upper()
    cid = _int(args[2])
    if sub == b"READ":
        count = 1000
        if len(args) > 4 and bytes(args[3]).upper() == b"COUNT":
            count = _int(args[4])
        rows, nxt = svc.cursor_read(cid, count)  # KeyError -> unknown cursor
        return [[len(rows)] + rows, nxt]
    if sub == b"DEL":
        svc.cursor_del(cid)
        return "+OK"
    raise RespError("ERR syntax error")


@register("FT.ALTER")
@_ft_cmd
def cmd_ft_alter(server, ctx, args):
    """FT.ALTER idx SCHEMA ADD field type [SORTABLE]."""
    if (
        len(args) < 5
        or bytes(args[1]).upper() != b"SCHEMA"
        or bytes(args[2]).upper() != b"ADD"
    ):
        raise RespError("ERR syntax error")
    ty = bytes(args[4]).upper().decode()
    if ty not in ("TEXT", "TAG", "NUMERIC"):
        raise RespError(f"ERR unsupported field type '{ty}'")
    try:
        _ft(server).alter(_s(args[0]), _s(args[3]), ty)
    except ValueError as e:
        raise RespError(f"ERR {e}")
    _ft_invalidate(server, ctx, _s(args[0]))
    return "+OK"


@register("FT.ALIASADD")
@_ft_cmd
def cmd_ft_aliasadd(server, ctx, args):
    try:
        _ft(server).alias_add(_s(args[0]), _s(args[1]))
    except ValueError as e:
        raise RespError(f"ERR {e}")
    return "+OK"


@register("FT.ALIASUPDATE")
@_ft_cmd
def cmd_ft_aliasupdate(server, ctx, args):
    _ft(server).alias_update(_s(args[0]), _s(args[1]))
    return "+OK"


@register("FT.ALIASDEL")
@_ft_cmd
def cmd_ft_aliasdel(server, ctx, args):
    try:
        _ft(server).alias_del(_s(args[0]))
    except ValueError as e:
        raise RespError(f"ERR {e}")
    return "+OK"


@register("FT.SYNUPDATE")
@_ft_cmd
def cmd_ft_synupdate(server, ctx, args):
    """FT.SYNUPDATE idx group_id [SKIPINITIALSCAN] term... — terms join the
    synonym group; query-time TEXT matching expands through groups
    (services/search.py SearchIndex.syn_update)."""
    idx = _ft(server)._idx(_s(args[0]))
    group = _s(args[1])
    terms = [_s(a) for a in args[2:]]
    if terms and terms[0].upper() == "SKIPINITIALSCAN":
        terms = terms[1:]  # groups apply query-side: no rescan either way
    if not terms:
        raise RespError("ERR FT.SYNUPDATE needs at least one term")
    idx.syn_update(group, terms)
    _ft_invalidate(server, ctx, _s(args[0]))
    return "+OK"


@register("FT.SYNDUMP")
@_ft_cmd
def cmd_ft_syndump(server, ctx, args):
    """FT.SYNDUMP idx -> flat [term, [group...], ...] (RediSearch shape)."""
    idx = _ft(server)._idx(_s(args[0]))
    out = []
    for term, groups in sorted(idx.syn_dump().items()):
        out.append(term.encode())
        out.append([g.encode() for g in groups])
    return out


@register("FT.CONFIG")
def cmd_ft_config(server, ctx, args):
    """FT.CONFIG GET|SET option [value] — a real settings map (per-server),
    accepted for driver compatibility; options do not alter the engine's
    search behavior and say so in FT.INFO-style introspection."""
    sub = bytes(args[0]).upper() if args else b""
    cfg = server.__dict__.setdefault("_ft_config", {"MAXEXPANSIONS": "200"})
    if sub == b"SET" and len(args) >= 3:
        cfg[_s(args[1]).upper()] = _s(args[2])
        return "+OK"
    if sub == b"GET" and len(args) >= 2:
        pat = _s(args[1]).upper()
        items = cfg.items() if pat == "*" else [(pat, cfg.get(pat))]
        return [[k.encode(), (v or "").encode()] for k, v in items if v is not None]
    raise RespError("ERR FT.CONFIG GET|SET option [value]")


@register("FT.DICTADD")
@_ft_cmd
def cmd_ft_dictadd(server, ctx, args):
    return _ft(server).dict_add(_s(args[0]), *[_s(a) for a in args[1:]])


@register("FT.DICTDEL")
@_ft_cmd
def cmd_ft_dictdel(server, ctx, args):
    return _ft(server).dict_del(_s(args[0]), *[_s(a) for a in args[1:]])


@register("FT.DICTDUMP")
@_ft_cmd
def cmd_ft_dictdump(server, ctx, args):
    return [t.encode() for t in _ft(server).dict_dump(_s(args[0]))]


@register("FT.SPELLCHECK")
@_ft_cmd
def cmd_ft_spellcheck(server, ctx, args):
    """FT.SPELLCHECK idx query [DISTANCE d] [TERMS INCLUDE|EXCLUDE dict]...
    -> [["TERM", term, [[score, suggestion], ...]], ...]."""
    include, exclude = [], []
    distance = 1
    i = 2
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"DISTANCE":
            distance = _int(args[i + 1])
            if not 1 <= distance <= 4:
                raise RespError("ERR invalid distance, must be between 1 and 4")
            i += 2
        elif opt == b"TERMS":
            mode = bytes(args[i + 1]).upper()
            (include if mode == b"INCLUDE" else exclude).append(_s(args[i + 2]))
            i += 3
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    res = _ft(server).spellcheck(
        _s(args[0]), _s(args[1]), include=include, exclude=exclude,
        distance=distance,
    )
    return [
        [b"TERM", term.encode(),
         [[_fnum(score), sugg.encode()] for score, sugg in suggs]]
        for term, suggs in res.items()
    ]


