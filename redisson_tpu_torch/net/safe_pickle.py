"""Restricted unpickling for wire payloads (OBJCALL args/results), and the
pickler that writes them.

The reference has the same dual-use surface — its JDK-serialization codecs
deserialize attacker-controlled bytes — and mitigates with class-filtering
(`SerializationCodec` supports an allowed-class filter).  Same policy here,
but as a tight allowlist of *specific globals*: broad module-root allowances
are gadget mines (e.g. ``numpy.testing._private.utils.runstring`` execs a
string), so numpy is limited to exactly the reconstruction callables array
pickles need, builtins to data constructors and exception types, and the
framework's own package to its wire-visible value classes.  Deployments
moving custom classes through OBJCALL opt modules in via `allow_module`.

A copy of ``redisson_tpu/net/safe_pickle.py`` with one addition: class
names in a pickle are a wire format.  The reference's servers and clients
name their classes ``redisson_tpu.<module>.<Class>``, and this package keeps
the same module layout under ``redisson_tpu_torch``.  So the port writes its
own classes under those wire names (`dumps`: ``redisson_tpu_torch.net.resp
.RespError`` travels as ``redisson_tpu.net.resp.RespError``), and its
unpickler binds an allowlisted wire name to the port's class of the same
path, never importing ``redisson_tpu``.  Either package's client can then
read the other's server, and an OBJCALL reply is the reference's bytes.
An allowlisted port class that arrives under its own name (written by a
plain pickler: a port executor task run by the reference's worker node
passes the port's codec) binds to the same class.

No torch object travels: `dumps` writes a tensor as the numpy array of its
values, refuses any other torch object, and `wire_exception` turns an
exception of a class outside the builtins and the port (a CUDA error from a
kernel) into the nearest builtin exception with the class name in its
message.
"""
from __future__ import annotations

import builtins
import importlib
import io
import pickle
import types

# pure-data stdlib modules where every global is a value constructor
_ALLOWED_DATA_ROOTS = {"datetime", "decimal", "fractions", "uuid"}

# user-extensible trust (allow_module) — empty by default
_TRUSTED_ROOTS: set = set()

# the package root classes are written under, and the port's own
WIRE_ROOT = "redisson_tpu"
PORT_ROOT = "redisson_tpu_torch"

_ALLOWED_GLOBALS = {
    # numpy array/scalar reconstruction (numpy 1.x and 2.x module paths)
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("_codecs", "encode"),
    # container constructors
    ("collections", "OrderedDict"),
    ("collections", "defaultdict"),
    ("collections", "deque"),
    ("collections", "Counter"),
    # the restricted unpickler's own rejection travels inside E-replies;
    # without this the root cause is masked by a second rejection
    ("_pickle", "UnpicklingError"),
    ("pickle", "UnpicklingError"),
}

# framework wire-visible classes, by wire name; each binds to the port's
# class of the same path under PORT_ROOT
_WIRE_CLASSES = {
    ("redisson_tpu.net.resp", "RespError"),
    ("redisson_tpu.net.resp", "Push"),
    # codecs: pure-config value classes that ride OBJCALL's codec frame so
    # remote handles honor getMap(name, codec) (client/remote.py objcall)
    ("redisson_tpu.client.codec", "JsonCodec"),
    ("redisson_tpu.client.codec", "PickleCodec"),
    ("redisson_tpu.client.codec", "StringCodec"),
    ("redisson_tpu.client.codec", "BytesCodec"),
    ("redisson_tpu.client.codec", "LongCodec"),
    ("redisson_tpu.client.codec", "DoubleCodec"),
    ("redisson_tpu.client.codec", "CompositeCodec"),
    ("redisson_tpu.client.codec", "ZlibCodec"),
    ("redisson_tpu.client.codec", "Bz2Codec"),
    ("redisson_tpu.client.codec", "LzmaCodec"),
    ("redisson_tpu.client.codec", "CborCodec"),
    ("redisson_tpu.client.codec", "Lz4Codec"),
    # reference support: handle codecs are ReferenceCodec-wrapped, and
    # handles themselves pickle as inert ObjectRef descriptors
    ("redisson_tpu.client.codec", "ReferenceCodec"),
    ("redisson_tpu.client.codec", "ObjectRef"),
    ("redisson_tpu.services.search", "SearchResult"),
    ("redisson_tpu.services.search", "Condition"),
    ("redisson_tpu.services.search", "Eq"),
    ("redisson_tpu.services.search", "In"),
    ("redisson_tpu.services.search", "Range"),
    ("redisson_tpu.services.search", "Text"),
    ("redisson_tpu.services.search", "And"),
    ("redisson_tpu.services.search", "Or"),
}

_ALLOWED_BUILTINS = {
    "set", "frozenset", "complex", "bytearray", "range", "slice", "dict",
    "list", "tuple", "bytes", "str", "int", "float", "bool", "object",
}


def allow_module(root: str) -> None:
    """Trust every global under `root` (e.g. the package holding your value
    classes).  Explicit opt-in — trusting a module trusts its callables."""
    _TRUSTED_ROOTS.add(root.split(".", 1)[0])


def _is_builtin_exception(name: str) -> bool:
    obj = getattr(builtins, name, None)
    return isinstance(obj, type) and issubclass(obj, BaseException)


def _port_module(wire_module: str) -> str:
    return PORT_ROOT + wire_module[len(WIRE_ROOT):]


_WIRE_MODULES: dict = {}


def wire_module(module: str):
    """The wire name of a port module path, None for any other module.
    One string object a module: the pickler memoizes by identity, as the C
    pickler's memo hits a module's own ``__module__`` string."""
    if module == PORT_ROOT or module.startswith(PORT_ROOT + "."):
        return _WIRE_MODULES.setdefault(module, WIRE_ROOT + module[len(PORT_ROOT):])
    return None


class RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        # a port class under its own name (a plain pickler wrote it: a port
        # task run by the reference's worker node) is the same allowlisted
        # class as under its wire name
        module = wire_module(module) or module
        if (module, name) in _WIRE_CLASSES:
            try:
                return getattr(importlib.import_module(_port_module(module)), name)
            except (ImportError, AttributeError):
                raise pickle.UnpicklingError(
                    f"global '{module}.{name}' has no class in this package yet"
                ) from None
        if (module, name) in _ALLOWED_GLOBALS:
            return super().find_class(module, name)
        if module == "builtins" and (name in _ALLOWED_BUILTINS or _is_builtin_exception(name)):
            return super().find_class(module, name)
        if root in _ALLOWED_DATA_ROOTS or root in _TRUSTED_ROOTS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"global '{module}.{name}' is forbidden in wire payloads; "
            "register the module with redisson_tpu_torch.net.safe_pickle.allow_module"
        )


def safe_loads(data: bytes):
    return RestrictedUnpickler(io.BytesIO(data)).load()


# -- the writing side ----------------------------------------------------------


class _NeedsWireNames(Exception):
    """The payload holds a port class: write it with the Python pickler."""


def _is_torch(obj) -> bool:
    module = getattr(type(obj), "__module__", None) or ""
    return module == "torch" or module.startswith("torch.")


def _torch_reduce(obj, protocol: int):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().__reduce_ex__(protocol)
    raise pickle.PicklingError(
        f"a {type(obj).__module__}.{type(obj).__name__} cannot travel on the wire"
    )


def _global_module(obj):
    if isinstance(obj, type) or callable(obj):
        return getattr(obj, "__module__", None)
    return None


class _FastPickler(pickle.Pickler):
    """The C pickler, for payloads that name no port class (nearly all)."""

    def __init__(self, file, protocol: int):
        super().__init__(file, protocol)
        self.wire_protocol = protocol

    def reducer_override(self, obj):
        if _is_torch(obj):
            return _torch_reduce(obj, self.wire_protocol)
        module = _global_module(obj)
        if module is not None and wire_module(module) is not None:
            raise _NeedsWireNames
        return NotImplemented


class _WirePickler(pickle._Pickler):
    """The Python pickler with the port's classes written under their wire
    names: the same opcodes the C pickler writes for the reference's."""

    def reducer_override(self, obj):
        if _is_torch(obj):
            return _torch_reduce(obj, self.proto)
        return NotImplemented

    def save_global(self, obj, name=None):
        module = wire_module(getattr(obj, "__module__", None) or "")
        if module is None or self.proto < 4:
            return super().save_global(obj, name)
        self.save(module)
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    dispatch = dict(pickle._Pickler.dispatch)
    dispatch[types.FunctionType] = save_global


def dumps(obj, protocol: int = pickle.DEFAULT_PROTOCOL) -> bytes:
    """`pickle.dumps` for wire payloads (see the module docstring)."""
    buf = io.BytesIO()
    try:
        _FastPickler(buf, protocol).dump(obj)
    except _NeedsWireNames:
        buf = io.BytesIO()
        _WirePickler(buf, protocol).dump(obj)
    return buf.getvalue()


def wire_exception(e: BaseException) -> BaseException:
    """`e` if its class can travel (a builtin or a port class), else the
    nearest builtin exception class of its bases, carrying the original
    class name and message."""
    cls = type(e)
    module = cls.__module__
    if module == "builtins" or wire_module(module) is not None:
        return e
    for base in cls.__mro__[1:]:
        if base.__module__ == "builtins":
            try:
                return base(f"{cls.__name__}: {e}")
            except Exception:  # noqa: BLE001 — a base with a fixed signature
                break
    return RuntimeError(f"{cls.__name__}: {e}")
