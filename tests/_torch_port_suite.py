"""Run a reference test module, unedited, on the port.

``load(module, waiting)`` executes the source of ``tests/<module>.py`` in a
fresh namespace whose imports of ``redisson_tpu`` and its submodules bind
the port's modules of the same path under ``redisson_tpu_torch`` (the
module-level imports and the ones inside test bodies alike), with four
defaults changed for the CPU: ``ServerThread``, ``redisson_tpu.create``,
``RedissonTpu.create`` and ``KernelMapReduce`` put their state on the CPU
unless the test asks for a device.  A module
the port does not have yet binds a stand-in whose every attribute raises
NotImplementedError (a test helper such as the harness's ``free_port``
excepted), so a test that reaches one fails loudly; such tests
are named in the caller's ``waiting`` dict (test -> the slice it waits for)
and are not collected.  The caller puts the returned names into its own
globals, where pytest collects them.
"""
from __future__ import annotations

import builtins
import importlib
import socket
import types
from pathlib import Path

import redisson_tpu_torch
from redisson_tpu_torch.client import redisson as _port_redisson
from redisson_tpu_torch.services import mapreduce as _port_mapreduce
from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server import server as _port_server

TESTS = Path(__file__).resolve().parent
REF, PORT = "redisson_tpu", "redisson_tpu_torch"


class CpuServerThread(_port_server.ServerThread):
    """The port's ServerThread, on the CPU unless asked otherwise."""

    def __init__(self, engine=None, port: int = 0, **kw):
        if engine is None:
            kw.setdefault("device", "cpu")
        super().__init__(engine, port, **kw)


def _create(config=None, device="cpu"):
    return redisson_tpu_torch.create(config, device)


class CpuRedissonTpu(_port_redisson.RedissonTpu):
    """The port's embedded facade, created on the CPU unless asked otherwise."""

    @classmethod
    def create(cls, config=None, device="cpu"):
        return super().create(config, device)


class _Shim(types.ModuleType):
    """A port module with some names replaced; the rest read through."""

    def __init__(self, real, **names):
        super().__init__(real.__name__)
        self.__dict__.update(names)
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)


def free_port() -> int:
    """A free TCP port on localhost (the reference harness's test helper)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exec(conn, *args, timeout=None):
    """One command on a wire connection, an error reply raised (the
    reference harness's test helper)."""
    reply = conn.execute(*args, timeout=timeout)
    if isinstance(reply, RespError):
        raise reply
    return reply


class CpuKernelMapReduce(_port_mapreduce.KernelMapReduce):
    """The port's KernelMapReduce, on the CPU unless asked otherwise."""

    def __init__(self, map_fn, reduce="sum", n_keys=1024, device="cpu"):
        super().__init__(map_fn, reduce, n_keys, device)


# test helpers of modules the port does not have yet, kept by their stand-ins
_HELPERS = {"redisson_tpu.harness": {"free_port": free_port, "_exec": _exec}}


class _Missing(types.ModuleType):
    def __getattr__(self, name):
        if name in _HELPERS.get(self.__name__, {}):
            return _HELPERS[self.__name__][name]
        if name.startswith("__"):
            raise AttributeError(name)
        what = f"{self.__name__}.{name}"

        def missing(*_a, **_k):
            raise NotImplementedError(f"{what} is not in the port yet")

        return missing


_SHIMS = {}


def _port_module(name: str):
    """The port's module for the reference module `name`."""
    if name in _SHIMS:
        return _SHIMS[name]
    try:
        mod = importlib.import_module(PORT + name[len(REF):])
    except ImportError:
        mod = _Missing(name)
    if name == REF:
        mod = _Shim(mod, create=_create)
    elif name == "redisson_tpu.server.server":
        mod = _Shim(mod, ServerThread=CpuServerThread)
    elif name == "redisson_tpu.client.redisson":
        mod = _Shim(mod, RedissonTpu=CpuRedissonTpu)
    elif name == "redisson_tpu.services.mapreduce":
        mod = _Shim(mod, KernelMapReduce=CpuKernelMapReduce)
    _SHIMS[name] = mod
    return mod


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and (name == REF or name.startswith(REF + ".")):
        mod = _port_module(name)
        return mod if fromlist else _port_module(REF)
    return builtins.__import__(name, globals, locals, fromlist, level)


def _uses(fn, fixtures) -> bool:
    code = getattr(fn, "__code__", None)
    return code is not None and bool(set(code.co_varnames[:code.co_argcount]) & set(fixtures))


def load(module: str, waiting: dict, into: str, only=None) -> dict:
    """The test functions, classes and fixtures of tests/<module>.py run on
    the port, less `waiting`'s tests ("name", "Class" or "Class::name");
    with `only` (fixture names), just the tests that take one of them."""
    path = TESTS / f"{module}.py"
    ns = {"__name__": into, "__file__": str(path),
          "__builtins__": {**builtins.__dict__, "__import__": _import}}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    out = {}
    for name, obj in ns.items():
        if name.startswith("__") or name in waiting:
            continue
        if isinstance(obj, type) and name.startswith("Test"):
            left = {k.split("::")[1]: None for k in waiting if k.split("::")[0] == name}
            if only is not None:
                left.update({k: None for k, v in vars(obj).items()
                             if k.startswith("test") and not _uses(v, only)})
            obj = type(name, (obj,), {"__module__": into, **left})
        elif only is not None and name.startswith("test") and not _uses(obj, only):
            continue
        out[name] = obj
    return out
