"""Run a reference test module, unedited, on the port.

``load(module, waiting)`` executes the source of ``tests/<module>.py`` in a
fresh namespace whose imports of ``redisson_tpu`` and its submodules bind
the port's modules of the same path under ``redisson_tpu_torch`` (the
module-level imports and the ones inside test bodies alike), with these
defaults changed for the CPU: ``ServerThread`` and ``TpuServer`` (from
``redisson_tpu.server`` and its ``server`` module), ``redisson_tpu.create``,
``RedissonTpu.create``,
``KernelMapReduce``, the harness's ``ClusterRunner`` and ``Engine`` put
their state on the CPU unless the test asks for a device, and each of
``redisson_tpu.chaos.soak``'s twelve ``*SoakConfig`` is a subclass whose
``device`` is the CPU.  Importing this
module gives the CPU 8 mesh positions (``parallel/mesh.set_cpu_positions``),
as the reference's tests/conftest.py gives JAX 8 host devices.  A module the port does not have yet binds a stand-in whose every
attribute raises NotImplementedError, so a test that reaches one fails
loudly; such tests
are named in the caller's ``waiting`` dict (test -> the slice it waits for)
and are not collected.  The caller puts the returned names into its own
globals, where pytest collects them.
"""
from __future__ import annotations

import builtins
import dataclasses
import importlib
import signal
import threading
import types
from contextlib import contextmanager
from pathlib import Path

import pytest

import redisson_tpu_torch
from redisson_tpu_torch import harness as _port_harness
from redisson_tpu_torch.chaos import soak as _port_soak
from redisson_tpu_torch.client import redisson as _port_redisson
from redisson_tpu_torch.parallel import mesh as _port_mesh
from redisson_tpu_torch.core import engine as _port_engine
from redisson_tpu_torch.services import mapreduce as _port_mapreduce
from redisson_tpu_torch.server import server as _port_server

TESTS = Path(__file__).resolve().parent

_port_mesh.set_cpu_positions(8)
REF, PORT = "redisson_tpu", "redisson_tpu_torch"


class CpuServerThread(_port_server.ServerThread):
    """The port's ServerThread, on the CPU unless asked otherwise."""

    def __init__(self, engine=None, port: int = 0, **kw):
        if engine is None:
            kw.setdefault("device", "cpu")
        super().__init__(engine, port, **kw)


class CpuTpuServer(_port_server.TpuServer):
    """The port's TpuServer, its engine on the CPU unless asked otherwise."""

    def __init__(self, engine=None, *args, **kw):
        if engine is None:
            kw.setdefault("device", "cpu")
        super().__init__(engine, *args, **kw)


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


class CpuClusterRunner(_port_harness.ClusterRunner):
    """The port's ClusterRunner, its nodes on the CPU unless asked otherwise."""

    def __init__(self, masters: int = 3, replicas_per_master: int = 0, **server_kw):
        server_kw.setdefault("device", "cpu")
        super().__init__(masters, replicas_per_master, **server_kw)


class CpuEngine(_port_engine.Engine):
    """The port's Engine, on the CPU unless asked otherwise."""

    def __init__(self, config=None, device="cpu"):
        super().__init__(config, device)


class CpuKernelMapReduce(_port_mapreduce.KernelMapReduce):
    """The port's KernelMapReduce, on the CPU unless asked otherwise."""

    def __init__(self, map_fn, reduce="sum", n_keys=1024, device="cpu"):
        super().__init__(map_fn, reduce, n_keys, device)


def _cpu_soak_config(cls):
    """The soak config `cls` with its ``device`` defaulting to the CPU."""
    return dataclasses.make_dataclass(
        cls.__name__, [("device", str, dataclasses.field(default="cpu"))],
        bases=(cls,), namespace={"__doc__": cls.__doc__, "__module__": __name__},
    )


CPU_SOAK_CONFIGS = {
    name: _cpu_soak_config(getattr(_port_soak, name))
    for name in dir(_port_soak) if name.endswith("SoakConfig")
}


class _Missing(types.ModuleType):
    def __getattr__(self, name):
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
    elif name in ("redisson_tpu.server", "redisson_tpu.server.server"):
        mod = _Shim(mod, ServerThread=CpuServerThread, TpuServer=CpuTpuServer)
    elif name == "redisson_tpu.client.redisson":
        mod = _Shim(mod, RedissonTpu=CpuRedissonTpu)
    elif name == "redisson_tpu.services.mapreduce":
        mod = _Shim(mod, KernelMapReduce=CpuKernelMapReduce)
    elif name == "redisson_tpu.harness":
        mod = _Shim(mod, ClusterRunner=CpuClusterRunner)
    elif name == "redisson_tpu.core.engine":
        mod = _Shim(mod, Engine=CpuEngine)
    elif name == "redisson_tpu.chaos.soak":
        mod = _Shim(mod, **CPU_SOAK_CONFIGS)
    _SHIMS[name] = mod
    return mod


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and (name == REF or name.startswith(REF + ".")):
        mod = _port_module(name)
        for item in fromlist or ():
            # `from pkg import submodule`: a port submodule not imported yet
            if item != "*" and not isinstance(mod, _Missing) and not hasattr(mod, item):
                _port_module(f"{name}.{item}")
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


@contextmanager
def time_limit(seconds: float):
    """Fail the test in it (TimeoutError) if it outlasts `seconds`: the
    limit of a test that starts server processes.  Armed only on the main
    thread, where SIGALRM is delivered."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expired(*_):
        raise TimeoutError(f"test outlasted its {seconds}s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture()
def devices():
    """The port's stand-in for tests/conftest.py's ``devices`` (JAX's 8 host
    devices): the CPU's 8 mesh positions.  A suite file that runs tests
    taking ``devices`` imports it into its globals."""
    return _port_mesh.local_devices("cpu", 8)
