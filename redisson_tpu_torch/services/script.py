"""Script & Function services: atomic server-side procedures.

Parity targets:
  * RScript — ``RedissonScript.java``: SCRIPT LOAD → sha1, EVAL/EVALSHA with
    keys+args, read/write modes; the executor's script cache turns EVAL into
    EVALSHA with NOSCRIPT fallback (``command/CommandAsyncService.java:400-512``,
    SHA cache at ``connection/ServiceManager.java:138-140``).
  * RFunction — ``RedissonFuction.java``: FUNCTION LOAD groups named functions
    into libraries; FCALL invokes by name.

The TPU-native re-expression of Lua atomicity (SURVEY.md §7.1 item 5): a
script is a Python callable `(ctx, keys, args) -> result` executed while the
engine holds the record locks of every declared key, so the script observes
and mutates a consistent cut of all touched objects — exactly what Redis
gives Lua by running it on the single command thread.  `ctx` exposes object
handles bound to the same engine; scripts that only touch their declared
keys are therefore serializable with all other object operations.

Scripts are addressed by the sha1 of their source text (same addressing
scheme as the reference), so clients can pre-register (`script_load`) and
later invoke by digest (`eval_sha`) without re-shipping code; unknown digests
raise NoScriptError — the NOSCRIPT reply clients use to fall back to a full
EVAL, which this module's `eval_with_cache` mirrors client-side.

A copy of ``redisson_tpu/services/script.py`` for the port.
"""
from __future__ import annotations

import hashlib
import inspect
import textwrap
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence


class NoScriptError(KeyError):
    """NOSCRIPT analog: digest not present in the script cache."""


class ScriptContext:
    """What a script sees: object handles sharing the caller's engine.

    Mirrors Lua's redis.call surface at the object level — scripts operate on
    typed objects, not raw commands (there is no command/keyspace gap here).
    """

    def __init__(self, engine):
        self._engine = engine
        from redisson_tpu_torch.client.redisson import RedissonTpu

        self.client = RedissonTpu(engine)

    def __getattr__(self, factory: str):
        # ctx.get_map("k") etc. — delegate every factory to the client facade
        return getattr(self.client, factory)


class ScriptMode:
    READ_ONLY = "READ_ONLY"
    READ_WRITE = "READ_WRITE"


def source_of(fn: Callable) -> str:
    """Canonical source text of a script function (digest input)."""
    try:
        return textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        # dynamically-built callables: fall back to a stable qualname+module id
        return f"<opaque:{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}>"


def sha1_of(fn_or_source) -> str:
    src = fn_or_source if isinstance(fn_or_source, str) else source_of(fn_or_source)
    return hashlib.sha1(src.encode()).hexdigest()


class ScriptService:
    """RScript analog bound to one engine."""

    def __init__(self, engine):
        self._engine = engine
        self._cache: Dict[str, Callable] = {}
        self._lock = threading.Lock()

    # -- cache management (SCRIPT LOAD / EXISTS / FLUSH) ---------------------

    def script_load(self, fn: Callable) -> str:
        sha = sha1_of(fn)
        with self._lock:
            self._cache[sha] = fn
        return sha

    def script_exists(self, *shas: str) -> List[bool]:
        with self._lock:
            return [s in self._cache for s in shas]

    def script_flush(self) -> None:
        with self._lock:
            self._cache.clear()

    # -- execution -----------------------------------------------------------

    def eval(
        self,
        fn: Callable,
        keys: Sequence[str] = (),
        args: Sequence[Any] = (),
        mode: str = ScriptMode.READ_WRITE,
    ):
        """Run `fn(ctx, keys, args)` atomically w.r.t. every key in `keys`."""
        ctx = ScriptContext(self._engine)
        with self._engine.locked_many(keys):
            return fn(ctx, list(keys), list(args))

    def eval_sha(
        self,
        sha: str,
        keys: Sequence[str] = (),
        args: Sequence[Any] = (),
        mode: str = ScriptMode.READ_WRITE,
    ):
        with self._lock:
            fn = self._cache.get(sha)
        if fn is None:
            raise NoScriptError(sha)
        return self.eval(fn, keys, args, mode)

    def eval_with_cache(
        self,
        fn: Callable,
        keys: Sequence[str] = (),
        args: Sequence[Any] = (),
        mode: str = ScriptMode.READ_WRITE,
    ):
        """The executor's EVAL→EVALSHA discipline
        (CommandAsyncService.java:439-512): try by digest; on NOSCRIPT, load
        and retry — steady state never re-ships the script body."""
        sha = sha1_of(fn)
        try:
            return self.eval_sha(sha, keys, args, mode)
        except NoScriptError:
            self.script_load(fn)
            return self.eval_sha(sha, keys, args, mode)


class FunctionService:
    """RFunction analog: named libraries of callable functions."""

    def __init__(self, engine):
        self._engine = engine
        self._script = ScriptService(engine)
        self._libs: Dict[str, Dict[str, Callable]] = {}
        self._lock = threading.Lock()

    def load(self, library: str, functions: Dict[str, Callable], replace: bool = False) -> None:
        """FUNCTION LOAD: register a library of named functions."""
        with self._lock:
            if library in self._libs and not replace:
                raise ValueError(f"library '{library}' already loaded (use replace=True)")
            self._libs[library] = dict(functions)

    def unload(self, library: str) -> bool:
        """FUNCTION DELETE."""
        with self._lock:
            return self._libs.pop(library, None) is not None

    def list(self) -> Dict[str, List[str]]:
        """FUNCTION LIST: library -> function names."""
        with self._lock:
            return {lib: sorted(fns) for lib, fns in self._libs.items()}

    def _resolve(self, name: str) -> Callable:
        with self._lock:
            for fns in self._libs.values():
                if name in fns:
                    return fns[name]
        raise KeyError(f"function '{name}' is not loaded")

    def call(self, name: str, keys: Sequence[str] = (), args: Sequence[Any] = ()):
        """FCALL: invoke by function name, atomic over `keys`."""
        return self._script.eval(self._resolve(name), keys, args)

    def call_read(self, name: str, keys: Sequence[str] = (), args: Sequence[Any] = ()):
        """FCALL_RO."""
        return self._script.eval(self._resolve(name), keys, args, ScriptMode.READ_ONLY)
