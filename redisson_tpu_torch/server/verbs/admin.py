"""Script and function verbs (the RScript and RFunction wire surface).

A copy of the script and function verbs of
``redisson_tpu/server/verbs/admin.py``: EVALSHA, EVAL, SCRIPT, FCALL,
FCALL_RO and FUNCTION, on the engine's ``services/script.py`` services.
Scripts are Python callables registered server-side, so callers address
them by digest (EVALSHA) or by function name (FCALL); EVAL, SCRIPT LOAD and
FUNCTION LOAD/DUMP reply the reference's errors.  The rest of the file
(node info, CONFIG, SAVE, CLUSTER, the replication verbs, DUMP, RESTORE,
COPY, WAIT) comes with the operations slice (ROADMAP M11).
"""

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import register, _s, _int

# -- script / function / admin verbs (RScript + RFunction wire surface) ------

def _script_svc(server):
    from redisson_tpu_torch.services.script import ScriptService

    return server.engine.service("script", lambda: ScriptService(server.engine))


def _function_svc(server):
    from redisson_tpu_torch.services.script import FunctionService

    return server.engine.service("function", lambda: FunctionService(server.engine))


def _proc_keys_args(args, at):
    """numkeys keys... args... tail shared by EVALSHA/FCALL."""
    n = _int(args[at])
    if n < 0:
        raise RespError("ERR Number of keys can't be negative")
    if len(args) < at + 1 + n:
        raise RespError("ERR Number of keys is greater than number of args")
    keys = [_s(k) for k in args[at + 1 : at + 1 + n]]
    rest = [bytes(a) for a in args[at + 1 + n :]]
    return keys, rest


@register("EVALSHA")
def cmd_evalsha(server, ctx, args):
    """EVALSHA sha numkeys key... arg... — invokes a script REGISTERED
    SERVER-SIDE (embedded script_load).  Scripts here are Python callables,
    so source never ships over the wire: remote callers address by digest
    only, and a miss replies NOSCRIPT exactly like the reference's
    EVAL-fallback discipline expects."""
    from redisson_tpu_torch.services.script import NoScriptError

    keys, rest = _proc_keys_args(args, 1)
    try:
        return _script_svc(server).eval_sha(_s(args[0]), keys, rest)
    except NoScriptError:
        raise RespError("NOSCRIPT No matching script. Please use EVAL.")


@register("EVAL")
def cmd_eval(server, ctx, args):
    raise RespError(
        "ERR EVAL with shipped source is not supported on this server: "
        "scripts are Python callables registered server-side (script_load); "
        "invoke by digest with EVALSHA, or FCALL a loaded function library"
    )


@register("SCRIPT")
def cmd_script(server, ctx, args):
    sub = bytes(args[0]).upper()
    svc = _script_svc(server)
    if sub == b"EXISTS":
        return [1 if ok else 0 for ok in svc.script_exists(*[_s(s) for s in args[1:]])]
    if sub == b"FLUSH":
        svc.script_flush()
        return "+OK"
    if sub == b"LOAD":
        raise RespError(
            "ERR SCRIPT LOAD over the wire is not supported (scripts are "
            "Python callables; register them server-side)"
        )
    raise RespError(f"ERR Unknown SCRIPT subcommand '{_s(args[0])}'")


def _fcall(server, args, read_only: bool):
    keys, rest = _proc_keys_args(args, 1)
    svc = _function_svc(server)
    # resolve OUTSIDE the invocation: a KeyError raised by the function's
    # own body must surface as the function's error, not "not found"
    try:
        fn = svc._resolve(_s(args[0]))
    except KeyError:
        raise RespError(f"ERR Function not found: {_s(args[0])}")
    from redisson_tpu_torch.services.script import ScriptMode

    mode = ScriptMode.READ_ONLY if read_only else ScriptMode.READ_WRITE
    return svc._script.eval(fn, keys, rest, mode)


@register("FCALL")
def cmd_fcall(server, ctx, args):
    return _fcall(server, args, read_only=False)


@register("FCALL_RO")
def cmd_fcall_ro(server, ctx, args):
    return _fcall(server, args, read_only=True)


@register("FUNCTION")
def cmd_function(server, ctx, args):
    sub = bytes(args[0]).upper()
    if sub == b"LIST":
        out = []
        for lib, fns in sorted(_function_svc(server).list().items()):
            out.append([
                b"library_name", lib.encode(),
                b"functions", [f.encode() for f in fns],
            ])
        return out
    if sub == b"DUMP" or sub == b"LOAD":
        raise RespError(
            "ERR FUNCTION libraries are Python callables registered "
            "server-side; wire DUMP/LOAD is not supported"
        )
    raise RespError(f"ERR Unknown FUNCTION subcommand '{_s(args[0])}'")
