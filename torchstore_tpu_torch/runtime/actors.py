"""Process-based actor runtime.

Port of ``torchstore_tpu/runtime/actors.py``: ``spawn_actors`` starts N OS
processes, each hosting one ``Actor`` whose ``@endpoint`` methods are served
over an asyncio TCP server. ``ActorRef`` / ``ActorMeshRef`` are picklable
handles: ``ref.method.call_one()`` performs a multiplexed RPC with the
out-of-band tensor framing of ``serialization.py``, ``mesh.method.call()``
fans out to every rank and ``mesh[i]`` indexes it.

Children start from a forkserver that has imported this package once (the
torch import is most of a fresh interpreter's start-up); the helper never
touches CUDA, so a child may use the card. ``TORCHSTORE_TORCH_MP_CONTEXT=spawn``
starts fresh interpreters instead. An actor registered in process
(``register_inproc``, a colocated volume) is called directly, without
serialization. Every request frame carries the caller's trace context,
re-activated around the endpoint under an ``rpc/<method>`` span, and every
accepted connection passes the auth challenge (``auth.py``) before a frame
is parsed. Servers bind ``TORCHSTORE_TORCH_BIND_HOST`` (127.0.0.1 by
default) and refs carry the advertised address (``ADVERTISE_HOST``, or the
hostname when binding 0.0.0.0 or ::).
"""

from __future__ import annotations

import asyncio
import multiprocessing as mp
import os
import pickle
import socket
import traceback
from typing import Any, Callable, Optional

from torchstore_tpu_torch.config import ENV_MP_CONTEXT, ENV_PREFIX, advertise_host, bind_host
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import context as trace_context
from torchstore_tpu_torch.observability.tracing import span
from torchstore_tpu_torch.runtime.auth import (
    client_authenticate,
    close_unauthenticated,
    server_authenticate,
)
from torchstore_tpu_torch.runtime.serialization import (
    KIND_CONTROL,
    KIND_ERROR,
    KIND_REQUEST,
    KIND_RESPONSE,
    read_message,
    write_message,
)
from torchstore_tpu_torch.utils import spawn_logged

logger = get_logger("torchstore_tpu_torch.runtime")

_ENDPOINT_ATTR = "_torchstore_torch_endpoint"

SPAWN_TIMEOUT_S = 120.0
STOP_TIMEOUT_S = 10.0


def endpoint(fn: Callable) -> Callable:
    """Mark a method remotely callable."""
    setattr(fn, _ENDPOINT_ATTR, True)
    return fn


class Actor:
    """Base class for actors; each instance lives in its own process.
    ``on_stop`` runs in that process before it exits."""

    async def on_stop(self) -> None:
        pass


class RemoteActorError(RuntimeError):
    """The remote endpoint raised; carries the remote traceback. The
    original exception is re-raised when it survives pickling, with this
    error as its ``__cause__``."""


class ActorDiedError(RuntimeError):
    pass


class ActorTimeoutError(ActorDiedError):
    """An RPC exceeded its deadline (the actor is wedged, or the transfer
    outlasted the timeout)."""


# --------------------------------------------------------------------------
# client side
# --------------------------------------------------------------------------


class _Connection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.write_lock = asyncio.Lock()
        self.pending: dict[int, asyncio.Future] = {}
        self.next_id = 0
        self.closed = False
        self._reader_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                kind, msg = await read_message(self.reader)
                fut = self.pending.pop(msg["id"], None)
                if fut is None or fut.done():
                    continue
                if kind == KIND_RESPONSE:
                    fut.set_result(msg["value"])
                elif kind == KIND_ERROR:
                    fut.set_exception(_rebuild_remote_error(msg))
                else:
                    fut.set_exception(RemoteActorError(f"unexpected frame kind {kind}"))
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as exc:
            self._fail_all(ActorDiedError(f"actor connection lost: {exc!r}"))
        except asyncio.CancelledError:
            self._fail_all(ActorDiedError("connection closed"))
            raise
        except Exception as exc:  # noqa: BLE001 - reported to every waiter
            self._fail_all(RemoteActorError(f"connection reader failed: {exc!r}"))

    def _fail_all(self, exc: Exception) -> None:
        self.closed = True
        for fut in self.pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self.pending.clear()

    async def request(self, kind: int, body: dict, timeout: Optional[float] = None) -> Any:
        if self.closed:
            raise ActorDiedError("connection already closed")
        req_id = self.next_id
        self.next_id += 1
        body = dict(body, id=req_id)
        # The caller's trace context rides the frame, so the server's spans
        # join the caller's trace (one contextvar read when none is active).
        ctx = trace_context.current()
        if ctx is not None:
            body["trace"] = ctx
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.pending[req_id] = fut
        try:
            async with self.write_lock:
                await write_message(self.writer, kind, body)
            if timeout is None or timeout <= 0:
                return await fut
            try:
                return await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                if fut.done() and not fut.cancelled():
                    raise  # the remote endpoint raised TimeoutError itself
                raise ActorTimeoutError(
                    f"RPC {body.get('method', body.get('op'))!r} to "
                    f"{body.get('actor')!r} timed out after {timeout:.0f}s"
                ) from None
        except BaseException:
            self.pending.pop(req_id, None)
            if fut.done() and not fut.cancelled():
                fut.exception()  # retrieved: a late failure is not logged
            else:
                fut.cancel()
            raise

    async def close(self) -> None:
        self.closed = True
        self._reader_task.cancel()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, OSError, RuntimeError):
            pass


def _rebuild_remote_error(msg: dict) -> Exception:
    remote = RemoteActorError(
        f"remote endpoint raised:\n{msg.get('traceback', '<no traceback>')}"
    )
    exc = msg.get("exception")
    if isinstance(exc, BaseException):
        exc.__cause__ = remote
        return exc
    return remote


# Actors hosted in this process, keyed as their published refs (host, port,
# name): a call on such a ref invokes the method directly, with no
# serialization (a colocated volume); other processes reach the same actor
# over its server. Only the hosting process registers, and forked children
# never inherit a hosting role.
_inproc_actors: dict[tuple[str, int, str], Actor] = {}


def register_inproc(host: str, port: int, name: str, actor: Actor) -> None:
    _inproc_actors[(host, port, name)] = actor


def unregister_inproc(host: str, port: int, name: str) -> None:
    _inproc_actors.pop((host, port, name), None)


# Connections per (event loop, address): tests run many asyncio.run loops,
# and a connection belongs to the loop that opened it. The forkserver helper
# never opens one, so a child inherits an empty pool.
_conn_pools: dict[tuple[int, str, int], tuple[asyncio.AbstractEventLoop, _Connection]] = {}
_conn_locks: dict[tuple[int, str, int], tuple[asyncio.AbstractEventLoop, asyncio.Lock]] = {}


async def get_connection(host: str, port: int) -> _Connection:
    loop = asyncio.get_running_loop()
    for k, (pool_loop, conn) in list(_conn_pools.items()):
        if pool_loop.is_closed():
            conn.closed = True
            sock = conn.writer.get_extra_info("socket")
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            _conn_pools.pop(k, None)
    for k, (lock_loop, _) in list(_conn_locks.items()):
        if lock_loop.is_closed():
            _conn_locks.pop(k, None)
    key = (id(loop), host, port)
    entry = _conn_pools.get(key)
    if entry is not None and not entry[1].closed:
        return entry[1]
    # Concurrent first calls share one connection: without the lock each
    # would open its own and replace the others' in the pool, whose reader
    # tasks would then be dropped while still pending.
    held = _conn_locks.get(key)
    if held is None or held[0] is not loop:
        held = _conn_locks[key] = (loop, asyncio.Lock())
    async with held[1]:
        entry = _conn_pools.get(key)
        if entry is not None and not entry[1].closed:
            return entry[1]
        reader, writer = await asyncio.open_connection(host, port, limit=2**20)
        _set_nodelay(writer)
        try:
            await client_authenticate(reader, writer)
        except BaseException:
            writer.close()
            raise
        conn = _Connection(reader, writer)
        _conn_pools[key] = (loop, conn)
        return conn


def _set_nodelay(writer: asyncio.StreamWriter) -> None:
    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


class ActorEndpointRef:
    def __init__(self, ref: "ActorRef", method: str, timeout: Optional[float] = None):
        self._ref = ref
        self._method = method
        self._timeout = timeout

    def with_timeout(self, timeout: Optional[float]) -> "ActorEndpointRef":
        """Copy with an explicit deadline (<= 0 disables); data-plane RPCs
        scale theirs with the payload size."""
        return ActorEndpointRef(self._ref, self._method, timeout)

    def effective_timeout(self) -> Optional[float]:
        if self._timeout is not None:
            return self._timeout
        if self._ref.rpc_timeout is not None:
            return self._ref.rpc_timeout
        from torchstore_tpu_torch.config import default_config

        return default_config().rpc_timeout

    async def call_one(self, *args, **kwargs) -> Any:
        inproc = _inproc_actors.get((self._ref.host, self._ref.port, self._ref.name))
        if inproc is not None:
            # Same process: a direct call. Arguments pass by reference, so a
            # transport that keeps or hands out data copies it
            # (``inproc_copy``).
            result = getattr(inproc, self._method)(*args, **kwargs)
            return await result if asyncio.iscoroutine(result) else result
        try:
            conn = await get_connection(self._ref.host, self._ref.port)
        except OSError as exc:
            raise ActorDiedError(
                f"cannot connect to actor {self._ref.name!r} at "
                f"{self._ref.host}:{self._ref.port}: {exc!r}"
            ) from exc
        return await conn.request(
            KIND_REQUEST,
            {
                "actor": self._ref.name,
                "method": self._method,
                "args": args,
                "kwargs": kwargs,
            },
            timeout=self.effective_timeout(),
        )

    async def call(self, *args, **kwargs) -> Any:
        """On one ref, ``call`` is ``call_one``."""
        return await self.call_one(*args, **kwargs)


class ActorRef:
    """Picklable handle to one actor process."""

    def __init__(self, name: str, host: str, port: int, rank: int = 0):
        self.name = name
        self.host = host
        self.port = port
        self.rank = rank
        # Per-ref RPC deadline; None defers to config.rpc_timeout.
        self.rpc_timeout: Optional[float] = None

    def __getattr__(self, method: str) -> ActorEndpointRef:
        if method.startswith("_"):
            raise AttributeError(method)
        return ActorEndpointRef(self, method)

    def __repr__(self) -> str:
        return f"ActorRef({self.name!r}@{self.host}:{self.port})"

    async def control(self, op: str) -> Any:
        conn = await get_connection(self.host, self.port)
        return await conn.request(KIND_CONTROL, {"op": op, "actor": self.name})

    async def ping(self) -> bool:
        return await self.control("ping") == "pong"


class MeshEndpointRef:
    def __init__(self, mesh: "ActorMeshRef", method: str):
        self._mesh = mesh
        self._method = method

    async def call(self, *args, **kwargs) -> list[Any]:
        """Fan out to every actor of the mesh; the results in rank order."""
        return list(await asyncio.gather(
            *(getattr(ref, self._method).call_one(*args, **kwargs) for ref in self._mesh.refs)
        ))

    async def call_one(self, *args, **kwargs) -> Any:
        if len(self._mesh.refs) != 1:
            raise ValueError(
                f"call_one on a mesh of size {len(self._mesh.refs)}; index the mesh first"
            )
        return await getattr(self._mesh.refs[0], self._method).call_one(*args, **kwargs)


class ActorMeshRef:
    """Picklable handle to a rank-ordered mesh of actors."""

    def __init__(self, refs: list[ActorRef]):
        self.refs = refs

    def __getattr__(self, method: str) -> MeshEndpointRef:
        if method.startswith("_") or method == "refs":
            raise AttributeError(method)
        return MeshEndpointRef(self, method)

    def __getitem__(self, idx) -> "ActorMeshRef":
        if isinstance(idx, int):
            return ActorMeshRef([self.refs[idx]])
        return ActorMeshRef(list(self.refs[idx]))

    def __len__(self) -> int:
        return len(self.refs)


class ActorMesh(ActorMeshRef):
    """The spawner's mesh: it also holds the OS process handles for
    ``stop``."""

    def __init__(self, refs: list[ActorRef], processes: list) -> None:
        super().__init__(refs)
        self._processes = processes

    def __getstate__(self):
        return {"refs": self.refs}

    def __setstate__(self, state):
        self.refs = state["refs"]
        self._processes = []

    async def stop(self) -> None:
        for ref in self.refs:
            try:
                await asyncio.wait_for(ref.control("stop"), timeout=STOP_TIMEOUT_S)
            except (ActorDiedError, OSError, asyncio.TimeoutError):
                pass
        loop = asyncio.get_running_loop()
        for proc in self._processes:
            await loop.run_in_executor(None, proc.join, STOP_TIMEOUT_S)
            if proc.is_alive():
                logger.warning("terminating unresponsive actor process %s", proc.pid)
                proc.terminate()
                await loop.run_in_executor(None, proc.join, 5.0)
            if proc.is_alive():
                proc.kill()
                await loop.run_in_executor(None, proc.join, 2.0)
        self._processes = []


# --------------------------------------------------------------------------
# server side
# --------------------------------------------------------------------------


class ActorServer:
    def __init__(self) -> None:
        self.actors: dict[str, Actor] = {}
        self.stop_event = asyncio.Event()
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        self.address: Optional[str] = None
        self._client_writers: set[asyncio.StreamWriter] = set()

    def register(self, name: str, actor: Actor) -> None:
        self.actors[name] = actor

    async def start(self, host: Optional[str] = None, port: int = 0) -> int:
        """Listen on ``host`` (the process's bind address by default);
        ``self.address`` is then the address refs carry."""
        host = bind_host() if host is None else host
        self._server = await asyncio.start_server(
            self._handle_client, host, port, limit=2**20
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self.address = advertise_host(host)
        return self.port

    async def _handle_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        # Nothing is parsed (so nothing unpickled) before the peer proves it
        # knows the secret.
        if not await server_authenticate(reader, writer):
            await close_unauthenticated(writer)
            return
        _set_nodelay(writer)
        self._client_writers.add(writer)
        write_lock = asyncio.Lock()
        tasks: set[asyncio.Future] = set()
        try:
            while True:
                kind, msg = await read_message(reader)
                spawn_logged(
                    self._dispatch(kind, msg, writer, write_lock),
                    name="actor.dispatch",
                    tasks=tasks,
                    log=logger,
                )
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._client_writers.discard(writer)
            for task in tasks:
                task.cancel()
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError, RuntimeError):
                pass

    async def _dispatch(
        self, kind: int, msg: dict, writer: asyncio.StreamWriter, write_lock: asyncio.Lock
    ) -> None:
        req_id = msg.get("id")
        try:
            if kind == KIND_CONTROL:
                value = await self._handle_control(msg)
            elif kind == KIND_REQUEST:
                value = await self._handle_request(msg)
            else:
                raise RemoteActorError(f"unknown frame kind {kind}")
            async with write_lock:
                await write_message(writer, KIND_RESPONSE, {"id": req_id, "value": value})
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - forwarded to the caller
            payload: dict[str, Any] = {"id": req_id, "traceback": traceback.format_exc()}
            try:
                pickle.dumps(exc)
                payload["exception"] = exc
            except Exception:  # noqa: BLE001 - unpicklable: traceback only
                payload["exception"] = None
            try:
                async with write_lock:
                    await write_message(writer, KIND_ERROR, payload)
            except (ConnectionError, OSError):
                logger.exception("failed to report endpoint error to caller")

    async def _handle_control(self, msg: dict) -> Any:
        op = msg["op"]
        if op == "ping":
            # Armed in a process, "actor.ping" makes its pings raise or stall.
            from torchstore_tpu_torch import faults

            await faults.afire("actor.ping")
            return "pong"
        if op == "stop":
            # Respond first; the serve loop exits after this dispatch.
            asyncio.get_running_loop().call_soon(self.stop_event.set)
            return "stopping"
        if op == "list":
            return sorted(self.actors)
        raise RemoteActorError(f"unknown control op {op!r}")

    async def _handle_request(self, msg: dict) -> Any:
        actor = self.actors.get(msg["actor"])
        if actor is None:
            raise RemoteActorError(
                f"no actor {msg['actor']!r} in this process (have: {sorted(self.actors)})"
            )
        method = getattr(type(actor), msg["method"], None)
        if method is None or not getattr(method, _ENDPOINT_ATTR, False):
            raise RemoteActorError(f"{type(actor).__name__}.{msg['method']} is not an @endpoint")
        # The caller's trace context covers the whole dispatch: the rpc span
        # and everything the endpoint does (transfers, nested RPCs) hang off
        # the caller's span.
        with trace_context.activate(msg.get("trace")):
            with span(f"rpc/{msg['method']}", actor=msg["actor"]):
                result = method(actor, *msg["args"], **msg["kwargs"])
                if asyncio.iscoroutine(result):
                    result = await result
        return result

    async def serve_until_stopped(self) -> None:
        await self.stop_event.wait()
        for actor in self.actors.values():
            try:
                await actor.on_stop()
            except Exception:  # noqa: BLE001 - stopping regardless
                logger.exception("actor on_stop failed")
        await self.close()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for writer in list(self._client_writers):
            try:
                writer.close()
            except (ConnectionError, OSError, RuntimeError):
                pass
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)
            except asyncio.TimeoutError:
                pass


# --------------------------------------------------------------------------
# spawning
# --------------------------------------------------------------------------


def _child_main(pipe, actor_cls, name: str, args: tuple, kwargs: dict, env: dict) -> None:
    # ``env`` is the child's whole TORCHSTORE_TORCH_* environment: a forkserver
    # child inherits the helper's env from when it started, so what the
    # spawner did not pass goes.
    for key in list(os.environ):
        if key.startswith(ENV_PREFIX) and key not in env:
            del os.environ[key]
    os.environ.update(env)
    _reinit_after_fork()
    try:
        asyncio.run(_child_async(pipe, actor_cls, name, args, kwargs))
    except KeyboardInterrupt:
        pass
    finally:
        # A multiprocessing child leaves through os._exit, which skips
        # atexit: flush the trace and the metrics dump here.
        try:
            from torchstore_tpu_torch.observability import metrics as obs_metrics
            from torchstore_tpu_torch.observability.tracing import flush_trace

            flush_trace()
            obs_metrics.dump_metrics()
        except Exception:  # noqa: BLE001 - exiting regardless
            pass


def _reinit_after_fork() -> None:
    """Re-arm what a forked child inherits from the helper against its own
    corrected env: the config, observability (trace path, dumper thread,
    recorder), fault points, the landing pool (its threads died in the
    fork), the side streams and the bulk rung's stripe threshold and
    emulated link rate."""
    from torchstore_tpu_torch import config as config_mod
    from torchstore_tpu_torch import faults, observability
    from torchstore_tpu_torch.transport import bulk, landing, pinning

    config_mod._default_config = None
    observability.reinit_after_fork()
    faults.reinit_after_fork()
    landing.reinit_after_fork()
    pinning.reinit_after_fork()
    bulk.reinit_after_fork()


async def _child_async(pipe, actor_cls, name: str, args: tuple, kwargs: dict) -> None:
    server = ActorServer()
    try:
        actor = actor_cls(*args, **kwargs)
        server.register(name, actor)
        # Refs carry a reachable address: a wildcard bind (across hosts)
        # advertises the hostname or ADVERTISE_HOST, not 0.0.0.0.
        port = await server.start()
        pipe.send(("ready", server.address, port))
    except BaseException:
        pipe.send(("error", traceback.format_exc(), None))
        raise
    finally:
        pipe.close()
    await server.serve_until_stopped()


async def spawn_actors(
    num_actors: int,
    actor_cls: type,
    name: str,
    *args,
    env_fn: Optional[Callable[[int], dict[str, str]]] = None,
    **kwargs,
) -> ActorMesh:
    """Spawn ``num_actors`` processes each hosting one ``actor_cls``. Each
    child gets ``RANK``/``LOCAL_RANK``/``WORLD_SIZE``/``LOCAL_WORLD_SIZE``
    so strategies can derive volume ids, plus this process's
    ``TORCHSTORE_TORCH_*`` settings."""
    ctx = _mp_context()
    loop = asyncio.get_running_loop()
    # The process tree shares one trace run id, set before the env is read.
    from torchstore_tpu_torch.observability.tracing import ensure_run_id

    ensure_run_id()
    inherited = {k: v for k, v in os.environ.items() if k.startswith(ENV_PREFIX)}
    procs = []
    pipes = []
    for rank in range(num_actors):
        env = dict(inherited)
        env.update(
            {
                "RANK": str(rank),
                "LOCAL_RANK": str(rank),
                "WORLD_SIZE": str(num_actors),
                "LOCAL_WORLD_SIZE": str(num_actors),
            }
        )
        if env_fn is not None:
            env.update(env_fn(rank))
        parent_conn, child_conn = ctx.Pipe()
        proc = ctx.Process(
            target=_child_main,
            args=(child_conn, actor_cls, f"{name}_{rank}", args, kwargs, env),
            daemon=True,
            name=f"tst-{name}-{rank}",
        )
        proc.start()
        child_conn.close()
        procs.append(proc)
        pipes.append(parent_conn)
    refs: list[ActorRef] = []
    try:
        for rank, (proc, pipe) in enumerate(zip(procs, pipes)):
            status, a, b = await loop.run_in_executor(
                None, _pipe_recv, pipe, proc, SPAWN_TIMEOUT_S
            )
            if status != "ready":
                raise ActorDiedError(f"actor {name}_{rank} failed during spawn:\n{a}")
            refs.append(ActorRef(f"{name}_{rank}", a, b, rank=rank))
    except BaseException:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        for proc in procs:
            await loop.run_in_executor(None, proc.join, 5.0)
            if proc.is_alive():
                proc.kill()
                await loop.run_in_executor(None, proc.join, 2.0)
        raise
    finally:
        for pipe in pipes:
            pipe.close()
    return ActorMesh(refs, procs)


_ctx: Optional[mp.context.BaseContext] = None
_ctx_method: Optional[str] = None


def _mp_context() -> mp.context.BaseContext:
    """``forkserver`` (the default) preloads this package in a helper that
    never touches CUDA, so each child skips the torch import and may use the
    card; ``spawn`` (``TORCHSTORE_TORCH_MP_CONTEXT=spawn``) starts fresh
    interpreters."""
    global _ctx, _ctx_method
    method = os.environ.get(ENV_MP_CONTEXT, "forkserver")
    if _ctx is not None and method == _ctx_method:
        return _ctx
    ctx = mp.get_context(method)
    if method == "forkserver":
        ctx.set_forkserver_preload(["torchstore_tpu_torch.runtime"])
        # Start the helper now with the trace and metrics env stripped: it
        # imports the package, which would otherwise open a trace file and a
        # dumper of its own (and could claim the configured paths). Children
        # re-arm from their own env.
        from torchstore_tpu_torch.observability import ENV_METRICS_DUMP, ENV_TRACE

        saved = {k: os.environ.pop(k) for k in (ENV_METRICS_DUMP, ENV_TRACE) if k in os.environ}
        try:
            from multiprocessing import forkserver

            forkserver.ensure_running()
        finally:
            os.environ.update(saved)
    _ctx, _ctx_method = ctx, method
    return ctx


def _pipe_recv(pipe, proc, timeout: float):
    if not pipe.poll(timeout):
        if not proc.is_alive():
            raise ActorDiedError(f"actor process exited during spawn (exitcode={proc.exitcode})")
        raise ActorDiedError(f"actor spawn timed out after {timeout}s")
    try:
        return pipe.recv()
    except EOFError as exc:
        raise ActorDiedError(
            f"actor process exited during spawn (exitcode={proc.exitcode})"
        ) from exc


# Owner-side singleton registry (the spawning process holds the handles).
_singletons: dict[str, ActorMesh] = {}


async def get_or_spawn_singleton(name: str, actor_cls: type, *args, **kwargs) -> ActorRef:
    """The process-local singleton actor ``name``, spawned on first use."""
    mesh = _singletons.get(name)
    if mesh is None:
        mesh = await spawn_actors(1, actor_cls, name, *args, **kwargs)
        _singletons[name] = mesh
    return mesh.refs[0]


async def stop_singleton(name: str) -> None:
    mesh = _singletons.pop(name, None)
    if mesh is not None:
        await mesh.stop()


async def close_all_connections() -> None:
    loop = asyncio.get_running_loop()
    for key, (pool_loop, conn) in list(_conn_pools.items()):
        if pool_loop is loop:
            await conn.close()
            _conn_pools.pop(key, None)
