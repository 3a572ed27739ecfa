"""Process-based actor runtime.

Port of ``torchstore_tpu/runtime/actors.py``: ``spawn_actors`` starts N OS
processes (``spawn`` start method: fresh interpreters, no inherited CUDA or
thread state), each hosting one ``Actor`` whose ``@endpoint`` methods are
served over an asyncio TCP server. ``ActorRef``/``ActorMesh`` are picklable
handles whose ``.method.call_one()`` performs a multiplexed RPC with the
out-of-band tensor framing of ``serialization.py``.
"""

from __future__ import annotations

import asyncio
import multiprocessing as mp
import os
import pickle
import socket
import traceback
from typing import Any, Callable, Optional

from torchstore_tpu_torch.config import ENV_PREFIX
from torchstore_tpu_torch.logging import get_logger
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
BIND_HOST = "127.0.0.1"


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


# Connections per (event loop, address): tests run many asyncio.run loops,
# and a connection belongs to the loop that opened it.
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


class ActorMesh:
    """Rank-ordered actor refs; in the spawning process it also holds the
    OS process handles for ``stop``."""

    def __init__(self, refs: list[ActorRef], processes: list) -> None:
        self.refs = refs
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
        self._client_writers: set[asyncio.StreamWriter] = set()

    def register(self, name: str, actor: Actor) -> None:
        self.actors[name] = actor

    async def start(self, host: str = BIND_HOST, port: int = 0) -> int:
        self._server = await asyncio.start_server(
            self._handle_client, host, port, limit=2**20
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _handle_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
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
            return "pong"
        if op == "stop":
            # Respond first; the serve loop exits after this dispatch.
            asyncio.get_running_loop().call_soon(self.stop_event.set)
            return "stopping"
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
    for key in list(os.environ):
        if key.startswith(ENV_PREFIX) and key not in env:
            del os.environ[key]
    os.environ.update(env)
    try:
        asyncio.run(_child_async(pipe, actor_cls, name, args, kwargs))
    except KeyboardInterrupt:
        pass


async def _child_async(pipe, actor_cls, name: str, args: tuple, kwargs: dict) -> None:
    server = ActorServer()
    try:
        actor = actor_cls(*args, **kwargs)
        server.register(name, actor)
        port = await server.start(BIND_HOST)
        pipe.send(("ready", BIND_HOST, port))
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
    ctx = mp.get_context("spawn")
    loop = asyncio.get_running_loop()
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
