"""Rendezvous key-value service: the bootstrap of an SPMD world.

Port of ``torchstore_tpu/runtime/rendezvous.py``. Rank 0 hosts a small
asyncio KV server on ``MASTER_ADDR:MASTER_PORT`` and every rank connects as
a client; blocking gets and atomic counters are enough for the handle
broadcast, barriers and the two-phase shutdown of ``spmd.py``. Its listener
takes the same auth challenge as every other (``auth.py``), and every op
passes the ``rendezvous.dispatch`` fault point.

Ops: ``set`` key value | ``get`` key (blocks until set) | ``add`` key delta
(atomic, returns the new value) | ``wait_counter`` key target | ``check``
key (presence, without blocking).
"""

from __future__ import annotations

import asyncio
import pickle
from typing import Any, Optional

from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.runtime.serialization import (
    KIND_REQUEST,
    KIND_RESPONSE,
    read_message,
    write_message,
)
from torchstore_tpu_torch.utils import spawn_logged

logger = get_logger("torchstore_tpu_torch.rendezvous")

DEFAULT_TIMEOUT_S = 300.0


class RendezvousServer:
    def __init__(self) -> None:
        self.kv: dict[str, Any] = {}
        self.counters: dict[str, int] = {}
        self._changed = asyncio.Condition()
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()
        self.port: Optional[int] = None

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _handle(self, reader, writer) -> None:
        from torchstore_tpu_torch.runtime.auth import close_unauthenticated, server_authenticate

        if not await server_authenticate(reader, writer):
            await close_unauthenticated(writer)
            return
        self._writers.add(writer)
        write_lock = asyncio.Lock()
        tasks: set[asyncio.Task] = set()
        try:
            while True:
                _, msg = await read_message(reader)
                spawn_logged(self._dispatch(msg, writer, write_lock),
                             name="rendezvous.dispatch", tasks=tasks, log=logger)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._writers.discard(writer)
            for task in tasks:
                task.cancel()
            try:
                writer.close()
            except (ConnectionError, OSError, RuntimeError):
                pass

    async def _dispatch(self, msg: dict, writer, write_lock) -> None:
        op = msg["op"]
        try:
            from torchstore_tpu_torch import faults

            await faults.afire("rendezvous.dispatch")
            if op == "set":
                async with self._changed:
                    self.kv[msg["key"]] = msg["value"]
                    self._changed.notify_all()
                value = True
            elif op == "get":
                async with self._changed:
                    while msg["key"] not in self.kv:
                        await self._changed.wait()
                    value = self.kv[msg["key"]]
            elif op == "add":
                async with self._changed:
                    self.counters[msg["key"]] = self.counters.get(msg["key"], 0) + msg["delta"]
                    value = self.counters[msg["key"]]
                    self._changed.notify_all()
            elif op == "wait_counter":
                async with self._changed:
                    while self.counters.get(msg["key"], 0) < msg["target"]:
                        await self._changed.wait()
                    value = self.counters[msg["key"]]
            elif op == "check":
                value = msg["key"] in self.kv
            else:
                raise ValueError(f"unknown rendezvous op {op!r}")
            ok = True
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - the reply carries it
            value, ok = repr(exc), False
        async with write_lock:
            await write_message(writer, KIND_RESPONSE, {"id": msg["id"], "value": value, "ok": ok})

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                try:
                    writer.close()
                except (ConnectionError, OSError, RuntimeError):
                    pass
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)
            except asyncio.TimeoutError:
                pass
            self._server = None


class RendezvousClient:
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader = None
        self._writer = None
        self._lock = asyncio.Lock()
        self._next_id = 0
        self._pending: dict[int, asyncio.Future] = {}
        self._reader_task: Optional[asyncio.Task] = None

    async def connect(self, timeout: float = DEFAULT_TIMEOUT_S) -> None:
        """Connect, retrying under a ``RetryPolicy`` while rank 0's server is
        not up yet (``timeout`` is the budget; a gentle jittered start, so a
        world connecting at once does not hit the listener in lockstep). A
        challenge that does not come within the auth timeout is retried the
        same way: rank 0's event loop can stay busy longer than that right
        after its listener opens (it spawns its host's volumes), and the
        connection then waits in its backlog unanswered."""
        from torchstore_tpu_torch.config import RetryPolicy
        from torchstore_tpu_torch.runtime.auth import client_authenticate

        policy = RetryPolicy(base_s=0.2, max_s=1.0, multiplier=1.5, deadline_s=timeout)
        deadline = policy.start()
        attempt = 0
        while True:
            try:
                self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
            except (ConnectionError, OSError):
                if not policy.should_retry(attempt, deadline):
                    raise
            else:
                try:
                    await client_authenticate(self._reader, self._writer)
                    break
                except (asyncio.TimeoutError, asyncio.IncompleteReadError):
                    self._writer.close()
                    if not policy.should_retry(attempt, deadline):
                        raise
                    logger.warning("rendezvous at %s:%s sent no auth challenge in time; "
                                   "retrying", self.host, self.port)
            await asyncio.sleep(policy.backoff(attempt))
            attempt += 1
        self._reader_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                _, msg = await read_message(self._reader)
                fut = self._pending.pop(msg["id"], None)
                if fut is not None and not fut.done():
                    if msg.get("ok", True):
                        fut.set_result(msg["value"])
                    else:
                        fut.set_exception(RuntimeError(msg["value"]))
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as exc:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(f"rendezvous lost: {exc!r}"))
            self._pending.clear()

    async def _request(self, op: str, timeout: float = DEFAULT_TIMEOUT_S, **body):
        req_id = self._next_id
        self._next_id += 1
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        async with self._lock:
            await write_message(self._writer, KIND_REQUEST, {"op": op, "id": req_id, **body})
        return await asyncio.wait_for(fut, timeout=timeout)

    async def set(self, key: str, value: Any) -> None:
        await self._request("set", key=key, value=value)

    async def get(self, key: str, timeout: float = DEFAULT_TIMEOUT_S) -> Any:
        return await self._request("get", timeout=timeout, key=key)

    async def add(self, key: str, delta: int = 1) -> int:
        return await self._request("add", key=key, delta=delta)

    async def wait_counter(self, key: str, target: int, timeout: float = DEFAULT_TIMEOUT_S) -> int:
        return await self._request("wait_counter", timeout=timeout, key=key, target=target)

    async def check(self, key: str) -> bool:
        return await self._request("check", key=key)

    async def barrier(self, name: str, world_size: int, timeout: float = DEFAULT_TIMEOUT_S) -> None:
        await self.add(f"barrier/{name}", 1)
        await self.wait_counter(f"barrier/{name}", world_size, timeout=timeout)

    async def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, OSError, RuntimeError):
                pass


def pickle_handle(obj: Any) -> bytes:
    return pickle.dumps(obj)


def unpickle_handle(raw: bytes) -> Any:
    return pickle.loads(raw)
