"""Bulk TCP transport: the cross-host data path.

Port of ``torchstore_tpu/transport/bulk.py`` without the one-sided planes
(doorbells, push sessions: later work). Tensor bytes move over TCP
connections of their own between a client and a volume, never through the
RPC frames:

- **Two-phase handshake.** The handshake RPC returns the volume's bulk
  endpoint; the client dials it and keeps the connection scoped to the
  request. **Promote on success**: only a request that succeeded puts its
  connection in the per-volume cache, so a failed request never poisons it.
- **Abort.** A put that failed after its bytes were sent sends an abort
  frame, so the volume drops what landed.
- **Striping.** A payload above ``STRIPE_THRESHOLD`` bytes is split into
  ranges carried over ``STRIPE_CONNS`` connections at once; each frame
  carries (index, offset, total), so the receiver reassembles in any order.
- **Packing.** The small tensors of a put batch ride one frame.
- **In-place gets.** A contiguous host destination of the served dtype and
  shape is filled straight from the socket.

Cards: a CUDA source is sent from page-locked host staging, filled by
device-to-host copies on the card's side stream; a CUDA destination is
filled from page-locked staging by host-to-device copies on that stream.
Staging is bounded: each connection owns two buffers of ``STAGE_CHUNK``
bytes a way, and frames are cut to that size, so the copy of one chunk
runs while the next one is on the wire. The staging buffers are
page-locked while their connection lives and unlocked when it closes.

IO rides raw non-blocking sockets (``loop.sock_sendall`` /
``sock_recv_into``): bytes go between the kernel and the tensor's memory
without a user-space copy. Wire format: ``<session u64><idx u32><nbytes
u64>`` and the payload. A put's payloads are sent before its RPC (the
volume waits for them); a get's are streamed by a background task after
the RPC's reply, so neither side blocks the other.
"""

from __future__ import annotations

import asyncio
import copy
import socket
import struct
import time
import uuid
from typing import Any, Optional

import torch

from torchstore_tpu_torch import faults, native
from torchstore_tpu_torch.config import (
    ENV_BULK_EMULATE_GBPS,
    ENV_BULK_STRIPE_THRESHOLD,
    StoreConfig,
    _env_float,
    _env_int,
    advertise_host,
    bind_host,
    default_config,
)
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.transport import landing
from torchstore_tpu_torch.transport.buffers import (
    Served,
    TransportBuffer,
    TransportCache,
    TransportContext,
    transfer_timeout,
)
from torchstore_tpu_torch.transport.pinning import host_register, host_unregister, side_stream
from torchstore_tpu_torch.transport.shared_memory import ShmServerCache
from torchstore_tpu_torch.transport.types import Request, TensorMeta
from torchstore_tpu_torch.utils import spawn_logged

logger = get_logger("torchstore_tpu_torch.transport.bulk")

_FRAME = struct.Struct("<QIQ")
IDX_HELLO = 0xFFFFFFFF
IDX_ABORT = 0xFFFFFFFE
# "The get payloads of this session go to THIS connection": a client may
# hold several connections to a volume. The server acks it (same idx back),
# so the client orders it before the get RPC, which rides another stream.
IDX_SESSION_OPEN = 0xFFFFFFFD
# A chunk of a payload: the body starts with a _STRIPE subheader (real idx,
# byte offset, total bytes).
IDX_STRIPED = 0xFFFFFFFC
# The packed small-key payload of a put batch (the offsets ride the RPC).
IDX_PACKED = 0xFFFFFFFB
_CONTROL_IDXS = frozenset({IDX_HELLO, IDX_ABORT, IDX_SESSION_OPEN, IDX_STRIPED})
_STRIPE = struct.Struct("<IQQ")

STRIPE_CONNS = 4
# Host staging a card copy goes through: bytes per buffer (two per
# connection and direction), and so the largest frame a card payload takes.
STAGE_CHUNK = 32 << 20
# Fresh receive buffers at or above this size are prefaulted natively
# before the socket writes into them.
PREFAULT_MIN_BYTES = 64 << 20
# Per-session state on the volume (landed put bytes, abort marks) goes
# after this long without its RPC: a crashed client must not grow the
# volume's memory forever.
SESSION_TTL_S = 600.0

_DIALS = obs_metrics.counter("ts_bulk_dials_total", "Bulk TCP connections dialed (main + stripe)")
_STRIPED = obs_metrics.counter(
    "ts_bulk_striped_transfers_total", "Payloads striped across parallel connections, by direction"
)
_STAGING_LOCKED = obs_metrics.gauge(
    "ts_bulk_staging_locked_bytes", "Page-locked card staging of the live bulk connections"
)

STRIPE_THRESHOLD = 64 << 20
_EMULATE_GBPS = 0.0


def reinit_after_fork() -> None:
    """Read the stripe threshold and the emulated link rate from this
    process's environment (a forked child's corrected one)."""
    global STRIPE_THRESHOLD, _EMULATE_GBPS
    STRIPE_THRESHOLD = _env_int(ENV_BULK_STRIPE_THRESHOLD, 64 << 20)
    try:
        _EMULATE_GBPS = _env_float(ENV_BULK_EMULATE_GBPS, 0.0)
    except ValueError:
        _EMULATE_GBPS = 0.0


reinit_after_fork()


def set_emulated_gbps(gbps: Optional[float]) -> float:
    """Set (None: read again from the environment) this process's emulated
    link rate; returns the previous one."""
    global _EMULATE_GBPS
    prev = _EMULATE_GBPS
    if gbps is None:
        reinit_after_fork()
    else:
        _EMULATE_GBPS = float(gbps)
    return prev


async def _pace(nbytes: int) -> None:
    """The time a link of the emulated rate would add for one payload
    frame (nothing when the rate is 0)."""
    if _EMULATE_GBPS > 0 and nbytes > 0:
        await asyncio.sleep(nbytes / (_EMULATE_GBPS * 1e9))


def is_available() -> bool:
    return True


def _new_id() -> int:
    return uuid.uuid4().int & ((1 << 64) - 1)


def _now() -> float:
    return time.monotonic()


# --------------------------------------------------------------------------
# bytes of tensors, and the card copies through host staging
# --------------------------------------------------------------------------


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as a flat uint8 tensor (a copy when ``t`` is not
    contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _mv(t: torch.Tensor) -> memoryview:
    """A writable memoryview of a host uint8 tensor's bytes."""
    return memoryview(t.numpy())


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t``'s bytes go through host staging (a card tensor)."""
    return t.is_cuda


def _card_copy(dst: torch.Tensor, src: torch.Tensor):
    """Copy between host staging and a card on the card's side stream;
    returns the event of the copy (None: a host copy, done already)."""
    card = dst if dst.is_cuda else src
    if not card.is_cuda:
        dst.copy_(src)
        return None
    stream = side_stream(card.device)
    with torch.cuda.stream(stream):
        dst.copy_(src, non_blocking=True)
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _after_current_stream(t: torch.Tensor) -> None:
    """Order the card's side stream after the work queued so far on the
    current stream (the cast that made a source, the zeroing of a
    destination)."""
    if t.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        side_stream(t.device).wait_event(ready)


async def _wait_event(event) -> None:
    if event is not None and not event.query():
        await asyncio.get_running_loop().run_in_executor(None, event.synchronize)


class _StagingRing:
    """Two host buffers of ``STAGE_CHUNK`` bytes that one connection's card
    copies go through in one direction, each with the event of its last
    copy. Page-locked when made, unlocked by ``release`` when the
    connection closes."""

    def __init__(self) -> None:
        self._bufs: list[Optional[torch.Tensor]] = [None, None]
        self._locked: list[int] = []
        self._locked_bytes = 0
        self.events: list = [None, None]
        self.next = 0
        self.released = False

    def buffer(self, k: int) -> torch.Tensor:
        buf = self._bufs[k]
        if buf is None:
            if self.released:
                raise ConnectionError("bulk connection closed")
            buf = torch.empty(STAGE_CHUNK, dtype=torch.uint8)
            ptr = host_register(buf)
            self._bufs[k] = buf
            self._locked.append(ptr)
            self._locked_bytes += buf.numel()
            _STAGING_LOCKED.inc(buf.numel())
        return buf

    async def wait(self, k: int) -> None:
        await _wait_event(self.events[k])
        self.events[k] = None

    def release(self) -> None:
        """Wait for the copies in flight, unlock and drop the buffers; the
        ring makes none after this."""
        self.released = True
        for event in self.events:
            if event is not None:
                event.synchronize()
        self.events = [None, None]
        host_unregister(self._locked)
        _STAGING_LOCKED.dec(self._locked_bytes)
        self._locked, self._locked_bytes = [], 0
        self._bufs = [None, None]


def _pieces(off: int, end: int, size: int = 0) -> list[tuple[int, int]]:
    """[off, end) cut into consecutive pieces of at most ``size`` bytes
    (``STAGE_CHUNK`` by default)."""
    size = size or STAGE_CHUNK
    return [(o, min(o + size, end)) for o in range(off, end, size)] or [(off, end)]


# --------------------------------------------------------------------------
# raw-socket IO
# --------------------------------------------------------------------------


async def _recv_exact(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` from the socket (kernel to destination, no staging)."""
    loop = asyncio.get_running_loop()
    pos = 0
    total = view.nbytes
    while pos < total:
        n = await loop.sock_recv_into(sock, view[pos:])
        if n == 0:
            raise ConnectionError("bulk peer closed mid-frame")
        pos += n


async def _discard(sock: socket.socket, nbytes: int) -> None:
    """Read and drop payload bytes addressed to no known session."""
    if nbytes <= 0:
        return
    scratch = memoryview(bytearray(min(nbytes, 1 << 16)))
    loop = asyncio.get_running_loop()
    left = nbytes
    while left:
        n = await loop.sock_recv_into(sock, scratch[: min(left, len(scratch))])
        if n == 0:
            raise ConnectionError("bulk peer closed mid-frame")
        left -= n


async def _send_frame(
    sock: socket.socket, lock: asyncio.Lock, session: int, idx: int,
    payload: Optional[memoryview],
) -> None:
    if await faults.afire("bulk.send_frame") == "drop-frame":
        return  # lost silently: the receiver's deadlines own the recovery
    loop = asyncio.get_running_loop()
    async with lock:
        nbytes = payload.nbytes if payload is not None else 0
        await loop.sock_sendall(sock, _FRAME.pack(session, idx, nbytes))
        if payload is not None:
            await loop.sock_sendall(sock, payload)
            await _pace(nbytes)


async def _send_frame_raw(
    sock: socket.socket, session: int, idx: int, subheader: bytes, payload: memoryview
) -> None:
    """A frame with a stripe subheader; the caller holds the write lock."""
    loop = asyncio.get_running_loop()
    await loop.sock_sendall(sock, _FRAME.pack(session, idx, len(subheader) + payload.nbytes))
    await loop.sock_sendall(sock, subheader)
    await loop.sock_sendall(sock, payload)
    await _pace(payload.nbytes)


def _shutdown_sock(sock: socket.socket) -> None:
    """Wake the connection's reader with an error; the reader then joins
    the sends in flight and closes the descriptor."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def _close_sock(sock: Optional[socket.socket]) -> None:
    """Close at once: only when no ``loop.sock_*`` call can be pending on
    the socket (a failed dial, teardown without a loop)."""
    if sock is not None:
        _shutdown_sock(sock)
        try:
            sock.close()
        except OSError:
            pass


def _family_for(host: str) -> int:
    return socket.AF_INET6 if ":" in host else socket.AF_INET


def _stripe_ranges(total: int, n: int, k: int) -> list[tuple[int, int]]:
    """The byte ranges connection ``k`` of ``n`` carries when a ``total``
    byte payload is striped: contiguous chunks dealt round-robin, so every
    connection streams at once."""
    chunk = -(-total // n)
    return [(off, min(off + chunk, total)) for off in range(k * chunk, total, chunk * n)]


def _fresh_buffer(nbytes: int) -> torch.Tensor:
    """An uninitialized host buffer a socket writes into; a large one is
    prefaulted natively first (its pages allocated by several threads, not
    one fault at a time under the receive)."""
    buf = torch.empty(nbytes, dtype=torch.uint8)
    if nbytes >= PREFAULT_MIN_BYTES:
        native.prefault(buf.data_ptr(), nbytes)
    return buf


# --------------------------------------------------------------------------
# server side (the storage volume's process)
# --------------------------------------------------------------------------


class BulkServer:
    """A volume's bulk listener: lands put payloads in a session table and
    streams get payloads back over the client's connections."""

    def __init__(self) -> None:
        self._listen_sock: Optional[socket.socket] = None
        self._accept_task: Optional[asyncio.Task] = None
        self.port: Optional[int] = None
        self.host: str = "127.0.0.1"
        # (session, idx) -> uint8 tensor of a landed payload
        self.incoming: dict[tuple[int, int], torch.Tensor] = {}
        # (session, idx) -> [uint8 tensor(total), bytes received] while
        # chunks arrive (maybe over several connections)
        self._stripe_asm: dict[tuple[int, int], list] = {}
        self.aborted: set[int] = set()
        self._session_ts: dict[int, float] = {}
        self._arrival = asyncio.Condition()
        # client id -> (sock, write lock): get payloads' fallback route
        self.client_conns: dict[int, tuple[socket.socket, asyncio.Lock]] = {}
        # session -> every connection the client opened for this get
        self.session_conns: dict[int, list[tuple[socket.socket, asyncio.Lock]]] = {}
        self._conn_tasks: set[asyncio.Task] = set()
        # sock -> sends in flight, joined before the socket is closed
        self._send_tasks: dict[socket.socket, set[asyncio.Task]] = {}
        self.counts = {"accepted": 0, "bytes_in": 0, "bytes_out": 0, "frames_in": 0,
                       "frames_out": 0, "striped_in": 0, "striped_out": 0, "aborts": 0}

    async def ensure_started(self, host: Optional[str] = None) -> tuple[str, int]:
        """Listen on ``host`` (the process's bind address by default); returns
        the advertised (host, port) clients dial."""
        if self._listen_sock is None:
            host = bind_host() if host is None else host
            sock = socket.socket(_family_for(host), socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, 0))
            sock.listen(64)
            sock.setblocking(False)
            self._listen_sock = sock
            self.port = sock.getsockname()[1]
            # A wildcard bind hands clients a reachable name, not 0.0.0.0.
            self.host = advertise_host(host)
            self._accept_task = asyncio.ensure_future(self._accept_loop())
            logger.info("bulk server bound %s:%s (advertised as %s)", host, self.port, self.host)
        return self.host, self.port

    async def _accept_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            try:
                conn, _ = await loop.sock_accept(self._listen_sock)
            except asyncio.CancelledError:
                raise
            except OSError as exc:
                if self._listen_sock is None or self._listen_sock.fileno() < 0:
                    return  # the listener closed
                # Transient (EMFILE, ECONNABORTED): keep accepting, paced.
                logger.warning("bulk accept failed (%s); retrying in 1s", exc)
                await asyncio.sleep(1.0)
                continue
            conn.setblocking(False)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.counts["accepted"] += 1
            spawn_logged(self._handle_conn(conn), name="bulk.conn", tasks=self._conn_tasks,
                         log=logger)

    async def _handle_conn(self, sock: socket.socket) -> None:
        from torchstore_tpu_torch.runtime.auth import server_authenticate_sock

        if not await server_authenticate_sock(sock):
            _close_sock(sock)  # no send in flight yet, the auth read is done
            return
        client_id = None
        conn_lock = asyncio.Lock()  # serializes every outgoing write
        header = bytearray(_FRAME.size)
        header_view = memoryview(header)
        sub = bytearray(_STRIPE.size)
        try:
            while True:
                await _recv_exact(sock, header_view)
                session, idx, nbytes = _FRAME.unpack(header)
                self.counts["frames_in"] += 1
                if await faults.afire("bulk.recv_frame") == "drop-frame":
                    await _discard(sock, nbytes)  # drained: the stream stays parseable
                    continue
                if idx == IDX_HELLO:
                    client_id = session
                    self.client_conns[client_id] = (sock, conn_lock)
                    continue
                if idx == IDX_SESSION_OPEN:
                    conns = self.session_conns.setdefault(session, [])
                    if all(c is not sock for c, _ in conns):
                        conns.append((sock, conn_lock))
                    self._session_ts[session] = _now()
                    await _send_frame(sock, conn_lock, session, IDX_SESSION_OPEN, None)
                    continue
                if idx == IDX_ABORT:
                    async with self._arrival:
                        self.counts["aborts"] += 1
                        self.aborted.add(session)
                        self._session_ts[session] = _now()
                        self._drop_session_bytes(session)
                        self._arrival.notify_all()
                    continue
                if idx == IDX_STRIPED:
                    await _recv_exact(sock, memoryview(sub))
                    real_idx, offset, total = _STRIPE.unpack(sub)
                    chunk_len = nbytes - _STRIPE.size
                    key = (session, real_idx)
                    asm = self._stripe_asm.get(key)
                    if asm is None:
                        asm = self._stripe_asm[key] = [_fresh_buffer(total), 0]
                    await _recv_exact(sock, _mv(asm[0][offset : offset + chunk_len]))
                    asm[1] += chunk_len
                    self.counts["bytes_in"] += chunk_len
                    if asm[1] >= total:
                        async with self._arrival:
                            # pop: an abort on another connection may have
                            # dropped the assembly meanwhile
                            if self._stripe_asm.pop(key, None) is not None:
                                self.incoming[key] = asm[0]
                                self.counts["striped_in"] += 1
                            self._session_ts[session] = _now()
                            self._purge_stale()
                            self._arrival.notify_all()
                    else:
                        self._session_ts[session] = _now()
                    continue
                buf = _fresh_buffer(nbytes)
                await _recv_exact(sock, _mv(buf))
                self.counts["bytes_in"] += nbytes
                async with self._arrival:
                    self.incoming[(session, idx)] = buf
                    self._session_ts[session] = _now()
                    self._purge_stale()
                    self._arrival.notify_all()
        except (ConnectionError, OSError):
            pass
        finally:
            if client_id is not None and self.client_conns.get(client_id, (None,))[0] is sock:
                self.client_conns.pop(client_id, None)
            for sess, conns in list(self.session_conns.items()):
                conns[:] = [(c, lk) for c, lk in conns if c is not sock]
                if not conns:
                    self.session_conns.pop(sess, None)
            # Join this connection's sends, then close: after that no
            # loop.sock_* call can reference the descriptor.
            send_tasks = list(self._send_tasks.pop(sock, ()))
            for task in send_tasks:
                task.cancel()
            if send_tasks:
                await asyncio.gather(*send_tasks, return_exceptions=True)
            _close_sock(sock)

    def _drop_session_bytes(self, session: int) -> None:
        for key in [k for k in self.incoming if k[0] == session]:
            del self.incoming[key]
        for key in [k for k in self._stripe_asm if k[0] == session]:
            del self._stripe_asm[key]

    def _purge_stale(self) -> None:
        """Drop session state older than ``SESSION_TTL_S`` (a client that
        crashed between its bytes and its RPC). Called under the lock."""
        now = _now()
        for session in [s for s, ts in self._session_ts.items() if now - ts > SESSION_TTL_S]:
            del self._session_ts[session]
            self.aborted.discard(session)
            self.session_conns.pop(session, None)
            self._drop_session_bytes(session)

    async def collect(self, session: int, indices: list[int]) -> dict[int, torch.Tensor]:
        """Wait for every payload of a put session (its bytes may land
        before or after its RPC)."""
        async with self._arrival:
            try:
                while True:
                    if session in self.aborted:
                        self.aborted.discard(session)
                        raise ConnectionError(f"bulk session {session} aborted by client")
                    if all((session, i) in self.incoming for i in indices):
                        return {i: self.incoming.pop((session, i)) for i in indices}
                    await self._arrival.wait()
            finally:
                self._session_ts.pop(session, None)

    def send_background(
        self, client_id: int, session: int, payloads: dict[int, torch.Tensor]
    ) -> list:
        """Stream a get's payloads (contiguous host uint8 tensors) without
        blocking its RPC's reply; returns the send tasks. Over several
        session connections, a large payload is striped across them; every
        chunk of a striped payload is at most ``STAGE_CHUNK`` bytes, the
        client's staging size."""
        conns = self.session_conns.pop(session, None)
        if not conns:
            fallback = self.client_conns.get(client_id)
            if fallback is None:
                raise ConnectionError(f"no bulk connection registered for client {client_id}")
            conns = [fallback]

        tasks = []

        def track(sock: socket.socket, coro) -> None:
            task = asyncio.ensure_future(coro)
            bucket = self._send_tasks.setdefault(sock, set())
            bucket.add(task)
            task.add_done_callback(bucket.discard)
            tasks.append(task)

        async def guarded(sock, send_all) -> None:
            try:
                await asyncio.wait_for(send_all(), timeout=SESSION_TTL_S)
            except asyncio.TimeoutError:
                # A cancelled sendall may have left half a frame on the
                # wire: the framing is lost, so the connection goes.
                logger.warning("bulk get send timed out (session=%s); closing", session)
                _shutdown_sock(sock)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - logged; the client's deadline fails the get
                logger.exception("bulk get send failed (session=%s)", session)

        def send_plain(sock, lock, frames: list[tuple[int, torch.Tensor]]):
            async def send_all() -> None:
                for idx, data in frames:
                    await _send_frame(sock, lock, session, idx, _mv(data))
                    self.counts["frames_out"] += 1
                    self.counts["bytes_out"] += data.numel()
            return send_all

        def send_stripes(sock, lock, idx, data, ranges, total):
            async def send_all() -> None:
                for lo, hi in ranges:
                    for off, end in _pieces(lo, hi):
                        async with lock:
                            await _send_frame_raw(sock, session, IDX_STRIPED,
                                                  _STRIPE.pack(idx, off, total), _mv(data[off:end]))
                        self.counts["frames_out"] += 1
                        self.counts["bytes_out"] += end - off
            return send_all

        plain: list[tuple[int, torch.Tensor]] = []
        for idx, data in payloads.items():
            nbytes = data.numel()
            if len(conns) > 1 and nbytes > STRIPE_THRESHOLD:
                _STRIPED.inc(direction="get")
                self.counts["striped_out"] += 1
                for k, (sock, lock) in enumerate(conns):
                    ranges = _stripe_ranges(nbytes, len(conns), k)
                    if ranges:
                        track(sock, guarded(sock, send_stripes(sock, lock, idx, data, ranges,
                                                               nbytes)))
            else:
                plain.append((idx, data))
        if plain:
            sock, lock = conns[0]
            track(sock, guarded(sock, send_plain(sock, lock, plain)))
        return tasks

    def stats(self) -> dict:
        return {**self.counts, "listening": self._listen_sock is not None,
                "client_conns": len(self.client_conns), "pending_payloads": len(self.incoming),
                "assembling": len(self._stripe_asm)}

    def close(self) -> None:
        """Stop listening and wake every connection's reader (each closes
        its own socket)."""
        if self._accept_task is not None:
            self._accept_task.cancel()
            self._accept_task = None
        if self._listen_sock is not None:
            sock, self._listen_sock = self._listen_sock, None
            try:
                sock.close()
            except OSError:
                pass
        for sock, _ in list(self.client_conns.values()):
            _shutdown_sock(sock)
        for conns in list(self.session_conns.values()):
            for sock, _ in conns:
                _shutdown_sock(sock)
        self.incoming.clear()
        self._stripe_asm.clear()


class BulkServerCache(TransportCache):
    def __init__(self) -> None:
        self.server = BulkServer()

    def stats(self) -> dict:
        return self.server.stats()

    def clear(self) -> None:
        self.server.close()


# --------------------------------------------------------------------------
# client side
# --------------------------------------------------------------------------


# Queue marks: the payload was received straight into its destination (a
# host view, or a card destination through staging).
LANDED = object()
LANDED_CARD = object()


class _SessionEntry:
    """One get session's client state, shared by every connection that
    carries it (the main one and the stripe ones)."""

    __slots__ = ("queue", "dests", "card_dests", "stripes")

    def __init__(self) -> None:
        self.queue: asyncio.Queue = asyncio.Queue()
        # idx -> contiguous host destination (received in place)
        self.dests: dict[int, memoryview] = {}
        # idx -> a card destination's bytes (received through staging)
        self.card_dests: dict[int, torch.Tensor] = {}
        # idx -> [target, received, total, mark] while chunks arrive
        self.stripes: dict[int, list] = {}


_CONN_STATS = ("recv_s", "recv_bytes", "h2d_wait_s", "d2h_wait_s", "send_s", "sent_bytes")


class BulkClientConn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.write_lock = asyncio.Lock()
        self.send_lock = asyncio.Lock()  # one staged card send at a time
        self.closed = False
        self.sessions: dict[int, _SessionEntry] = {}
        self._rings: dict[str, _StagingRing] = {}
        # Seconds of the card path on this connection: receiving into
        # staging and waiting for its copies to the card (gets); waiting for
        # the copies from the card and sending the staging (puts).
        self.stats = dict.fromkeys(_CONN_STATS, 0)
        self._reader_task = asyncio.ensure_future(self._demux())

    def ring(self, direction: str) -> _StagingRing:
        ring = self._rings.get(direction)
        if ring is None:
            if self.closed:
                raise ConnectionError("bulk connection closed")
            ring = self._rings[direction] = _StagingRing()
        return ring

    async def _recv_to_card(self, dest: torch.Tensor, offset: int, nbytes: int) -> None:
        """Receive ``nbytes`` of the socket into ``dest[offset:]`` (a card
        destination's bytes) through the staging ring: a chunk's copy to the
        card runs while the next chunk is received."""
        ring = self.ring("recv")
        stats = self.stats
        for off, end in _pieces(0, nbytes):
            k = ring.next
            ring.next ^= 1
            t0 = time.perf_counter()
            await ring.wait(k)
            t1 = time.perf_counter()
            buf = ring.buffer(k)[: end - off]
            await _recv_exact(self.sock, _mv(buf))
            stats["h2d_wait_s"] += t1 - t0
            stats["recv_s"] += time.perf_counter() - t1
            stats["recv_bytes"] += end - off
            ring.events[k] = _card_copy(dest[offset + off : offset + end], buf)

    async def _demux(self) -> None:
        header = bytearray(_FRAME.size)
        header_view = memoryview(header)
        sub = bytearray(_STRIPE.size)
        try:
            while True:
                await _recv_exact(self.sock, header_view)
                session, idx, nbytes = _FRAME.unpack(header)
                entry = self.sessions.get(session)
                if idx == IDX_STRIPED:
                    await _recv_exact(self.sock, memoryview(sub))
                    real_idx, offset, total = _STRIPE.unpack(sub)
                    chunk_len = nbytes - _STRIPE.size
                    if entry is None:
                        await _discard(self.sock, chunk_len)
                        continue
                    st = entry.stripes.get(real_idx)
                    if st is None:
                        card = entry.card_dests.get(real_idx)
                        dest = entry.dests.get(real_idx)
                        if card is not None and card.numel() == total:
                            st = [card, 0, total, LANDED_CARD]
                        elif dest is not None and dest.nbytes == total:
                            st = [dest, 0, total, LANDED]
                        else:
                            st = [_fresh_buffer(total), 0, total, None]
                        entry.stripes[real_idx] = st
                    if st[3] is LANDED_CARD:
                        await self._recv_to_card(st[0], offset, chunk_len)
                    elif st[3] is LANDED:
                        await _recv_exact(self.sock, st[0][offset : offset + chunk_len])
                    else:
                        await _recv_exact(self.sock, _mv(st[0][offset : offset + chunk_len]))
                    st[1] += chunk_len
                    if st[1] >= total:
                        del entry.stripes[real_idx]
                        _STRIPED.inc(direction="get")
                        entry.queue.put_nowait((real_idx, st[3] or st[0]))
                    continue
                if idx in _CONTROL_IDXS:
                    if nbytes:
                        await _discard(self.sock, nbytes)
                    if entry is not None:
                        entry.queue.put_nowait((idx, None))
                    continue
                card = entry.card_dests.get(idx) if entry is not None else None
                if card is not None and card.numel() == nbytes:
                    await self._recv_to_card(card, 0, nbytes)
                    entry.queue.put_nowait((idx, LANDED_CARD))
                    continue
                dest = entry.dests.get(idx) if entry is not None else None
                if dest is not None and dest.nbytes == nbytes:
                    await _recv_exact(self.sock, dest)
                    entry.queue.put_nowait((idx, LANDED))
                    continue
                if entry is None:
                    await _discard(self.sock, nbytes)
                    continue
                buf = _fresh_buffer(nbytes)
                await _recv_exact(self.sock, _mv(buf))
                entry.queue.put_nowait((idx, buf))
        except (ConnectionError, OSError):
            for entry in self.sessions.values():
                entry.queue.put_nowait((None, None))
        finally:
            # The receive just ended, so the descriptor is out of the
            # selector: closing here (and only here) is safe.
            self.closed = True
            try:
                self.sock.close()
            except OSError:
                pass
            for ring in self._rings.values():
                ring.release()

    def register_session(self, session: int) -> _SessionEntry:
        entry = _SessionEntry()
        self.sessions[session] = entry
        return entry

    def adopt_session(self, session: int, entry: _SessionEntry) -> None:
        """Carry an existing session on this connection too (striping)."""
        self.sessions[session] = entry

    def release_session(self, session: int) -> None:
        self.sessions.pop(session, None)

    def close_now(self) -> None:
        """Mark closed and wake the reader, which closes the descriptor."""
        self.closed = True
        _shutdown_sock(self.sock)


async def _dial(host: str, port: int, timeout: float) -> socket.socket:
    loop = asyncio.get_running_loop()
    infos = await loop.getaddrinfo(host, port, type=socket.SOCK_STREAM)
    family, _, _, _, sockaddr = infos[0]
    sock = socket.socket(family, socket.SOCK_STREAM)
    sock.setblocking(False)
    try:
        await asyncio.wait_for(loop.sock_connect(sock, sockaddr), timeout)
    except BaseException:
        _close_sock(sock)
        raise
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    from torchstore_tpu_torch.runtime.auth import client_authenticate_sock

    try:
        await client_authenticate_sock(sock)
    except BaseException:
        _close_sock(sock)
        raise
    _DIALS.inc()
    return sock


class BulkClientCache(TransportCache):
    """The promoted, reused connection to each volume, and the extra ones
    that carry stripes of large transfers."""

    def __init__(self) -> None:
        self.client_id = _new_id()
        self.connections: dict[str, BulkClientConn] = {}
        self.stripe_conns: dict[str, list[BulkClientConn]] = {}
        self.endpoints: dict[str, tuple[str, int]] = {}
        self.dials = 0
        self.card_sync_s = 0.0  # gets' final waits for their copies to the cards

    def get_alive(self, volume_id: str) -> Optional[BulkClientConn]:
        conn = self.connections.get(volume_id)
        if conn is not None and conn.closed:
            del self.connections[volume_id]
            return None
        return conn

    async def get_stripe_conns(self, volume_id: str, n: int, timeout: float) -> list:
        """Up to ``n`` extra live connections for striping (dialed lazily,
        reused); [] when the endpoint is unknown."""
        endpoint = self.endpoints.get(volume_id)
        if endpoint is None:
            return []
        conns = [c for c in self.stripe_conns.get(volume_id, []) if not c.closed]
        self.stripe_conns[volume_id] = conns
        try:
            while len(conns) < n:
                sock = await _dial(endpoint[0], endpoint[1], timeout)
                self.dials += 1
                conns.append(BulkClientConn(sock))
        except (ConnectionError, OSError, asyncio.TimeoutError):
            # Striping is an optimization: carry on with what dialed.
            pass
        return conns

    def stats(self) -> dict:
        """Dials, connections alive, and the card path's seconds and bytes
        summed over every connection (see ``BulkClientConn.stats``)."""
        conns = list(self.connections.values()) + [
            c for cs in self.stripe_conns.values() for c in cs]
        out = {"dials": self.dials,
               "connections": sum(not c.closed for c in self.connections.values()),
               "stripe_connections": sum(not c.closed for cs in self.stripe_conns.values()
                                         for c in cs),
               "card_sync_s": self.card_sync_s, **dict.fromkeys(_CONN_STATS, 0)}
        for conn in conns:
            for k, v in conn.stats.items():
                out[k] = out.get(k, 0) + v
        return out

    def clear(self) -> None:
        for conn in self.connections.values():
            conn.close_now()
        self.connections.clear()
        for conns in self.stripe_conns.values():
            for conn in conns:
                conn.close_now()
        self.stripe_conns.clear()
        self.endpoints.clear()


async def prewarm_connection(volume, config: Optional[StoreConfig] = None, stripes: int = 0) -> int:
    """Dial and promote the volume's main bulk connection (a successful
    dial is the success promotion waits for), and with ``stripes`` open
    that many stripe connections, so a large first transfer stripes from
    its first byte. Returns the fresh dials; raises when a dial fails."""
    config = config or default_config()
    cache: BulkClientCache = volume.transport_context.get_cache(BulkClientCache)
    dials = 0
    if cache.get_alive(volume.volume_id) is None:
        buffer = BulkTransportBuffer(config)
        await buffer._ensure_conn(volume)
        buffer._post_request_success(volume)
        if not buffer._promoted:
            buffer._conn.close_now()  # a concurrent first request won the slot
        else:
            dials += 1
    if stripes > 0:
        before = len([c for c in cache.stripe_conns.get(volume.volume_id, []) if not c.closed])
        conns = await cache.get_stripe_conns(volume.volume_id, stripes, config.handshake_timeout)
        dials += max(0, len(conns) - before)
    return dials


class BulkTransportBuffer(TransportBuffer):
    transport_name = "bulk"
    # The handshake (endpoint exchange and dial) runs in ``_ensure_conn``,
    # and only while no promoted connection exists.
    requires_handshake = False
    # drop() returns at once and the buffer may go right after, so its
    # abort / close task is anchored here.
    _cleanup_tasks: set = set()

    def __init__(self, config: Optional[StoreConfig] = None, inproc_copy: bool = False) -> None:
        self.config = config or default_config()
        # Colocated: objects ride by reference, so the volume copies them;
        # tensor bytes always cross the socket.
        self.inproc_copy = inproc_copy
        self.session = _new_id()
        self.client_id: Optional[int] = None
        # carried by the RPC
        self.manifest: dict[int, TensorMeta] = {}
        # packed small keys: request idx -> (byte offset, TensorMeta)
        self.packed_manifest: dict[int, tuple[int, TensorMeta]] = {}
        self.packed_total = 0
        self.objects: dict[int, Any] = {}
        self.descriptors: dict[int, TensorMeta] = {}
        # client-only
        self._conn: Optional[BulkClientConn] = None
        self._promoted = False
        self._entry: Optional[_SessionEntry] = None
        self._session_carriers: list[BulkClientConn] = []
        self._card_devices: set = set()
        self._sent_put = False
        self._succeeded = False

    def __getstate__(self):
        # No tensor and no socket travels; the config does (the volume's
        # hooks read their timeouts from it).
        state = self.__dict__.copy()
        state.update(_conn=None, _entry=None, _session_carriers=[], _card_devices=set())
        return state

    # ---- connections -------------------------------------------------------

    async def _ensure_conn(self, volume) -> BulkClientConn:
        cache: BulkClientCache = volume.transport_context.get_cache(BulkClientCache)
        self.client_id = cache.client_id
        conn = cache.get_alive(volume.volume_id)
        if conn is not None:
            self._conn = conn
            self._promoted = True
            return conn
        # Two phases: the handshake RPC names the endpoint, then the dial.
        handshake = volume.actor.handshake.with_timeout(self.config.handshake_timeout)
        host, port = await handshake.call_one(self, [], "bulk_connect")
        cache.endpoints[volume.volume_id] = (host, port)
        sock = await _dial(host, port, self.config.handshake_timeout)
        cache.dials += 1
        conn = BulkClientConn(sock)
        self._conn = conn
        self._promoted = False  # scoped to this request until it succeeds
        await _send_frame(sock, conn.write_lock, cache.client_id, IDX_HELLO, None)
        return conn

    def _post_request_success(self, volume) -> None:
        """Promote on success: publish the request's connection, unless a
        concurrent first request already did (this one closes at drop)."""
        self._succeeded = True
        if self._conn is not None and not self._promoted:
            cache: BulkClientCache = volume.transport_context.get_cache(BulkClientCache)
            if cache.get_alive(volume.volume_id) is None:
                cache.connections[volume.volume_id] = self._conn
                self._promoted = True

    async def _with_conn(self, op: str, volume, run):
        try:
            await self._ensure_conn(volume)
        except BaseException as exc:
            self._count_error(op, volume, exc)
            self.drop()
            raise
        return await run()

    # ---- client: put -------------------------------------------------------

    async def put_to_storage_volume(self, volume, requests: list[Request]) -> None:
        await self._with_conn(
            "put", volume, lambda: super(BulkTransportBuffer, self).put_to_storage_volume(
                volume, requests))

    async def _pre_put_hook(self, volume, requests: list[Request]) -> None:
        cache: BulkClientCache = volume.transport_context.get_cache(BulkClientCache)
        packed = await self._pack_small_requests(requests)
        self._sent_put = True  # from here bytes may be on the wire
        for idx, req in enumerate(requests):
            if req.is_object:
                self.objects[idx] = req.objects
                continue
            if idx in packed:
                continue
            t = req.tensor_val
            self.manifest[idx] = TensorMeta.of(t)
            data = _byte_view(t)
            conns = [self._conn]
            if data.numel() > STRIPE_THRESHOLD:
                conns += await cache.get_stripe_conns(
                    volume.volume_id, STRIPE_CONNS - 1, self.config.handshake_timeout)
            await self._send_payload(idx, data, conns)

    async def _send_payload(self, idx: int, data: torch.Tensor, conns: list) -> None:
        """Send one payload's bytes: over several connections in striped
        chunks, or over one in a plain frame (a card payload above one
        staging buffer in chunks on the one connection)."""
        total = data.numel()
        striped = len(conns) > 1
        if striped:
            _STRIPED.inc(direction="put")
        card = _on_card(data)
        if card:
            _after_current_stream(data)
        jobs = []
        for k, conn in enumerate(conns):
            ranges = _stripe_ranges(total, len(conns), k) if striped else [(0, total)]
            if card:
                pieces = [p for lo, hi in ranges for p in _pieces(lo, hi)]
            else:
                pieces = ranges
            if pieces:
                jobs.append(self._send_pieces(conn, idx, data, pieces, total,
                                              chunked=striped or len(pieces) > 1, card=card))
        await asyncio.gather(*jobs)

    async def _send_pieces(self, conn: BulkClientConn, idx: int, data: torch.Tensor,
                           pieces: list, total: int, chunked: bool, card: bool) -> None:
        async def send(off: int, end: int, view: memoryview) -> None:
            if chunked:
                async with conn.write_lock:
                    await _send_frame_raw(conn.sock, self.session, IDX_STRIPED,
                                          _STRIPE.pack(idx, off, total), view)
            else:
                await _send_frame(conn.sock, conn.write_lock, self.session, idx, view)

        if not card:
            for off, end in pieces:
                await send(off, end, _mv(data[off:end]))
            return
        # A card payload: the copy of the next chunk into staging runs while
        # this one is sent. A buffer is refilled only after its chunk went.
        async with conn.send_lock:
            ring = conn.ring("send")

            def fill(i: int) -> None:
                off, end = pieces[i]
                ring.events[i % 2] = _card_copy(ring.buffer(i % 2)[: end - off], data[off:end])

            stats = conn.stats
            fill(0)
            for i, (off, end) in enumerate(pieces):
                if i + 1 < len(pieces):
                    fill(i + 1)
                t0 = time.perf_counter()
                await ring.wait(i % 2)
                t1 = time.perf_counter()
                await send(off, end, _mv(ring.buffer(i % 2)[: end - off]))
                stats["d2h_wait_s"] += t1 - t0
                stats["send_s"] += time.perf_counter() - t1
                stats["sent_bytes"] += end - off

    async def _pack_small_requests(self, requests: list[Request]) -> set[int]:
        """Every tensor at or under ``arena_max_bytes`` rides one packed
        frame (the offsets ride the RPC): one header and one send for the
        whole small-key tail of the batch."""
        limit = getattr(self.config, "arena_max_bytes", 0)
        if limit <= 0:
            return set()
        members = [idx for idx, req in enumerate(requests)
                   if not req.is_object and req.tensor_val is not None and req.nbytes <= limit]
        if len(members) < 2:
            return set()
        datas = {idx: _byte_view(requests[idx].tensor_val) for idx in members}
        offsets, total = landing.compute_arena_layout([datas[idx].numel() for idx in members])
        packed = torch.empty(total, dtype=torch.uint8)
        pairs = []
        for idx, off in zip(members, offsets):
            data = datas[idx]
            self.packed_manifest[idx] = (off, TensorMeta.of(requests[idx].tensor_val))
            if data.numel():
                pairs.append((packed[off : off + data.numel()], data))
        await landing.land_async(pairs, self.config)
        self.packed_total = total
        self._sent_put = True
        await _send_frame(self._conn.sock, self._conn.write_lock, self.session, IDX_PACKED,
                          _mv(packed))
        return set(members)

    def _handle_put_reply(self, volume, reply, requests) -> None:
        self._post_request_success(volume)

    # ---- client: get -------------------------------------------------------

    async def get_from_storage_volume(self, volume, requests: list[Request]):
        async def run():
            try:
                return await super(BulkTransportBuffer, self).get_from_storage_volume(
                    volume, requests)
            finally:
                # Every exit releases the session, or pooled connections
                # collect dead sessions that pin their destinations.
                for carrier in self._session_carriers:
                    carrier.release_session(self.session)
                self._session_carriers = []
                self._entry = None

        return await self._with_conn("get", volume, run)

    async def _pre_get_hook(self, volume, requests: list[Request]) -> None:
        self._entry = self._conn.register_session(self.session)
        self._session_carriers = [self._conn]
        for idx, req in enumerate(requests):
            dest = req.destination_view
            # Raw bytes land as they are: dtype and shape must be what the
            # volume serves, else the copy landing (which checks) takes it.
            if dest is None or not dest.is_contiguous() or req.tensor_meta is None:
                continue
            if req.tensor_meta.torch_dtype != dest.dtype:
                continue
            served = (req.tensor_slice.local_shape if req.tensor_slice is not None
                      else req.tensor_meta.shape)
            if tuple(served) != tuple(dest.shape):
                continue
            if _on_card(dest):
                self._entry.card_dests[idx] = _byte_view(dest)
                if dest.is_cuda and dest.device not in self._card_devices:
                    self._card_devices.add(dest.device)
                    _after_current_stream(dest)
            else:
                self._entry.dests[idx] = _mv(_byte_view(dest))
        expect_large = any(
            m.tensor_meta is not None and m.tensor_meta.nbytes > STRIPE_THRESHOLD
            for m in (r.meta_only() for r in requests)
        )
        if expect_large:
            cache: BulkClientCache = volume.transport_context.get_cache(BulkClientCache)
            for extra in await cache.get_stripe_conns(
                volume.volume_id, STRIPE_CONNS - 1, self.config.handshake_timeout
            ):
                extra.adopt_session(self.session, self._entry)
                self._session_carriers.append(extra)
        for carrier in self._session_carriers:
            await _send_frame(carrier.sock, carrier.write_lock, self.session, IDX_SESSION_OPEN,
                              None)
        # Every carrier's ack first: the get RPC rides another stream, so
        # without it the volume could serve before the session's route exists.
        for _ in self._session_carriers:
            ack, _ = await asyncio.wait_for(self._entry.queue.get(),
                                            timeout=self.config.handshake_timeout)
            if ack != IDX_SESSION_OPEN:
                raise ConnectionError(f"bulk session-open handshake failed (got frame {ack})")

    async def _handle_storage_volume_response(
        self, volume, remote: "BulkTransportBuffer", requests: list[Request]
    ) -> list[Any]:
        frame_timeout = transfer_timeout(
            self.config.rpc_timeout, sum(m.nbytes for m in remote.descriptors.values())
        )
        expected = set(remote.descriptors)
        received: dict[int, Any] = {}
        while expected - set(received):
            idx, raw = await asyncio.wait_for(self._entry.queue.get(), timeout=frame_timeout)
            if idx is None:
                raise ConnectionError("bulk connection lost during get")
            received[idx] = raw
        if self._card_devices:
            loop = asyncio.get_running_loop()
            t0 = time.perf_counter()
            for dev in self._card_devices:  # the staged copies to the cards
                await loop.run_in_executor(None, side_stream(dev).synchronize)
            cache: BulkClientCache = volume.transport_context.get_cache(BulkClientCache)
            cache.card_sync_s += time.perf_counter() - t0
        results: list[Any] = []
        landings = []
        for idx, req in enumerate(requests):
            if req.is_object or idx in remote.objects:
                results.append(remote.objects[idx])
                continue
            meta = remote.descriptors[idx]
            raw = received[idx]
            if raw is LANDED or raw is LANDED_CARD:
                results.append(req.destination_view)
                continue
            value = raw.view(meta.torch_dtype).reshape(meta.shape)
            dest = req.destination_view
            if dest is None:
                results.append(value)
                continue
            if tuple(dest.shape) != tuple(value.shape):
                raise ValueError(
                    f"destination shape {tuple(dest.shape)} != fetched {tuple(value.shape)}")
            landings.append((dest, value))
            results.append(dest)
        await landing.land_async(landings, self.config)
        self._post_request_success(volume)
        return results

    # ---- server hooks --------------------------------------------------------

    async def recv_handshake(self, ctx: TransportContext, metas, existing, op: str):
        server: BulkServer = ctx.get_cache(BulkServerCache).server
        return await server.ensure_started()

    async def handle_put_request(
        self, ctx: TransportContext, metas: list[Request], existing: dict
    ) -> dict[int, Any]:
        server: BulkServer = ctx.get_cache(BulkServerCache).server
        objects = self.objects
        if self.inproc_copy:
            objects = {k: copy.deepcopy(v) for k, v in objects.items()}
        out: dict[int, Any] = dict(objects)
        # Scaled with the bytes: a multi-GB transfer slower than the flat
        # handshake timeout must not fail the put.
        total = sum(m.nbytes for m in self.manifest.values()) + self.packed_total
        indices = sorted(self.manifest)
        if self.packed_manifest:
            indices.append(IDX_PACKED)
        payloads = await asyncio.wait_for(
            server.collect(self.session, indices),
            timeout=transfer_timeout(self.config.handshake_timeout, total),
        )
        if self.packed_manifest:
            raw = payloads.pop(IDX_PACKED)
            for idx, (off, meta) in self.packed_manifest.items():
                out[idx] = raw[off : off + meta.nbytes].view(meta.torch_dtype).reshape(meta.shape)
        for idx, raw in payloads.items():
            meta = self.manifest[idx]
            # The received buffer becomes the entry: a reader being served
            # the old entry keeps its bytes (nothing is overwritten in place).
            out[idx] = raw.view(meta.torch_dtype).reshape(meta.shape)
        return out

    async def handle_get_request(
        self, ctx: TransportContext, metas: list[Request], entries: list[Any]
    ) -> None:
        server: BulkServer = ctx.get_cache(BulkServerCache).server
        shm = ctx.peek(ShmServerCache)
        payloads: dict[int, torch.Tensor] = {}
        gathers = []
        leased: list[str] = []
        for idx, (meta, entry) in enumerate(zip(metas, entries)):
            if meta.is_object:
                self.objects[idx] = copy.deepcopy(entry) if self.inproc_copy else entry
                continue
            served: Served = entry
            part = served.part()
            self.descriptors[idx] = TensorMeta.of(part)
            found = shm.lookup(*served.cache_key) if shm is not None else None
            if found is not None and found.ptr == served.tensor.data_ptr():
                # A segment an shm put landed: leased while its bytes are on
                # the wire, so a re-put of the key retires it, not reuses it.
                shm.grant(found.seg.name)
                leased.append(found.seg.name)
            if part.is_contiguous():
                payloads[idx] = part.reshape(-1).view(torch.uint8)
                continue
            # A box of a stored tensor: gathered natively (row blocks).
            flat = torch.empty(part.shape, dtype=part.dtype)
            gathers.append((flat, part))
            payloads[idx] = flat.reshape(-1).view(torch.uint8)
        try:
            for dst, src in gathers:
                await landing.run_in_pool(native.copy_into, dst, src, config=self.config)
            tasks = server.send_background(self.client_id, self.session, payloads) \
                if payloads else []
        except BaseException:
            for name in leased:
                shm.release(name)
            raise
        if leased:
            def release(_) -> None:
                for name in leased:
                    shm.release(name)

            if tasks:
                asyncio.gather(*tasks, return_exceptions=True).add_done_callback(release)
            else:
                release(None)

    # ---- cleanup -------------------------------------------------------------

    def drop(self) -> None:
        conn = self._conn
        if conn is not None:
            need_abort = self._sent_put and not self._succeeded and not conn.closed
            promoted = self._promoted
            session = self.session

            async def cleanup() -> None:
                if need_abort:
                    # Under the write lock: a raw write could land inside
                    # another request's payload on a shared connection.
                    try:
                        await _send_frame(conn.sock, conn.write_lock, session, IDX_ABORT, None)
                    except Exception:  # noqa: BLE001 - the connection is going anyway
                        pass
                if not promoted:
                    conn.close_now()  # never published after a failure

            try:
                spawn_logged(cleanup(), name="bulk.cleanup",
                             tasks=BulkTransportBuffer._cleanup_tasks, log=logger)
            except RuntimeError:  # no running loop (interpreter teardown)
                if not promoted:
                    _close_sock(conn.sock)
        self._conn = None
        self.manifest = {}
        self.packed_manifest = {}
        self.packed_total = 0
        self.objects = {}
        self.descriptors = {}
