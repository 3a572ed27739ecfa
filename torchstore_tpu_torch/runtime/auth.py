"""Connection authentication: HMAC challenge-response on every listener.

Port of ``torchstore_tpu/runtime/auth.py``. The actor RPC server unpickles
its peers' frames, and the direct-sync source serves its staging to any
peer that connects; neither may read a byte from a stranger. With
``TORCHSTORE_TORCH_AUTH_SECRET`` (or ``StoreConfig.auth_secret``) set, every
accepted connection completes a challenge before its first frame is parsed:

    server -> client:  b"TSAU" + 16-byte random nonce
    client -> server:  HMAC-SHA256(secret, nonce)           (32 bytes)

The bulk transport's raw sockets and the rendezvous server take the same
challenge (``server_authenticate_sock`` / ``client_authenticate_sock``).
Nothing is unpickled before it; a wrong or missing MAC closes the
connection, and the nonce makes the answer useless for a replay. With no
secret the exchange is skipped (no cost, no bytes on the wire).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import os
import socket
from typing import Optional

from torchstore_tpu_torch.logging import get_logger

logger = get_logger("torchstore_tpu_torch.auth")

AUTH_MAGIC = b"TSAU"
NONCE_LEN = 16
MAC_LEN = 32  # sha256
AUTH_TIMEOUT_S = 10.0


def get_secret() -> Optional[str]:
    from torchstore_tpu_torch.config import default_config

    return default_config().auth_secret or None


def compute_mac(secret: str, nonce: bytes) -> bytes:
    return hmac.new(secret.encode(), nonce, hashlib.sha256).digest()


async def server_authenticate(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter, secret: Optional[str] = None
) -> bool:
    """The server's side of the challenge: True lets the connection
    proceed; False means close it without parsing anything."""
    secret = secret if secret is not None else get_secret()
    if not secret:
        return True
    nonce = os.urandom(NONCE_LEN)
    try:
        writer.write(AUTH_MAGIC + nonce)
        await writer.drain()
        mac = await asyncio.wait_for(reader.readexactly(MAC_LEN), timeout=AUTH_TIMEOUT_S)
    except (asyncio.IncompleteReadError, asyncio.TimeoutError, OSError):
        logger.warning("peer closed or stalled during auth challenge")
        return False
    if not hmac.compare_digest(mac, compute_mac(secret, nonce)):
        logger.warning("rejecting connection from %s: bad auth MAC",
                       writer.get_extra_info("peername"))
        return False
    return True


async def client_authenticate(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter, secret: Optional[str] = None
) -> None:
    """The client's side: answer the server's challenge."""
    secret = secret if secret is not None else get_secret()
    if not secret:
        return
    hello = await asyncio.wait_for(
        reader.readexactly(len(AUTH_MAGIC) + NONCE_LEN), timeout=AUTH_TIMEOUT_S
    )
    if hello[: len(AUTH_MAGIC)] != AUTH_MAGIC:
        raise ConnectionError(
            "auth secret is configured but the server did not issue a challenge: "
            "peer is running without TORCHSTORE_TORCH_AUTH_SECRET"
        )
    writer.write(compute_mac(secret, hello[len(AUTH_MAGIC):]))
    await writer.drain()


async def close_unauthenticated(writer: asyncio.StreamWriter) -> None:
    try:
        writer.close()
        await writer.wait_closed()
    except (ConnectionError, OSError, RuntimeError):
        pass


# ---- raw-socket variants (the bulk transport) ------------------------------


async def server_authenticate_sock(sock: socket.socket, secret: Optional[str] = None) -> bool:
    """``server_authenticate`` on a non-blocking raw socket."""
    secret = secret if secret is not None else get_secret()
    if not secret:
        return True
    loop = asyncio.get_running_loop()
    nonce = os.urandom(NONCE_LEN)
    try:
        await loop.sock_sendall(sock, AUTH_MAGIC + nonce)
        mac = await asyncio.wait_for(_recv_exactly(sock, MAC_LEN), timeout=AUTH_TIMEOUT_S)
    except (ConnectionError, asyncio.TimeoutError, OSError):
        logger.warning("bulk peer closed or stalled during auth challenge")
        return False
    if not hmac.compare_digest(mac, compute_mac(secret, nonce)):
        logger.warning("rejecting bulk connection: bad auth MAC")
        return False
    return True


async def client_authenticate_sock(sock: socket.socket, secret: Optional[str] = None) -> None:
    """``client_authenticate`` on a non-blocking raw socket."""
    secret = secret if secret is not None else get_secret()
    if not secret:
        return
    loop = asyncio.get_running_loop()
    hello = await asyncio.wait_for(
        _recv_exactly(sock, len(AUTH_MAGIC) + NONCE_LEN), timeout=AUTH_TIMEOUT_S
    )
    if hello[: len(AUTH_MAGIC)] != AUTH_MAGIC:
        raise ConnectionError(
            "auth secret is configured but the server did not issue a challenge: "
            "peer is running without TORCHSTORE_TORCH_AUTH_SECRET"
        )
    await loop.sock_sendall(sock, compute_mac(secret, hello[len(AUTH_MAGIC):]))


async def _recv_exactly(sock: socket.socket, n: int) -> bytes:
    loop = asyncio.get_running_loop()
    buf = bytearray()
    while len(buf) < n:
        chunk = await loop.sock_recv(sock, n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed during auth")
        buf += chunk
    return bytes(buf)
