"""Client <-> volume mapping strategies.

Port of ``torchstore_tpu/strategy.py``: a strategy gives each volume its id
(computed inside the volume process from its env) and picks the volumes a
client writes to: its primary and, with ``replication`` > 1, the primary's
successors in sorted-id order.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional

from torchstore_tpu_torch.runtime import ActorRef
from torchstore_tpu_torch.transport.buffers import TransportContext
from torchstore_tpu_torch.utils import get_hostname


@dataclass
class StorageVolumeRef:
    """What transports need of a volume: its actor handle and id, the
    client's transport context, its host, and an optional forced
    transport."""

    actor: ActorRef
    volume_id: str
    transport_context: TransportContext
    hostname: str = ""
    transport_type: Optional[str] = None  # forced override, else auto

    def is_same_host(self) -> bool:
        return self.hostname == get_hostname()


class StoreStrategy(ABC):
    """``default_transport_type`` forces one transport for every volume.
    ``replication`` > 1 lands every put on that many volumes, so a get can
    be served by any of them."""

    def __init__(
        self, default_transport_type: Optional[str] = None, replication: int = 1
    ) -> None:
        if replication < 1:
            raise ValueError("replication must be >= 1")
        self.default_transport_type = default_transport_type
        self.replication = replication

    @abstractmethod
    def get_volume_id(self) -> str:
        """Runs inside the volume process (reads its own rank env)."""

    @abstractmethod
    def get_client_id(self) -> str:
        """Runs inside the client process."""

    def select_volume_id(self, client_id: str, volume_ids: list[str]) -> str:
        """The volume a client writes to: the one whose id is the client's."""
        if client_id in volume_ids:
            return client_id
        raise ValueError(
            f"no storage volume for client id {client_id!r}; volumes: {sorted(volume_ids)}"
        )

    def select_put_volume_ids(self, client_id: str, volume_ids: list[str]) -> list[str]:
        """Every volume a put writes to: the primary, then its
        ``replication`` - 1 successors on the ring of sorted ids."""
        primary = self.select_volume_id(client_id, volume_ids)
        if self.replication == 1:
            return [primary]
        if self.replication > len(volume_ids):
            raise ValueError(
                f"replication={self.replication} exceeds the {len(volume_ids)} available volumes"
            )
        ring = sorted(volume_ids)
        start = ring.index(primary)
        return [ring[(start + i) % len(ring)] for i in range(self.replication)]


class LocalRankStrategy(StoreStrategy):
    """One volume per rank; a client writes to its own rank's volume."""

    def get_volume_id(self) -> str:
        return os.environ.get("RANK", os.environ.get("LOCAL_RANK", "0"))

    def get_client_id(self) -> str:
        return os.environ.get("RANK", os.environ.get("LOCAL_RANK", "0"))


class HostStrategy(StoreStrategy):
    """One volume per host; a client writes to its own host's volume. The
    host is ``TORCHSTORE_TORCH_HOSTNAME`` when set (tests emulate hosts so),
    else the machine's name."""

    def get_volume_id(self) -> str:
        return get_hostname()

    def get_client_id(self) -> str:
        return get_hostname()


class SingletonStrategy(StoreStrategy):
    """One volume shared by every client."""

    VOLUME_ID = "0"

    def get_volume_id(self) -> str:
        return self.VOLUME_ID

    def get_client_id(self) -> str:
        return self.VOLUME_ID

    def select_volume_id(self, client_id: str, volume_ids: list[str]) -> str:
        return self.VOLUME_ID
