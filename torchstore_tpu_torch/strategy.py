"""Client <-> volume mapping strategies.

Port of ``torchstore_tpu/strategy.py``: a strategy gives each volume its id
(computed inside the volume process from its env) and picks the volume a
client writes to.
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
    """``default_transport_type`` forces one transport for every volume."""

    def __init__(self, default_transport_type: Optional[str] = None) -> None:
        self.default_transport_type = default_transport_type

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


class LocalRankStrategy(StoreStrategy):
    """One volume per rank; a client writes to its own rank's volume."""

    def get_volume_id(self) -> str:
        return os.environ.get("RANK", os.environ.get("LOCAL_RANK", "0"))

    def get_client_id(self) -> str:
        return os.environ.get("RANK", os.environ.get("LOCAL_RANK", "0"))


class SingletonStrategy(StoreStrategy):
    """One volume shared by every client."""

    VOLUME_ID = "0"

    def get_volume_id(self) -> str:
        return self.VOLUME_ID

    def get_client_id(self) -> str:
        return self.VOLUME_ID

    def select_volume_id(self, client_id: str, volume_ids: list[str]) -> str:
        return self.VOLUME_ID
