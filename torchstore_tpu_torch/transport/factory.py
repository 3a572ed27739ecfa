"""Transport selection: shared memory for a same-host volume, else RPC.

Port of ``torchstore_tpu/transport/factory.py`` without the bulk-TCP and
device rungs. A transport forced on the volume ref (from the strategy)
wins over the automatic choice.
"""

from __future__ import annotations

from enum import Enum
from typing import TYPE_CHECKING, Optional

from torchstore_tpu_torch.config import StoreConfig, default_config
from torchstore_tpu_torch.transport import shared_memory
from torchstore_tpu_torch.transport.buffers import TransportBuffer
from torchstore_tpu_torch.transport.rpc import RPCTransportBuffer

if TYPE_CHECKING:
    from torchstore_tpu_torch.strategy import StorageVolumeRef


class TransportType(str, Enum):
    UNSET = "unset"
    RPC = "rpc"
    SHM = "shm"


def shm_available(volume: "StorageVolumeRef", config: StoreConfig) -> bool:
    return config.shm_enabled and volume.is_same_host() and shared_memory.is_available()


def create_transport_buffer(
    volume: "StorageVolumeRef", config: Optional[StoreConfig] = None
) -> TransportBuffer:
    config = config or default_config()
    forced = volume.transport_type
    if forced in (None, TransportType.UNSET, TransportType.UNSET.value):
        chosen = TransportType.SHM if shm_available(volume, config) else TransportType.RPC
    else:
        chosen = TransportType(forced)
    if chosen == TransportType.SHM:
        return shared_memory.SharedMemoryTransportBuffer(config)
    return RPCTransportBuffer()
