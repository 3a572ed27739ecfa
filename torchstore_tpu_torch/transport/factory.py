"""Transport selection: shared memory on the same host, else bulk TCP, else
RPC.

Port of ``torchstore_tpu/transport/factory.py`` without the device rung of
the volume ladder. A transport forced on the volume ref (from the strategy)
wins over the automatic choice. ``demotion_ladder`` lists the rungs a
failed put may retry on, best first (shm -> bulk -> rpc). A volume hosted
in this process (colocated) gets buffers that copy what they store and
serve: nothing is serialized on that path.
"""

from __future__ import annotations

from enum import Enum
from typing import TYPE_CHECKING, Optional, Union

from torchstore_tpu_torch.config import StoreConfig, default_config
from torchstore_tpu_torch.transport import bulk, shared_memory
from torchstore_tpu_torch.transport.buffers import TransportBuffer
from torchstore_tpu_torch.transport.rpc import RPCTransportBuffer

if TYPE_CHECKING:
    from torchstore_tpu_torch.strategy import StorageVolumeRef


class TransportType(str, Enum):
    UNSET = "unset"
    RPC = "rpc"
    SHM = "shm"
    BULK = "bulk"


def shm_available(volume: "StorageVolumeRef", config: StoreConfig) -> bool:
    return config.shm_enabled and volume.is_same_host() and shared_memory.is_available()


def bulk_available(volume: "StorageVolumeRef", config: StoreConfig) -> bool:
    return config.bulk_tcp_enabled and bulk.is_available()


def _forced(volume: "StorageVolumeRef") -> Optional[TransportType]:
    forced = volume.transport_type
    if forced in (None, TransportType.UNSET, TransportType.UNSET.value):
        return None
    return TransportType(forced)


def demotion_ladder(
    volume: "StorageVolumeRef", config: Optional[StoreConfig] = None
) -> list[TransportType]:
    """The rungs a put retry may walk down, best first, starting at the one
    ``create_transport_buffer`` picks: a broken shm handshake or a reset
    bulk socket demotes to the next rung instead of surfacing. rpc rides
    the actor channel itself and is always last. A volume pinned to a rung
    never retries above it."""
    config = config or default_config()
    start = _forced(volume)
    available = {
        TransportType.SHM: shm_available(volume, config),
        TransportType.BULK: bulk_available(volume, config),
        TransportType.RPC: True,
    }
    rungs: list[TransportType] = []
    for rung in (TransportType.SHM, TransportType.BULK, TransportType.RPC):
        if start is not None and not rungs:
            if rung == start:
                rungs.append(rung)  # the pin itself: the rung that failed
            continue
        if available[rung]:
            rungs.append(rung)
    return rungs or [TransportType.RPC]


def auto_select(volume: "StorageVolumeRef", config: StoreConfig) -> TransportType:
    """The rung an unforced request takes."""
    if shm_available(volume, config):
        return TransportType.SHM
    if bulk_available(volume, config):
        return TransportType.BULK
    return TransportType.RPC


def create_transport_buffer(
    volume: "StorageVolumeRef",
    config: Optional[StoreConfig] = None,
    force: Optional[Union[TransportType, str]] = None,
) -> TransportBuffer:
    """A buffer of the rung ``force`` names, else the volume's forced rung,
    else the automatic choice."""
    config = config or default_config()
    if force is not None:
        chosen = TransportType(force)
    else:
        chosen = _forced(volume) or auto_select(volume, config)
    if chosen == TransportType.SHM:
        return shared_memory.SharedMemoryTransportBuffer(config, inproc_copy=volume.is_inproc())
    if chosen == TransportType.BULK:
        return bulk.BulkTransportBuffer(config, inproc_copy=volume.is_inproc())
    return RPCTransportBuffer(inproc_copy=volume.is_inproc())
