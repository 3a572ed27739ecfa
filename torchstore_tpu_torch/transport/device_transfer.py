"""The device rung of direct weight sync: CUDA IPC between processes of one
host.

Port of ``torchstore_tpu/transport/device_transfer.py``. The reference pulls
staged device arrays through JAX's transfer server, device to device over
the accelerator fabric. Between the cards of one host the counterpart is
CUDA IPC: a source exports each of its card-side staging blocks once
(``cudaIpcGetMemHandle``, through torch's ``reduce_tensor``), and a dest
process on the same host opens it (``cudaIpcOpenMemHandle``, through
``rebuild_cuda_tensor``) and copies card to card.

- ``Placement`` stands where the reference's ``ShardingDescriptor`` stands:
  where a staged tensor lives, by the card's UUID and the host. Never by a
  device index: ``CUDA_VISIBLE_DEVICES`` numbers the cards differently in
  each process, so a dest maps the UUID to its own index (``card_index``).
- ``DeviceSpec`` is a staged tensor's shape, dtype and placement.
- ``DeviceTransferEngine`` exports blocks (``stage``) and opens them
  (``pull``). An export holds one reference on the block's memory for the
  opener (torch's IPC reference counters); opening a block this process
  already holds open releases that reference at once, so a dest that keeps
  its opened blocks opens each once however often it pulls.
- A process cannot open its own export (``cudaIpcOpenMemHandle`` refuses
  memory of the calling process): a dest in the source's process takes the
  staging tensors directly (``direct_weight_sync``'s in-process route).

The stamped one-sided uploads (``upload_stamped`` / ``finalize_stamped``)
belong to the one-sided planes and are not ported here.
"""

from __future__ import annotations

import inspect
import os
from dataclasses import dataclass
from typing import Optional

import torch

from torchstore_tpu_torch.observability.tracing import span
from torchstore_tpu_torch.utils import get_hostname

# The placement of a staged tensor in host memory (a source whose leaves
# were taken for cards, as tests do on a machine without one): no other
# process can open it.
HOST_CARD = "host"


def is_available() -> bool:
    """True when this process sees a CUDA card (CUDA IPC needs one)."""
    return torch.cuda.is_available()


def card_uuid(device: torch.device) -> str:
    """The UUID of the card ``device`` names in this process, or
    ``HOST_CARD`` for host memory."""
    if device.type != "cuda":
        return HOST_CARD
    return str(torch.cuda.get_device_properties(device).uuid)


def card_index(uuid: str) -> Optional[int]:
    """This process's index of the card with ``uuid``, or None when it does
    not see that card (or ``uuid`` is host memory)."""
    if uuid == HOST_CARD or not torch.cuda.is_available():
        return None
    for i in range(torch.cuda.device_count()):
        if card_uuid(torch.device("cuda", i)) == uuid:
            return i
    return None


@dataclass(frozen=True)
class Placement:
    """Where a staged tensor lives: the card's UUID and the host."""

    card: str
    host: str

    @classmethod
    def of(cls, device: torch.device) -> "Placement":
        return cls(card=card_uuid(device), host=get_hostname())


@dataclass(frozen=True)
class DeviceSpec:
    """Shape, dtype and placement of one staged tensor."""

    shape: tuple[int, ...]
    dtype: str
    placement: Placement

    @classmethod
    def of(cls, t: torch.Tensor) -> "DeviceSpec":
        return cls(shape=tuple(int(s) for s in t.shape),
                   dtype=str(t.dtype).removeprefix("torch."),
                   placement=Placement.of(t.device))


def _rebuild_signature() -> list[str]:
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    return list(inspect.signature(rebuild_cuda_tensor).parameters)


class DeviceTransferEngine:
    """Exports and opens CUDA IPC handles for this process. ``opens``
    counts the blocks this process opened (one ``cudaIpcOpenMemHandle``
    each)."""

    _instance: Optional["DeviceTransferEngine"] = None

    def __init__(self) -> None:
        self.opens = 0

    @classmethod
    def get(cls) -> "DeviceTransferEngine":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def ensure_server(self) -> str:
        """The address dests know this process by (host and pid). CUDA IPC
        runs no server: the source's peer server carries the handles."""
        return f"{get_hostname()}:{os.getpid()}"

    def stage(self, blocks: list[torch.Tensor]) -> list[tuple[str, tuple]]:
        """Export ``blocks`` (CUDA tensors that outlive every opener's
        use): per block its card's UUID and the arguments that open it."""
        from torch.multiprocessing.reductions import reduce_tensor

        out = []
        for block in blocks:
            _, args = reduce_tensor(block)
            out.append((card_uuid(block.device), tuple(args)))
        return out

    def pull(self, exported: list[tuple[str, tuple]], fresh: bool) -> list[torch.Tensor]:
        """Open exported blocks on this process's cards (the UUID mapped to
        this process's index). ``fresh`` says the caller holds none of them
        open yet: they count as opens. A UUID this process does not see
        raises ``ValueError``."""
        from torch.multiprocessing.reductions import rebuild_cuda_tensor

        device_at = _rebuild_signature().index("storage_device")
        out = []
        with span("transport.pull_device", transport="ipc", blocks=len(exported), fresh=fresh):
            for uuid, args in exported:
                index = card_index(uuid)
                if index is None:
                    raise ValueError(f"card {uuid} is not visible in this process")
                args = list(args)
                args[device_at] = index
                out.append(rebuild_cuda_tensor(*args))
        if fresh:
            self.opens += len(out)
        return out

    def reset(self) -> None:
        """Zero the open count (tests)."""
        self.opens = 0


def prewarm_engine() -> Optional[str]:
    """Make the engine ready before the first publish or pull needs it:
    CUDA's lazy initialization runs here, not on iteration 0. Returns the
    engine's address, or None without a card."""
    if not is_available():
        return None
    torch.cuda.init()
    return DeviceTransferEngine.get().ensure_server()

