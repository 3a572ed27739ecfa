"""Client-local segment pool: staging made ahead for the direct path.

Port of ``torchstore_tpu/provision/pool.py``. A direct source on the host
rung creates one ``/dev/shm`` staging segment per tensor at ``register``,
on the first publish's critical path. ``api.prewarm(..., direct=True)``
creates and pre-faults those segments in the trainer's own process ahead
of it, and ``DirectWeightSyncSource.register`` draws exact-size segments
from here before it creates any. Process-local and advisory: ``take``
returning None means the source creates the segment as before.
"""

from __future__ import annotations

from typing import Optional

from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.transport import shared_memory as shm

logger = get_logger("torchstore_tpu_torch.provision.pool")

class LocalSegmentPool:
    def __init__(self) -> None:
        self._by_size: dict[int, list[shm.ShmSegment]] = {}

    @property
    def pooled_bytes(self) -> int:
        return sum(size * len(segs) for size, segs in self._by_size.items())

    def provision(self, sizes: dict[int, int]) -> dict:
        """Create and pre-fault ``{size: count}`` segments, counting those
        already pooled against the want. At most half of what /dev/shm has
        free (less a margin) is taken: writing past a full tmpfs is a
        SIGBUS, and two trainers may prewarm on one host at once; what does
        not fit is reported as ``clamped_bytes`` and created at
        ``register``. Synchronous: call it from an executor thread."""
        if not shm.is_available():
            return {"created": 0, "bytes": 0, "clamped_bytes": 0, "error": "shm unavailable"}
        budget = max(0, (shm.shm_available_bytes() - shm.PROVISION_MARGIN_BYTES) // 2)
        created = created_bytes = clamped_bytes = 0
        for size, count in sorted(sizes.items(), reverse=True):
            size = max(int(size), 1)
            want = max(0, int(count) - len(self._by_size.get(size, ())))
            fits = min(want, budget // size)
            budget -= fits * size
            clamped_bytes += (want - fits) * size
            for _ in range(fits):
                self._by_size.setdefault(size, []).append(shm.ShmSegment.create_provisioned(size))
                created += 1
                created_bytes += size
        if clamped_bytes:
            logger.info("local staging prewarm clamped %d bytes to /dev/shm headroom",
                        clamped_bytes)
        return {"created": created, "bytes": created_bytes, "clamped_bytes": clamped_bytes}

    def take(self, size: int) -> Optional[shm.ShmSegment]:
        segs = self._by_size.get(max(int(size), 1))
        return segs.pop() if segs else None

    def clear(self) -> None:
        for segs in self._by_size.values():
            for seg in segs:
                seg.unlink()
        self._by_size.clear()


_pool: Optional[LocalSegmentPool] = None


def local_pool() -> LocalSegmentPool:
    """The process's pool, made on first use."""
    global _pool
    if _pool is None:
        _pool = LocalSegmentPool()
    return _pool
