"""Per-volume spill tier: demote cold versions from memory to disk.

Port of ``torchstore_tpu/tiering/spill.py``. One ``SpillTier`` lives in each
``StorageVolume`` when ``TORCHSTORE_TORCH_TIER_ENABLED`` is set. It owns:

- a crash-safe disk store (``storage_utils/file_store.FileBackedStore``
  under ``TORCHSTORE_TORCH_TIER_DIR/<volume_id>``: every persist is
  write-temp, fsync, rename, so a volume killed mid-spill never leaves a
  torn file the fault-in would trust);
- the watermark policy: when the volume's resident bytes exceed
  ``TIER_HIGH_PCT`` of the budget, whole version groups (``{channel}/v{n}``)
  are demoted, least recently used first, until resident bytes are at or
  under ``TIER_LOW_PCT``; leased groups are exempt, and so are keys outside
  any version group (pointers, ad-hoc keys);
- the ``spilled`` bookkeeping the volume's get consults (one dict lookup
  when nothing is spilled).

The mechanics (dropping the memory copy, landing a fault-in, resident-byte
accounting, fault points) stay in ``storage_volume.py``; this module is the
policy and the disk.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Iterable, Optional

from torchstore_tpu_torch.config import (
    ENV_TIER_BUDGET_BYTES,
    ENV_TIER_DIR,
    ENV_TIER_ENABLED,
    ENV_TIER_HIGH_PCT,
    ENV_TIER_LOW_PCT,
    _env_bool,
    _env_float,
    _env_int,
    default_config,
)
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability import recorder as obs_recorder
from torchstore_tpu_torch.tiering import group_key, version_group
from torchstore_tpu_torch.transport.types import Request

_SPILLS = obs_metrics.counter("ts_spills_total", "Entries demoted from the memory tier to disk")
_FAULT_INS = obs_metrics.counter(
    "ts_fault_ins_total", "Spilled entries faulted back into the memory tier, by reason"
)
_TIER_RESIDENT = obs_metrics.gauge(
    "ts_tier_resident_bytes", "Bytes resident in this volume's memory tier"
)
_TIER_SPILLED = obs_metrics.gauge(
    "ts_tier_spilled_bytes", "Bytes demoted to this volume's disk spill tier"
)


def enabled() -> bool:
    return _env_bool(ENV_TIER_ENABLED, False)


class SpillTier:
    """Policy and disk half of one volume's spill tier (module doc); its
    directory, budget and watermarks come from the environment
    (``config.ENV_TIER_*``)."""

    def __init__(self, volume_id: str) -> None:
        from torchstore_tpu_torch.storage_utils.file_store import FileBackedStore

        root = os.environ.get(ENV_TIER_DIR) or os.path.join(tempfile.gettempdir(),
                                                            "torchstore_torch_tier")
        budget_bytes = _env_int(ENV_TIER_BUDGET_BYTES, default_config().shm_pool_max_bytes)
        high_pct = _env_float(ENV_TIER_HIGH_PCT, 0.85)
        low_pct = _env_float(ENV_TIER_LOW_PCT, 0.65)
        if not 0.0 < low_pct <= high_pct:
            raise ValueError(
                f"tier watermarks must satisfy 0 < low <= high (got low={low_pct}, "
                f"high={high_pct})"
            )
        self.volume_id = str(volume_id)
        self.budget_bytes = max(1, int(budget_bytes))
        self.high_pct = high_pct
        self.low_pct = low_pct
        self.disk = FileBackedStore(os.path.join(root, self.volume_id))
        # key -> spilled bytes: the one structure a get consults. Seeded from
        # what the directory holds: a restarted volume serves its spilled set.
        self.spilled: dict[str, int] = {key: self._nbytes(entry)
                                        for key, entry in self.disk.kv.items()}
        # Version group -> last access (monotonic): the LRU clock.
        self.access: dict[str, float] = {}
        # Fault-ins since the last sweep drained them (the controller flips
        # their index tier back to resident).
        self._faulted: list[str] = []
        # Seconds and bytes of every spill and fault-in, for ``stats``.
        self.counts = {"spills": 0, "spill_bytes": 0, "spill_s": 0.0,
                       "fault_ins": 0, "fault_in_bytes": 0, "fault_in_s": 0.0}
        self.publish_gauges(resident_bytes=0)

    @staticmethod
    def _nbytes(entry: Any) -> int:
        from torchstore_tpu_torch.storage_volume import entry_nbytes

        return entry_nbytes(entry)

    @property
    def spilled_bytes(self) -> int:
        return sum(self.spilled.values())

    @property
    def high_bytes(self) -> int:
        return int(self.budget_bytes * self.high_pct)

    @property
    def low_bytes(self) -> int:
        return int(self.budget_bytes * self.low_pct)

    def publish_gauges(self, resident_bytes: int) -> None:
        _TIER_RESIDENT.set(resident_bytes, volume=self.volume_id)
        _TIER_SPILLED.set(self.spilled_bytes, volume=self.volume_id)

    def touch(self, keys: Iterable[str]) -> None:
        """Refresh the LRU clock of the version group of each key (every
        put and get batch). A cohort that wants its version kept holds a
        lease; recency only orders the unpinned versions."""
        now = time.monotonic()
        for key in keys:
            group = version_group(key)
            if group is not None:
                self.access[group_key(*group)] = now

    def drain_faulted(self) -> list[str]:
        out, self._faulted = self._faulted, []
        return out

    # ---- policy ----------------------------------------------------------

    def cold_groups(self, kv: dict, pins: Iterable[str]) -> list[tuple[str, list[str]]]:
        """The version groups that may be demoted, coldest first:
        ``[(group, [keys...]), ...]``. Pinned groups and keys outside any
        version group never appear."""
        pinned = set(pins or ())
        groups: dict[str, list[str]] = {}
        for key in kv:
            vg = version_group(key)
            if vg is None:
                continue
            group = group_key(*vg)
            if group not in pinned:
                groups.setdefault(group, []).append(key)
        return sorted(groups.items(), key=lambda item: self.access.get(item[0], 0.0))

    # ---- disk half -------------------------------------------------------

    def write(self, key: str, entry: Any) -> int:
        """Persist one resident entry to disk (crash-safe); returns its
        bytes. Runs on a landing-pool thread, under the volume's tier lock;
        ``spilled_in`` records it once the caller has checked, on its event
        loop, that the entry was not replaced meanwhile. A failure leaves
        the entry resident and served."""
        from torchstore_tpu_torch.storage_utils.file_store import entry_requests

        metas, values = entry_requests(key, entry)
        self.disk.store(metas, values)
        return self._nbytes(self.disk.kv.get(key))

    def spilled_in(self, key: str, nbytes: int, seconds: float) -> None:
        """Bookkeeping once ``write``'s copy is the key's: the next get of
        ``key`` faults it back in."""
        self.spilled[key] = nbytes
        self.counts["spills"] += 1
        self.counts["spill_bytes"] += nbytes
        self.counts["spill_s"] += seconds
        _SPILLS.inc(volume=self.volume_id)
        obs_recorder.record("tier", "spill", key=key, nbytes=nbytes, volume=self.volume_id)

    def load(self, key: str) -> tuple[list[Request], dict[int, Any]]:
        """(metas, file-mapped values) of a spilled entry, to land back in
        memory; ``KeyError`` when it is not spilled (a concurrent fault-in
        promoted it)."""
        from torchstore_tpu_torch.storage_utils.file_store import entry_requests

        return entry_requests(key, self.disk.kv[key])

    def faulted_in(self, key: str, reason: str, seconds: float) -> None:
        """Bookkeeping once the volume landed ``key`` again: the disk copy
        goes, and the promotion is counted."""
        nbytes = self.spilled.pop(key, 0)
        self.disk.delete(key)
        self._faulted.append(key)
        self.counts["fault_ins"] += 1
        self.counts["fault_in_bytes"] += nbytes
        self.counts["fault_in_s"] += seconds
        _FAULT_INS.inc(reason=reason)
        obs_recorder.record("tier", "fault_in", key=key, nbytes=nbytes, volume=self.volume_id,
                            reason=reason)

    def discard(self, key: str) -> bool:
        """Forget a stale disk copy (the key was written or deleted in
        memory); idempotent. True when one was spilled: the volume then
        deletes its files (``disk.delete``) under its tier lock, in the
        order of its memory changes."""
        return self.spilled.pop(key, None) is not None

    def manifest(self, exclude: Optional[set] = None) -> list[dict]:
        """The spilled entries' manifest: their bytes live only here, so an
        index rebuild must see them."""
        return self.disk.manifest(exclude)

    def stats(self) -> dict:
        return {**self.counts, "spilled_keys": len(self.spilled),
                "spilled_bytes": self.spilled_bytes, "budget_bytes": self.budget_bytes,
                "high_bytes": self.high_bytes, "low_bytes": self.low_bytes,
                "dir": self.disk.root}

    def reset(self) -> None:
        self.spilled.clear()
        self.access.clear()
        self._faulted.clear()
        self.disk.reset()
        self.publish_gauges(resident_bytes=0)
