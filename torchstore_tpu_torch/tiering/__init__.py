"""Version retention and the disk tier.

Port of ``torchstore_tpu/tiering/__init__.py``. RL fleets read mixed
versions of one channel: rollout generators on v_t, evaluation on
v_{t-k}, replay on older ones. This package holds the two pieces that
serve them:

- cohort retention leases (``leases.py``): a controller-side registry of
  TTL'd pins on ``(channel, version)``. The publisher's GC and partial
  reclaim skip pinned versions, the controller's ``notify_delete_batch``
  refuses to de-index their keys whoever asks, and
  ``WeightSubscriber.acquire(version=)`` holds one for the read;
- the spill tier (``spill.py``): each volume demotes cold, unpinned
  version groups to disk under a watermark policy (crash-safe writes
  through ``storage_utils/file_store.py``), and a get of a spilled key
  faults it back in inside the volume's ordinary get.

Tier states and the version inventory (``version_catalog``) live in the
controller's index; a tier flip is metadata only.
"""

from __future__ import annotations

import re
from typing import Optional

# Tier states of one replica in the controller's index
# (``StorageInfo.tier``), as ``version_catalog`` reports them.
RESIDENT = "resident"
TIERED = "spilled"

# A channel version's keys are "{channel}/v{n}/{leaf...}", its commit marker
# included; the group "{channel}/v{n}" is the unit of spill and of leases.
_VERSION_SEG = re.compile(r"^v(\d+)$")


def version_group(key: str) -> Optional[tuple[str, int]]:
    """``(channel, version)`` of a channel-version key, else None. The first
    ``v<digits>`` segment after the first wins (a channel may hold slashes,
    a version never does)."""
    segs = key.split("/")
    for i in range(1, len(segs)):
        m = _VERSION_SEG.match(segs[i])
        if m is not None:
            return "/".join(segs[:i]), int(m.group(1))
    return None


def group_key(channel: str, version: int) -> str:
    return f"{channel}/v{int(version)}"


from torchstore_tpu_torch.tiering.leases import Lease, LeaseRegistry  # noqa: E402

__all__ = ["Lease", "LeaseRegistry", "RESIDENT", "TIERED", "group_key", "version_group"]
