"""Cohort retention leases: TTL'd pins on (channel, version) pairs.

Port of ``torchstore_tpu/tiering/leases.py``. The registry lives in the
controller (one per store) and decides which versions are retained: the
publisher's GC asks it before deleting, ``notify_delete_batch`` enforces it
against any delete, and each volume's spill pass receives the pinned
groups so a leased version is never demoted.

Leases have TTLs (a crashed cohort cannot pin capacity forever) and an
owner each (the cohort id): one owner renewing keeps its pin; a (channel,
version) pinned by several owners stays retained until the last lease goes.
Expiry is lazy, run by every operation, so the guarantee holds without
the background sweeper.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from torchstore_tpu_torch.config import ENV_LEASE_TTL_S, _env_float
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability import recorder as obs_recorder

logger = get_logger("torchstore_tpu_torch.tiering.leases")

_ACTIVE = obs_metrics.gauge("ts_leases_active", "Live cohort retention leases in this controller")


def default_ttl_s() -> float:
    return _env_float(ENV_LEASE_TTL_S, 30.0)


@dataclass
class Lease:
    """One owner's pin on one (channel, version)."""

    lease_id: str
    cohort: str
    channel: str
    version: int
    ttl_s: float
    expires_at: float  # monotonic
    created_ts: float  # wall clock, for the catalog

    def describe(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        return {
            "lease_id": self.lease_id,
            "cohort": self.cohort,
            "channel": self.channel,
            "version": self.version,
            "ttl_s": self.ttl_s,
            "expires_in_s": round(max(0.0, self.expires_at - now), 3),
            "created_ts": self.created_ts,
        }


class LeaseRegistry:
    """A bounded table of TTL'd leases. It lives on the controller's event
    loop and every method is synchronous, so it takes no lock."""

    MAX_LEASES = 4096

    def __init__(self, ttl_s: Optional[float] = None) -> None:
        self.default_ttl_s = default_ttl_s() if ttl_s is None else float(ttl_s)
        self._leases: dict[str, Lease] = {}
        self._counter = 0

    def __len__(self) -> int:
        return len(self._leases)

    def _publish(self) -> None:
        _ACTIVE.set(len(self._leases))

    def acquire(self, cohort: str, channel: str, version: int,
                ttl_s: Optional[float] = None) -> dict:
        """Pin (channel, version) for ``cohort``; returns the lease's
        description (its ``lease_id`` renews and releases it). The same
        owner pinning the same version again renews its lease rather than
        stacking another: TTL and expiry only grow, and the reply says
        ``renewed: True`` so a read-scoped caller does not release a pin it
        merely refreshed."""
        if not cohort or not channel:
            raise ValueError("lease_acquire requires cohort and channel")
        self.expire()
        ttl = self.default_ttl_s if ttl_s is None else float(ttl_s)
        if ttl <= 0:
            raise ValueError("lease ttl_s must be positive")
        now = time.monotonic()
        version = int(version)
        for lease in self._leases.values():
            if (lease.cohort, lease.channel, lease.version) == (cohort, channel, version):
                lease.ttl_s = max(lease.ttl_s, ttl)
                lease.expires_at = max(lease.expires_at, now + ttl)
                return {**lease.describe(now), "renewed": True}
        if len(self._leases) >= self.MAX_LEASES:
            raise RuntimeError(
                f"lease table full ({self.MAX_LEASES}); release or let TTLs expire before "
                "pinning more versions"
            )
        self._counter += 1
        lease = Lease(
            lease_id=f"{cohort}:{channel}:v{version}:{self._counter}",
            cohort=cohort, channel=channel, version=version, ttl_s=ttl,
            expires_at=now + ttl, created_ts=time.time(),
        )
        self._leases[lease.lease_id] = lease
        self._publish()
        obs_recorder.record("tier", "lease_acquire", cohort=cohort, channel=channel,
                            version=version, ttl_s=ttl)
        return {**lease.describe(now), "renewed": False}

    def renew(self, lease_id: str, ttl_s: Optional[float] = None) -> dict:
        """Extend a live lease; ``KeyError`` when it is unknown or expired:
        the caller re-acquires (and checks the version still exists)."""
        self.expire()
        lease = self._leases.get(lease_id)
        if lease is None:
            raise KeyError(f"lease {lease_id!r} is unknown or expired; re-acquire")
        ttl = lease.ttl_s if ttl_s is None else float(ttl_s)
        if ttl <= 0:
            raise ValueError("lease ttl_s must be positive")
        lease.ttl_s = ttl
        lease.expires_at = time.monotonic() + ttl
        return lease.describe()

    def release(self, lease_id: str) -> bool:
        """Drop one lease; idempotent (False when it is already gone)."""
        lease = self._leases.pop(lease_id, None)
        self._publish()
        if lease is not None:
            obs_recorder.record("tier", "lease_release", cohort=lease.cohort,
                                channel=lease.channel, version=lease.version)
        return lease is not None

    def expire(self, now: Optional[float] = None) -> list[Lease]:
        """Drop every lease past its TTL; returns them."""
        now = time.monotonic() if now is None else now
        dead = [lid for lid, lease in self._leases.items() if lease.expires_at <= now]
        dropped = [self._leases.pop(lid) for lid in dead]
        if dropped:
            self._publish()
            for lease in dropped:
                obs_recorder.record("tier", "lease_expired", cohort=lease.cohort,
                                    channel=lease.channel, version=lease.version)
                logger.warning("lease %s expired (cohort %s no longer pins %s/v%d)",
                               lease.lease_id, lease.cohort, lease.channel, lease.version)
        return dropped

    # ---- queries ---------------------------------------------------------

    def pins(self, channel: Optional[str] = None) -> dict[str, dict[int, list[str]]]:
        """{channel: {version: [cohort, ...]}} over the live leases."""
        self.expire()
        out: dict[str, dict[int, list[str]]] = {}
        for lease in self._leases.values():
            if channel is not None and lease.channel != channel:
                continue
            out.setdefault(lease.channel, {}).setdefault(lease.version, []).append(lease.cohort)
        return out

    def pinned_groups(self) -> set[str]:
        """The "channel/vN" groups of every live pin: what each volume's
        spill pass exempts."""
        from torchstore_tpu_torch.tiering import group_key

        self.expire()
        return {group_key(lease.channel, lease.version) for lease in self._leases.values()}

    def is_pinned(self, channel: str, version: int) -> bool:
        self.expire()
        return any(lease.channel == channel and lease.version == int(version)
                   for lease in self._leases.values())

    def blocks_delete(self, key: str) -> bool:
        """Whether deleting ``key`` would reap a leased version's data."""
        from torchstore_tpu_torch.tiering import version_group

        group = version_group(key)
        return group is not None and self.is_pinned(*group)

    def describe(self) -> list[dict]:
        self.expire()
        now = time.monotonic()
        return [lease.describe(now) for lease in self._leases.values()]

    def clear(self) -> None:
        self._leases.clear()
        self._publish()
