"""Capacity planner: manifest and fleet -> per-volume provisioning.

Port of ``torchstore_tpu/provision/planner.py``; pure arithmetic, no IO.
From a ``StateDictManifest``, the volumes a put from this client lands on
(primary and replicas, as the strategy picks them) and each volume's
transport rung, it builds the ``ProvisionPlan`` the executors drive:

- per volume: the ``{segment size: count}`` pool the shared-memory put
  handshake will ask for, the bytes that makes, and the bulk connections
  to dial ahead (the main one, or the stripe set when a payload is above
  the striping threshold);
- clamping: a capacity grant smaller than the ask keeps the largest
  segments first (the costliest cold allocations of a first sync).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from torchstore_tpu_torch.provision.manifest import StateDictManifest


@dataclass
class VolumePlan:
    """What one volume is provisioned with before the first sync."""

    volume_id: str
    transport: str  # "shm" | "bulk" | "rpc"
    # {segment size: count} to create into the volume's free pool (the
    # shared-memory rung only).
    segment_sizes: dict[int, int] = field(default_factory=dict)
    # Bulk connections to dial ahead: 0 off the bulk rung.
    dials: int = 0
    # Bytes the segment plan lost to a capacity grant.
    clamped_bytes: int = 0

    @property
    def planned_bytes(self) -> int:
        return sum(size * count for size, count in self.segment_sizes.items())


@dataclass
class ProvisionPlan:
    volumes: dict[str, VolumePlan] = field(default_factory=dict)
    # The manifest's total; the volumes' asks sum to a multiple of it under
    # replication.
    manifest_bytes: int = 0
    replicas: int = 1
    device_server: bool = False  # make the device engine ready too

    @property
    def planned_bytes(self) -> int:
        return sum(p.planned_bytes for p in self.volumes.values())

    @property
    def clamped_bytes(self) -> int:
        return sum(p.clamped_bytes for p in self.volumes.values())


def expected_bulk_conns(manifest: StateDictManifest) -> int:
    """Connections one bulk volume needs for this working set: the main
    one, or the stripe set when any payload will be striped."""
    from torchstore_tpu_torch.transport import bulk

    if manifest.max_request_nbytes() > bulk.STRIPE_THRESHOLD:
        return bulk.STRIPE_CONNS
    return 1


def plan_provisioning(
    manifest: StateDictManifest,
    put_volume_ids: list[str],
    transports: dict[str, str],
    ici_available: bool = False,
    arena_max_bytes: int = 0,
) -> ProvisionPlan:
    """Every volume a put lands on gets the manifest's whole segment plan on
    the shared-memory rung, a dial plan on the bulk rung, and nothing on
    the RPC rung (payloads ride the codec). ``arena_max_bytes`` packs the
    small requests as the transport's arena does, so the pool holds what
    the first put's handshake asks for."""
    sizes = manifest.segment_sizes(arena_max_bytes)
    plan = ProvisionPlan(
        manifest_bytes=manifest.total_bytes,
        replicas=max(1, len(put_volume_ids)),
        device_server=bool(ici_available and manifest.device_resident),
    )
    for vid in put_volume_ids:
        transport = transports.get(vid, "rpc")
        vp = VolumePlan(volume_id=vid, transport=transport)
        if transport == "shm":
            vp.segment_sizes = dict(sizes)
        elif transport == "bulk":
            vp.dials = expected_bulk_conns(manifest)
        plan.volumes[vid] = vp
    return plan


def clamp_to_grant(vp: VolumePlan, granted_bytes: Optional[int]) -> VolumePlan:
    """Shrink a volume's segment plan to a capacity grant (None: no clamp;
    0 drops the plan), spending the budget on the largest segments first.
    Mutates and returns ``vp``."""
    if granted_bytes is None or vp.transport != "shm":
        return vp
    budget = max(0, int(granted_bytes))
    kept: dict[int, int] = {}
    clamped = 0
    for size in sorted(vp.segment_sizes, reverse=True):
        want = vp.segment_sizes[size]
        fit = min(want, budget // size) if size > 0 else want
        if fit:
            kept[size] = fit
            budget -= size * fit
        clamped += (want - fit) * size
    vp.segment_sizes = kept
    vp.clamped_bytes = clamped
    return vp
