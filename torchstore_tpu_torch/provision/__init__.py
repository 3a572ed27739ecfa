"""Cold-start provisioning: the prewarm of pools, connections and plans.

Port of ``torchstore_tpu/provision/``. A store's steady state is fast
(segment-reusing handshakes, promoted bulk connections, cached plans), but
the first sync of a working set pays every layer's lazy setup on its
critical path: tmpfs segments created and faulted, TCP dials, plans built,
the device engine started. This package provisions it ahead, from a
``StateDictManifest`` (keys, shapes, dtypes, request sizes, total bytes)
read off a live state dict's metadata or built by hand:

    manifest     the working set without its bytes (manifest.py)
    planner      manifest + fleet -> per-volume segment and dial plan
                 (planner.py, pure arithmetic)
    reservation  the controller's tmpfs grants, so concurrent prewarms
                 cannot oversubscribe /dev/shm (controller.py)
    executors    the volumes' pools pre-sized (huge pages, native
                 prefault), bulk pre-dials, the device engine, the
                 client-local direct staging (executors.py, pool.py)
    api          ``prewarm(...)``, ``WeightPublisher.register`` and the
                 automatic hint in ``put_state_dict``

Advisory: a stage that fails is logged, counted in
``ts_prewarm_errors_total`` and reported, and the sync takes the lazy path.
"""

from torchstore_tpu_torch.provision.executors import (
    as_manifest,
    maybe_auto_prewarm,
    prewarm_manifest,
)
from torchstore_tpu_torch.provision.manifest import ManifestEntry, StateDictManifest
from torchstore_tpu_torch.provision.planner import (
    ProvisionPlan,
    VolumePlan,
    clamp_to_grant,
    expected_bulk_conns,
    plan_provisioning,
)
from torchstore_tpu_torch.provision.pool import LocalSegmentPool, local_pool

__all__ = [
    "LocalSegmentPool",
    "ManifestEntry",
    "ProvisionPlan",
    "StateDictManifest",
    "VolumePlan",
    "as_manifest",
    "clamp_to_grant",
    "expected_bulk_conns",
    "local_pool",
    "maybe_auto_prewarm",
    "plan_provisioning",
    "prewarm_manifest",
]
