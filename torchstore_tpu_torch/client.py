"""The per-process store client.

Port of ``torchstore_tpu/client.py``: a put lands the payloads on the
strategy's volume through the chosen transport, then indexes them at the
controller; a get locates the keys, fetches from the volumes, and lands
each tensor in the caller's target when one is given (CPU or CUDA, filled
in place) or returns a fresh tensor (a zero-copy view on the shared-memory
rung). A CUDA payload is staged to the host by the transport (straight into
the shared segment on the shared-memory rung).

Sharded values: a ``Shard`` (data plus its ``TensorSlice``) or a DTensor's
local shard is put under its mesh coordinates; a key commits once every
coordinate is stored. A get with a ``Shard``, ``TensorSlice`` or DTensor
target intersects the wanted region with every stored shard, fetches each
distinct intersection once (replicated shards hold identical ones) and
lands it straight into the target's view: for a CUDA target one
host-to-device copy per intersection, with no assembly on the host. A
DTensor target's local tensor is filled in place.

A put lands on every volume the strategy names (``replication``) and one
notify indexes them all, detaching a replica whose landing failed. Located
keys are cached (bounded) until the placement epoch moves: a get that
finds any of its keys cached reads the epoch first (one RPC; a caller that
has just read it, as a plan-cached ``get_state_dict`` has, skips it), and
a fetch that finds a location stale, or a replica's volume dead, relocates
once. ``SyncPlanCache`` holds the transfer plans of ``put_state_dict`` /
``get_state_dict``; an epoch move drops them with the cached locations.

Transient failures (``RETRYABLE_ERRORS``: a dead or wedged actor, a broken
socket, an injected fault) are retried under ``config.retry``: a put whose
every replica failed is landed again (re-routed onto healthy spares), a
single-volume put walks down the transport ladder one rung per attempt (shm
-> bulk -> rpc) unless its volume was diagnosed dead, then fails over to a
healthy volume, and a get relocates and fetches again from the replicas
not seen failing. A volume RPC that fails asks the controller's
``check_volumes`` (at most once per ``DIAGNOSIS_WINDOW_S``) and raises
``ActorDiedError`` naming its verdict; volumes it reports not ok are marked
dead (a get tries them last, a put substitutes a healthy spare for them,
and this client's attachments to a dead process's segments are dropped),
and one it reports ok under a new ref was replaced by ``repair``: the
volume map is reloaded and the retry reaches the replacement. After a
placement-epoch move the next put re-reads the volumes' health and routes
around quarantined ones. A volume on
another host (its ``hostname`` is not this process's) is reached over the
bulk TCP rung; the client's ``BulkClientCache`` keeps one promoted
connection per volume and the stripe connections of large transfers. ``put_batch`` / ``get_batch``
root a trace (``ensure_root``) under their spans. Cohort leases, the
version catalog and the spill pass are the controller's, reached through
``lease_acquire`` / ``lease_renew`` / ``lease_release`` / ``lease_list``,
``version_catalog`` and ``tier_sweep``. The one-sided planes are later
work.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Optional

import torch

from torchstore_tpu_torch import sharding
from torchstore_tpu_torch.config import StoreConfig, default_config
from torchstore_tpu_torch.faults import FaultInjectedError
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import context as obs_context
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability.tracing import span
from torchstore_tpu_torch.metadata.index_core import ObjectType, StorageInfo
from torchstore_tpu_torch.runtime import ActorDiedError, ActorRef, ActorTimeoutError
from torchstore_tpu_torch.strategy import StorageVolumeRef
from torchstore_tpu_torch.transport.buffers import TransportContext
from torchstore_tpu_torch.transport.bulk import BulkClientCache
from torchstore_tpu_torch.transport.factory import (
    TransportType,
    create_transport_buffer,
    demotion_ladder,
)
from torchstore_tpu_torch.transport.shared_memory import ShmClientCache
from torchstore_tpu_torch.transport.types import OpaqueBlob, Request, TensorSlice
from torchstore_tpu_torch.utils import (
    Box,
    assemble_tensor,
    get_destination_view,
    intersect_boxes,
)

logger = get_logger("torchstore_tpu_torch.client")

_PLAN_HITS = obs_metrics.counter(
    "ts_plan_cache_hits_total",
    "put/get_state_dict iterations served by a cached transfer plan, by op",
)
_PLAN_MISSES = obs_metrics.counter(
    "ts_plan_cache_misses_total",
    "put/get_state_dict iterations that (re)built their transfer plan, by op",
)
_PLAN_INVALIDATIONS = obs_metrics.counter(
    "ts_plan_cache_invalidations_total",
    "Cached transfer plans dropped, by reason (epoch/capacity)",
)
_FETCH_RETRIES = obs_metrics.counter(
    "ts_client_fetch_retries_total", "Batch fetches retried after a stale-location/ref failure"
)
_PUT_RETRIES = obs_metrics.counter(
    "ts_client_put_retries_total",
    "Non-replicated put landings retried under the unified RetryPolicy, "
    "by the transport rung the retry used",
)
_FAILOVERS = obs_metrics.counter(
    "ts_client_failovers_total",
    "Operations that succeeded only after failing over (get replica "
    "re-route or put transport demotion), by op",
)

# The one family of transient failures every retry and failover keys on:
# dead or wedged actors (ActorTimeoutError is an ActorDiedError), broken
# sockets and injected faults. Anything else (a missing key, a shape
# mismatch) is an answer and surfaces at once.
RETRYABLE_ERRORS = (ActorDiedError, ConnectionError, OSError, FaultInjectedError)
# A volume's failure asks the controller for a fleet diagnosis at most once
# per this many seconds; later failures in the window reuse its verdicts.
DIAGNOSIS_WINDOW_S = 2.0
# Seconds the controller's pings and the diagnosis RPC itself may take.
DIAGNOSIS_PING_S = 5.0
DIAGNOSIS_RPC_S = 15.0


class SyncPlanCache:
    """Iteration-stable transfer plans for ``put_state_dict`` /
    ``get_state_dict``. An RL loop syncs the same signature every step;
    a plan keyed by (op, state-dict key, signature) and stamped with the
    controller's placement epoch lets a warm step skip the commit marker,
    the structure checks and the locate: one epoch read validates it. The
    epoch moves only on structural changes (new, changed or deleted keys,
    detached replicas), never on a same-layout overwrite; a move drops
    every plan (and the client drops its cached locations with them)."""

    MAX_ENTRIES = 64

    def __init__(self) -> None:
        self.entries: dict[tuple, dict] = {}
        self.epoch: Optional[int] = None  # last adopted placement epoch
        # key -> signature of this client's last put_state_dict of it: a
        # changed signature is a restructure the index cannot always see
        # (a republish that drops keys deletes nothing), so the publisher
        # bumps the epoch itself.
        self.last_put_sig: dict[str, tuple] = {}

    def observe_epoch(self, epoch: Optional[int]) -> bool:
        """Adopt a placement epoch; True when it moved (plans dropped)."""
        if epoch is None or epoch == self.epoch:
            return False
        moved = self.epoch is not None
        self.epoch = epoch
        if moved and self.entries:
            _PLAN_INVALIDATIONS.inc(len(self.entries), reason="epoch")
            self.entries.clear()
        return moved

    def lookup(self, op: str, key: str, signature: tuple) -> Optional[dict]:
        entry = self.entries.get((op, key, signature))
        if entry is not None and entry.get("epoch") == self.epoch:
            _PLAN_HITS.inc(op=op)
            return entry
        _PLAN_MISSES.inc(op=op)
        return None

    def peek(self, op: str, key: str, signature: tuple) -> Optional[dict]:
        """``lookup`` without counting: whether an epoch read is worth it."""
        return self.entries.get((op, key, signature))

    def store(
        self, op: str, key: str, signature: tuple, plan: dict, epoch: Optional[int] = None
    ) -> None:
        """``epoch``: the epoch the plan was built under, read before the
        data it describes was fetched (a later one would let a structural
        change in between validate the plan forever)."""
        if len(self.entries) >= self.MAX_ENTRIES:
            _PLAN_INVALIDATIONS.inc(len(self.entries), reason="capacity")
            self.entries.clear()
        plan["epoch"] = self.epoch if epoch is None else epoch
        self.entries[(op, key, signature)] = plan


def _same_ref(a: ActorRef, b: ActorRef) -> bool:
    """Refs compare by the actor they reach (pickled copies are not equal)."""
    return (a.host, a.port, a.name) == (b.host, b.port, b.name)


@dataclass
class Shard:
    """An explicit shard for put and get: its data (a CPU or CUDA tensor of
    ``tensor_slice.local_shape``; None for a get that returns a fresh
    tensor) and its place in the global tensor and the mesh."""

    data: Optional[torch.Tensor]
    tensor_slice: TensorSlice


@dataclass
class _Want:
    """One key of a get: the wanted region (None: the whole stored value),
    the in-place destination covering ``dest_box`` of the global tensor,
    and what the get returns once the destination is filled."""

    key: str
    wanted: Optional[TensorSlice] = None
    dest: Optional[torch.Tensor] = None
    dest_box: Optional[Box] = None
    result: Any = None


class LocalClient:
    # Bound on the location cache; overflow clears it (a warm working set
    # refills in one locate).
    LOC_CACHE_MAX = 65536

    def __init__(self, controller: ActorRef, config: Optional[StoreConfig] = None) -> None:
        self._controller = controller
        self._config = config or default_config()
        self._strategy = None
        self._volume_refs: Optional[dict[str, StorageVolumeRef]] = None
        self._ctx = TransportContext()
        self._loc_cache: dict[str, dict[str, StorageInfo]] = {}
        self._seen_epoch: Optional[int] = None
        self.plan_cache: Optional[SyncPlanCache] = (
            SyncPlanCache() if self._config.plan_cache else None
        )
        # Tensor parts fetched from volumes: one per whole tensor, one per
        # distinct intersection of a wanted region with a stored shard.
        self.parts_fetched = 0
        self.epoch_reads = 0  # placement-epoch RPCs this client made
        # Volumes the controller's diagnosis reported not ok (dead, wedged
        # or quarantined): gets try them last, puts replace them with a
        # healthy spare; forgiven by a later diagnosis that reports them ok.
        self._dead_volumes: set[str] = set()
        # The last diagnosis (monotonic time, verdict per volume): the retry
        # loops of a correlated outage reuse it within the window.
        self._diag_at = 0.0
        self._diag_statuses: dict[str, str] = {}
        self.diagnoses = 0  # diagnosis fan-outs this client asked for
        self.last_diagnosis: Optional[str] = None  # the verdict the last failure met
        # Volumes the supervisor quarantined, re-read after an epoch move.
        self._avoid_volumes: set[str] = set()
        self._volumes_stale = False
        # Bumped whenever the volume map was reloaded for stale refs.
        self._refresh_epoch = 0

    @property
    def config(self) -> StoreConfig:
        return self._config

    async def _ensure_setup(self) -> None:
        if self._volume_refs is None:
            await self._load_volumes()

    async def _load_volumes(self) -> None:
        """(Re)read the strategy and the volume map; the swap at the end is
        one assignment, so a concurrent operation keeps the previous map."""
        self._controller.rpc_timeout = self._config.rpc_timeout
        strategy = await self._controller.get_strategy.call_one()
        vmap = await self._controller.get_volume_map.call_one()
        forced = strategy.default_transport_type if strategy else None
        refs = {}
        for vid, info in vmap.items():
            info["ref"].rpc_timeout = self._config.rpc_timeout
            refs[vid] = StorageVolumeRef(
                actor=info["ref"],
                volume_id=vid,
                transport_context=self._ctx,
                hostname=info["hostname"],
                transport_type=forced,
            )
        self._strategy = strategy
        self._adopt_health(vmap)
        self._volume_refs = refs

    def _adopt_health(self, vmap: dict) -> None:
        """Avoid, in puts, the volumes the supervisor quarantined."""
        self._avoid_volumes = {vid for vid, info in vmap.items()
                               if info.get("health") == "quarantined"}

    @property
    def controller(self) -> ActorRef:
        return self._controller

    def close(self) -> None:
        """Unpin and drop this client's segment attachments, and close its
        bulk connections."""
        self._ctx.clear()

    def shm_stats(self) -> dict:
        """The client half of the segment pool's economics: handshake
        offers taken, segments created cold, attachments page-locked (in
        the background) and the seconds that took, and the seconds puts and
        gets waited for a registration in progress."""
        cache = self._ctx.get_cache(ShmClientCache)
        return {**cache.counts, "pin_seconds": cache.pin_seconds,
                "pin_wait_seconds": cache.pin_wait_seconds,
                "pin_pending": cache.pin_pending()}

    def bulk_stats(self) -> dict:
        """The bulk rung's connections: dials made (main and stripe),
        connections alive, and the seconds of its card path (receive vs
        copy to the card on gets, copy from the card vs send on puts)."""
        return self._ctx.get_cache(BulkClientCache).stats()

    async def wait_pinned(self) -> float:
        """Wait until the attachments queued for page-locking are locked
        (e.g. at a step boundary, so the next sync copies pinned pages);
        returns the seconds waited."""
        return await self._ctx.get_cache(ShmClientCache).wait_pinned()

    def _observe_epoch(self, epoch: int) -> None:
        """Adopt the controller's placement epoch; a move drops the cached
        plans and locations together: both describe the placement that
        changed."""
        if self.plan_cache is not None:
            moved = self.plan_cache.observe_epoch(epoch)
        else:
            moved = self._seen_epoch is not None and epoch != self._seen_epoch
        self._seen_epoch = epoch
        if moved:
            self._loc_cache.clear()
            # Quarantines and reinstatements move the epoch: the next put
            # re-reads the volumes' health before it picks its targets.
            self._volumes_stale = True

    async def _refresh_health(self) -> set[str]:
        """Re-read the controller's volume map (one RPC, after an epoch
        move): quarantined volumes are avoided by puts; a volume added,
        gone or replaced (a new ref under its id) reloads the map. Returns
        the ids whose ref is new to this client."""
        self._volumes_stale = False
        try:
            vmap = await self._controller.get_volume_map.call_one()
        except RETRYABLE_ERRORS:  # a controller hiccup: keep the view we have
            return set()
        self._adopt_health(vmap)
        refs = self._volume_refs or {}
        fresh = {vid for vid, info in vmap.items()
                 if vid not in refs or not _same_ref(info["ref"], refs[vid].actor)}
        if fresh or set(refs) - set(vmap):
            await self._load_volumes()
        return fresh

    async def placement_epoch(self) -> int:
        """Read and adopt the controller's placement epoch: the one RPC
        that validates a cached plan."""
        await self._ensure_setup()
        self.epoch_reads += 1
        epoch = await self._controller.placement_epoch.call_one()
        self._observe_epoch(epoch)
        return epoch

    async def bump_placement_epoch(self) -> int:
        """Invalidate every consumer's cached transfer plans."""
        epoch = await self._controller.bump_placement_epoch.call_one()
        self._observe_epoch(epoch)
        return epoch

    # ------------------------------------------------------------------
    # put
    # ------------------------------------------------------------------

    @staticmethod
    def _value_to_requests(key: str, value: Any) -> list[Request]:
        if isinstance(value, Shard):
            data = None if value.data is None else value.data.detach()
            return [Request.from_tensor_slice(key, value.tensor_slice, data)]
        if sharding.is_dtensor(value):
            return sharding.put_requests(key, value)
        if isinstance(value, torch.Tensor):
            return [Request.from_tensor(key, value.detach())]
        # Objects are pickled here, in the client: volumes carry bytes.
        return [Request.from_objects(key, OpaqueBlob.wrap(value))]

    def _put_volumes(self) -> list[StorageVolumeRef]:
        """Every volume a put writes to: the primary and its replicas, as
        the strategy picks them from all volumes, each quarantined or
        diagnosed-dead one replaced by a healthy volume it did not pick.
        With no healthy spare left the avoided volume stays (a degraded put
        lands where it can and detaches the rest)."""
        selected = list(self._strategy.select_put_volume_ids(
            self._strategy.get_client_id(), list(self._volume_refs)
        ))
        avoid = self._avoid_volumes | self._dead_volumes
        if avoid and any(vid in avoid for vid in selected):
            spares = sorted(vid for vid in self._volume_refs
                            if vid not in avoid and vid not in selected)
            selected = [spares.pop(0) if vid in avoid and spares else vid for vid in selected]
        return [self._volume_refs[vid] for vid in selected]

    async def put(self, key: str, value: Any) -> None:
        await self.put_batch({key: value})

    async def put_batch(
        self,
        items: dict[str, Any],
        watermark: Optional[tuple] = None,
        unchanged: Optional[dict] = None,
    ) -> None:
        """Land every item on each of the strategy's volumes at once, then
        index them all in one notify: a key is visible to readers only once
        its bytes landed (a sharded key once every coordinate has). A
        replica whose landing failed is detached from these keys in the same
        notify; the put fails only when no replica landed.

        ``watermark``: ``(stream_key, version)`` of a layer-streamed
        publish; the notify watermarks every key at ``version`` in the same
        indexing step, so a streaming reader trusts a key only once its
        bytes are committed. ``unchanged``: ``{store_key: (base_store_key,
        base_version)}`` aliases of the same publish, watermarked with it
        (see ``stream_sync``).

        Every replica failing transiently lands the batch again under
        ``config.retry``; a single-volume put retries down the transport
        ladder (``_retry_put_demoted``)."""
        with obs_context.ensure_root(), span(
            "put_batch", keys=len(items), key=next(iter(items), None)
        ) as sp:
            await self._put_batch(items, sp, watermark, unchanged)

    async def _put_batch(self, items: dict[str, Any], sp: span, watermark, unchanged) -> None:
        await self._ensure_setup()
        if self._volumes_stale:
            await self._refresh_health()
        requests = [r for k, v in items.items() for r in self._value_to_requests(k, v)]
        volumes = self._put_volumes()
        sp.set(nbytes=sum(r.nbytes for r in requests), replicas=len(volumes))
        landed, failed = await self._land_all(volumes, requests)
        if (not landed and len(volumes) > 1
                and all(isinstance(r, RETRYABLE_ERRORS) for _, r in failed)):
            # Every replica failed transiently: with no copy landed there is
            # nothing to commit, so land the whole batch again.
            policy = self._config.retry
            deadline = policy.start()
            attempt = 0
            while not landed and policy.should_retry(attempt, deadline):
                await asyncio.sleep(policy.backoff(attempt))
                attempt += 1
                # Placement again: the diagnosis marked the failed replicas
                # dead or the supervisor quarantined them meanwhile, so
                # healthy spares stand in (the supersede notify detaches
                # what the old replicas hold of these keys).
                if self._volumes_stale:
                    await self._refresh_health()
                fresh = self._put_volumes()
                if [v.volume_id for v in fresh] != [v.volume_id for v in volumes]:
                    logger.warning("replicated put re-routed: %s -> %s",
                                   [v.volume_id for v in volumes], [v.volume_id for v in fresh])
                    volumes = fresh
                landed, retry_failed = await self._land_all(volumes, requests)
                if landed:
                    failed = retry_failed
                    _FAILOVERS.inc(op="put")
                    logger.warning("replicated put recovered on retry %d", attempt)
                elif not all(isinstance(r, RETRYABLE_ERRORS) for _, r in retry_failed):
                    failed = retry_failed
                    break  # an answer, not a transient
        if not landed and len(volumes) == 1:
            gens = await self._retry_put_demoted(volumes[0], requests, failed[0][1])
            if gens is not None:
                landed, failed = [(volumes[0], gens)], []
            elif isinstance(failed[0][1], RETRYABLE_ERRORS):
                landed, failed = await self._fail_over_put(volumes[0], requests, failed)
        if not landed:
            raise failed[0][1]
        for volume, exc in failed:
            logger.warning(
                "replicated put degraded: volume %s failed (%r); detaching its copies",
                volume.volume_id, exc,
            )
        epoch = await self._controller.notify_put_batch.call_one(
            [r.meta_only() for r in requests],
            [v.volume_id for v, _ in landed],
            detach_volume_ids=[v.volume_id for v, _ in failed] or None,
            write_gens={v.volume_id: gens for v, gens in landed},
            watermark=watermark,
            unchanged=unchanged,
            # A full overwrite: any other volume still indexed for these
            # metas (an auto-repair copy, a placement before a failover)
            # holds superseded bytes, detached and reclaimed in this step.
            supersede=True,
        )
        self._observe_epoch(epoch)

    async def _fail_over_put(self, volume: StorageVolumeRef, requests: list[Request],
                             failed: list) -> tuple[list, list]:
        """A single-volume put whose volume is gone: land on the next
        healthy volume placement picks now (``_put_volumes`` leaves the
        dead one out); ``(landed, failed)``."""
        if self._volumes_stale:
            await self._refresh_health()
        (retry,) = self._put_volumes()
        if retry.volume_id == volume.volume_id:
            return [], failed
        try:
            gens = await self._land(retry, requests)
        except RETRYABLE_ERRORS as exc:
            logger.warning("put failover to %s failed too: %s", retry.volume_id, exc)
            return [], failed
        _FAILOVERS.inc(op="put")
        logger.warning("put failed over from %s to %s", volume.volume_id, retry.volume_id)
        return [(retry, gens)], []

    async def _land_all(self, volumes: list[StorageVolumeRef], requests: list[Request]):
        """Land on every volume at once; ``(landed, failed)`` lists of
        (volume, write generations or exception). Every landing finishes
        before the caller decides."""
        results = await asyncio.gather(
            *(self._land(volume, requests) for volume in volumes), return_exceptions=True
        )
        landed = [(v, r) for v, r in zip(volumes, results) if not isinstance(r, BaseException)]
        failed = [(v, r) for v, r in zip(volumes, results) if isinstance(r, BaseException)]
        return landed, failed

    async def _land(
        self,
        volume: StorageVolumeRef,
        requests: list[Request],
        transport: Optional[TransportType] = None,
    ) -> dict[str, int]:
        """Put ``requests`` on one volume (over ``transport`` when given);
        returns its write generations."""
        buffer = create_transport_buffer(volume, self._config, force=transport)
        try:
            await buffer.put_to_storage_volume(volume, requests)
        except (ActorDiedError, ConnectionError, OSError) as exc:
            # A dead volume surfaces as a broken socket on some rungs: one
            # family, with the controller's verdict, for callers and retries.
            await self._raise_with_diagnosis(volume.volume_id, exc)
        return buffer.write_gens or {}

    async def _raise_with_diagnosis(self, vid: str, exc: BaseException) -> None:
        """A volume RPC failed: ask the controller to ping the fleet and
        raise ``ActorDiedError`` (``ActorTimeoutError`` for a timeout) with
        its verdict on ``vid``. Volumes it reports not ok are marked dead,
        and this client's attachments to dead processes' segments are
        dropped; a volume it reports ok under a ref other than ours was
        replaced, so the volume map is reloaded for the retry. One fan-out
        per DIAGNOSIS_WINDOW_S: a retry loop in a correlated outage reuses
        the verdicts (a failure the last fan-out did not confirm stays
        retryable)."""
        cls = ActorTimeoutError if isinstance(exc, ActorTimeoutError) else ActorDiedError
        loop = asyncio.get_running_loop()
        now = loop.time()
        if self._diag_at and now - self._diag_at < DIAGNOSIS_WINDOW_S:
            cached = self._diag_statuses.get(vid)
            if cached is not None and cached != "ok":
                self._dead_volumes.add(vid)
            self.last_diagnosis = cached
            raise cls(f"storage volume {vid} RPC failed: {exc} [controller diagnosis (cached): "
                      f"{cached or 'not in the last health check'}]") from exc
        self._diag_at = now
        self.diagnoses += 1
        diagnosis = "controller unreachable"
        try:
            statuses = await self._controller.check_volumes.with_timeout(
                DIAGNOSIS_RPC_S).call_one(timeout=DIAGNOSIS_PING_S)
        except Exception:  # noqa: BLE001 - the diagnosis is best effort
            statuses = None
        if statuses is not None:
            diagnosis = statuses.get(vid, "unknown volume")
            self._diag_statuses = statuses
            self._dead_volumes = {v for v, status in statuses.items() if status != "ok"}
            if any(status.startswith("dead") for status in statuses.values()):
                self._ctx.get_cache(ShmClientCache).forget_dead()
            if diagnosis == "ok" and await self._ref_replaced(vid):
                diagnosis += " (ref was stale; volume map refreshed)"
        self.last_diagnosis = diagnosis
        raise cls(f"storage volume {vid} RPC failed: {exc} [controller diagnosis: "
                  f"{diagnosis}]") from exc

    async def _ref_replaced(self, vid: str) -> bool:
        """Whether the controller now maps ``vid`` to another actor than the
        one this client holds (``repair`` replaced it); if so, the volume
        map was reloaded and the cached locations are dropped."""
        try:
            replaced = vid in await self._refresh_health()
        except Exception:  # noqa: BLE001 - the retry will reload
            return False
        if replaced:
            self._loc_cache.clear()
            self._refresh_epoch += 1
        return replaced

    async def _retry_put_demoted(
        self, volume: StorageVolumeRef, requests: list[Request], first_exc: BaseException
    ) -> Optional[dict[str, int]]:
        """Retry a failed single-volume landing under ``config.retry``, one
        rung down the transport ladder per attempt. Returns the write
        generations, or None when the policy ran out or the volume is dead
        (the caller raises ``first_exc``)."""
        if not isinstance(first_exc, RETRYABLE_ERRORS) or volume.volume_id in self._dead_volumes:
            return None
        policy = self._config.retry
        deadline = policy.start()
        ladder = demotion_ladder(volume, self._config)
        attempt = 0
        while policy.should_retry(attempt, deadline):
            await asyncio.sleep(policy.backoff(attempt))
            rung = ladder[min(attempt + 1, len(ladder) - 1)]
            try:
                gens = await self._land(volume, requests, transport=rung)
            except RETRYABLE_ERRORS as exc:
                attempt += 1
                logger.warning("put retry %d on %s over %s failed: %s",
                               attempt, volume.volume_id, rung.value, exc)
                if volume.volume_id in self._dead_volumes:
                    return None  # diagnosed dead: no rung reaches it
                continue
            _PUT_RETRIES.inc(transport=rung.value)
            _FAILOVERS.inc(op="put")
            logger.warning(
                "non-replicated put to %s recovered on transport %s after %d retr%s "
                "(first failure: %s)", volume.volume_id, rung.value, attempt + 1,
                "y" if attempt == 0 else "ies", first_exc,
            )
            return gens
        return None

    # ------------------------------------------------------------------
    # get
    # ------------------------------------------------------------------

    async def get(self, key: str, like: Any = None) -> Any:
        return (await self.get_batch({key: like}))[key]

    async def get_batch(self, items, _epoch_checked: bool = False) -> dict[str, Any]:
        """All-or-nothing batched get: a missing or partially committed key
        fails the batch before data moves. ``items`` is a list of keys or
        {key: target or None}. A tensor target is filled in place and
        returned; a ``Shard`` target fills its data (returned) with its
        region, or returns a fresh tensor of it when the data is None; a
        ``TensorSlice`` returns a fresh tensor of its region; a DTensor's
        local tensor is filled with its shard and the DTensor returned.
        ``_epoch_checked``: the caller read the placement epoch just now
        (``placement_epoch``), so cached locations are valid as they are.

        A transient fetch failure relocates and fetches again under
        ``config.retry`` while every key keeps a replica not seen failing
        in this get (a volume ``repair`` replaced counts as not seen: its
        ref was reloaded); a key another client deleted or re-laid out
        meanwhile relocates once."""
        with obs_context.ensure_root(), span("get_batch", keys=len(items)):
            return await self._get_batch(items, _epoch_checked)

    async def _get_batch(self, items, _epoch_checked: bool) -> dict[str, Any]:
        if isinstance(items, str):
            raise TypeError("get_batch takes a list of keys or a {key: target} dict")
        if not isinstance(items, dict):
            items = {key: None for key in items}
        wants = [self._want(key, like) for key, like in items.items()]
        await self._ensure_setup()
        keys = list(items)
        if not _epoch_checked and (
            self._seen_epoch is None or any(key in self._loc_cache for key in keys)
        ):
            # Cached locations hold while the placement epoch does: another
            # client's put may have detached a replica or added one since.
            self.epoch_reads += 1
            self._observe_epoch(await self._controller.placement_epoch.call_one())
        cached = [key for key in keys if key in self._loc_cache]
        located = await self._locate(keys)
        dead: set[str] = set()  # volumes found dead by this get
        policy = self._config.retry
        deadline = policy.start()
        attempt = 0
        stale_retried = False
        while True:
            try:
                out = await self._fetch(wants, located, dead)
                if attempt > 0:
                    _FAILOVERS.inc(op="get")
                return out
            except RETRYABLE_ERRORS as exc:
                for key in keys:
                    self._loc_cache.pop(key, None)
                alive = [v for v in self._volume_refs if v not in self._dead_volumes]
                if not policy.should_retry(attempt, deadline) or (not alive and attempt > 0):
                    raise
                _FETCH_RETRIES.inc()
                logger.warning("fetch attempt %d failed (%r); failing over", attempt + 1, exc)
                await asyncio.sleep(policy.backoff(attempt))
                attempt += 1
                # Relocate, and read the replicas not found dead.
                located = {
                    key: {vid: info for vid, info in infos.items() if vid not in dead}
                    for key, infos in (await self._locate(keys)).items()
                }
                if not all(located.values()):
                    raise
            except (KeyError, ValueError):
                # Another client deleted or re-laid out a key between the
                # epoch check and the fetch: relocate once.
                if stale_retried or not cached:
                    raise
                stale_retried = True
                _FETCH_RETRIES.inc()
                for key in cached:
                    self._loc_cache.pop(key, None)
                located = await self._locate(keys)

    async def _locate(self, keys: list[str]) -> dict[str, dict[str, StorageInfo]]:
        """Where each key lives: from the cache, else one locate RPC for
        the rest (whose answers are cached)."""
        located = {key: self._loc_cache[key] for key in keys if key in self._loc_cache}
        missing = [key for key in keys if key not in located]
        if missing:
            fresh = await self._controller.locate_volumes.call_one(missing)
            if len(self._loc_cache) + len(fresh) > self.LOC_CACHE_MAX:
                self._loc_cache.clear()
            self._loc_cache.update(fresh)
            located.update(fresh)
        return located

    @staticmethod
    def _want(key: str, like: Any) -> _Want:
        if like is None:
            return _Want(key)
        if sharding.is_dtensor(like):
            ts = sharding.target_slice(like)
            return _Want(key, ts, sharding.local_tensor(like), ts.box, like)
        if isinstance(like, torch.Tensor):
            return _Want(key, None, like, Box((0,) * like.ndim, tuple(like.shape)), like)
        if isinstance(like, Shard):
            ts = like.tensor_slice
            if like.data is not None and tuple(like.data.shape) != ts.local_shape:
                raise ValueError(
                    f"Shard target data shape {tuple(like.data.shape)} != slice local_shape "
                    f"{ts.local_shape} for key {key!r}"
                )
            return _Want(key, ts, like.data, ts.box, like.data)
        if isinstance(like, TensorSlice):
            return _Want(key, like)
        raise TypeError(f"unsupported get target {type(like)} for {key!r}")

    def _volume_requests(
        self, want: _Want, infos: dict[str, StorageInfo]
    ) -> list[tuple[str, Request]]:
        """The (volume id, request) pairs that fetch ``want``: one for an
        object or a whole stored tensor, one per distinct intersection of
        the wanted region with the stored shards for a sharded key."""
        # Healthy replicas first: diagnosed-dead and quarantined volumes stay
        # as a last resort (holding the only copy, they surface the error).
        ordered = sorted(infos, key=lambda v: (v in self._dead_volumes
                                               or v in self._avoid_volumes, v))
        info = infos[ordered[0]]
        key = want.key
        if info.object_type == ObjectType.OBJECT:
            return [(ordered[0], Request(key=key, is_object=True))]
        if info.object_type == ObjectType.TENSOR:
            stored = [(ordered[0], None, info)]
            global_shape = info.tensor_meta.shape
        else:
            stored = [(vid, ts, infos[vid]) for vid in ordered
                      for ts in infos[vid].tensor_slices.values()]
            global_shape = stored[0][1].global_shape
        full = Box((0,) * len(global_shape), tuple(global_shape))
        if want.wanted is not None and want.wanted.global_shape != full.shape:
            raise ValueError(
                f"requested global shape {want.wanted.global_shape} != stored "
                f"{full.shape} for key {key!r}"
            )
        if want.wanted is None and want.dest is not None and want.dest_box != full:
            raise ValueError(
                f"target shape {want.dest_box.shape} != stored {full.shape} for key {key!r}"
            )
        region = full if want.wanted is None else want.wanted.box
        subs: list[tuple[str, Request]] = []
        seen: set[Box] = set()
        covered = 0
        for vid, ts, vinfo in stored:
            inter = intersect_boxes(ts.box if ts is not None else full, region)
            if inter is None or inter in seen:
                continue  # disjoint, or a replica's identical region
            seen.add(inter)
            covered += inter.size
            if ts is None:  # a whole stored tensor: the region of it, or all of it
                part = None if want.wanted is None else want.wanted.with_box(inter)
            else:
                part = ts.with_box(inter)  # the stored shard's coordinates find it
            sub = Request(key=key, tensor_slice=part, tensor_meta=vinfo.tensor_meta)
            if want.dest is not None:
                sub.destination_view = get_destination_view(
                    want.dest, want.dest_box, inter, require_contiguous=False
                )
            subs.append((vid, sub))
        if covered < region.size:
            raise ValueError(
                f"stored shards of {key!r} cover only {covered} of the {region.size} "
                f"elements of {region}"
            )
        return subs

    async def _fetch(
        self, wants: list[_Want], located: dict[str, dict[str, StorageInfo]], dead: set[str]
    ) -> dict[str, Any]:
        """Fetch every want from the volumes ``located`` names; the id of a
        volume found dead is added to ``dead``."""
        plans = [self._volume_requests(want, located[want.key]) for want in wants]
        by_volume: dict[str, list[Request]] = {}
        for subs in plans:
            for vid, sub in subs:
                by_volume.setdefault(vid, []).append(sub)
        self.parts_fetched += sum(not r.is_object for reqs in by_volume.values() for r in reqs)

        async def fetch_volume(vid: str, requests: list[Request]) -> list[Any]:
            volume = self._volume_refs[vid]
            buffer = create_transport_buffer(volume, self._config)
            # The coordinates ride the span: a trace shows which shards each
            # volume served.
            coords = [r.tensor_slice.coordinates for r in requests if r.tensor_slice is not None]
            try:
                with span("fetch_volume", volume=vid, transport=buffer.transport_name,
                          keys=len(requests), coords=coords or None):
                    return await buffer.get_from_storage_volume(volume, requests)
            except (ActorDiedError, ConnectionError, OSError) as exc:
                # Failed in this get: the retry reads the other replicas,
                # unless the diagnosis found the ref stale and reloaded it.
                dead.add(vid)
                refreshed = self._refresh_epoch
                try:
                    await self._raise_with_diagnosis(vid, exc)
                finally:
                    if self._refresh_epoch != refreshed:
                        dead.discard(vid)

        ordered = sorted(by_volume.items())
        results = await asyncio.gather(*(fetch_volume(v, reqs) for v, reqs in ordered))
        fetched: dict[int, Any] = {}
        for (_, requests), values in zip(ordered, results):
            for req, value in zip(requests, values):
                fetched[id(req)] = value
        return {
            want.key: self._assemble(
                want, [(sub, fetched[id(sub)]) for _, sub in subs], located[want.key]
            )
            for want, subs in zip(wants, plans)
        }

    @staticmethod
    def _assemble(want: _Want, parts: list[tuple[Request, Any]], infos: dict) -> Any:
        """The value a get returns for ``want`` from its fetched parts."""
        if parts and parts[0][0].is_object:
            value = parts[0][1]
            return value.unwrap() if isinstance(value, OpaqueBlob) else value
        if want.dest is not None:
            return want.result  # every part landed in its view of the target
        if len(parts) == 1 and parts[0][0].tensor_slice is None:
            return parts[0][1]  # a whole stored tensor
        if not parts:  # an empty region
            meta = next(iter(infos.values())).tensor_meta
            return torch.empty(want.wanted.local_shape, dtype=meta.torch_dtype)
        out, _ = assemble_tensor([(value, sub.tensor_slice.offsets) for sub, value in parts])
        return out

    # ------------------------------------------------------------------
    # delete / keys / exists
    # ------------------------------------------------------------------

    async def delete(self, key: str) -> None:
        await self.delete_batch([key])

    async def delete_batch(self, keys: list[str]) -> None:
        """De-index first (readers stop finding the keys), then clear the
        volumes that held them."""
        await self._ensure_setup()
        by_volume = await self._controller.notify_delete_batch.call_one(keys)
        ordered = sorted(by_volume.items())
        results = await asyncio.gather(
            *(self._volume_refs[vid].actor.delete_batch.call_one(vkeys) for vid, vkeys in ordered),
            return_exceptions=True,
        )
        for (vid, vkeys), result in zip(ordered, results):
            if isinstance(result, RETRYABLE_ERRORS):
                # De-indexed already: a dead or stuck volume only strands
                # bytes nobody can reach (they go with its process).
                logger.warning("delete of %d key(s) on unreachable volume %s skipped (%s)",
                               len(vkeys), vid, result)
            elif isinstance(result, BaseException):
                raise result
        for key in keys:
            self._ctx.delete_key(key)
            self._loc_cache.pop(key, None)

    async def delete_prefix(self, prefix: str) -> int:
        """Delete every key under ``prefix`` (by whole path segments, e.g. an
        old version's "policy/v41"); returns how many. Idempotent."""
        keys = await self._controller.keys.call_one(prefix)
        if keys:
            await self.delete_batch(keys)
        return len(keys)

    async def keys(self, prefix: Optional[str] = None) -> list[str]:
        return await self._controller.keys.call_one(prefix)

    # ------------------------------------------------------------------
    # repair support
    # ------------------------------------------------------------------

    async def refresh_volumes(self) -> None:
        """Reload the volume map (``repair`` swapped replacements in); drops
        cached locations, dead marks, and attachments to segments of
        processes that are gone."""
        self._loc_cache.clear()
        self._dead_volumes.clear()
        self._diag_at = 0.0
        self._refresh_epoch += 1
        self._ctx.get_cache(ShmClientCache).forget_dead()
        await self._load_volumes()

    async def replicate_to(self, volume_id: str, requests: list[Request]) -> None:
        """Land ``requests`` on the one volume ``volume_id`` and index them
        there, beside the other copies (``repair``'s re-replication)."""
        await self._ensure_setup()
        gens = await self._land(self._volume_refs[volume_id], requests)
        epoch = await self._controller.notify_put_batch.call_one(
            [r.meta_only() for r in requests], volume_id, write_gens={volume_id: gens})
        self._observe_epoch(epoch)

    async def exists(self, key: str) -> bool:
        """True once any part of ``key`` is indexed (also when partial)."""
        return await self._controller.contains.call_one(key) != "missing"

    # ------------------------------------------------------------------
    # blocking waits
    # ------------------------------------------------------------------

    @staticmethod
    def _wait_rpc_timeout(timeout: Optional[float]) -> float:
        # The RPC outlives the controller's wait, so its TimeoutError (which
        # names the keys) arrives first; 0 disables the RPC deadline.
        return 0 if timeout is None else timeout + 10.0

    async def wait_for(self, keys, timeout: Optional[float] = None) -> None:
        """Block until every key (a str or a list) exists and is committed;
        ``TimeoutError`` on expiry. In place of polling a get."""
        if isinstance(keys, str):
            keys = [keys]
        await self._ensure_setup()
        await self._controller.wait_for_committed.with_timeout(
            self._wait_rpc_timeout(timeout)
        ).call_one(list(keys), timeout)

    async def wait_for_change(
        self, key: str, last_gen: int = 0, timeout: Optional[float] = None
    ) -> dict:
        """Block until ``key``'s update generation differs from
        ``last_gen``; returns ``{"gen", "state"}`` (state: missing, partial
        or committed)."""
        await self._ensure_setup()
        return await self._controller.wait_for_change.with_timeout(
            self._wait_rpc_timeout(timeout)
        ).call_one(key, last_gen, timeout)

    # ------------------------------------------------------------------
    # layer-streamed sync (see stream_sync.py)
    # ------------------------------------------------------------------

    async def stream_begin(self, key: str, quant: Optional[dict] = None) -> int:
        """Open the next streamed publish of ``key``; returns its version.
        ``quant`` is the decode meta readers need before the seal."""
        await self._ensure_setup()
        return await self._controller.stream_begin.call_one(key, quant)

    async def stream_seal(self, key: str, version: int) -> None:
        await self._ensure_setup()
        await self._controller.stream_seal.call_one(key, version)

    async def stream_mark_unchanged(self, key: str, version: int, aliases: dict) -> None:
        """Watermark the keys of a streamed delta fragment that landed no
        bytes (each an alias of an earlier version's committed key)."""
        await self._ensure_setup()
        await self._controller.stream_mark_unchanged.call_one(key, version, aliases)

    async def stream_state(self, key: str) -> Optional[dict]:
        """``key``'s stream record, or None when it was never streamed.
        Read watermarks through ``stream_sync.watermark_of`` /
        ``inconsistent_keys``."""
        await self._ensure_setup()
        return await self._controller.stream_state.call_one(key)

    async def wait_for_stream(
        self,
        key: str,
        version: int,
        known: int = 0,
        timeout: Optional[float] = None,
        volume_id: Optional[str] = None,
    ) -> dict:
        """Long-poll a streamed publish's progress (``Controller.
        wait_for_stream``); the RPC outlives the controller's wait, as
        every blocking wait's does."""
        await self._ensure_setup()
        return await self._controller.wait_for_stream.with_timeout(
            self._wait_rpc_timeout(timeout)
        ).call_one(key, version, known, timeout, volume_id)

    async def stream_ack(self, key: str, version: int, subscriber: str) -> None:
        """This subscriber's acquire completion on the stream's timeline
        (telemetry)."""
        await self._ensure_setup()
        await self._controller.stream_ack.call_one(key, version, subscriber)

    # ------------------------------------------------------------------
    # version retention and the spill tier (see tiering/)
    # ------------------------------------------------------------------

    async def lease_acquire(
        self, cohort: str, channel: str, version: int, ttl_s: Optional[float] = None
    ) -> dict:
        """Pin (channel, version) for ``cohort`` against GC and spill
        (TTL'd: renew to keep it); returns the lease's description, whose
        ``lease_id`` renews and releases it."""
        await self._ensure_setup()
        return await self._controller.lease_acquire.call_one(cohort, channel, version, ttl_s)

    async def lease_renew(self, lease_id: str, ttl_s: Optional[float] = None) -> dict:
        await self._ensure_setup()
        return await self._controller.lease_renew.call_one(lease_id, ttl_s)

    async def lease_release(self, lease_id: str) -> bool:
        await self._ensure_setup()
        return await self._controller.lease_release.call_one(lease_id)

    async def lease_list(self, channel: Optional[str] = None) -> dict[str, dict[int, list[str]]]:
        """{channel: {version: [cohort, ...]}} over the live leases."""
        await self._ensure_setup()
        return await self._controller.lease_list.call_one(channel)

    async def version_catalog(self, channel: Optional[str] = None) -> dict[str, dict[int, dict]]:
        """Each channel version's keys, bytes, volumes, tier split and
        leases (``Controller.version_catalog``)."""
        await self._ensure_setup()
        return await self._controller.version_catalog.call_one(channel)

    async def tier_sweep(self) -> dict[str, dict]:
        """One spill pass over every volume now; a summary per volume."""
        await self._ensure_setup()
        return await self._controller.tier_sweep.call_one()
