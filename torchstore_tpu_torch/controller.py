"""Controller actor: the store's metadata plane.

Port of the core endpoints of ``torchstore_tpu/controller.py`` (``init``,
``locate_volumes``, ``contains``, ``notify_put_batch``,
``notify_delete_batch``, ``keys``, ``wait_for_committed``,
``wait_for_change``, ``placement_epoch``, ``bump_placement_epoch``,
``stats``, ``teardown``, plus the volume map clients load), with commit
tracking for sharded keys, and the stream records of layer-streamed
publishes (``stream_begin``, ``stream_seal``, ``stream_mark_unchanged``,
``stream_state``, ``stream_ack``, ``wait_for_stream``, and the per-key
watermarks ``notify_put_batch(watermark=)`` applies in the same indexing
step as the metadata). ``inject_fault`` / ``clear_faults`` arm and disarm
fault points in the controller's process, and ``stats()`` carries its
metrics registry.

Version retention (``tiering/``): the controller holds the store's cohort
leases (``lease_acquire`` / ``lease_renew`` / ``lease_release`` /
``lease_list``); ``notify_delete_batch`` refuses to de-index a leased
version's keys whoever asks; ``version_catalog`` lists every channel
version with its tier split and leases; ``tier_sweep`` (and a background
sweeper every ``TORCHSTORE_TORCH_TIER_SWEEP_INTERVAL_S``) runs each
volume's spill pass with the pinned groups and folds the reported spills
and fault-ins into the index; ``rebuild_index`` recovers the index from the
volumes' manifests after a restart of a durable store.

Replication and healing: a full overwrite (``notify_put_batch(supersede=
True)``) detaches every other copy of what it wrote, and the index
reclaims detached copies in the background, conditional on their write
generation. ``check_volumes`` diagnoses every volume (``ok``, ``wedged:
...``, ``dead: ...`` or ``quarantined: ...``); the health supervisor pings
every volume each ``TORCHSTORE_TORCH_HEALTH_INTERVAL_S`` and runs the ok ->
quarantined -> probation -> ok state machine (one placement-epoch bump per
sweep that moved any volume, a flight-recorder dump per quarantine), and a
quarantine starts an auto-repair pass that copies the volume's keys onto
healthy volumes (``TORCHSTORE_TORCH_AUTO_REPAIR``). ``volume_health``
reads the supervisor's view; ``replace_volume`` swaps a repair's fresh
volume in for a dead one. ``reserve_prewarm`` / ``release_prewarm`` grant
prewarms tmpfs capacity against the volumes' headroom, netted per host
(co-located volumes share one ``/dev/shm``), with a TTL for a crashed
prewarmer. The relay, control, autoscale and mirror engines
of the reference are not part of this port yet. The controller never sees
tensor bytes: only ``Request.meta_only()`` copies.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Optional

from torchstore_tpu_torch import faults, tiering
from torchstore_tpu_torch.config import (
    ENV_TIER_SWEEP_INTERVAL_S,
    _env_float,
    auto_repair_enabled,
    health_interval_s,
    health_miss_threshold,
)
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability import recorder as obs_recorder
from torchstore_tpu_torch.metadata.index_core import IndexCore, StorageInfo, resolve_manifests
from torchstore_tpu_torch.runtime import Actor, ActorRef, endpoint
from torchstore_tpu_torch.tiering import spill as tiering_spill
from torchstore_tpu_torch.transport.types import Request
from torchstore_tpu_torch.utils import spawn_logged

logger = get_logger("torchstore_tpu_torch.controller")

_LEASE_BLOCKED_DELETES = obs_metrics.counter(
    "ts_lease_blocked_deletes_total",
    "Delete requests refused because a cohort lease pins the version",
)
_VOLUME_HEALTH = obs_metrics.gauge(
    "ts_volume_health",
    "Supervisor view of each volume: 1 healthy, 0.5 probation, 0 quarantined",
)
_QUARANTINES = obs_metrics.counter(
    "ts_quarantines_total",
    "Volumes moved to quarantine by the health supervisor",
)
# Seconds the supervisor waits for a volume's ping, at most: one interval,
# clamped to [0.5, 5].
PING_TIMEOUT_BOUNDS = (0.5, 5.0)
# Seconds a quarantine's post-mortem waits for each volume's ring.
FLIGHT_FETCH_S = 2.0
_PREWARM_RESERVED = obs_metrics.gauge(
    "ts_prewarm_reserved_bytes",
    "tmpfs bytes held by outstanding prewarm capacity reservations, per volume",
)
# Seconds the controller waits for a volume's capacity view.
CAPACITY_RPC_S = 10.0


class Controller(Actor):
    # Stream records kept at once; sealed (idle) records are evicted first.
    MAX_STREAMS = 256
    # Subscriber acks kept per stream record; the oldest go first.
    MAX_STREAM_ACKS = 64

    def __init__(self) -> None:
        self.strategy = None
        self.volume_refs: dict[str, ActorRef] = {}
        self.volume_hostnames: dict[str, str] = {}
        self.core = IndexCore(self)
        # Bumped on every structural placement change: one cheap RPC lets a
        # consumer validate a whole cached transfer plan.
        self._placement_epoch = 0
        # Stream records of layer-streamed publishes, by state-dict key; dict
        # order is touch recency (see _stream_rec).
        self._streams: dict[str, dict] = {}
        # Cohort retention leases: the authority on which versions are
        # pinned against deletes and spills.
        self._leases = tiering.LeaseRegistry()
        # The background spill sweeper: on when the tier is (one reading of
        # the knob the volumes read too) and the interval is positive.
        self._tier_enabled = tiering_spill.enabled()
        self._tier_interval = _env_float(ENV_TIER_SWEEP_INTERVAL_S, 2.0)
        self._tier_task: Optional[asyncio.Task] = None
        self._tasks: set = set()
        # The health supervisor: per volume {"state": ok | probation |
        # quarantined, "misses", "oks"}; one heartbeat task, started by
        # init and cancelled at teardown.
        self._vol_health: dict[str, dict] = {}
        self._health_interval = health_interval_s()
        self._miss_threshold = health_miss_threshold()
        self._auto_repair = auto_repair_enabled()
        self._health_task: Optional[asyncio.Task] = None
        self._health_tasks: set = set()
        # Volumes with an auto-repair pass in flight (a flapping volume must
        # not stack passes), and the report of each volume's last pass.
        self._repairing: set[str] = set()
        self._repair_reports: dict[str, dict] = {}
        # Prewarm capacity reservations: id -> (monotonic expiry, {volume:
        # granted bytes}). Grants count against the volumes' tmpfs headroom,
        # so concurrent prewarms cannot oversubscribe /dev/shm; a crashed
        # prewarmer's reservation expires by its TTL.
        self._prewarm_reservations: dict[str, tuple[float, dict[str, int]]] = {}
        obs_recorder.recorder().arm_exit_dump()

    def _bump_epoch(self) -> int:
        self._placement_epoch += 1
        return self._placement_epoch

    # ---- what the index core reads of its host -----------------------------

    def quarantined_ids(self) -> set:
        return {vid for vid, h in self._vol_health.items() if h["state"] == "quarantined"}

    async def on_structural(self) -> int:
        return self._bump_epoch()

    # The reclaim state lives in the core; these views keep it reachable
    # from a controller built directly (tests).
    @property
    def _pending_reclaims(self) -> dict:
        return self.core._pending_reclaims

    @property
    def _reclaim_tasks(self) -> set:
        return self.core._reclaim_tasks

    @property
    def _reclaim_running(self) -> set:
        return self.core._reclaim_running

    @endpoint
    async def init(self, strategy, volume_refs: list[ActorRef]) -> dict[str, Any]:
        """Resolve volume ids with a ``get_id`` fan-out and adopt the
        strategy."""
        self.strategy = strategy
        infos = await asyncio.gather(*(ref.get_id.call_one() for ref in volume_refs))
        self.volume_refs = {}
        self.volume_hostnames = {}
        for ref, info in zip(volume_refs, infos):
            vid = str(info["volume_id"])
            if vid in self.volume_refs:
                raise ValueError(f"duplicate volume id {vid!r}; check strategy env wiring")
            self.volume_refs[vid] = ref
            self.volume_hostnames[vid] = info["hostname"]
        self._vol_health = {vid: {"state": "ok", "misses": 0, "oks": 0}
                            for vid in self.volume_refs}
        for vid in self.volume_refs:
            _VOLUME_HEALTH.set(1, volume=vid)
        self._start_tier_sweeper()
        self._start_supervisor()
        return {"volume_ids": sorted(self.volume_refs), "hostnames": self.volume_hostnames}

    @endpoint
    async def get_strategy(self):
        return self.strategy

    @endpoint
    async def get_volume_map(self) -> dict[str, dict]:
        return {
            vid: {"ref": ref, "hostname": self.volume_hostnames[vid],
                  "health": self._vol_health.get(vid, {}).get("state", "ok")}
            for vid, ref in self.volume_refs.items()
        }

    @endpoint
    async def locate_volumes(
        self, keys: list[str], missing_ok: bool = False, require_committed: bool = True
    ) -> dict[str, dict[str, StorageInfo]]:
        """Where each key lives; a sharded key not yet stored at every mesh
        coordinate raises ``PartiallyCommittedError`` unless
        ``require_committed`` is off."""
        await faults.afire("controller.locate")
        return self.core.locate(keys, missing_ok, require_committed)

    @endpoint
    async def contains(self, key: str) -> str:
        """'missing', 'partial' or 'committed'."""
        return self.core.contains(key)

    @endpoint
    async def notify_put_batch(
        self,
        metas: list[Request],
        volume_id: "str | list[str]",
        detach_volume_ids: Optional[list[str]] = None,
        write_gens: Optional[dict[str, dict[str, int]]] = None,
        watermark: Optional[tuple] = None,
        unchanged: Optional[dict] = None,
        supersede: bool = False,
    ) -> int:
        """Index ``metas`` as stored on ``volume_id`` (one id or a list),
        with each volume's write generations, and detach them from
        ``detach_volume_ids`` (replicas whose landing failed); returns the
        placement epoch. ``supersede``: the put landed on every replica the
        strategy chose, a full overwrite, so every other volume indexed for
        these metas holds superseded bytes and is detached in the same step
        (a partial writer, such as ``replicate_to``, leaves it off). Every
        detached copy is reclaimed in the background, conditional on its
        write generation.

        ``watermark``: ``(stream_key, version)`` of a layer-streamed
        publish. Every meta's key is watermarked at ``version`` in the same
        indexing step as its metadata, under the index's condition and
        before the notify that wakes ``wait_for_stream``: no reader sees a
        watermark before the bytes it stands for are committed. Once for
        all replicas: ``volume_id`` lists them all. ``unchanged``:
        ``{new_store_key: (base_store_key, base_version)}``, keys of the
        same publish that ship no bytes and serve the base key's committed
        bytes, watermarked in the same step (requires ``watermark``)."""
        if unchanged and watermark is None:
            raise ValueError(
                "notify_put_batch(unchanged=...) requires watermark=: "
                "unchanged-key aliases are a streamed-publish protocol"
            )
        await faults.afire("controller.notify")
        volume_ids = [volume_id] if isinstance(volume_id, str) else list(volume_id)
        keys = {m.key for m in metas}
        async with self.core.cond():
            if unchanged:
                self._check_unchanged(unchanged)  # before anything is indexed
            if self.core.apply_put_batch(metas, volume_ids, detach_volume_ids, write_gens,
                                         supersede=supersede):
                self._bump_epoch()
            if watermark is None:
                self.core.bump_locked(keys)
                return self._placement_epoch
        # The watermark step runs after the metadata committed: a delay here
        # holds committed bytes invisible to streaming readers, a raise fails
        # the notify before any reader trusted the partial version. Disarmed,
        # nothing yields between the two holds of the condition.
        await faults.afire("channel.watermark")
        async with self.core.cond():
            self._apply_watermark(watermark[0], int(watermark[1]), metas, unchanged)
            self.core.bump_locked(keys)
        return self._placement_epoch

    def _apply_watermark(
        self, stream_key: str, version: int, metas: list[Request], unchanged: Optional[dict]
    ) -> None:
        """The watermark step of a streamed publish (see notify_put_batch):
        it runs after the batch's metadata is indexed. Watermarks only move
        up: a late notify of a superseded stream never rolls a key back."""
        rec = self._stream_rec(stream_key, version)
        now = time.time()
        for meta in metas:
            rec["watermarks"][meta.key] = max(rec["watermarks"].get(meta.key, 0), version)
            if version == rec["version"]:
                # The first commit of a key is its landing.
                rec["landing_ts"].setdefault(meta.key, now)
        if unchanged:
            self._record_unchanged(rec, unchanged, version, now)

    def _lease_guard(self, keys: list[str]) -> list[str]:
        """The keys a delete may reap: those under a pinned (channel,
        version) stay indexed whoever asked (the publisher's GC, a close, a
        raw ``delete_prefix``). The hard guarantee that a leased version is
        never reaped mid-read; one snapshot of the pinned groups serves the
        batch."""
        pinned = self._leases.pinned_groups()
        if not pinned:
            return keys
        passed, blocked = [], []
        for key in keys:
            group = tiering.version_group(key)
            (blocked if group is not None and tiering.group_key(*group) in pinned
             else passed).append(key)
        if blocked:
            _LEASE_BLOCKED_DELETES.inc(len(blocked))
            obs_recorder.record("tier", "delete_blocked", keys=len(blocked), sample=blocked[0])
            logger.warning("refusing to delete %d key(s) under leased version(s) (e.g. %s); "
                           "release or let the cohort leases expire first",
                           len(blocked), blocked[0])
        return passed

    @endpoint
    async def notify_delete_batch(self, keys: list[str]) -> dict[str, list[str]]:
        """Remove keys from the index first (notify-before-delete) and
        return which volumes held each key; keys of a leased version stay
        (``_lease_guard``). Deleting a streamed state dict's commit marker
        (or a stream key itself) retires its stream record: pollers wake
        and see it gone."""
        keys = self._lease_guard(keys)
        by_volume = self.core.delete_keys(keys)
        if by_volume:
            deleted = {k for vkeys in by_volume.values() for k in vkeys}
            self._retire_stream_records(deleted)
            self._bump_epoch()
            await self.core.bump(keys)
        return by_volume

    def _retire_stream_records(self, deleted) -> None:
        for key in deleted:
            self._streams.pop(key, None)
            if key.endswith("/MAPPING"):
                self._streams.pop(key[: -len("/MAPPING")], None)

    @endpoint
    async def placement_epoch(self) -> int:
        return self._placement_epoch

    @endpoint
    async def bump_placement_epoch(self) -> int:
        """Invalidate every cached transfer plan: publishers call it for a
        restructure the index cannot see."""
        return self._bump_epoch()

    @endpoint
    async def keys(self, prefix: Optional[str] = None) -> list[str]:
        return self.core.keys_list(prefix)

    @endpoint
    async def wait_for_committed(self, keys: list[str], timeout: Optional[float] = None) -> None:
        """Block until every key exists and is committed (a sharded key:
        every mesh coordinate landed); ``TimeoutError`` on expiry. Woken by
        the notify that commits the key, in place of a polling get."""
        await self.core.wait_for_committed(keys, timeout)

    @endpoint
    async def wait_for_change(
        self, key: str, last_gen: int = 0, timeout: Optional[float] = None
    ) -> dict[str, Any]:
        """Block until ``key``'s update generation (bumped by every indexed
        put or delete of it) differs from ``last_gen``; returns ``{"gen",
        "state"}`` with state missing, partial or committed."""
        return await self.core.wait_for_change(key, last_gen, timeout)

    # ---- layer-streamed sync (watermark protocol) ------------------------

    def _stream_rec(self, key: str, version: Optional[int] = None) -> dict:
        """The stream record of ``key``, created on first touch. At
        MAX_STREAMS the least recently touched sealed record goes first (a
        live channel's record never loses to one-shot streams), the oldest
        of all only when every record has a stream in flight; readers of an
        evicted record fall back to the barrier path."""
        rec = self._streams.pop(key, None)
        if rec is None:
            if len(self._streams) >= self.MAX_STREAMS:
                victim = next(
                    (k for k, r in self._streams.items() if r["sealed"] >= r["version"]),
                    next(iter(self._streams)),
                )
                self._streams.pop(victim)
            rec = {
                "version": version or 1,
                "sealed": 0,
                "watermarks": {},
                # store_key -> (base_store_key, base_channel_version): keys
                # of a delta publish that ship nothing and serve the
                # previous version's bytes.
                "aliases": {},
                # Decode meta the publisher registered at stream_begin:
                # readers decode blobs before the seal's marker exists.
                "quant": None,
                "begin_ts": time.time(),
                "seal_ts": None,
                "landing_ts": {},
                "acks": {},
            }
        elif version is not None and version > rec["version"]:
            rec["version"] = version
            # A new generation restarts the timeline; the watermarks stay
            # (max semantics across generations).
            rec["begin_ts"] = time.time()
            rec["seal_ts"] = None
            rec["landing_ts"] = {}
            rec["acks"] = {}
        self._streams[key] = rec  # re-inserted last: dict order is recency
        return rec

    def _notify_streams(self) -> None:
        self.core.cond().notify_all()

    @endpoint
    async def stream_begin(self, key: str, quant: Optional[dict] = None) -> int:
        """Open the next streamed publish of ``key``; returns its version
        (monotonic per key over the controller's life). ``quant``: the
        static decode meta of a quantized stream (format, block, delta
        context), set on every begin so a reused record never keeps an
        earlier generation's."""
        rec = self._streams.get(key)
        version = (max(rec["version"], rec["sealed"]) + 1) if rec else 1
        rec = self._stream_rec(key, version)
        rec["quant"] = quant
        async with self.core.cond():
            self._notify_streams()
        return version

    @endpoint
    async def stream_seal(self, key: str, version: int) -> None:
        """The terminal record of one streamed publish, written after its
        commit marker: a sealed stream always has a barrier-readable dict."""
        version = int(version)
        rec = self._stream_rec(key, version)
        rec["sealed"] = max(rec["sealed"], version)
        if version == rec["version"] and rec["seal_ts"] is None:
            rec["seal_ts"] = time.time()
        async with self.core.cond():
            self._notify_streams()

    def _check_unchanged(self, aliases: dict) -> None:
        """Every base key of ``aliases`` is committed: a publish aliasing
        deleted bytes fails the publisher, never its readers. One batched
        locate for all of them."""
        base_keys = sorted({alias[0] for alias in aliases.values()})
        located = self.core.locate(base_keys, missing_ok=True, require_committed=False)
        for new_sk, alias in aliases.items():
            infos = located.get(alias[0])
            if not infos or self.core.committed_state(infos) != "committed":
                raise ValueError(
                    f"unchanged-watermark alias {new_sk!r} -> {alias[0]!r}: base bytes "
                    "are not committed (deleted or never landed); readers could never "
                    "serve this key - publish a keyframe instead"
                )

    def _record_unchanged(self, rec: dict, aliases: dict, version: int, now: float) -> None:
        """Watermark each aliased key at ``version``, pointing readers at
        its base key's committed bytes (checked by ``_check_unchanged``)."""
        for new_sk, alias in aliases.items():
            rec["watermarks"][new_sk] = max(rec["watermarks"].get(new_sk, 0), version)
            rec["aliases"][new_sk] = (alias[0], int(alias[1]))
            if version == rec["version"]:
                rec["landing_ts"].setdefault(new_sk, now)

    @endpoint
    async def stream_mark_unchanged(self, key: str, version: int, aliases: dict) -> None:
        """Watermark the keys of a streamed fragment that landed no bytes
        (every key an alias): the standalone form of
        ``notify_put_batch(unchanged=)``. Its bytes committed with an
        earlier version, so there is no window to close."""
        async with self.core.cond():
            self._check_unchanged(aliases)
            rec = self._stream_rec(key, int(version))
            self._record_unchanged(rec, aliases, int(version), time.time())
            self._notify_streams()

    @endpoint
    async def stream_state(self, key: str) -> Optional[dict]:
        """A snapshot of ``key``'s stream record, or None when it was never
        streamed (or its record was evicted or retired)."""
        rec = self._streams.get(key)
        if rec is None:
            return None
        return {
            "version": rec["version"],
            "sealed": rec["sealed"],
            "watermarks": dict(rec["watermarks"]),
            "aliases": dict(rec["aliases"]),
            "quant": rec["quant"],
            "begin_ts": rec["begin_ts"],
            "seal_ts": rec["seal_ts"],
            "landing_ts": dict(rec["landing_ts"]),
            "acks": {sub: dict(ack) for sub, ack in rec["acks"].items()},
        }

    @endpoint
    async def stream_ack(self, key: str, version: int, subscriber: str) -> None:
        """One subscriber's acquire completion on the stream's timeline
        (bounded to MAX_STREAM_ACKS). Telemetry: a missing record is a
        no-op."""
        rec = self._streams.get(key)
        if rec is None:
            return
        acks = rec["acks"]
        if subscriber not in acks and len(acks) >= self.MAX_STREAM_ACKS:
            acks.pop(next(iter(acks)))
        acks[subscriber] = {"version": int(version), "ts": time.time()}

    @endpoint
    async def wait_for_stream(
        self,
        key: str,
        version: int,
        known: int = 0,
        timeout: Optional[float] = None,
        volume_id: Optional[str] = None,
    ) -> dict[str, Any]:
        """Long-poll a streamed publish, woken by the notifies (no spin):
        returns once ``key``'s stream has more than ``known`` keys
        watermarked at ``version`` or newer, or ``version`` sealed, or a
        newer stream began (superseded), or the record is gone. ``known =
        -1`` waits for the record to exist at all. ``volume_id`` names a
        relay copy in the reference; this port has no relay, so it is
        ignored, as the reference ignores a volume outside the relay.

        Returns ``{"missing", "version", "sealed", "superseded", "ready",
        "watermarks", "aliases", "quant"}``: ``ready`` lists the store keys
        watermarked at ``version`` or newer, ``watermarks`` their values (a
        reader treats one above ``version`` as a mixed generation)."""
        version = int(version)
        cond = self.core.cond()

        def view() -> Optional[dict]:
            rec = self._streams.get(key)
            if rec is None:
                return None
            ready = {k: v for k, v in rec["watermarks"].items() if v >= version}
            return {
                "missing": False,
                "version": rec["version"],
                "sealed": rec["sealed"] >= version,
                "superseded": rec["version"] > version,
                "ready": sorted(ready),
                "watermarks": ready,
                "aliases": {k: rec["aliases"][k] for k in ready if k in rec["aliases"]},
                "quant": rec["quant"],
            }

        def changed() -> bool:
            v = view()
            if v is None:
                return known >= 0  # a gone record wakes established readers
            if known < 0:
                return True
            return len(v["ready"]) > known or v["sealed"] or v["superseded"]

        async with cond:
            try:
                await asyncio.wait_for(cond.wait_for(changed), timeout)
            except asyncio.TimeoutError:
                raise TimeoutError(
                    f"wait_for_stream({key!r}, v{version}) timed out after {timeout}s "
                    f"with {known} key(s) already served"
                ) from None
            v = view()
        if v is None:
            return {"missing": True, "version": 0, "sealed": False, "superseded": False,
                    "ready": [], "watermarks": {}, "aliases": {}, "quant": None}
        return v

    # ---- version retention and the spill tier ------------------------------

    @endpoint
    async def lease_acquire(self, cohort: str, channel: str, version: int,
                            ttl_s: Optional[float] = None) -> dict:
        """Pin (channel, version) for a cohort (TTL'd: renew to keep);
        returns the lease's description. Pinning a version with no keys is
        allowed (a pre-pin) and says so: ``resident_keys`` 0."""
        lease = self._leases.acquire(cohort, channel, version, ttl_s)
        lease["resident_keys"] = self.core.count_prefix(tiering.group_key(channel, version))
        return lease

    @endpoint
    async def lease_renew(self, lease_id: str, ttl_s: Optional[float] = None) -> dict:
        return self._leases.renew(lease_id, ttl_s)

    @endpoint
    async def lease_release(self, lease_id: str) -> bool:
        return self._leases.release(lease_id)

    @endpoint
    async def lease_list(self, channel: Optional[str] = None) -> dict[str, dict[int, list[str]]]:
        """{channel: {version: [cohort, ...]}} over the live leases."""
        return self._leases.pins(channel)

    @endpoint
    async def version_catalog(self, channel: Optional[str] = None) -> dict[str, dict[int, dict]]:
        """Every ``{channel}/v{n}`` group of the index: keys, logical bytes,
        volumes, the tier split, and the live leases pinning it (pre-pins
        of versions with no keys included)."""
        out = self.core.catalog(channel)
        for lease in self._leases.describe():
            if channel is not None and lease["channel"] != channel:
                continue
            out.setdefault(lease["channel"], {}).setdefault(lease["version"], {
                "keys": 0, "bytes": 0, "resident_keys": 0, "spilled_keys": 0,
                "volumes": set(), "leases": [],
            })["leases"].append(lease)
        for versions in out.values():
            for rec in versions.values():
                rec["volumes"] = sorted(rec["volumes"])
        return out

    def _start_tier_sweeper(self) -> None:
        """(Re)start the background sweeper; idempotent across inits."""
        if self._tier_task is not None:
            self._tier_task.cancel()
            self._tier_task = None
        if self._tier_enabled and self._tier_interval > 0:
            self._tier_task = spawn_logged(self._tier_loop(), name="controller.tier_sweep",
                                           tasks=self._tasks, log=logger)

    async def _tier_loop(self) -> None:
        while True:
            await asyncio.sleep(self._tier_interval)
            try:
                await self._tier_sweep_once()
            except Exception:  # noqa: BLE001 - one bad pass must not stop the sweeper
                logger.exception("tier sweep failed; retrying next round")

    async def _tier_sweep_once(self) -> dict[str, dict]:
        """One spill pass over the volumes with the current pinned groups;
        their spills and fault-ins become the index's tier states (metadata
        only: no epoch bump)."""
        pins = sorted(self._leases.pinned_groups())
        reports: dict[str, dict] = {}
        for vid, ref in list(self.volume_refs.items()):
            try:
                rep = await ref.tier_sweep.call_one(pins)
            except Exception as exc:  # noqa: BLE001 - reported per volume
                reports[vid] = {"error": f"{type(exc).__name__}: {exc}"}
                continue
            if not rep.get("enabled"):
                reports[vid] = rep
                continue
            self.core.set_tiers(vid, list(rep["spilled"]), list(rep["fault_ins"]))
            if rep["spilled"]:
                obs_recorder.record("tier", f"sweep/{vid}", spilled=len(rep["spilled"]),
                                    resident_bytes=rep.get("resident_bytes"),
                                    spilled_bytes=rep.get("spilled_bytes"), pins=len(pins))
            reports[vid] = {
                "spilled": len(rep["spilled"]),
                "fault_ins": len(rep["fault_ins"]),
                "resident_bytes": rep.get("resident_bytes"),
                "spilled_bytes": rep.get("spilled_bytes"),
                "spilled_keys": rep.get("spilled_keys"),
            }
        return reports

    @endpoint
    async def tier_sweep(self) -> dict[str, dict]:
        """One spill pass now (``tier_sweep()``), in place of waiting for
        the background interval; a summary per volume."""
        return await self._tier_sweep_once()

    @endpoint
    async def rebuild_index(self) -> int:
        """Recover the index from the volumes' manifests (durable volumes
        and spilled entries); returns the entries indexed. A key whose
        shards disagree on layout keeps only the newest (file mtime): that
        layout may stay partial until it is put again, and its gets fail
        loudly rather than mix stale and fresh shards."""
        manifests = await asyncio.gather(
            *(ref.manifest.call_one() for ref in self.volume_refs.values()))
        survivors, dropped = resolve_manifests(list(zip(self.volume_refs, manifests)))
        count = await self.core.reindex(survivors)
        if dropped:
            logger.warning("rebuild_index dropped %d superseded-layout shard(s); the surviving "
                           "layout may be partially committed until put again", dropped)
        self._bump_epoch()  # the rebuilt index invalidates every plan
        return count

    @endpoint
    async def stats(self, include_volumes: bool = False) -> dict:
        """The index summary (op counters, keys, indexed bytes, pending
        reclaims per volume), the volume count, the live leases, the
        supervisor's view and each volume's last auto-repair (keys, bytes,
        seconds in its pulls, the rungs they took, its start, the moment of
        the quarantine, as a wall-clock time, and its wall seconds); with ``include_volumes`` each volume's
        ``stats`` too (an ``error`` string for one that does not answer)."""
        out = {**self.core.summary(), "num_volumes": len(self.volume_refs),
               "active_leases": len(self._leases),
               "volume_health": {vid: dict(h) for vid, h in self._vol_health.items()},
               "auto_repairs": {vid: dict(r) for vid, r in self._repair_reports.items()},
               "metrics": obs_metrics.metrics_snapshot()}
        if include_volumes:

            async def one(vid: str, ref: ActorRef):
                try:
                    return vid, await asyncio.wait_for(ref.stats.call_one(), timeout=10.0)
                except Exception as exc:  # noqa: BLE001 - reported inline
                    return vid, {"error": f"{type(exc).__name__}: {exc}"}

            results = await asyncio.gather(*(one(v, r) for v, r in self.volume_refs.items()))
            out["volumes"] = dict(results)
        return out

    # ---- health: diagnosis, the supervisor, auto-repair, replacement -------

    @endpoint
    async def check_volumes(self, timeout: float = 5.0) -> dict[str, str]:
        """Ping every volume: volume id -> ``ok``, ``wedged: ...`` (alive
        but no answer within ``timeout``: stopped, deadlocked or
        overloaded; may recover), ``dead: ...`` (unreachable) or
        ``quarantined: ...`` (answers, but the supervisor has not
        reinstated it yet: clients keep avoiding it meanwhile)."""

        async def ping(vid: str, ref: ActorRef) -> tuple[str, str]:
            try:
                await asyncio.wait_for(ref.ping(), timeout=timeout)
            except asyncio.TimeoutError:
                return vid, (f"wedged: no ping response within {timeout:.0f}s (process alive "
                             "but stuck: stopped, deadlocked or overloaded; may recover)")
            except Exception as exc:  # noqa: BLE001 - reported, not raised
                return vid, f"dead: {type(exc).__name__}"
            if self._vol_health.get(vid, {}).get("state") == "quarantined":
                return vid, "quarantined: skipped by placement until reinstated"
            return vid, "ok"

        return dict(await asyncio.gather(*(ping(v, r) for v, r in self.volume_refs.items())))

    def _start_supervisor(self) -> None:
        """(Re)start the heartbeat loop; idempotent across inits; off when
        the interval is <= 0."""
        if self._health_task is not None:
            self._health_task.cancel()
            self._health_task = None
        if self._health_interval > 0:
            self._health_task = spawn_logged(self._health_loop(), name="controller.health",
                                             tasks=self._health_tasks, log=logger)

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self._health_interval)
            await self._health_sweep()

    async def _health_sweep(self) -> None:
        """One heartbeat round. Per volume: ok (or probation) ->
        quarantined after ``_miss_threshold`` consecutive misses;
        quarantined -> probation on the first answered ping -> ok after
        ``_miss_threshold`` consecutive answers. One placement-epoch bump
        per sweep that moved any volume (clients drop their plans and
        locations and re-read the health map); a quarantine dumps the
        flight recorder and starts auto-repair."""
        lo, hi = PING_TIMEOUT_BOUNDS
        timeout = min(max(self._health_interval, lo), hi)

        async def ping(vid: str, ref: ActorRef) -> tuple[str, bool]:
            try:
                await asyncio.wait_for(ref.ping(), timeout=timeout)
                return vid, True
            except Exception:  # noqa: BLE001 - any failure is a miss
                return vid, False

        results = await asyncio.gather(*(ping(v, r) for v, r in self.volume_refs.items()))
        changed = False
        for vid, ok in results:
            h = self._vol_health.setdefault(vid, {"state": "ok", "misses": 0, "oks": 0})
            state = h["state"]
            if ok:
                h["misses"] = 0
                if state == "quarantined":
                    h["state"], h["oks"] = "probation", 1
                    _VOLUME_HEALTH.set(0.5, volume=vid)
                    changed = True
                    obs_recorder.record("health", f"probation/{vid}")
                    logger.warning("volume %s answered pings again: probation (1/%d stable "
                                   "rounds to reinstate)", vid, self._miss_threshold)
                elif state == "probation":
                    h["oks"] += 1
                    if h["oks"] >= self._miss_threshold:
                        h["state"] = "ok"
                        _VOLUME_HEALTH.set(1, volume=vid)
                        changed = True
                        obs_recorder.record("health", f"reinstated/{vid}")
                        logger.warning("volume %s reinstated after %d stable rounds",
                                       vid, h["oks"])
                continue
            h["oks"] = 0
            h["misses"] += 1
            if state == "quarantined" or h["misses"] < self._miss_threshold:
                continue
            h["state"] = "quarantined"
            _VOLUME_HEALTH.set(0, volume=vid)
            _QUARANTINES.inc(volume=vid)
            changed = True
            obs_recorder.record("health", f"quarantine/{vid}", misses=h["misses"])
            logger.warning("volume %s QUARANTINED after %d missed heartbeats; placement skips "
                           "it%s", vid, h["misses"],
                           "; auto-repair starting" if self._auto_repair else "")
            # The merged post-mortem of the moment a volume went dark, off
            # the sweep's path. The reference also abandons the volume's
            # drain here (A12's autoscale engine) and re-parents relay trees
            # around it (A11.1); neither is ported.
            spawn_logged(self._dump_flight(f"quarantine:{vid}"), name="controller.flight_dump",
                         tasks=self._health_tasks, log=logger)
            if self._auto_repair:
                self._start_auto_repair(vid)
        if changed:
            # The reference also pushes the quarantine set to its index
            # shards here (A10); this index lives in the controller.
            self._bump_epoch()

    async def _dump_flight(self, trigger: str) -> Optional[str]:
        """A merged post-mortem: this controller's ring and that of every
        volume that answers within FLIGHT_FETCH_S (the one the trigger is
        about usually does not). Never fails the fleet."""

        async def one(vid: str, ref: ActorRef) -> list:
            try:
                events = await asyncio.wait_for(ref.flight_record.call_one(),
                                                timeout=FLIGHT_FETCH_S)
            except Exception:  # noqa: BLE001 - unreachable: its ring is lost
                return []
            for event in events:
                event.setdefault("process", f"volume:{vid}")
            return events

        gathered = await asyncio.gather(*(one(v, r) for v, r in self.volume_refs.items()))
        return obs_recorder.dump_postmortem(trigger, [e for es in gathered for e in es])

    def _start_auto_repair(self, volume_id: str) -> None:
        if volume_id in self._repairing:
            return
        self._repairing.add(volume_id)
        obs_recorder.record("health", f"auto_repair/{volume_id}")
        spawn_logged(self._auto_repair_volume(volume_id), name="controller.auto_repair",
                     tasks=self._health_tasks, log=logger)

    async def _auto_repair_volume(self, volume_id: str) -> None:
        """Copy every key the quarantined volume held that keeps a healthy
        copy onto healthy volumes (``IndexCore.auto_repair_pass``)."""
        try:
            healthy = [vid for vid, h in self._vol_health.items()
                       if h["state"] == "ok" and vid in self.volume_refs]
            started, t0 = time.time(), time.monotonic()
            report = await self.core.auto_repair_pass(volume_id, healthy)
            report.update(started_at=started, wall_s=time.monotonic() - t0)
            self._repair_reports[volume_id] = report
            obs_recorder.record("health", f"auto_repaired/{volume_id}", keys=report["keys"],
                                nbytes=report["bytes"], skipped_moved=report["skipped_moved"])
            if report["keys"]:
                logger.warning("auto-repair of quarantined volume %s: re-replicated %d key(s) "
                               "(%d bytes) onto healthy volumes", volume_id, report["keys"],
                               report["bytes"])
        finally:
            self._repairing.discard(volume_id)

    @endpoint
    async def volume_health(self) -> dict[str, dict]:
        """The supervisor's view: {volume_id: {"state": ok | probation |
        quarantined, "misses", "oks"}}."""
        return {vid: dict(h) for vid, h in self._vol_health.items()}

    @endpoint
    async def replace_volume(self, volume_id: str, new_ref: ActorRef,
                             hostname: str) -> dict[str, Any]:
        """Swap a fresh volume in for the dead ``volume_id`` (repair). Its
        index entries are detached (the replacement starts empty); returns
        what it held: ``recoverable`` {key: [TensorSlice, ...] or None (a
        whole value)} that another volume still serves, and ``lost``, the
        keys with no copy left (now out of the index, so reads fail loudly
        as missing). The reference also swaps the ref into its index shards
        (A10)."""
        if volume_id not in self.volume_refs:
            raise ValueError(f"unknown volume {volume_id!r}")
        self.volume_refs[volume_id] = new_ref
        self.volume_hostnames[volume_id] = hostname
        result = await self.core.detach_volume(volume_id)
        # A fresh process: the supervisor judges it from scratch.
        self._vol_health[volume_id] = {"state": "ok", "misses": 0, "oks": 0}
        _VOLUME_HEALTH.set(1, volume=volume_id)
        self._bump_epoch()
        return result

    # ---- fault injection --------------------------------------------------

    @endpoint
    async def inject_fault(
        self,
        name: str,
        action: str,
        count: Optional[int] = None,
        prob: Optional[float] = None,
        delay_ms: Optional[float] = None,
    ) -> dict:
        """Arm a fault point inside the controller's process (``faults.py``)."""
        return faults.arm(name, action, count=count, prob=prob, delay_ms=delay_ms)

    @endpoint
    async def clear_faults(self, name: Optional[str] = None) -> int:
        return faults.disarm(name)

    @endpoint
    async def list_faults(self) -> list:
        return faults.armed()

    # ---- prewarm capacity reservations ----------------------------------------

    def _outstanding_prewarm(self) -> dict[str, int]:
        outstanding: dict[str, int] = {}
        for _, grants in self._prewarm_reservations.values():
            for vid, nbytes in grants.items():
                outstanding[vid] = outstanding.get(vid, 0) + nbytes
        return outstanding

    def _expire_prewarm(self) -> None:
        """Drop reservations past their TTL and set the reserved-bytes gauge
        of every volume."""
        now = time.monotonic()
        for rid in [r for r, (expiry, _) in self._prewarm_reservations.items() if expiry <= now]:
            del self._prewarm_reservations[rid]
        outstanding = {vid: 0 for vid in self.volume_refs}
        outstanding.update(self._outstanding_prewarm())
        for vid, nbytes in outstanding.items():
            _PREWARM_RESERVED.set(nbytes, volume=vid)

    @endpoint
    async def reserve_prewarm(self, reservation_id: str, asks: dict[str, int],
                              ttl_s: float = 120.0, config=None) -> dict[str, Any]:
        """Grant tmpfs capacity to a prewarm: per asked volume ``min(ask,
        headroom - outstanding grants)``, the headroom the smaller of the
        pool cap's room (per volume) and /dev/shm's free bytes (per host:
        co-located volumes share one tmpfs, so their grants are netted
        against one budget). ``config`` (the prewarming client's) rides to
        the volumes' capacity views. An unreachable volume grants 0 and is
        named in ``errors``. Returns ``{"grants": {vid: bytes}, "errors":
        {vid: reason}}``."""
        self._expire_prewarm()
        outstanding = self._outstanding_prewarm()
        # A placeholder at the full ask before the capacity RPCs: endpoints
        # run concurrently, and two reservers computing headroom against
        # the same outstanding set would both be granted it. Pessimistic (a
        # concurrent peer may be under-granted); replaced by the grants.
        self._prewarm_reservations[reservation_id] = (
            time.monotonic() + ttl_s, {vid: int(n) for vid, n in asks.items()})

        async def capacity(vid: str):
            ref = self.volume_refs.get(vid)
            if ref is None:
                return vid, None, "unknown volume"
            try:
                info = await asyncio.wait_for(ref.shm_capacity.call_one(config),
                                              timeout=CAPACITY_RPC_S)
                return vid, info, None
            except Exception as exc:  # noqa: BLE001 - reported, not raised
                return vid, None, f"{type(exc).__name__}: {exc}"

        try:
            results = await asyncio.gather(*(capacity(vid) for vid in sorted(asks)))
        except BaseException:
            self._prewarm_reservations.pop(reservation_id, None)
            raise
        host_of = lambda vid: self.volume_hostnames.get(vid, vid)  # noqa: E731
        host_budget: dict[str, int] = {}
        for vid, info, _ in results:
            if info is not None and info.get("shm"):
                avail = int(info["available_bytes"])
                host = host_of(vid)
                host_budget[host] = min(host_budget.get(host, avail), avail)
        for vid, nbytes in outstanding.items():
            if host_of(vid) in host_budget:
                host_budget[host_of(vid)] = max(0, host_budget[host_of(vid)] - nbytes)
        granted: dict[str, int] = {}
        errors: dict[str, str] = {}
        for vid, info, err in results:
            if info is None or not info.get("shm"):
                granted[vid] = 0
                errors[vid] = err or "shm unavailable on volume"
                continue
            cap_room = max(0, int(info["pool_cap"]) - int(info["pool_bytes"]))
            cap_room -= outstanding.get(vid, 0)
            grant = max(0, min(int(asks[vid]), cap_room, host_budget.get(host_of(vid), 0)))
            host_budget[host_of(vid)] = host_budget.get(host_of(vid), 0) - grant
            granted[vid] = grant
        self._prewarm_reservations[reservation_id] = (time.monotonic() + ttl_s, dict(granted))
        self._expire_prewarm()
        return {"grants": granted, "errors": errors}

    @endpoint
    async def release_prewarm(self, reservation_id: str) -> None:
        """Drop a reservation once its provisioning landed (the pool holds
        the bytes now) or was abandoned. Idempotent."""
        self._prewarm_reservations.pop(reservation_id, None)
        self._expire_prewarm()

    @endpoint
    async def teardown(self) -> None:
        """Reset every volume and forget the index and the leases."""
        if self._tier_task is not None:
            self._tier_task.cancel()
            self._tier_task = None
        for task in list(self._health_tasks):
            task.cancel()
        self._health_task = None
        self._health_tasks.clear()
        self._repairing.clear()
        self._leases.clear()
        self._prewarm_reservations.clear()
        self._expire_prewarm()  # the reserved-bytes gauges read 0 too
        results = await asyncio.gather(
            *(ref.reset.call_one() for ref in self.volume_refs.values()),
            return_exceptions=True,
        )
        for vid, res in zip(self.volume_refs, results):
            if isinstance(res, BaseException):
                logger.warning("volume %s reset failed at teardown: %r", vid, res)
        keys = list(self.core.index)
        self.core.teardown()
        self._streams.clear()
        self._bump_epoch()
        await self.core.bump(keys)
