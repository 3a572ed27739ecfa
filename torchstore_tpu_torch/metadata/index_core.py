"""The controller's key -> volume index.

Port of ``torchstore_tpu/metadata/index_core.py``: which volumes hold each
key and what they hold (a whole tensor, an object, or the shards of a
sharded tensor by mesh coordinate), commit tracking for sharded keys,
structural-change tracking for the placement epoch, deletes, and per-key
update generations with a condition the blocking waits sleep on. Each
replica carries its capacity tier (resident, or spilled to its volume's
disk); a fresh put resets it to resident, and a tier flip is metadata only,
never structural. ``catalog`` is the per-channel version inventory, and
``reindex`` rebuilds the index from volume manifests (``resolve_manifests``).

Replication and repair: a detached replica (its landing failed, a full
overwrite superseded it, or a new layout dropped it) keeps its old bytes,
unindexed; the core schedules a reclaim of them, drained per volume in the
background under ``config.reclaim_policy()`` and conditional on the write
generation the copy was detached at (``delete_batch_if``), so an
acknowledged put that lands meanwhile is never destroyed. ``locate`` leaves
out quarantined replicas while the healthy ones cover the key.
``auto_repair_pass`` copies a quarantined volume's keys volume to volume
(``pull_from``) onto healthy volumes, and ``detach_volume`` drops a replaced
volume's entries. The host (the controller) provides ``volume_refs``,
``volume_hostnames`` and ``quarantined_ids()``. The stamped publication of
the index (A10) and ``migrate_key`` / ``export_entries`` (A12's control
loop, A10's shards) are not ported.
"""

from __future__ import annotations

import asyncio
import math
import secrets
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

from torchstore_tpu_torch import tiering
from torchstore_tpu_torch.config import reclaim_policy
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.storage_utils.trie import Trie
from torchstore_tpu_torch.transport.buffers import transfer_timeout
from torchstore_tpu_torch.transport.types import Request, TensorMeta, TensorSlice
from torchstore_tpu_torch.utils import spawn_logged

logger = get_logger("torchstore_tpu_torch.metadata")

_PENDING_RECLAIMS = obs_metrics.gauge(
    "ts_controller_pending_reclaims",
    "Stale-replica reclaims not yet drained, per volume",
)
_RECLAIMED = obs_metrics.counter(
    "ts_controller_reclaimed_keys_total",
    "Stale copies deleted by the background reclaim",
)
_AUTO_REPAIRS = obs_metrics.counter(
    "ts_auto_repairs_total",
    "Keys re-replicated automatically after a quarantine",
)
# Keys one pull_from RPC of auto-repair moves at most.
REPAIR_BATCH_KEYS = 64


class ObjectType(Enum):
    OBJECT = "object"
    TENSOR = "tensor"
    TENSOR_SLICE = "tensor_slice"


def _object_type(meta: Request) -> ObjectType:
    if meta.is_object:
        return ObjectType.OBJECT
    if meta.tensor_slice is not None:
        return ObjectType.TENSOR_SLICE
    return ObjectType.TENSOR


class StoreKeyError(KeyError):
    pass


class PartiallyCommittedError(KeyError):
    pass


@dataclass
class StorageInfo:
    """What one volume holds for one key."""

    object_type: ObjectType
    tensor_meta: Optional[TensorMeta] = None
    # coordinates -> TensorSlice, for TENSOR_SLICE keys.
    tensor_slices: dict[tuple, TensorSlice] = field(default_factory=dict)
    # The volume's write generation of the last indexed put (0: unknown).
    write_gen: int = 0
    # Capacity tier of this replica's bytes: tiering.RESIDENT (memory) or
    # tiering.TIERED (on the volume's disk; the next get faults it in).
    tier: str = tiering.RESIDENT
    # The write generation of an auto-repair copy indexed here (0: none);
    # a put's notify that lands under it finds its bytes replaced.
    pulled_gen: int = 0

    @classmethod
    def from_meta(cls, meta: Request) -> "StorageInfo":
        info = cls(object_type=_object_type(meta), tensor_meta=meta.tensor_meta)
        if meta.tensor_slice is not None:
            info.tensor_slices[meta.tensor_slice.coordinates] = meta.tensor_slice
        return info


def resolve_manifests(
    per_volume: list[tuple[str, list]],
) -> tuple[list[tuple[str, Request, int]], int]:
    """(volume id, meta, write generation) entries to index from volume
    manifests, keeping only the newest layout (by file mtime) of a key whose
    shards disagree on mesh, global shape or dtype (a crash mid re-shard).
    Returns (survivors, how many were dropped). Bare ``Request`` items
    count as mtime 0 and generation 0."""
    entries: list[tuple[str, Request, Optional[tuple], int]] = []
    layouts: dict[str, dict[tuple, float]] = {}  # key -> layout -> newest mtime
    for vid, manifest in per_volume:
        for item in manifest:
            if isinstance(item, dict):
                meta, mtime, gen = item["meta"], item.get("mtime", 0.0), item.get("write_gen", 0)
            else:
                meta, mtime, gen = item, 0.0, 0
            sig = None
            if meta.tensor_slice is not None:
                ts = meta.tensor_slice
                sig = (ts.mesh_shape, ts.global_shape,
                       meta.tensor_meta.dtype if meta.tensor_meta else None)
                sigs = layouts.setdefault(meta.key, {})
                sigs[sig] = max(sigs.get(sig, 0.0), mtime)
            entries.append((vid, meta, sig, gen))
    winners = {key: max(sigs, key=sigs.get) for key, sigs in layouts.items() if len(sigs) > 1}
    survivors: list[tuple[str, Request, int]] = []
    dropped = 0
    for vid, meta, sig, gen in entries:
        if sig is not None and meta.key in winners and sig != winners[meta.key]:
            dropped += 1
            continue
        survivors.append((vid, meta, gen))
    return survivors, dropped


def _layout(meta: Request) -> tuple:
    """What a re-put must keep for an entry to stay: its kind and, for a
    shard, the mesh and global shape."""
    ts = meta.tensor_slice
    if ts is None:
        return (_object_type(meta),)
    return (ObjectType.TENSOR_SLICE, ts.mesh_shape, ts.global_shape)


def _info_layout(info: StorageInfo) -> tuple:
    if info.object_type != ObjectType.TENSOR_SLICE:
        return (info.object_type,)
    ts = next(iter(info.tensor_slices.values()))
    return (ObjectType.TENSOR_SLICE, ts.mesh_shape, ts.global_shape)


class IndexCore:
    def __init__(self, host: Any = None) -> None:
        # The controller: ``volume_refs``, ``volume_hostnames`` and
        # ``quarantined_ids()`` (read at each use: repair swaps refs).
        self.host = host
        self.index: Trie = Trie()  # key -> {volume_id: StorageInfo}
        self.counters = {"puts": 0, "put_bytes": 0, "locates": 0, "deletes": 0}
        # Bumped on every indexed put or delete of a key; the condition is
        # notified with every bump.
        self._key_gens: dict[str, int] = {}
        self._update_cond: Optional[asyncio.Condition] = None
        # Reclaims of stale copies on detached replicas: {key: the write
        # generation the copy was detached at (-1: unknown, resolved on the
        # volume)} per volume, drained by one task per volume.
        self._pending_reclaims: dict[str, dict[str, int]] = {}
        self._reclaim_running: set[str] = set()
        self._reclaim_tasks: set = set()

    def cond(self) -> asyncio.Condition:
        if self._update_cond is None:
            self._update_cond = asyncio.Condition()
        return self._update_cond

    async def bump(self, keys) -> None:
        async with self.cond():
            self.bump_locked(keys)

    def bump_locked(self, keys) -> None:
        """``bump`` for a caller that holds the condition already: the
        notify that commits a put and the watermark step of a streamed
        publish share one hold of it."""
        for key in keys:
            self._key_gens[key] = self._key_gens.get(key, 0) + 1
        self.cond().notify_all()

    def contains(self, key: str) -> str:
        """'missing', 'partial' or 'committed'."""
        infos = self.index.get(key)
        return "missing" if infos is None else self.committed_state(infos)

    async def wait_for_committed(self, keys: list[str], timeout: Optional[float] = None) -> None:
        """Return once every key exists and is committed; ``TimeoutError``
        naming the keys still missing or partial otherwise."""
        cond = self.cond()

        def pending() -> list[str]:
            return [k for k in keys if self.contains(k) != "committed"]

        async with cond:
            try:
                await asyncio.wait_for(cond.wait_for(lambda: not pending()), timeout)
            except asyncio.TimeoutError:
                raise TimeoutError(
                    f"wait_for_committed timed out after {timeout}s; still "
                    f"missing/partial: {pending()[:5]}"
                ) from None

    async def wait_for_change(
        self, key: str, last_gen: int = 0, timeout: Optional[float] = None
    ) -> dict[str, Any]:
        """Return ``{"gen", "state"}`` once ``key``'s update generation
        differs from ``last_gen``: with 0, at once for any key ever written.
        Inequality, not ">": a restarted index counts from scratch, and a
        subscriber holding a larger generation must wake."""
        cond = self.cond()
        async with cond:
            try:
                await asyncio.wait_for(
                    cond.wait_for(lambda: self._key_gens.get(key, 0) != last_gen), timeout
                )
            except asyncio.TimeoutError:
                raise TimeoutError(
                    f"wait_for_change({key!r}) timed out after {timeout}s at "
                    f"generation {self._key_gens.get(key, 0)}"
                ) from None
            return {"gen": self._key_gens.get(key, 0), "state": self.contains(key)}

    def summary(self) -> dict:
        """The index half of the controller's ``stats``."""
        indexed_bytes = 0
        sharded_keys = 0
        for infos in self.index.values():
            sharded = False
            for info in infos.values():
                sharded |= info.object_type == ObjectType.TENSOR_SLICE
                indexed_bytes += self._info_nbytes(info)
            sharded_keys += sharded
        return {
            **self.counters,
            "num_keys": len(self.index),
            "sharded_keys": sharded_keys,
            "indexed_bytes_approx": indexed_bytes,
            "pending_reclaims": {vid: len(keys) for vid, keys in self._pending_reclaims.items()
                                 if keys},
        }

    @staticmethod
    def committed_state(infos: dict[str, StorageInfo]) -> str:
        """'committed' or 'partial' for one key: a sharded key is committed
        once the coordinates stored across its volumes number
        prod(mesh_shape)."""
        any_info = next(iter(infos.values()))
        if any_info.object_type != ObjectType.TENSOR_SLICE:
            return "committed"
        coords: set[tuple] = set()
        for info in infos.values():
            coords.update(info.tensor_slices)
        mesh_shape = next(iter(any_info.tensor_slices.values())).mesh_shape
        return "committed" if len(coords) >= math.prod(mesh_shape) else "partial"

    @staticmethod
    def covers(subset: dict[str, StorageInfo], full: dict[str, StorageInfo]) -> bool:
        """Whether ``subset``'s replicas serve all that ``full``'s do: any
        replica of a whole tensor or object; the union of coordinates of a
        sharded key."""
        if next(iter(full.values())).object_type != ObjectType.TENSOR_SLICE:
            return True
        have = {c for info in subset.values() for c in info.tensor_slices}
        return have >= {c for info in full.values() for c in info.tensor_slices}

    def _quarantined(self) -> set:
        return self.host.quarantined_ids() if self.host is not None else set()

    def serving_infos(
        self, infos: dict[str, StorageInfo], quarantined: set
    ) -> dict[str, StorageInfo]:
        """The replicas a locate reports: quarantined ones are left out
        while the healthy ones alone cover the key. A quarantined volume
        holding the only copy stays listed, so the reader meets the real
        failure rather than a missing key."""
        if quarantined and any(vid in quarantined for vid in infos):
            healthy = {vid: i for vid, i in infos.items() if vid not in quarantined}
            if healthy and self.covers(healthy, infos):
                return healthy
        return infos

    def locate(
        self, keys: list[str], missing_ok: bool = False, require_committed: bool = True
    ) -> dict[str, dict[str, StorageInfo]]:
        self.counters["locates"] += 1
        quarantined = self._quarantined()
        out: dict[str, dict[str, StorageInfo]] = {}
        for key in keys:
            infos = self.index.get(key)
            if infos is None:
                if missing_ok:
                    continue
                raise StoreKeyError(f"Key {key!r} not found in store")
            if require_committed and self.committed_state(infos) == "partial":
                raise PartiallyCommittedError(
                    f"Key {key!r} is only partially committed; not all mesh "
                    "coordinates have been stored yet"
                )
            out[key] = self.serving_infos(infos, quarantined)
        return out

    def count_prefix(self, prefix: str) -> int:
        """Keys under ``prefix`` by whole segments ("c/v1" never counts
        "c/v10/...")."""
        return sum(1 for _ in self.index.keys().filter_by_prefix(prefix))

    def keys_list(self, prefix: Optional[str] = None) -> list[str]:
        """Every key, or those under ``prefix`` by whole path segments
        ("a/b" holds "a/b" and "a/b/c", not "a/bc"), as the reference's
        trie matches them."""
        if prefix is None:
            return sorted(self.index)
        return sorted(self.index.keys().filter_by_prefix(prefix))

    def apply_put_batch(
        self,
        metas: list[Request],
        volume_ids: list[str],
        detach_volume_ids: Optional[list[str]] = None,
        write_gens: Optional[dict[str, dict[str, int]]] = None,
        supersede: bool = False,
    ) -> bool:
        """Index ``metas`` as stored on every id in ``volume_ids`` (with
        each volume's write generation, when given), and drop them from
        ``detach_volume_ids`` (replicas whose landing failed: they hold the
        old bytes, or a partial landing). ``supersede``: a full overwrite,
        so any other volume indexed for the same meta (an auto-repair copy,
        an earlier placement) holds superseded bytes and is detached too.
        A put under another kind or layout (mesh or global shape) replaces
        the key's entry on every volume: stale shards must neither satisfy
        the commit check nor be served beside new ones. Every copy dropped
        so gets a conditional reclaim at the generation it was indexed at.
        Returns True when the placement changed structurally (a new key,
        replica or shard coordinate, a new shape or dtype under an old key,
        a new layout, a detached replica)."""
        structural = bool(detach_volume_ids)
        stale_gens: dict[str, dict[str, int]] = {}
        for meta in metas:
            if meta.tensor_val is not None or meta.objects is not None:
                raise ValueError(
                    "controller must never receive data payloads; send meta_only() requests"
                )
            self.counters["puts"] += 1
            if meta.tensor_meta is not None:
                self.counters["put_bytes"] += meta.tensor_meta.nbytes
            infos = self.index.get(meta.key)
            pre_gens = {vid: info.write_gen for vid, info in (infos or {}).items()}
            if infos is not None and any(
                _info_layout(info) != _layout(meta) for info in infos.values()
            ):
                # The old layout's copies on volumes this put does not land
                # on stay behind, unindexed: reclaim them (the volumes this
                # put lands on drop theirs as it lands).
                for vid, gen in pre_gens.items():
                    if vid not in volume_ids:
                        stale_gens.setdefault(vid, {})[meta.key] = gen
                infos = None
            if infos is None:
                infos = self.index[meta.key] = {}
                structural = True
            for vid in volume_ids:
                gen = (write_gens or {}).get(vid, {}).get(meta.key, 0)
                old = infos.get(vid)
                if meta.tensor_slice is None and old is not None and gen and old.pulled_gen > gen:
                    # An auto-repair pull stored its copy here after this
                    # put landed (its read of the source came before the
                    # put reached it): the volume holds the pull's bytes,
                    # not this put's. Detach it; the pulled copy is
                    # reclaimed.
                    stale_gens.setdefault(vid, {})[meta.key] = old.pulled_gen
                    del infos[vid]
                    structural = True
                    continue
                if meta.tensor_slice is None:
                    new = StorageInfo.from_meta(meta)
                    new.write_gen = gen
                    if old is None or old.tensor_meta != new.tensor_meta:
                        structural = True
                    infos[vid] = new
                    continue
                if old is None:
                    old = infos[vid] = StorageInfo(ObjectType.TENSOR_SLICE)
                coords = meta.tensor_slice.coordinates
                if old.tensor_slices.get(coords) != meta.tensor_slice:
                    structural = True
                old.tensor_slices[coords] = meta.tensor_slice
                old.tensor_meta = meta.tensor_meta
                old.write_gen = max(old.write_gen, gen)
                # Fresh bytes land resident (the volume drops a stale disk copy).
                old.tier = tiering.RESIDENT
            for vid in detach_volume_ids or ():
                # The detached copy's generation is the newest a reclaim may
                # delete; a volume never indexed for the key may still hold
                # a partial landing: -1, resolved on the volume.
                prev = infos.get(vid)
                gen = prev.write_gen if prev is not None else pre_gens.get(vid, -1)
                stale = stale_gens.setdefault(vid, {})
                stale[meta.key] = max(stale.get(meta.key, gen), gen)
                self.detach_meta(meta, vid)
            if supersede:
                for vid in [v for v in list(infos) if v not in volume_ids]:
                    prev = infos[vid]
                    if meta.tensor_slice is not None and (
                        meta.tensor_slice.coordinates not in prev.tensor_slices
                    ):
                        continue  # it holds other shards only
                    stale_gens.setdefault(vid, {})[meta.key] = prev.write_gen
                    self.detach_meta(meta, vid)
                    structural = True
            if not infos:
                self.index.pop(meta.key, None)  # its one copy was a pull's
        for vid, keys in stale_gens.items():
            self.schedule_reclaim(vid, keys)
        return structural

    def detach_meta(self, meta: Request, volume_id: str) -> None:
        """Remove one meta's footprint on ``volume_id``: its coordinates for
        a shard (the volume's other shards stay), the whole entry else. A
        key with no volume left leaves the index."""
        infos = self.index.get(meta.key)
        if infos is None or volume_id not in infos:
            return
        info = infos[volume_id]
        if meta.tensor_slice is not None and info.object_type == ObjectType.TENSOR_SLICE:
            info.tensor_slices.pop(meta.tensor_slice.coordinates, None)
            if info.tensor_slices:
                return
        del infos[volume_id]
        if not infos:
            del self.index[meta.key]

    def delete_keys(self, keys: list[str]) -> dict[str, list[str]]:
        """Remove keys from the index; returns which volumes held each key
        so the caller can clear the data plane. Idempotent."""
        by_volume: dict[str, list[str]] = {}
        for key in keys:
            infos = self.index.pop(key, None)
            if infos is None:
                continue
            self.counters["deletes"] += 1
            for vid in infos:
                by_volume.setdefault(vid, []).append(key)
        return by_volume

    def set_tiers(self, volume_id: str, spilled: list[str], fault_ins: list[str]) -> None:
        """Fold one volume's reported spills and fault-ins into its replicas'
        tiers. Metadata only, not structural: cached plans stay valid, and a
        get of a spilled key faults it in on the volume."""
        for keys, tier in ((spilled, tiering.TIERED), (fault_ins, tiering.RESIDENT)):
            for key in keys:
                infos = self.index.get(key)
                if infos is not None and volume_id in infos:
                    infos[volume_id].tier = tier

    async def reindex(self, survivors: list[tuple[str, Request, int]]) -> int:
        """Rebuild the index from resolved volume manifests (durable
        recovery); returns the entries indexed. Every recovered key's update
        generation is seeded at one random large offset: a subscriber that
        outlived the restart holds an old generation, and ``wait_for_change``
        wakes on inequality, so small seeds could equal exactly the one it
        last saw and block it."""
        count = 0
        for vid, meta, gen in survivors:
            infos = self.index.get(meta.key)
            if infos is None:
                infos = self.index[meta.key] = {}
            info = infos.get(vid)
            if info is None:
                info = infos[vid] = StorageInfo.from_meta(meta)
            elif meta.tensor_slice is not None:
                info.tensor_slices[meta.tensor_slice.coordinates] = meta.tensor_slice
            info.write_gen = max(info.write_gen, gen)
            count += 1
        offset = secrets.randbits(46) | (1 << 45)
        async with self.cond():
            for key in self.index:
                self._key_gens[key] = offset
            self.cond().notify_all()
        return count

    def catalog(self, channel: Optional[str] = None) -> dict[str, dict[int, dict]]:
        """The per-channel version inventory: for each "{channel}/v{n}"
        group, its keys, logical bytes (one replica's), volumes, and the
        tier split (a key counts resident while any replica serves it from
        memory). Leases are the controller's and are folded in there."""
        out: dict[str, dict[int, dict]] = {}
        for key, infos in self.index.items():
            group = tiering.version_group(key)
            if group is None or not infos:
                continue
            chan, ver = group
            if channel is not None and chan != channel:
                continue
            rec = out.setdefault(chan, {}).setdefault(ver, {
                "keys": 0, "bytes": 0, "resident_keys": 0, "spilled_keys": 0,
                "volumes": set(), "leases": [],
            })
            rec["keys"] += 1
            rec["bytes"] += self._info_nbytes(next(iter(infos.values())))
            if any(i.tier != tiering.TIERED for i in infos.values()):
                rec["resident_keys"] += 1
            else:
                rec["spilled_keys"] += 1
            rec["volumes"].update(infos)
        return out

    # ---- reclaims of stale copies ------------------------------------------

    def schedule_reclaim(self, volume_id: str, keys: dict[str, int]) -> None:
        """``keys``: {key: the write generation of the copy just detached,
        the newest bytes the reclaim may delete (-1: unknown)}. One drainer
        per volume picks up keys added while it runs."""
        pending = self._pending_reclaims.setdefault(volume_id, {})
        for key, gen in keys.items():
            pending[key] = max(pending[key], gen) if key in pending else gen
        _PENDING_RECLAIMS.set(len(pending), volume=volume_id)
        if volume_id in self._reclaim_running:
            return
        self._reclaim_running.add(volume_id)
        spawn_logged(self._reclaim_detached(volume_id), name="controller.reclaim",
                     tasks=self._reclaim_tasks, log=logger)

    async def _reclaim_detached(self, volume_id: str) -> None:
        """Drain the volume's pending stale keys once it answers. A key
        indexed on the volume again meanwhile is skipped (fresh bytes landed
        there). The delete is conditional on the stale generation: a put
        that landed after the detach raised the volume's generation, so the
        volume keeps its bytes and reports them fresh; a kept generation is
        requeued, so bytes whose notify never comes (their client died) go
        on a later round. Keys at -1 (a partial landing the controller
        never indexed) take two phases: the volume's current generation is
        read first, then exactly those bytes are deleted. A completed delete
        of a key the index meanwhile claims for this volume detaches that
        entry (``_reconcile_clobbered``)."""
        try:
            policy = reclaim_policy()
            deadline = policy.start()
            attempt = 0
            while policy.should_retry(attempt, deadline):
                await asyncio.sleep(policy.backoff(attempt))
                attempt += 1
                ref = self.host.volume_refs.get(volume_id) if self.host is not None else None
                pending = self._pending_reclaims.get(volume_id)
                if ref is None or not pending:
                    return
                batch = {k: g for k, g in pending.items()
                         if volume_id not in self.index.get(k, {})}
                for key in list(pending):
                    if key not in batch:
                        del pending[key]  # indexed here again: done
                if not batch:
                    return
                unknown = sorted(k for k, g in batch.items() if g < 0)
                try:
                    if unknown:
                        observed = await ref.write_gens.call_one(unknown)
                        for key in unknown:
                            if key in observed:
                                batch[key] = observed[key]
                            # Absent keys stay at -1: bytes with no recorded
                            # generation (a durable volume restarted) are
                            # stale, and delete_batch_if deletes them.
                        for key in list(batch):
                            if volume_id in self.index.get(key, {}):
                                del batch[key]  # indexed while we read
                        if not batch:
                            continue
                    result = await ref.delete_batch_if.call_one(sorted(batch.items()))
                except Exception:  # noqa: BLE001 - still unreachable: next round
                    continue
                for key, sent in batch.items():
                    # A newer stale generation scheduled during the RPC stays.
                    if pending.get(key) in (sent, -1):
                        pending.pop(key, None)
                for key, gen in result.get("kept_gens", {}).items():
                    pending[key] = max(pending.get(key, 0), gen)
                if result["kept_fresh"]:
                    logger.info("reclaim on volume %s kept %d key(s) with fresh bytes (%s); "
                                "checking again next round", volume_id,
                                len(result["kept_fresh"]), result["kept_fresh"][:3])
                await self._reconcile_clobbered(volume_id, result["removed"])
                _RECLAIMED.inc(len(result["removed"]))
                _PENDING_RECLAIMS.set(len(pending), volume=volume_id)
                logger.info("reclaimed %d stale key(s) on volume %s",
                            len(result["removed"]), volume_id)
                if not pending:
                    return
            left = self._pending_reclaims.get(volume_id) or ()
            if left:
                logger.warning("gave up reclaiming %d stale key(s) on volume %s (unreachable)",
                               len(left), volume_id)
        finally:
            self._reclaim_running.discard(volume_id)
            self._pending_reclaims.pop(volume_id, None)
            _PENDING_RECLAIMS.set(0, volume=volume_id)

    async def _reconcile_clobbered(self, volume_id: str, removed: list[str]) -> None:
        """A reclaimed key the index now claims for this volume lost a racing
        put's bytes before its notify indexed them: detach the entry, so
        readers fail over (or fail loudly) instead of reading missing bytes;
        the next publish restores the redundancy."""
        clobbered = []
        for key in removed:
            infos = self.index.get(key)
            if infos is not None and volume_id in infos:
                del infos[volume_id]
                if not infos:
                    del self.index[key]
                clobbered.append(key)
        if clobbered:
            logger.warning("reclaim raced a fresh put on volume %s: detached %d re-indexed "
                           "key(s) it deleted (%s); redundancy degraded until the next publish",
                           volume_id, len(clobbered), clobbered[:3])
            await self.bump(set(clobbered))

    # ---- repair --------------------------------------------------------------

    def merge_copies(self, volume_id: str, metas: list[Request],
                     write_gens: dict[str, int]) -> set:
        """Index freshly pulled copies of ``metas`` on ``volume_id``; a key
        deleted meanwhile is never indexed again. Returns the keys touched
        (a new replica: structural, the caller bumps)."""
        touched = set()
        for meta in metas:
            infos = self.index.get(meta.key)
            if infos is None:
                continue
            self._merge(infos, volume_id, meta)
            info = infos[volume_id]
            info.write_gen = max(info.write_gen, write_gens.get(meta.key, 0))
            info.pulled_gen = max(info.pulled_gen, write_gens.get(meta.key, 0))
            touched.add(meta.key)
        return touched

    @staticmethod
    def _merge(infos: dict[str, StorageInfo], volume_id: str, meta: Request) -> None:
        info = infos.get(volume_id)
        if info is None:
            infos[volume_id] = StorageInfo.from_meta(meta)
            return
        if meta.tensor_slice is not None:
            info.tensor_slices[meta.tensor_slice.coordinates] = meta.tensor_slice
        if meta.tensor_meta is not None:
            info.tensor_meta = meta.tensor_meta

    async def auto_repair_pass(self, volume_id: str, healthy: list[str]) -> dict:
        """Copy every key the quarantined ``volume_id`` held that keeps a
        healthy copy onto a healthy volume without one, volume to volume
        (``pull_from``, in batches of ``REPAIR_BATCH_KEYS``), with no client
        involved. A key whose only copy was there is left to ``repair()``.
        A key overwritten or deleted while its copy was in flight (its
        source's write generation moved) is not indexed: the extra copy is
        reclaimed on the target instead, so a repaired replica never serves
        stale bytes under fresh metadata. A key a put wrote on the target
        while the pull read it comes back ``moved`` (the target kept the
        put's bytes): neither indexed nor reclaimed. A put that reached
        the target before the pull's snapshot had its bytes replaced by
        the pull's: its entry there is detached and the copy reclaimed,
        here when its notify came first, in ``apply_put_batch``
        (``pulled_gen``) when it comes later. Returns ``{"keys",
        "bytes", "seconds", "alloc_s", "rungs", "skipped_moved"}``: keys and
        bytes indexed, seconds in the pulls and the part of them spent
        making segments, pulls by rung, keys the target kept a put's bytes
        for."""
        out = {"keys": 0, "bytes": 0, "seconds": 0.0, "alloc_s": 0.0, "rungs": {},
               "skipped_moved": 0}
        if not healthy:
            return out
        plan: dict[tuple[str, str], list] = {}
        rr = 0
        for key in list(self.index):
            infos = self.index.get(key)
            if infos is None or volume_id not in infos:
                continue
            lost = infos[volume_id]
            src = None
            for cand in (v for v in healthy if v in infos):
                have = infos[cand]
                if have.object_type != lost.object_type:
                    continue
                if lost.object_type == ObjectType.TENSOR_SLICE and not (
                    set(lost.tensor_slices) <= set(have.tensor_slices)
                ):
                    continue  # the survivor lacks some of the lost shards
                src = cand
                break
            targets = sorted(v for v in healthy if v not in infos)
            if src is None or not targets:
                continue
            tgt = targets[rr % len(targets)]
            rr += 1
            plan.setdefault((src, tgt), []).append(
                (key, self._info_metas(key, lost), infos[src].write_gen,
                 self._info_nbytes(lost)))
        loop = asyncio.get_running_loop()
        for (src, tgt), items in plan.items():
            src_ref = self.host.volume_refs.get(src)
            tgt_ref = self.host.volume_refs.get(tgt)
            if src_ref is None or tgt_ref is None:
                continue
            for i in range(0, len(items), REPAIR_BATCH_KEYS):
                batch = items[i:i + REPAIR_BATCH_KEYS]
                metas = [m for _, ms, _, _ in batch for m in ms]
                pull = tgt_ref.pull_from
                deadline = transfer_timeout(pull.effective_timeout(), sum(b[3] for b in batch))
                t0 = loop.time()
                try:
                    result = await pull.with_timeout(deadline).call_one(
                        src_ref, metas, src_hostname=self.host.volume_hostnames.get(src, ""),
                        src_volume=src)
                except Exception as exc:  # noqa: BLE001 - per batch
                    logger.warning("auto-repair pull %s -> %s failed for %d key(s): %s",
                                   src, tgt, len(batch), exc)
                    continue
                out["seconds"] += loop.time() - t0
                out["alloc_s"] += result.get("alloc_s", 0.0)
                rung = result.get("rung", "rpc")
                out["rungs"][rung] = out["rungs"].get(rung, 0) + 1
                fresh = []
                moved = set(result.get("moved", ()))
                out["skipped_moved"] += len(moved)
                pulled_gens = result.get("write_gens", {})
                overwritten: set = set()
                for key, kmetas, src_gen, nbytes in batch:
                    if key in moved:
                        # A put landed on the target during the read: the
                        # target holds the put's bytes, which its notify
                        # indexes; nothing was stored, nothing to reclaim.
                        continue
                    infos = self.index.get(key)
                    mine = infos.get(tgt) if infos else None
                    if mine is not None:
                        # A put's notify indexed the target meanwhile. Its
                        # landing there came before the pull's snapshot
                        # (else the key had moved), so the pull's store
                        # replaced the put's bytes: detach the entry and
                        # reclaim the pulled copy.
                        if (mine.object_type != ObjectType.TENSOR_SLICE
                                and mine.write_gen < pulled_gens.get(key, 0)):
                            del infos[tgt]
                            if not infos:
                                del self.index[key]
                            self.schedule_reclaim(tgt, {key: pulled_gens[key]})
                            overwritten.add(key)
                        continue
                    cur = infos.get(src) if infos else None
                    if cur is None or cur.write_gen != src_gen:
                        # Overwritten or deleted mid-copy: the pulled bytes
                        # may be stale; reclaim them on the target.
                        self.schedule_reclaim(tgt, {key: -1})
                        continue
                    fresh.extend(kmetas)
                    out["bytes"] += nbytes
                touched = self.merge_copies(tgt, fresh, pulled_gens)
                if overwritten:
                    await self.host.on_structural()
                    await self.bump(overwritten)
                if touched:
                    out["keys"] += len(touched)
                    _AUTO_REPAIRS.inc(len(touched))
                    await self.host.on_structural()
                    await self.bump(touched)
                await asyncio.sleep(0)  # yield between batches
        return out

    @staticmethod
    def _info_metas(key: str, info: StorageInfo) -> list[Request]:
        """Meta-only requests of one replica's footprint."""
        if info.object_type == ObjectType.OBJECT:
            return [Request(key=key, is_object=True)]
        if info.object_type == ObjectType.TENSOR:
            return [Request(key=key, tensor_meta=info.tensor_meta)]
        return [Request(key=key, tensor_slice=ts, tensor_meta=info.tensor_meta)
                for ts in info.tensor_slices.values()]

    @staticmethod
    def _info_nbytes(info: StorageInfo) -> int:
        meta = info.tensor_meta
        if info.object_type == ObjectType.TENSOR_SLICE:
            itemsize = meta.itemsize if meta is not None else 4
            return sum(ts.nelements * itemsize for ts in info.tensor_slices.values())
        return int(meta.nbytes) if meta is not None else 0

    async def detach_volume(self, volume_id: str) -> dict[str, Any]:
        """Drop every entry on ``volume_id`` (its replacement starts empty).
        Returns ``{"recoverable": {key: [TensorSlice, ...] or None (a whole
        value)}, "lost": [keys with no copy left, now out of the index]}``."""
        recoverable: dict[str, Any] = {}
        lost: list[str] = []
        changed = set()
        for key in list(self.index):
            infos = self.index[key]
            info = infos.pop(volume_id, None)
            if info is None:
                continue
            changed.add(key)
            if infos:
                recoverable[key] = (list(info.tensor_slices.values())
                                    if info.object_type == ObjectType.TENSOR_SLICE else None)
            else:
                lost.append(key)
                del self.index[key]
        self._pending_reclaims.pop(volume_id, None)  # the new volume holds nothing stale
        if changed:
            await self.bump(changed)
        return {"recoverable": recoverable, "lost": lost}

    def teardown(self) -> None:
        for task in list(self._reclaim_tasks):
            task.cancel()
        self._reclaim_tasks.clear()
        self._reclaim_running.clear()
        self._pending_reclaims.clear()
        self.index.clear()
