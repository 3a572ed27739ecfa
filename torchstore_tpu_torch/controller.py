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
step as the metadata). The relay, tiering, control, autoscale and mirror
engines of the reference are not part of this port yet. The controller
never sees tensor bytes: only ``Request.meta_only()`` copies.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Optional

from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.metadata.index_core import IndexCore, StorageInfo
from torchstore_tpu_torch.runtime import Actor, ActorRef, endpoint
from torchstore_tpu_torch.transport.types import Request

logger = get_logger("torchstore_tpu_torch.controller")


class Controller(Actor):
    # Stream records kept at once; sealed (idle) records are evicted first.
    MAX_STREAMS = 256
    # Subscriber acks kept per stream record; the oldest go first.
    MAX_STREAM_ACKS = 64

    def __init__(self) -> None:
        self.strategy = None
        self.volume_refs: dict[str, ActorRef] = {}
        self.volume_hostnames: dict[str, str] = {}
        self.core = IndexCore()
        # Bumped on every structural placement change: one cheap RPC lets a
        # consumer validate a whole cached transfer plan.
        self._placement_epoch = 0
        # Stream records of layer-streamed publishes, by state-dict key; dict
        # order is touch recency (see _stream_rec).
        self._streams: dict[str, dict] = {}

    def _bump_epoch(self) -> int:
        self._placement_epoch += 1
        return self._placement_epoch

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
        return {"volume_ids": sorted(self.volume_refs), "hostnames": self.volume_hostnames}

    @endpoint
    async def get_strategy(self):
        return self.strategy

    @endpoint
    async def get_volume_map(self) -> dict[str, dict]:
        return {
            vid: {"ref": ref, "hostname": self.volume_hostnames[vid]}
            for vid, ref in self.volume_refs.items()
        }

    @endpoint
    async def locate_volumes(
        self, keys: list[str], missing_ok: bool = False, require_committed: bool = True
    ) -> dict[str, dict[str, StorageInfo]]:
        """Where each key lives; a sharded key not yet stored at every mesh
        coordinate raises ``PartiallyCommittedError`` unless
        ``require_committed`` is off."""
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
    ) -> int:
        """Index ``metas`` as stored on ``volume_id`` (one id or a list),
        with each volume's write generations, and detach them from
        ``detach_volume_ids`` (replicas whose landing failed); returns the
        placement epoch.

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
        volume_ids = [volume_id] if isinstance(volume_id, str) else list(volume_id)
        async with self.core.cond():
            if unchanged:
                self._check_unchanged(unchanged)  # before anything is indexed
            if self.core.apply_put_batch(metas, volume_ids, detach_volume_ids, write_gens):
                self._bump_epoch()
            if watermark is not None:
                self._apply_watermark(watermark[0], int(watermark[1]), metas, unchanged)
            self.core.bump_locked({m.key for m in metas})
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

    @endpoint
    async def notify_delete_batch(self, keys: list[str]) -> dict[str, list[str]]:
        """Remove keys from the index first (notify-before-delete) and
        return which volumes held each key. Deleting a streamed state
        dict's commit marker (or a stream key itself) retires its stream
        record: pollers wake and see it gone."""
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

    @endpoint
    async def stats(self, include_volumes: bool = False) -> dict:
        """The index summary (op counters, keys, indexed bytes) and the
        volume count; with ``include_volumes`` each volume's ``stats`` too
        (an ``error`` string for one that does not answer)."""
        out = {**self.core.summary(), "num_volumes": len(self.volume_refs)}
        if include_volumes:

            async def one(vid: str, ref: ActorRef):
                try:
                    return vid, await asyncio.wait_for(ref.stats.call_one(), timeout=10.0)
                except Exception as exc:  # noqa: BLE001 - reported inline
                    return vid, {"error": f"{type(exc).__name__}: {exc}"}

            results = await asyncio.gather(*(one(v, r) for v, r in self.volume_refs.items()))
            out["volumes"] = dict(results)
        return out

    @endpoint
    async def teardown(self) -> None:
        """Reset every volume and forget the index."""
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
