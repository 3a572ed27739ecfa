"""Versioned weight channel: the RL weight-sync steady state as one object.

Port of ``torchstore_tpu/weight_channel.py``:

- ``WeightPublisher.publish(sd)`` writes the state dict under
  ``name/v{n}``, then advances the ``name/LATEST`` pointer, then deletes
  the versions beyond the newest ``keep``; ``stream()`` does the same as a
  layer-streamed publish (``stream_sync``), announced on ``name/STREAM``
  before its first layer lands.
- ``WeightSubscriber.acquire()`` blocks until a version newer than the
  last one it returned is committed (woken by the controller's update
  notification, no polling), pulls it (in place into ``user_state_dict``
  targets, resharding as usual) and returns ``(state_dict, version)``;
  ``acquire_streamed()`` serves a streamed publish layer by layer.

``LATEST`` is written only after the version's commit marker, so a
subscriber woken by the pointer always finds a complete state dict. GC
keeps ``keep`` versions, so a subscriber mid-pull on version n is safe
while n+1 publishes (keep >= 2).

Not in this port yet, each raising ``NotImplementedError``: ``register``
(provisioning, ROADMAP A11), the relay (``relay=`` / ``relay_volume=``,
A11) and pinned reads of an older version (``version=``, cohort leases,
A11). Without a lease plane, GC and the reclaim of a crashed publisher's
partial version delete whatever they find stale, as the reference does
when no lease pins a version.
"""

from __future__ import annotations

import secrets
import time
from typing import Any, Optional

from torchstore_tpu_torch import state_dict_utils as sdu
from torchstore_tpu_torch.logging import Counter, Gauge, get_logger
from torchstore_tpu_torch.state_dict_utils import NoMatchingPush

logger = get_logger("torchstore_tpu_torch.weight_channel")

_PUBLISHES = Counter("ts_weight_channel_publishes_total", "Versions published, per channel")
_PUBLISHED_VERSION = Gauge("ts_weight_channel_published_version", "Latest version published")
_ACQUIRED_VERSION = Gauge(
    "ts_weight_channel_acquired_version", "Latest version a subscriber pulled"
)
_VERSION_LAG = Gauge(
    "ts_weight_channel_version_lag",
    "Versions between the channel pointer and what this subscriber last acquired, "
    "measured at wakeup (0 = consuming every publish)",
)
_SKIPPED = Counter(
    "ts_weight_channel_versions_skipped_total",
    "Published versions a subscriber never pulled (lagged past)",
)

_LATEST = "LATEST"
# The announce of an in-flight streamed publish: written when a
# ChannelStream opens, before any layer lands; streaming subscribers wake
# on it.
_STREAM_PTR = "STREAM"


def _version_key(name: str, version: int) -> str:
    return f"{name}/v{version}"


def _parse_pointer(value) -> tuple[int, int]:
    """(version, epoch) of a LATEST pointer; a plain int reads as epoch 0."""
    if isinstance(value, (tuple, list)):
        return int(value[0]), int(value[1])
    return int(value), 0


def _versions_present(name: str, keys: list[str]) -> set[int]:
    """The version numbers of a channel's ``name/v<n>/...`` keys."""
    present: set[int] = set()
    for key in keys:
        seg = key[len(name) + 1:].split("/", 1)[0]
        if seg.startswith("v") and seg[1:].isdigit():
            present.add(int(seg[1:]))
    return present


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md, queue A, item {item}")


def _resolve_client(store_name: str):
    from torchstore_tpu_torch import api

    return api.client(store_name)


class WeightPublisher:
    """Trainer side of a versioned weight channel."""

    def __init__(
        self,
        name: str,
        store_name: str = "default",
        keep: int = 2,
        client: Any = None,
        transfer_quant: Optional[str] = None,
        delta: bool = False,
        keyframe_every: Optional[int] = None,
    ) -> None:
        if keep < 1:
            raise ValueError("keep must be >= 1 (the latest version must live)")
        self.name = name
        self.keep = keep
        self._store_name = store_name
        self._client = client
        self._next_version: Optional[int] = None
        # Wire-tier defaults of this publisher: ``transfer_quant`` (None: the
        # config's default) and ``delta=True`` to ship deltas between
        # versions (blockwise modes only), keyframing every
        # ``keyframe_every`` versions (default: the config's).
        self._transfer_quant = transfer_quant
        self._delta = delta
        self._keyframe_every = keyframe_every
        self._codec = None
        # Minted when this publisher creates the channel, inherited when it
        # resumes one: subscribers tell a recreated channel (numbering
        # restarts) from a duplicate wakeup by it.
        self._epoch: Optional[int] = None

    def _resolve_client(self):
        if self._client is None:
            self._client = _resolve_client(self._store_name)
        return self._client

    async def register(self, state_dict: Any, transfer_dtype=None, direct: bool = False) -> dict:
        """Provision the store for this channel's working set before the
        first publish."""
        raise _not_ported("WeightPublisher.register (provisioning)", "A11")

    async def _resolve_next_version(self, client) -> int:
        """Resume after the channel's LATEST (a restarted publisher must not
        overwrite live versions), and reclaim a partial version a crashed
        predecessor left beyond the pointer."""
        if self._next_version is None:
            try:
                current, epoch = _parse_pointer(await client.get(f"{self.name}/{_LATEST}"))
                self._next_version = current + 1
                self._epoch = epoch
            except KeyError:
                self._next_version = 0
                self._epoch = secrets.randbits(62) or 1
                current = -1
            await self._reclaim_partials(client, current)
        return self._next_version

    async def _commit(self, client, version: int) -> None:
        """The commit tail of a version, for ``publish`` and
        ``ChannelStream.seal`` alike: advance LATEST (its callers have
        written the version's data and marker), step the counter."""
        await client.put(f"{self.name}/{_LATEST}", (version, self._epoch))
        self._next_version = version + 1
        _PUBLISHES.inc(channel=self.name)
        _PUBLISHED_VERSION.set(version, channel=self.name)

    async def _reclaim_partials(self, client, current: int) -> None:
        """Delete every version directory beyond the committed pointer (keys
        a crashed publisher streamed but never sealed). Once per publisher,
        on resume."""
        stale = {v for v in _versions_present(self.name, await client.keys(self.name))
                 if v > current}
        for v in sorted(stale):
            removed = await client.delete_prefix(_version_key(self.name, v))
            if removed:
                logger.warning("channel %s: reclaimed partial v%d (%d keys) left by a crashed "
                               "publisher", self.name, v, removed)

    def _resolve_quant(self, client, override: Optional[str]) -> Optional[str]:
        explicit = override if override is not None else self._transfer_quant
        mode = sdu.resolve_transfer_quant(explicit, None, getattr(client, "config", None))
        if mode is None and explicit is not None:
            # Disabled explicitly ("none"): keep the sentinel so
            # put_state_dict does not apply the config's default.
            return "none"
        return mode

    def _ensure_codec(self, client, mode: str):
        """The publisher's DeltaEncoder (one per publisher: a restarted one
        has no baselines and keyframes). Readers chain-walk back to the
        newest keyframe, which must still be kept: keep >= keyframe
        cadence."""
        if self._codec is None:
            cfg = getattr(client, "config", None)
            kf = int(self._keyframe_every or (cfg.delta_keyframe if cfg is not None else 8))
            if kf > self.keep:
                raise ValueError(
                    f"delta publishing on channel {self.name!r} needs keep >= keyframe "
                    f"cadence ({kf}): readers chain-walk deltas back to the newest "
                    "keyframe, which must still be retained - raise keep or lower "
                    "keyframe_every / TORCHSTORE_TORCH_DELTA_KEYFRAME"
                )
            block = cfg.quant_block if cfg is not None else 256
            skip_eps = cfg.delta_skip_eps if cfg is not None else 0.0
            self._codec = sdu.DeltaEncoder(mode, block, kf, skip_eps)
        return self._codec

    def _delta_ctx_for(
        self, client, version: int, transfer_quant: Optional[str], delta: Optional[bool]
    ) -> tuple[Optional[str], Optional[dict]]:
        """(effective quant mode, delta_ctx) of one publish."""
        mode = self._resolve_quant(client, transfer_quant)
        use_delta = self._delta if delta is None else delta
        if not use_delta:
            return mode, None
        if mode not in ("int8_block", "int4_block"):
            raise ValueError(
                "delta publishing requires a blockwise transfer_quant "
                f"(int8_block/int4_block), got {mode!r}"
            )
        return mode, {"codec": self._ensure_codec(client, mode), "version": int(version),
                      "channel": self.name}

    def stream(
        self, transfer_dtype=None, transfer_quant: Optional[str] = None,
        delta: Optional[bool] = None,
    ) -> "ChannelStream":
        """Open a layer-streamed publish of the next version: ``await
        cs.put(fragment)`` as the trainer produces fragments, then ``await
        cs.seal()`` to advance LATEST and GC as ``publish`` does. Streaming
        subscribers (``acquire_streamed``) wake on the announce and pull
        layers before the seal; barrier subscribers wake at the seal."""
        return ChannelStream(self, transfer_dtype=transfer_dtype,
                             transfer_quant=transfer_quant, delta=delta)

    async def publish(
        self,
        state_dict: Any,
        transfer_dtype=None,
        transfer_quant: Optional[str] = None,
        direct: bool = False,
        delta: Optional[bool] = None,
    ) -> int:
        """Write the next version, advance LATEST, GC old versions; returns
        the version. ``direct=True`` publishes through the one-hop path
        under one stable key (``name/direct``): the first publish registers
        staging buffers, later ones refresh them, and the version number
        only orders the wakeups."""
        client = self._resolve_client()
        version = await self._resolve_next_version(client)
        if direct:
            data_key, quant_mode, delta_ctx = f"{self.name}/direct", transfer_quant, None
        else:
            data_key = _version_key(self.name, version)
            quant_mode, delta_ctx = self._delta_ctx_for(client, version, transfer_quant, delta)
        await sdu.put_state_dict(client, data_key, state_dict, transfer_dtype=transfer_dtype,
                                 transfer_quant=quant_mode, direct=direct, delta_ctx=delta_ctx)
        # The pointer last: subscribers woken by it see a committed dict.
        await self._commit(client, version)
        if not direct:
            await self._gc(client, version)
        return version

    async def _gc(self, client, version: int) -> None:
        """Keep the newest ``keep`` versions at or below the one just
        published and delete every other version present, not only the one
        this publish expires: versions orphaned by a crash between pointer
        and GC, or by a restart with a smaller ``keep``, go on the next
        publish. The window counts the versions present, never ``version -
        keep``; versions beyond ``version`` are left alone."""
        present = _versions_present(self.name, await client.keys(self.name))
        window = sorted(v for v in present if v <= version)
        for v in window[: -self.keep]:
            removed = await client.delete_prefix(_version_key(self.name, v))
            logger.debug("channel %s: GC'd v%d (%d keys)", self.name, v, removed)

    async def close(self, delete: bool = False) -> None:
        """With ``delete=True``, remove every key the channel owns."""
        if delete:
            await self._resolve_client().delete_prefix(self.name)


class ChannelStream:
    """One layer-streamed publish of a channel version (see
    :meth:`WeightPublisher.stream`). The first ``put`` resolves the next
    version, opens the stream and announces it on the channel's ``STREAM``
    pointer; ``seal()`` commits the marker, advances ``LATEST`` and GCs. An
    abandoned stream never advances a pointer: the previous version stays
    acquirable, and the next publisher's resume reclaims the partial."""

    def __init__(
        self,
        publisher: WeightPublisher,
        transfer_dtype=None,
        transfer_quant: Optional[str] = None,
        delta: Optional[bool] = None,
    ) -> None:
        self._pub = publisher
        self._transfer_dtype = transfer_dtype
        self._transfer_quant = transfer_quant
        self._delta = delta
        self._stream = None
        self.version: Optional[int] = None

    async def put(self, fragment: Any) -> int:
        from torchstore_tpu_torch import stream_sync

        if self._stream is None:
            pub = self._pub
            client = pub._resolve_client()
            self.version = await pub._resolve_next_version(client)
            quant_mode, delta_ctx = pub._delta_ctx_for(
                client, self.version, self._transfer_quant, self._delta
            )
            self._stream = stream_sync.stream_state_dict(
                client, _version_key(pub.name, self.version),
                transfer_dtype=self._transfer_dtype, transfer_quant=quant_mode,
                delta_ctx=delta_ctx,
            )
            await self._stream.begin()
            # Announce the in-flight version before any layer lands: a
            # plain put, so a crashed publisher leaves at worst a stale
            # announce that the next wakeup skips.
            await client.put(f"{pub.name}/{_STREAM_PTR}", (self.version, pub._epoch))
        return await self._stream.put(fragment)

    async def seal(self) -> int:
        if self._stream is None:
            raise RuntimeError("seal() before any put(): nothing published")
        pub = self._pub
        client = pub._resolve_client()
        version = self.version
        await self._stream.seal()
        # The pointer last: barrier subscribers see a sealed dict.
        await pub._commit(client, version)
        await pub._gc(client, version)
        return version


class WeightSubscriber:
    """Consumer side: blocks for fresh versions instead of polling."""

    def __init__(
        self,
        name: str,
        store_name: str = "default",
        client: Any = None,
        relay: bool = False,
        relay_volume: Optional[str] = None,
    ) -> None:
        if relay or relay_volume is not None:
            raise _not_ported("WeightSubscriber(relay=...) (broadcast relay)", "A11")
        self.name = name
        self._store_name = store_name
        self._client = client
        self._last_gen = 0
        self._last_stream_gen = 0
        self.last_version: Optional[int] = None
        self._last_epoch: Optional[int] = None
        # The delta tier's accumulated state of this subscriber, across
        # acquires (unchanged keys then serve with no re-transfer).
        self._decoder = None
        self._decoder_epoch: Optional[int] = None

    def _delta_decoder(self, epoch: Optional[int] = None):
        if self._decoder is None:
            self._decoder = sdu.DeltaDecoder()
            self._decoder_epoch = epoch
        elif epoch is not None and epoch != self._decoder_epoch:
            # A recreated channel restarts numbering under a fresh epoch:
            # state of the old epoch could collide with the new numbers.
            self._decoder.drop()
            self._decoder_epoch = epoch
        return self._decoder

    def _resolve_client(self):
        if self._client is None:
            self._client = _resolve_client(self._store_name)
        return self._client

    def _observe_lag(self, version: int, epoch: int) -> None:
        """Versions published since the last acquire that this subscriber
        will never pull (same epoch only: a recreated channel restarts)."""
        if self.last_version is not None and epoch == self._last_epoch:
            skipped = version - self.last_version - 1
            _VERSION_LAG.set(max(0, skipped), channel=self.name)
            if skipped > 0:
                _SKIPPED.inc(skipped, channel=self.name)

    def _delivered(self, version: int, epoch: int) -> None:
        self.last_version = version
        self._last_epoch = epoch
        _ACQUIRED_VERSION.set(version, channel=self.name)

    async def acquire(
        self,
        user_state_dict: Any = None,
        timeout: Optional[float] = None,
        direct: bool = False,
        strict: bool = True,
        version: Optional[int] = None,
    ) -> tuple[Any, int]:
        """Block until a version this subscriber has not acquired is
        published, pull it, and return (state_dict, version). The first call
        returns the channel's current version at once when one exists; each
        publish is delivered at most once (a recreated channel restarts its
        numbering and delivers its v0). ``TimeoutError`` when nothing new
        arrives within ``timeout`` seconds; ``timeout=None`` waits for good
        (the long poll has no RPC deadline)."""
        if version is not None:
            raise _not_ported("acquire(version=...) (pinned reads under cohort leases)", "A11")
        client = self._resolve_client()
        pointer = f"{self.name}/{_LATEST}"
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            change = await client.wait_for_change(pointer, self._last_gen, timeout=remaining)
            self._last_gen = change["gen"]
            if change["state"] != "committed":
                continue  # a deleted channel; wait for the next publish
            data_key = None
            try:
                version, epoch = _parse_pointer(await client.get(pointer))
                if version == self.last_version and epoch == self._last_epoch:
                    # A duplicate wakeup: the pointer is read in a later RPC
                    # than the generation, so a publish landing in between
                    # shows the same version twice. Delivered at most once.
                    continue
                data_key = f"{self.name}/direct" if direct else _version_key(self.name, version)
                self._observe_lag(version, epoch)
                sd = await sdu.get_state_dict(
                    client, data_key, user_state_dict, direct=direct, strict=strict,
                    delta_state=None if direct else self._delta_decoder(epoch),
                )
            except (NoMatchingPush, KeyError):
                # The pointer or the version went between the wakeup and
                # the pull (a deleted channel, or a subscriber lagging more
                # than keep versions); wait for the next publish.
                logger.info("channel %s: %s vanished before pull; waiting for the next "
                            "version", self.name, data_key or pointer)
                continue
            self._delivered(version, epoch)
            return sd, version

    async def acquire_streamed(
        self,
        user_state_dict: Any = None,
        key_order: Optional[list] = None,
        on_layer: Any = None,
        timeout: Optional[float] = None,
        strict: bool = True,
        version: Optional[int] = None,
    ) -> tuple[Any, int]:
        """Like :meth:`acquire`, against layer-streamed publishes: wakes on
        the channel's in-flight announce and pulls layer by layer as the
        watermarks land, in ``key_order`` when given, calling ``on_layer``
        per leaf, so generation starts before the publisher seals. The dict
        returned is one version's weights, and versions are delivered at
        most once."""
        from torchstore_tpu_torch import stream_sync

        if version is not None:
            raise _not_ported("acquire_streamed(version=...) (pinned reads under cohort leases)",
                              "A11")
        client = self._resolve_client()
        pointer = f"{self.name}/{_STREAM_PTR}"
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            change = await client.wait_for_change(pointer, self._last_stream_gen,
                                                  timeout=remaining)
            self._last_stream_gen = change["gen"]
            if change["state"] != "committed":
                continue
            try:
                version, epoch = _parse_pointer(await client.get(pointer))
            except KeyError:
                continue
            if version == self.last_version and epoch == self._last_epoch:
                continue  # a duplicate wakeup: delivered at most once
            data_key = _version_key(self.name, version)
            self._observe_lag(version, epoch)
            try:
                sd = await stream_sync.get_state_dict_streamed(
                    client, data_key, user_state_dict=user_state_dict, key_order=key_order,
                    on_layer=on_layer, strict=strict,
                    timeout=None if deadline is None else max(0.0, deadline - time.monotonic()),
                    delta_state=self._delta_decoder(epoch),
                )
            except (NoMatchingPush, KeyError):
                # The announced version went before the pull (GC'd under a
                # lagging subscriber, or a crashed publisher's partial was
                # reclaimed); wait for the next announce.
                logger.info("channel %s: streamed %s vanished before pull; waiting for the "
                            "next version", self.name, data_key)
                continue
            self._delivered(version, epoch)
            return sd, version
