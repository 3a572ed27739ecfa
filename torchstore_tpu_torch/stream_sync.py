"""Layer-streamed weight sync: publish and acquire as a pipeline.

Port of ``torchstore_tpu/stream_sync.py``. The barrier protocol
(``state_dict_utils``) publishes a whole state dict and only then lets
readers fetch it. Here the sync is a pipeline:

- :class:`StreamedPut` takes tensors fragment by fragment (a layer, a
  module) as they become ready and puts each fragment at once. Every put's
  notify carries a per-key version watermark
  (``Controller.notify_put_batch(watermark=)``), applied in the same
  indexing step as the metadata, so a key is trusted at version v the
  moment its bytes are committed. ``seal()`` writes the MAPPING commit
  marker last (barrier readers still see only complete dicts) and the
  controller's seal record.
- :func:`get_state_dict_streamed` acquires layer by layer: a long poll on
  the controller (``wait_for_stream``, woken by the notifies) hands back
  each batch of freshly watermarked keys, which are fetched through
  ``get_batch`` and handed to an ``on_layer`` callback, in ``key_order``
  when one is given, so a forward pass can start before the last layer
  lands.

A reader never mixes generations: every served key must carry the target
version's watermark; a key watermarked newer, a superseded stream or a
failed final re-check restarts the acquire at the newest version, counted
in ``ts_stream_fallbacks_total`` and bounded by ``config.stream_retries``.
Watermark reads go through :func:`watermark_of` / :func:`inconsistent_keys`.

A floating leaf is cast through ``cast_floating_tensors`` (the grouped cast
kernel for CUDA leaves) or encoded by the quant codec on its device, as the
barrier put does; fetches go through ``get_batch`` (the one-sided stamped
reads of the reference are ROADMAP A10).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional

from torchstore_tpu_torch import faults
from torchstore_tpu_torch import state_dict_utils as sdu
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability.tracing import span
from torchstore_tpu_torch.utils import get_hostname, maybe_await

logger = get_logger("torchstore_tpu_torch.stream_sync")

_LAYER_BATCHES = obs_metrics.counter(
    "ts_stream_layer_batches_total", "Streamed layer batches published (watermarked put batches)"
)
_SEALS = obs_metrics.counter("ts_stream_seals_total", "Streamed publishes sealed")
_ACQUIRES = obs_metrics.counter(
    "ts_stream_acquires_total", "Streamed acquires completed consistently"
)
_FALLBACKS = obs_metrics.counter(
    "ts_stream_fallbacks_total", "Streamed acquires that fell back or restarted, by reason"
)
# Store keys watermarked at the target version but not yet served by this
# process's streamed acquire: moves during a stream, settles at 0.
_LAG = obs_metrics.gauge(
    "ts_stream_lag_keys", "Watermarked-but-unserved keys in this process's streamed acquire"
)
_OVERLAP = obs_metrics.gauge(
    "ts_stream_overlap_ratio", "Fraction of the publish window the last streamed acquire ran inside"
)
_FIRST_LAYER = obs_metrics.gauge(
    "ts_stream_first_layer_seconds", "Stream begin to this subscriber's first served layer"
)


# Why a streamed acquire restarted or fell back to the barrier path.
FALLBACK_REASONS = ("no_stream", "stream_gone", "superseded", "mixed_generation",
                    "marker_gone", "marker_drift", "incomplete_seal")


def stream_counters() -> dict:
    """This process's streamed-sync counts: layer batches and seals
    published, acquires completed, fallbacks by reason, and the last
    acquire's lag, first-layer seconds and overlap ratio."""
    return {
        "layer_batches": _LAYER_BATCHES.total(),
        "seals": _SEALS.total(),
        "acquires": _ACQUIRES.total(),
        "fallbacks": {r: _FALLBACKS.value(reason=r) for r in FALLBACK_REASONS},
        "lag_keys": _LAG.value(),
        "first_layer_s": _FIRST_LAYER.value(),
        "overlap_ratio": _OVERLAP.value(),
    }


class MixedGenerationError(RuntimeError):
    """A streamed acquire could not complete a single-generation serve."""


class _Restart(Exception):
    """Restart the acquire at the newest stream version."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


# --------------------------------------------------------------------------
# watermark accessors
# --------------------------------------------------------------------------


def watermark_of(state: Optional[dict], store_key: str) -> Optional[int]:
    """The version whose bytes a store key holds, per the stream record;
    None when unknown (never watermarked, or the record is gone)."""
    if state is None:
        return None
    return (state.get("watermarks") or {}).get(store_key)


def inconsistent_keys(state: Optional[dict], store_keys, version: int) -> list[str]:
    """Store keys whose watermark is not ``version``: the served set is one
    generation iff this is empty."""
    return [sk for sk in store_keys if watermark_of(state, sk) != version]


# --------------------------------------------------------------------------
# publish side
# --------------------------------------------------------------------------


def _merge_mapping(a: dict, b: dict) -> dict:
    """Merge the flatten mappings of two fragments of one streamed publish.
    Dicts merge per child; any other container must arrive whole in one
    fragment."""
    if a["kind"] != b["kind"]:
        raise ValueError(
            f"streamed fragments disagree on container structure ({a['kind']!r} vs {b['kind']!r})"
        )
    if a["kind"] == "dict":
        items = dict(a["items"])
        for k, v in b["items"].items():
            items[k] = _merge_mapping(items[k], v) if k in items else v
        key_types = dict(a.get("key_types", {}))
        key_types.update(b.get("key_types", {}))
        return {"kind": "dict", "items": items, "key_types": key_types}
    if a == b:
        return a
    raise ValueError(
        "streamed fragments overlap inside a non-dict container; publish list/tuple "
        "containers whole in one fragment"
    )


class StreamedPut:
    """One streamed publish of a state dict under ``key``.

    >>> stream = stream_state_dict(client, "policy/sd")
    >>> for name, layer in trainer.layers():        # as they become ready
    ...     await stream.put({"layers": {name: layer}})
    >>> await stream.seal()

    Flat keys must be disjoint across fragments (a layer is published once
    per stream). ``seal`` writes the MAPPING commit marker last, then the
    controller's seal record. An abandoned stream leaves the previous
    sealed version acquirable: readers trust only watermarked keys, and
    barrier readers key on the absent or older marker."""

    def __init__(
        self,
        client,
        key: str,
        transfer_dtype=None,
        transfer_quant: Optional[str] = None,
        delta_ctx: Optional[dict] = None,
    ) -> None:
        self._client = client
        self.key = key
        self.version: Optional[int] = None
        self._transfer_dtype = transfer_dtype
        config = getattr(client, "config", None)
        self._quant = sdu.resolve_transfer_quant(transfer_quant, transfer_dtype, config)
        if self._quant is not None and transfer_dtype is not None:
            raise ValueError(
                "transfer_quant and transfer_dtype are mutually exclusive "
                "(quantization defines the wire format)"
            )
        if delta_ctx is not None and self._quant not in ("int8_block", "int4_block"):
            raise ValueError(
                f"delta streaming requires transfer_quant int8_block/int4_block (got {self._quant!r})"
            )
        self._qblock = config.quant_block if config is not None else 256
        self._delta_ctx = delta_ctx
        self._qkeys: list[str] = []
        self._qdtypes: dict[str, str] = {}
        self._aliases: dict[str, int] = {}  # flat key -> base channel version
        self._mapping: Optional[dict] = None
        self._leaf_sigs: dict[str, tuple] = {}
        self._sealed = False

    async def begin(self) -> int:
        """Open the stream on the controller (implicit on the first
        ``put``); an early ``begin`` lets readers start polling before the
        first layer is trained."""
        if self.version is None:
            quant = None
            if self._quant is not None:
                # The decode meta readers need before the seal's marker
                # exists: the format and, for delta, the channel whose
                # version directories a chain walks.
                delta = None
                if self._delta_ctx is not None:
                    delta = {"channel": self._delta_ctx["channel"],
                             "version": int(self._delta_ctx["version"])}
                quant = {"fmt": self._quant, "block": self._qblock, "delta": delta}
            self.version = await self._client.stream_begin(self.key, quant=quant)
        return self.version

    @property
    def published_keys(self) -> list[str]:
        return sorted(self._leaf_sigs)

    async def put(self, fragment: Any) -> int:
        """Publish one fragment (a nested or flat dict of leaves) and
        watermark each of its keys at this stream's version; returns the
        number of flat keys."""
        await faults.afire("channel.publish_layer")
        if self._sealed:
            raise RuntimeError(f"stream for {self.key!r} is already sealed")
        version = await self.begin()
        flat, mapping = sdu.flatten_state_dict(fragment)
        if not flat:
            return 0
        if sdu.MAPPING_KEY in flat:
            raise ValueError(
                f"{sdu.MAPPING_KEY!r} is a reserved top-level state-dict key (it is the "
                "commit marker); rename that entry"
            )
        dup = sorted(set(flat) & set(self._leaf_sigs))
        if dup:
            raise ValueError(
                f"flat keys republished within one stream: {dup[:5]} - a layer is "
                "published exactly once per stream"
            )
        self._mapping = mapping if self._mapping is None else _merge_mapping(self._mapping, mapping)
        for k, v in flat.items():
            self._leaf_sigs[k] = sdu._leaf_signature(v)
        if self._transfer_dtype is not None:
            flat = sdu.cast_floating_tensors(flat, self._transfer_dtype)
        aliases: dict[str, tuple] = {}
        if self._quant is not None:
            flat, aliases = await self._encode_quant(flat)
        with span("stream.publish_layer", key=self.key, version=version,
                  keys=len(flat) + len(aliases)):
            if flat:
                await self._client.put_batch(
                    {sdu._store_key(self.key, k): v for k, v in flat.items()},
                    watermark=(self.key, version),
                    unchanged=aliases or None,
                )
            elif aliases:
                # Every key of the fragment is unchanged: no bytes land, the
                # aliases alone watermark the keys.
                await self._client.stream_mark_unchanged(self.key, version, aliases)
        _LAYER_BATCHES.inc()
        return len(flat) + len(aliases)

    async def _encode_quant(self, flat: dict) -> tuple[dict, dict[str, tuple]]:
        """Encode one fragment's floating leaves into blobs on their
        devices: (flat to put, unchanged aliases). A delta-unchanged key
        ships nothing and is aliased (store key -> (base store key, base
        version)) in the same watermark step."""
        config = getattr(self._client, "config", None)
        if self._delta_ctx is None:
            out, meta = await sdu.quantize_transfer_async(flat, self._quant, self._qblock,
                                                          config=config)
            self._qkeys += meta["keys"]
            self._qdtypes.update(meta["dtypes"])
            return out, {}
        out, meta, base_of = await sdu._delta_encode_flat(flat, self._quant, self._qblock,
                                                          self._delta_ctx)
        self._qkeys += meta["keys"]
        self._qdtypes.update(meta["dtypes"])
        self._aliases.update(base_of)
        channel = self._delta_ctx["channel"]
        aliases = {
            sdu._store_key(self.key, fk): (
                sdu._store_key(sdu._delta_version_key(channel, base), fk), int(base))
            for fk, base in base_of.items()
        }
        return out, aliases

    async def seal(self) -> int:
        """Write the commit marker, then the controller's seal record;
        returns the stream version. Idempotent."""
        if self._sealed:
            return self.version
        if self._mapping is None:
            raise RuntimeError("seal() before any put(): nothing to commit")
        # As put_state_dict: a restructure this client cannot prove
        # unchanged bumps the placement epoch, so no reader's cached plan
        # serves the old structure.
        cache = getattr(self._client, "plan_cache", None)
        signature = tuple(sorted(self._leaf_sigs.items())) + (
            ("cast", str(self._transfer_dtype), self._quant, self._qblock),
        )
        if cache is not None:
            if cache.last_put_sig.get(self.key) != signature:
                await self._client.bump_placement_epoch()
            cache.last_put_sig[self.key] = signature
        else:
            await self._client.bump_placement_epoch()
        marker: dict = {"mapping": self._mapping, "stream": {"version": self.version}}
        if self._quant is not None:
            quant_meta: dict = {"fmt": self._quant, "block": self._qblock, "keys": self._qkeys,
                                "dtypes": self._qdtypes}
            if self._delta_ctx is not None:
                quant_meta["delta"] = {"channel": self._delta_ctx["channel"],
                                       "version": int(self._delta_ctx["version"]),
                                       "aliases": dict(self._aliases)}
            marker["quant"] = quant_meta
        with span("stream.seal", key=self.key, version=self.version, keys=len(self._leaf_sigs)):
            await self._client.put(sdu._store_key(self.key, sdu.MAPPING_KEY), marker)
        await self._client.stream_seal(self.key, self.version)
        self._sealed = True
        _SEALS.inc()
        return self.version


def stream_state_dict(
    client,
    key: str,
    transfer_dtype=None,
    transfer_quant: Optional[str] = None,
    delta_ctx: Optional[dict] = None,
) -> StreamedPut:
    """Open a layer-streamed publish of ``key``."""
    return StreamedPut(client, key, transfer_dtype=transfer_dtype,
                       transfer_quant=transfer_quant, delta_ctx=delta_ctx)


# --------------------------------------------------------------------------
# acquire side
# --------------------------------------------------------------------------


async def get_state_dict_streamed(
    client,
    key: str,
    user_state_dict: Any = None,
    key_order: Optional[list[str]] = None,
    on_layer: Optional[Callable[[str, Any], Any]] = None,
    strict: bool = True,
    timeout: Optional[float] = None,
    wait_for_stream_s: Optional[float] = None,
    delta_state: Any = None,
) -> Any:
    """Acquire a streamed state dict layer by layer.

    Each store key is fetched the moment its watermark lands. With
    ``key_order`` (model-forward order, e.g. ``models.generate.
    forward_key_order``) delivery is in order: layer k+1 waits until layer
    k was served, so ``on_layer(flat_key, value)`` (sync or async, once per
    leaf) can start a forward pass before the last layer lands; without it
    layers are served as they arrive. A ``key_order`` entry the publisher
    never pushes holds its successors back until the seal.

    ``delta_state`` (a ``DeltaDecoder``) is the reader's accumulated state
    of a delta channel: quantized layers decode through it, and unchanged
    keys are served from it with no re-transfer. ``wait_for_stream_s``
    long-polls for the stream to begin when no record exists yet; with no
    record and no wait, the barrier ``get_state_dict`` serves the key.

    Never mixes generations: a drift restarts at the newest version
    (``config.stream_retries`` times), then raises
    :class:`MixedGenerationError`. A stream whose marker belongs to a
    barrier publish (``marker_drift``) or whose seal left keys at an older
    version (``incomplete_seal``) is served by the barrier path."""
    config = getattr(client, "config", None)
    retries = max(0, int(config.stream_retries if config is not None else 2))
    poll_s = float(config.stream_poll_s) if config is not None else 10.0
    deadline = None if timeout is None else time.monotonic() + timeout
    for attempt in range(retries + 1):
        state = await client.stream_state(key)
        if state is None and wait_for_stream_s:
            try:
                res = await client.wait_for_stream(key, 1, -1, timeout=wait_for_stream_s)
            except TimeoutError:
                res = {"missing": True}
            if not res.get("missing"):
                state = await client.stream_state(key)
        if state is None:
            # Never streamed (or the record was evicted or retired): the
            # barrier path serves it, or raises NoMatchingPush.
            _FALLBACKS.inc(reason="no_stream")
            return await sdu.get_state_dict(client, key, user_state_dict, strict=strict,
                                            delta_state=delta_state)
        target = int(state["version"])
        try:
            return await _acquire_stream(client, key, target, user_state_dict, key_order,
                                         on_layer, strict, deadline, poll_s, delta_state)
        except _Restart as exc:
            _FALLBACKS.inc(reason=exc.reason)
            _LAG.set(0)
            logger.warning("streamed acquire of %r v%d restarting (%s; attempt %d/%d)",
                           key, target, exc.reason, attempt + 1, retries + 1)
            if exc.reason in ("incomplete_seal", "marker_drift"):
                # Retrying cannot help: the marker belongs to another
                # publish (a barrier put over a streamed key), or the seal
                # left keys of an older generation. The barrier path serves
                # the dict of the commit marker.
                return await sdu.get_state_dict(client, key, user_state_dict, strict=strict,
                                                delta_state=delta_state)
    raise MixedGenerationError(
        f"streamed acquire of {key!r} could not complete a consistent single-generation "
        f"serve in {retries + 1} attempts (publishers are overwriting keys faster than "
        "this consumer acquires them)"
    )


async def _acquire_stream(
    client,
    key: str,
    target: int,
    user_state_dict: Any,
    key_order: Optional[list[str]],
    on_layer,
    strict: bool,
    deadline: Optional[float],
    poll_s: float,
    delta_state: Any = None,
) -> Any:
    user_flat = user_mapping = None
    if user_state_dict is not None:
        user_flat, user_mapping = sdu.flatten_state_dict(user_state_dict)
    # store key -> (flat key, fetch target): with a user dict only its keys
    # are fetched (subset pulls with strict=False, in-place landings).
    targets_of: dict[str, Any] = {}
    flat_of: dict[str, str] = {}
    if user_flat is not None:
        for fk, v in user_flat.items():
            sk = sdu._store_key(key, fk)
            flat_of[sk] = fk
            targets_of[sk] = v if sdu._is_fetch_target(v) else None
    prefix_len = len(key) + len(sdu._SEP)
    ordered_sks = [sdu._store_key(key, fk) for fk in key_order] if key_order else None
    served: dict[str, Any] = {}  # flat key -> value
    served_sks: list[str] = []
    served_set: set[str] = set()
    known = 0
    sealed = False
    poll = max(0.1, poll_s)
    first_serve_ts: Optional[float] = None
    # A quantized stream: the record's decode meta (set at stream_begin)
    # drives per-layer decode before the seal's marker exists.
    qmeta: Optional[dict] = None
    decoder = None
    qchannel: Optional[str] = None
    alias_of: dict[str, tuple] = {}  # new store key -> (base store key, base version)

    def adopt_quant(meta: Optional[dict]) -> None:
        nonlocal qmeta, decoder, qchannel
        if meta is None or qmeta is not None:
            return
        qmeta = meta
        decoder = delta_state if delta_state is not None else sdu.DeltaDecoder()
        qchannel = (meta.get("delta") or {}).get("channel")

    def user_leaf(fk: str):
        leaf = user_flat.get(fk) if user_flat is not None else None
        return leaf if sdu._is_fetch_target(leaf) else None

    async def serve(sks: list[str]) -> None:
        nonlocal first_serve_ts
        if user_flat is not None:
            sks = [sk for sk in sks if sk in flat_of]
        if not sks:
            return
        to_fetch: dict[str, tuple] = {}  # sk -> (fetch key, landing target)
        local_vals: dict[str, Any] = {}
        for sk in sks:
            fk = flat_of.get(sk, sk[prefix_len:])
            alias = alias_of.get(sk) if qmeta is not None else None
            if alias is not None:
                st = decoder.serve_unchanged(fk, alias[1])
                if st is not None:
                    # The reader holds the aliased version's state already:
                    # served with no re-transfer.
                    local_vals[sk] = sdu._quant_result(st, user_leaf(fk))
                    continue
                to_fetch[sk] = (alias[0], None)
            elif qmeta is not None:
                # A floating leaf of a quant stream is a blob: a keyframe
                # blob lands on a CUDA target's card, a delta one (its size
                # unknown here) on the host. Others land in their targets.
                tgt = targets_of.get(sk)
                if tgt is not None and not sdu._is_floating(tgt):
                    to_fetch[sk] = (sk, tgt)
                elif qmeta.get("delta"):
                    to_fetch[sk] = (sk, None)
                else:
                    to_fetch[sk] = (sk, sdu._blob_landing(qmeta, tgt))
            else:
                to_fetch[sk] = (sk, targets_of.get(sk))
        fetched = {}
        if to_fetch:
            fetched = await client.get_batch({src: tgt for src, tgt in to_fetch.values()})
        heads = sdu._read_heads(fetched) if qmeta is not None else {}
        if first_serve_ts is None:
            first_serve_ts = time.time()
        for sk in sks:
            fk = flat_of.get(sk, sk[prefix_len:])
            if sk in local_vals:
                value = local_vals[sk]
            else:
                src = to_fetch[sk][0]
                value = fetched[src]
                if qmeta is not None and sdu.is_quant_blob(value, heads.get(src)):
                    leaf = user_leaf(fk)
                    st = await decoder.decode(
                        fk, value, fetch_base=sdu._chain_fetcher(client, qchannel, fk),
                        device=sdu._leaf_device(leaf), head=heads.get(src),
                    )
                    value = sdu._quant_result(st, leaf)
            served[fk] = value
            served_sks.append(sk)
            served_set.add(sk)
            _LAG.set(known - len(served_sks))
            if on_layer is not None:
                await maybe_await(on_layer(fk, value))

    with span("stream.acquire", key=key, version=target):
        while not sealed:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"streamed acquire of {key!r} v{target} timed out with "
                    f"{len(served_sks)} layer(s) served"
                )
            chunk = poll if remaining is None else min(poll, remaining)
            try:
                res = await client.wait_for_stream(key, target, known, timeout=chunk)
            except TimeoutError:
                continue  # re-poll: refreshes the deadline accounting
            if res.get("missing"):
                raise _Restart("stream_gone")
            if res["superseded"]:
                raise _Restart("superseded")
            adopt_quant(res.get("quant"))
            alias_of.update(res.get("aliases") or {})
            ready = res["ready"]
            known = len(ready)
            if inconsistent_keys(res, ready, target):
                # A key watermarked newer than the target: serving it would mix
                # generations.
                raise _Restart("mixed_generation")
            sealed = bool(res["sealed"])
            fresh = [sk for sk in ready if sk not in served_set]
            if ordered_sks is not None:
                # In order: the contiguous ready prefix of the caller's order;
                # the rest (keys outside the order, or held behind an entry the
                # publisher never pushed) is served at the seal, still in order.
                ready_set = set(ready)
                wave: list[str] = []
                for sk in ordered_sks:
                    if sk in served_set:
                        continue
                    if sk not in ready_set:
                        break
                    wave.append(sk)
                if sealed:
                    pos = {sk: i for i, sk in enumerate(ordered_sks)}
                    in_wave = set(wave)
                    wave += sorted((sk for sk in fresh if sk not in in_wave),
                                   key=lambda sk: (pos.get(sk, len(pos)), sk))
                await serve(wave)
            else:
                await serve(fresh)
            _LAG.set(known - len(served_sks))

    # The seal: structure, then the consistency re-check.
    marker_sk = sdu._store_key(key, sdu.MAPPING_KEY)
    try:
        marker = (await client.get_batch({marker_sk: None}))[marker_sk]
    except KeyError as exc:
        raise _Restart("marker_gone") from exc
    if (marker.get("stream") or {}).get("version") != target:
        # The marker belongs to another publish (a barrier put, or a newer
        # stream raced the seal).
        raise _Restart("marker_drift")
    mapping = marker["mapping"]
    leaf_keys = sdu._leaf_keys(mapping)
    if user_flat is not None:
        extra = set(user_flat) - leaf_keys
        if extra:
            raise ValueError(f"user dict keys not present in push {key!r}: {sorted(extra)[:5]}")
        missing = leaf_keys - set(user_flat)
        if strict and missing:
            raise ValueError(
                f"state dict structure mismatch for {key!r}: missing in user dict: "
                f"{sorted(missing)[:5]} (pass strict=False to pull a subset)"
            )
        unserved = [fk for fk in user_flat if fk not in served]
    else:
        unserved = [fk for fk in sorted(leaf_keys) if fk not in served]
    if unserved:
        # Sealed, but some keys never reached the target watermark: one
        # generation cannot be served; the barrier path can.
        raise _Restart("incomplete_seal")
    state2 = await client.stream_state(key)
    if state2 is None:
        raise _Restart("stream_gone")
    if int(state2["version"]) != target:
        # A newer stream began: its begin precedes any of its landings, so
        # bytes read from it exist only if this fires.
        raise _Restart("superseded")
    if inconsistent_keys(state2, served_sks, target):
        raise _Restart("mixed_generation")
    flat = (
        {fk: served[fk] for fk in user_flat}
        if user_flat is not None
        else {fk: served[fk] for fk in sorted(leaf_keys)}
    )
    result = sdu.unflatten_state_dict(flat, user_mapping if user_flat is not None else mapping)
    _LAG.set(0)
    _ACQUIRES.inc()
    _publish_acquire_telemetry(state2, first_serve_ts, time.time())
    try:
        await client.stream_ack(key, target, f"{get_hostname()}:{os.getpid()}")
    except Exception:  # noqa: BLE001 - a lost ack (telemetry) must not fail the serve
        pass
    return result


def _publish_acquire_telemetry(
    state: Optional[dict], first_serve_ts: Optional[float], done_ts: float
) -> None:
    """First-layer seconds (stream begin to this reader's first served
    layer) and the overlap ratio (the share of the publish window the
    acquire ran inside), from the record's wall-clock stamps."""
    if state is None or first_serve_ts is None or state.get("begin_ts") is None:
        return
    begin_ts, seal_ts = state["begin_ts"], state.get("seal_ts")
    _FIRST_LAYER.set(max(0.0, first_serve_ts - begin_ts))
    if seal_ts is None or seal_ts <= begin_ts:
        return
    overlap = max(0.0, min(seal_ts, done_ts) - max(begin_ts, first_serve_ts))
    _OVERLAP.set(min(1.0, overlap / (seal_ts - begin_ts)))
