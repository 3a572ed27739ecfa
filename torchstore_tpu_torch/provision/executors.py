"""Prewarm orchestrator: drive a ProvisionPlan through the live store.

Port of ``torchstore_tpu/provision/executors.py``. ``prewarm_manifest`` is
the engine behind ``prewarm``, ``WeightPublisher.register`` and the
automatic hint in ``put_state_dict``. It never raises: a stage that fails
(a volume down, tmpfs full, a dial refused) is logged, counted in
``ts_prewarm_errors_total`` and named in the report, and the sync that
follows takes the lazy path as before.

Stages, each a span under ``provision.prewarm``:

1. plan          manifest, the put's volumes and each one's rung
2. reserve       the controller's capacity grants clamp the plan
3. shm           each volume's pool pre-sized (huge pages, native
                 prefault), with a twin set for the second put populated in
                 the background; the client attaches the segments it made
                 and, for a working set on a card, page-locks them
4. bulk          the main connection, and the stripe set, dialed ahead
5. device        the device engine made ready for a working set on cards
6. local staging (``direct=True``) the client-local segments a direct
                 source's ``register`` draws
7. release       the reservation dropped (the pool holds the bytes now)

The reference's registration leg (bulk buffers registered ahead) waits for
a registration backend in the port; the report names it as skipped.
"""

from __future__ import annotations

import asyncio
import contextlib
import time
import uuid
import weakref
from typing import Any, Optional

from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import context as obs_context
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability.tracing import span
from torchstore_tpu_torch.provision import planner
from torchstore_tpu_torch.provision.manifest import StateDictManifest
from torchstore_tpu_torch.provision.pool import local_pool
from torchstore_tpu_torch.transport import bulk
from torchstore_tpu_torch.transport import device_transfer as dt
from torchstore_tpu_torch.transport import shared_memory as shm
from torchstore_tpu_torch.transport.factory import create_transport_buffer

logger = get_logger("torchstore_tpu_torch.provision")

RUNS = obs_metrics.counter("ts_prewarm_runs_total", "Prewarm invocations (explicit + auto-hint)")
_BYTES = obs_metrics.counter(
    "ts_prewarm_bytes_total", "Bytes pre-faulted into pools/staging by prewarm, by leg"
)
_SEGMENTS = obs_metrics.counter(
    "ts_prewarm_segments_total", "Segments pre-created by prewarm, by leg"
)
_DIALS = obs_metrics.counter("ts_prewarm_dials_total", "Connections pre-opened by prewarm, by leg")
ERRORS = obs_metrics.counter(
    "ts_prewarm_errors_total", "Prewarm stage failures (lazy path proceeded)"
)
_CLAMPED = obs_metrics.counter(
    "ts_prewarm_clamped_bytes_total", "Plan bytes dropped by capacity grants (tmpfs headroom)"
)

REGISTRATIONS_SKIPPED = "no registration backend in the port (ROADMAP A11.3)"


def fail(report: dict, stage: str, exc: BaseException) -> None:
    """Count and report a failed stage; the lazy path serves."""
    ERRORS.inc(stage=stage)
    report["ok"] = False
    report["errors"][stage] = f"{type(exc).__name__}: {exc}"
    logger.warning("prewarm stage %s failed (%s: %s); the lazy path will serve", stage,
                   type(exc).__name__, exc)


def as_manifest(state_dict_or_manifest: Any, transfer_dtype=None,
                transfer_quant: Optional[str] = None, quant_block: int = 256
                ) -> StateDictManifest:
    if isinstance(state_dict_or_manifest, StateDictManifest):
        return state_dict_or_manifest
    return StateDictManifest.from_state_dict(
        state_dict_or_manifest, transfer_dtype=transfer_dtype, transfer_quant=transfer_quant,
        quant_block=quant_block,
    )


async def prewarm_manifest(client, manifest: StateDictManifest, direct: bool = False,
                           flat: Optional[dict] = None, wait_pinned: bool = True) -> dict:
    """Provision every layer a sync of ``manifest`` touches; returns the
    report and never raises. ``direct=True`` also creates the client-local
    staging a direct source's ``register`` draws; ``flat`` (the source's
    flat dict, when one was given) decides whether that source takes the
    device rung, which stages on the card instead. ``wait_pinned``: wait
    for the page-locking of a working set on a card (else it runs in the
    background, as for a put's announced spares). ``seconds`` in the report
    holds each stage's wall time (a volume stage: its slowest volume)."""
    report: dict[str, Any] = {
        "ok": True,
        "manifest_bytes": manifest.total_bytes,
        "entries": len(manifest.entries),
        "planned_bytes": 0,
        "clamped_bytes": 0,
        "granted_bytes": {},
        "segments": 0,
        "bytes": 0,
        "rotation_segments": 0,
        "rotation_bytes": 0,
        "dials": 0,
        "local_segments": 0,
        "pre_attached": 0,
        "device_server": None,
        "errors": {},
        "seconds": {},
    }
    RUNS.inc()
    try:
        with obs_context.ensure_root(), span("provision.prewarm", nbytes=manifest.total_bytes,
                                             entries=len(manifest.entries)):
            plan = await _build_plan(client, manifest, report)
            if plan is not None:
                reservation = await _reserve(client, plan, report)
                await _run_volume_legs(client, plan, report, pin=manifest.device_resident)
                if manifest.device_resident and wait_pinned and report["pre_attached"]:
                    with _timed(report, "pin"), span("provision.pin"):
                        try:
                            await client.wait_pinned()
                        except Exception as exc:  # noqa: BLE001 - advisory: the
                            # attachment stays pageable
                            fail(report, "pin", exc)
                if plan.device_server:
                    _run_device_leg(report)
                if any(vp.transport == "bulk" for vp in plan.volumes.values()):
                    report["skipped"] = {"registrations": REGISTRATIONS_SKIPPED}
                if reservation is not None:
                    with _timed(report, "release"), span("provision.release"):
                        try:
                            await client.controller.release_prewarm.call_one(reservation)
                        except Exception:  # noqa: BLE001 - its TTL expires it anyway
                            pass
            if direct:
                await _run_local_staging_leg(client, manifest, flat, report)
    except Exception as exc:  # noqa: BLE001 - prewarm never raises
        # Exception, not BaseException: a cancelled caller (the auto hint
        # runs inside put_state_dict) still cancels it.
        fail(report, "prewarm", exc)
    return report


@contextlib.contextmanager
def _timed(report: dict, stage: str):
    """Keep the longest wall time of ``stage`` in ``report["seconds"]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        took = time.perf_counter() - t0
        report["seconds"][stage] = max(report["seconds"].get(stage, 0.0), took)


async def _build_plan(client, manifest: StateDictManifest, report: dict):
    try:
        with _timed(report, "plan"), span("provision.plan", entries=len(manifest.entries)):
            await client._ensure_setup()
            if not client._volume_refs:
                raise RuntimeError("no storage volumes")
            config = client.config
            # The volumes a put lands on now: primary and replicas, each
            # quarantined one replaced as the put replaces it.
            volumes = client._put_volumes()
            transports = {v.volume_id: create_transport_buffer(v, config).transport_name
                          for v in volumes}
            plan = planner.plan_provisioning(
                manifest, [v.volume_id for v in volumes], transports,
                ici_available=config.ici_enabled and dt.is_available(),
                arena_max_bytes=config.arena_max_bytes,
            )
            report["transports"] = transports
            report["planned_bytes"] = plan.planned_bytes
            return plan
    except Exception as exc:  # noqa: BLE001 - cancellation propagates
        fail(report, "plan", exc)
        return None


async def _reserve(client, plan: planner.ProvisionPlan, report: dict) -> Optional[str]:
    asks = {vid: vp.planned_bytes for vid, vp in plan.volumes.items()
            if vp.transport == "shm" and vp.planned_bytes}
    if not asks:
        return None
    reservation = uuid.uuid4().hex
    try:
        with _timed(report, "reserve"), span("provision.reserve", volumes=len(asks)):
            result = await client.controller.reserve_prewarm.call_one(
                reservation, asks, config=client.config)
        grants = result.get("grants", {})
        report["granted_bytes"] = grants
        for vid, reason in (result.get("errors") or {}).items():
            ERRORS.inc(stage="reserve")
            report["errors"][f"reserve:{vid}"] = reason
            report["ok"] = False
        for vid, vp in plan.volumes.items():
            planner.clamp_to_grant(vp, grants.get(vid))
        report["clamped_bytes"] = plan.clamped_bytes
        if plan.clamped_bytes:
            _CLAMPED.inc(plan.clamped_bytes)
            logger.info("prewarm clamped %d bytes to fit capacity grants (tmpfs headroom)",
                        plan.clamped_bytes)
        return reservation
    except Exception as exc:  # noqa: BLE001 - go on unclamped: the volume
        # clamps to its own pool cap and tmpfs regardless.
        fail(report, "reserve", exc)
        return None


async def _run_volume_legs(client, plan: planner.ProvisionPlan, report: dict,
                           pin: bool) -> None:
    config = client.config

    async def one(vid: str, vp: planner.VolumePlan) -> None:
        volume = client._volume_refs[vid]
        if vp.transport == "shm" and vp.segment_sizes:
            with _timed(report, "shm"), span("provision.shm", volume=vid,
                                             nbytes=vp.planned_bytes):
                result = await volume.actor.provision_shm.call_one(vp.segment_sizes, config)
            if result.get("error"):
                raise RuntimeError(f"volume {vid}: {result['error']}")
            report["segments"] += result.get("created", 0)
            report["bytes"] += result.get("bytes", 0)
            report["rotation_segments"] += result.get("rotation", 0)
            report["rotation_bytes"] += result.get("rotation_bytes", 0)
            # The volume clamps to its own pool cap and tmpfs too.
            if result.get("clamped_bytes"):
                report["clamped_bytes"] += result["clamped_bytes"]
                _CLAMPED.inc(result["clamped_bytes"])
            _SEGMENTS.inc(result.get("created", 0), leg="shm")
            _BYTES.inc(result.get("bytes", 0), leg="shm")
            names = result.get("names") or []
            if names:
                # The client half: attach (and, for a working set on a card,
                # page-lock) what the volume made, so the first put's
                # offers find their attachments.
                with _timed(report, "pre_attach"), span("provision.pre_attach", volume=vid,
                                                        segments=len(names)):
                    attached = await shm.pre_attach_segments(volume, names, pin=pin)
                report["pre_attached"] += attached
        elif vp.transport == "bulk" and vp.dials:
            with _timed(report, "bulk"), span("provision.bulk", volume=vid, dials=vp.dials):
                n = await bulk.prewarm_connection(volume, config, stripes=vp.dials - 1)
            report["dials"] += n
            _DIALS.inc(n, leg="bulk")

    items = sorted(plan.volumes.items())
    results = await asyncio.gather(*(one(vid, vp) for vid, vp in items), return_exceptions=True)
    for (vid, _), result in zip(items, results):
        if isinstance(result, BaseException):
            if not isinstance(result, Exception):
                raise result  # cancellation propagates
            fail(report, f"volume:{vid}", result)


def _run_device_leg(report: dict) -> None:
    try:
        with _timed(report, "device"), span("provision.device"):
            report["device_server"] = dt.prewarm_engine()
    except Exception as exc:  # noqa: BLE001
        fail(report, "device", exc)


async def _run_local_staging_leg(client, manifest: StateDictManifest, flat: Optional[dict],
                                 report: dict) -> None:
    """Create and prefault the client-local staging segments a direct
    source's ``register`` draws (one a tensor, in the transfer dtype), on
    an executor thread: a model-sized prefault on the loop would stall every
    RPC. A source whose leaves take the device rung stages on the card, so
    the device engine is made ready instead."""
    from torchstore_tpu_torch import direct_weight_sync as dws

    try:
        with _timed(report, "local_staging"), span("provision.local_staging",
                                                   nbytes=manifest.total_bytes):
            config = client.config
            if flat is not None:
                on_cards = dws.device_rung_eligible(
                    {k: dws._local_shard(v) for k, v in flat.items()}, config)
            else:
                on_cards = manifest.device_resident and config.ici_enabled and dt.is_available()
            if on_cards:
                report["device"] = True
                report["device_server"] = dt.prewarm_engine()
                return
            result = await asyncio.get_running_loop().run_in_executor(
                None, local_pool().provision, manifest.segment_sizes())
        if result.get("error"):
            raise RuntimeError(result["error"])
        report["local_segments"] = result["created"]
        report["local_bytes"] = result["bytes"]
        if result["clamped_bytes"]:
            report["clamped_bytes"] += result["clamped_bytes"]
            _CLAMPED.inc(result["clamped_bytes"])
        _SEGMENTS.inc(result["created"], leg="local")
        _BYTES.inc(result["bytes"], leg="local")
    except Exception as exc:  # noqa: BLE001
        fail(report, "local_staging", exc)


# --------------------------------------------------------------------------
# the automatic hint (put_state_dict)
# --------------------------------------------------------------------------

# Per client, the size signatures prewarmed already: the hint fires once per
# distinct working-set shape, not once per publish. Weak client keys cannot
# outlive their client (a forked child builds its own).
_auto_seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


async def maybe_auto_prewarm(client, flat: dict) -> Optional[dict]:
    """The ``put_state_dict`` hint: provision from the flat dict about to be
    put (already cast or encoded) before its first data-plane puts. Gated
    by ``config.prewarm_auto`` and ``prewarm_auto_min_bytes``; at most once
    per size signature per client; never raises."""
    from torchstore_tpu_torch.state_dict_utils import _local_leaf

    try:
        config = getattr(client, "config", None)
        if config is None or not config.prewarm_auto:
            return None
        # The cheap checks first: a loop that puts the same working set
        # every step pays this signature only.
        signature = []
        for key, value in flat.items():
            local, _ = _local_leaf(value)
            if local is not None and local.numel():
                signature.append((key, local.numel() * local.element_size()))
        signature = tuple(sorted(signature))
        if sum(n for _, n in signature) < config.prewarm_auto_min_bytes:
            return None
        seen = _auto_seen.setdefault(client, set())
        if signature in seen:
            return None
        seen.add(signature)
        # On the put's critical path: page-locking runs in the background.
        report = await prewarm_manifest(client, StateDictManifest.from_state_dict(flat),
                                        wait_pinned=False)
        logger.info("auto-prewarm: %d entries / %d bytes -> %d segment(s), %d dial(s)%s",
                    report["entries"], report["manifest_bytes"], report["segments"],
                    report["dials"], " (with errors)" if report["errors"] else "")
        return report
    except Exception as exc:  # noqa: BLE001 - the put proceeds
        fail({"ok": False, "errors": {}}, "auto", exc)
        return None
