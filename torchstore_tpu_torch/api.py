"""Public module-level async API.

Port of ``torchstore_tpu/api.py`` for one host: a registry of stores keyed
by ``store_name``; ``initialize`` spawns the storage volumes and the
controller as processes and wires them; ``put``/``get``/... delegate to the
store's ``LocalClient``. ``initialize`` publishes the controller's handle in
``TORCHSTORE_TORCH_STORE_<name>``, which ``runtime.spawn_actors`` hands to
its children, so an actor process reaches the store by name (a learner
publishing, a generator acquiring).

``initialize(storage_dir=...)`` makes the volumes durable (each persists
its entries under ``<storage_dir>/<volume_id>``), and ``recover=True``
rebuilds the controller's index from what the directory holds.
``version_catalog``, the ``lease_*`` calls and ``tier_sweep`` reach the
version-retention and spill-tier plane (``tiering/``).

``repair`` replaces dead volumes with fresh processes under their ids and
copies back every key a survivor still holds; ``volume_health`` reads the
controller's supervisor (quarantine, probation, auto-repair). ``shutdown``
also unlinks the segments a killed volume left in ``/dev/shm``.

``initialize(colocated=True)`` hosts the one volume in this process: its
actor server still answers other processes, and this process's calls on it
are direct (the transports copy what they store and serve, as the frames
would). ``config.auth_secret`` turns on the HMAC challenge on every
listener; it is one per process. ``inject_fault`` / ``clear_faults`` arm
fault points in running processes, ``metrics_snapshot`` returns this
process's registry and ``collect_trace`` merges the per-process trace
files.
"""

from __future__ import annotations

import asyncio
import base64
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from torchstore_tpu_torch import config as config_mod
from torchstore_tpu_torch import native, state_dict_utils
from torchstore_tpu_torch.client import LocalClient
from torchstore_tpu_torch.config import (
    ENV_AUTH_SECRET,
    ENV_PREFIX,
    ENV_STORAGE_DIR,
    ENV_VOLUME_ID,
    StoreConfig,
    default_config,
)
from torchstore_tpu_torch.controller import Controller
from torchstore_tpu_torch.logging import get_logger, set_log_level
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability import recorder as obs_recorder
from torchstore_tpu_torch.observability import tracing
from torchstore_tpu_torch.runtime import (
    ActorMesh,
    ActorRef,
    get_or_spawn_singleton,
    spawn_actors,
    stop_singleton,
)
from torchstore_tpu_torch.runtime.actors import (
    ActorServer,
    close_all_connections,
    register_inproc,
    unregister_inproc,
)
from torchstore_tpu_torch.storage_volume import StorageVolume
from torchstore_tpu_torch.strategy import LocalRankStrategy, SingletonStrategy, StoreStrategy
from torchstore_tpu_torch.transport import shared_memory
from torchstore_tpu_torch.transport.types import Request

logger = get_logger("torchstore_tpu_torch.api")

DEFAULT_STORE = "default"
ENV_STORE_PREFIX = ENV_PREFIX + "STORE_"


@dataclass
class _StoreHandle:
    controller: ActorRef
    volume_mesh: Optional[ActorMesh]  # None in a process that did not initialize
    client: LocalClient
    # A colocated volume: (its actor server, its ref, the volume).
    inproc_volume: Optional[tuple] = None
    # How a volume is spawned again: each one's env by rank, and the rank
    # each replacement stands in for (by volume id).
    volume_env_fn: Optional[Callable[[int], dict]] = None
    # Replacement volumes spawned by repair(), one mesh each.
    repair_meshes: list = field(default_factory=list)
    repair_ranks: dict = field(default_factory=dict)


_stores: dict[str, _StoreHandle] = {}


def _publish_handle(store_name: str, controller: ActorRef) -> None:
    payload = base64.b64encode(pickle.dumps(controller)).decode()
    os.environ[ENV_STORE_PREFIX + store_name] = payload


def _discover_handle(store_name: str) -> Optional[ActorRef]:
    payload = os.environ.get(ENV_STORE_PREFIX + store_name)
    if not payload:
        return None
    return pickle.loads(base64.b64decode(payload))


def _controller_name(store_name: str) -> str:
    return f"tst_{store_name}_controller"


async def initialize(
    num_storage_volumes: int = 1,
    strategy: Optional[StoreStrategy] = None,
    store_name: str = DEFAULT_STORE,
    config: Optional[StoreConfig] = None,
    storage_dir: Optional[str] = None,
    recover: bool = False,
    colocated: bool = False,
    volume_env_fn: Optional[Callable[[int], dict]] = None,
) -> ActorRef:
    """Boot a store on this host: spawn the volume processes and the
    controller process, and wire them. ``colocated=True`` hosts the one
    volume in this process instead.

    ``storage_dir``: the volumes persist every entry under
    ``<storage_dir>/<volume_id>`` and serve what it already holds;
    ``recover=True`` (which requires it) rebuilds the index from those
    entries, so a store restarted over the directory serves them again.

    ``volume_env_fn(rank) -> dict`` adds environment to each spawned volume
    (ignored when colocated): a ``TORCHSTORE_TORCH_HOSTNAME`` of its own
    emulates a volume on another host on one box, so the client reaches
    it over the bulk rung."""
    if store_name in _stores:
        raise RuntimeError(f"store {store_name!r} already initialized")
    config = config or default_config()
    if recover and not storage_dir:
        raise ValueError("recover=True requires storage_dir")
    if colocated and num_storage_volumes != 1:
        raise ValueError("colocated=True hosts exactly one volume")
    set_log_level(config.log_level)
    if native.enabled():
        native.get_lib()  # built or loaded now, not under the first transfer
    if strategy is None:
        strategy = SingletonStrategy() if num_storage_volumes == 1 else LocalRankStrategy()
    if getattr(strategy, "replication", 1) > num_storage_volumes:
        raise ValueError(
            f"replication={strategy.replication} needs at least that many storage volumes "
            f"(have {num_storage_volumes})"
        )
    if config.auth_secret:
        # Auth is per process: the connection pool and every listener of
        # this process read one secret, so a second store with another one
        # would break the first's connections. Exported, the secret reaches
        # the volume and controller processes with the other settings.
        existing = os.environ.get(ENV_AUTH_SECRET)
        if existing and existing != config.auth_secret:
            raise ValueError(
                f"a different {ENV_AUTH_SECRET} is already active in this process; auth "
                "secrets are per-process, not per-store"
            )
        if existing != config.auth_secret:
            os.environ[ENV_AUTH_SECRET] = config.auth_secret
            config_mod._default_config = None
    # The storage directory rides each volume's spawn environment, never
    # this process's: a failed or concurrent initialize leaks it nowhere.
    volume_env = {ENV_STORAGE_DIR: storage_dir} if storage_dir else {}

    def env_fn(rank: int) -> dict:
        return {**volume_env, **((volume_env_fn(rank) or {}) if volume_env_fn else {})}

    # Volumes and controller start together.
    volumes, controller = await asyncio.gather(
        _host_colocated_volume(store_name, strategy, storage_dir) if colocated else spawn_actors(
            num_storage_volumes, StorageVolume, f"tst_{store_name}_volume", strategy,
            env_fn=env_fn,
        ),
        get_or_spawn_singleton(_controller_name(store_name), Controller),
        return_exceptions=True,
    )
    inproc_volume = None
    if colocated and not isinstance(volumes, BaseException):
        volumes, inproc_volume = volumes
    try:
        for res in (volumes, controller):
            if isinstance(res, BaseException):
                raise res
        controller.rpc_timeout = config.rpc_timeout
        await controller.init.call_one(strategy, volumes.refs)
        if recover:
            recovered = await controller.rebuild_index.call_one()
            logger.info("recovered %d entries from %s", recovered, storage_dir)
    except BaseException:
        if inproc_volume is not None:
            await _stop_colocated_volume(inproc_volume)
        elif isinstance(volumes, ActorMesh):
            await volumes.stop()
        await stop_singleton(_controller_name(store_name))
        raise
    _stores[store_name] = _StoreHandle(
        controller=controller,
        volume_mesh=None if colocated else volumes,
        client=LocalClient(controller, config),
        inproc_volume=inproc_volume,
        volume_env_fn=env_fn,
    )
    _publish_handle(store_name, controller)
    return controller


async def _host_colocated_volume(
    store_name: str, strategy, storage_dir: Optional[str] = None
) -> tuple[ActorMesh, tuple]:
    """One ``StorageVolume`` in this process: a real actor server (other
    processes reach it over RPC) and an in-process registration (this
    process's calls are direct)."""
    volume = StorageVolume(strategy, storage_dir)
    name = f"tst_{store_name}_volume_0"
    server = ActorServer()
    server.register(name, volume)
    port = await server.start()
    ref = ActorRef(name, server.address, port)
    register_inproc(server.address, port, name, volume)
    return ActorMesh([ref], []), (server, ref, volume)


async def _stop_colocated_volume(inproc_volume: tuple) -> None:
    """Unregister and close a colocated volume, and release its segments:
    the orphan reaper keys on dead creators, and this process lives on."""
    server, ref, volume = inproc_volume
    unregister_inproc(ref.host, ref.port, ref.name)
    try:
        await volume.on_stop()
    except Exception:  # noqa: BLE001 - close the server regardless
        logger.exception("colocated volume cleanup failed")
    await server.close()


def client(store_name: str = DEFAULT_STORE) -> LocalClient:
    """The ``LocalClient`` of ``store_name``: of the store this process
    initialized, or, in an actor process its spawner started after
    ``initialize``, of the store whose handle it was given."""
    handle = _stores.get(store_name)
    if handle is None:
        controller = _discover_handle(store_name)
        if controller is None:
            raise RuntimeError(
                f"store {store_name!r} is not initialized in this process and no published "
                "handle was found; call initialize() first"
            )
        handle = _stores[store_name] = _StoreHandle(
            controller=controller, volume_mesh=None, client=LocalClient(controller)
        )
    return handle.client


async def put(key: str, value: Any, store_name: str = DEFAULT_STORE) -> None:
    await client(store_name).put(key, value)


async def put_batch(items: dict[str, Any], store_name: str = DEFAULT_STORE) -> None:
    await client(store_name).put_batch(items)


async def get(key: str, like: Any = None, store_name: str = DEFAULT_STORE) -> Any:
    return await client(store_name).get(key, like)


async def get_batch(items, store_name: str = DEFAULT_STORE) -> dict[str, Any]:
    return await client(store_name).get_batch(items)


async def delete(key: str, store_name: str = DEFAULT_STORE) -> None:
    await client(store_name).delete(key)


async def delete_prefix(prefix: str, store_name: str = DEFAULT_STORE) -> int:
    return await client(store_name).delete_prefix(prefix)


async def keys(prefix: Optional[str] = None, store_name: str = DEFAULT_STORE) -> list[str]:
    return await client(store_name).keys(prefix)


async def exists(key: str, store_name: str = DEFAULT_STORE) -> bool:
    return await client(store_name).exists(key)


async def wait_for(keys, timeout: Optional[float] = None, store_name: str = DEFAULT_STORE) -> None:
    """Block until every key (str or list of str) exists and is committed
    (a sharded key: every mesh coordinate landed); ``TimeoutError`` on
    expiry. The controller wakes the wait, in place of polling a get."""
    await client(store_name).wait_for(keys, timeout=timeout)


async def put_state_dict(
    key: str,
    state_dict: Any,
    transfer_dtype: Optional[torch.dtype] = None,
    transfer_quant: Optional[str] = None,
    direct: bool = False,
    rank: int = 0,
    num_ranks: int = 1,
    store_name: str = DEFAULT_STORE,
) -> None:
    """Publish a state dict under ``key``: through the store (buffered), or
    with ``direct=True`` as staging buffers dests pull from in one hop.
    ``transfer_dtype`` casts floating leaves for the transfer;
    ``transfer_quant`` (int8, int8_block, int4_block; default: the config's
    ``transfer_quant``) ships each as one fused quantized blob instead,
    encoded on the leaf's device."""
    await state_dict_utils.put_state_dict(
        client(store_name),
        key,
        state_dict,
        transfer_dtype=transfer_dtype,
        transfer_quant=transfer_quant,
        direct=direct,
        rank=rank,
        num_ranks=num_ranks,
    )


def direct_staging_buffers(key: str, store_name: str = DEFAULT_STORE) -> Any:
    """Registered staging buffers of a direct-pushed state dict, or None."""
    return state_dict_utils.direct_staging_buffers(client(store_name), key)


def direct_sync_stats(key: str, store_name: str = DEFAULT_STORE) -> dict:
    """The rung, page-locking seconds and the last pull's copied regions of
    the direct sync of ``key`` in this process."""
    return state_dict_utils.direct_sync_stats(client(store_name), key)


async def get_state_dict(
    key: str,
    user_state_dict: Any = None,
    direct: bool = False,
    strict: bool = True,
    key_order: Optional[list] = None,
    on_layer: Any = None,
    stream: bool = False,
    store_name: str = DEFAULT_STORE,
) -> Any:
    """Fetch the state dict published under ``key``; with
    ``user_state_dict`` its tensors (CPU or CUDA) are filled in place.
    ``stream=True`` (or a ``key_order`` / ``on_layer``) reads a streamed
    publish layer by layer (``get_state_dict_streamed``)."""
    return await state_dict_utils.get_state_dict(
        client(store_name), key, user_state_dict, direct=direct, strict=strict,
        key_order=key_order, on_layer=on_layer, stream=stream,
    )


async def prewarm(
    state_dict: Any,
    store_name: str = DEFAULT_STORE,
    transfer_dtype: Optional[torch.dtype] = None,
    direct: bool = False,
    acquire_key: Optional[str] = None,
) -> dict:
    """Provision the direct path ahead of its first sync. ``acquire_key``
    (with ``state_dict`` as the acquire's targets): build and cache the
    dest's transfer plan of that direct-pushed key, dial its sources and
    attach their same-host staging, so the first ``get_state_dict(...,
    direct=True)`` starts at the data movement. ``direct=True``: create and
    pre-fault the client-local ``/dev/shm`` staging a direct source's
    ``register`` draws (one segment per tensor, in ``transfer_dtype`` for
    floating leaves); when the leaves would take the device rung, which
    stages on the card, make the device engine ready instead. Advisory: a failure is logged and reported
    (``ok``, ``errors``), never raised. Provisioning the store's volumes
    (the manifest, pool reservations, dials) is not ported."""
    from torchstore_tpu_torch.provision.pool import local_pool

    def advisory_failure(stage: str, exc: Exception) -> dict:
        logger.warning("prewarm %s failed: %s; the lazy path will serve", stage, exc)
        return {"ok": False, "errors": {stage: str(exc)}}

    if acquire_key is not None:
        try:
            return await state_dict_utils.preplan_direct(client(store_name), acquire_key,
                                                         state_dict)
        except Exception as exc:  # noqa: BLE001 - advisory, never raises
            return advisory_failure("preplan", exc)
    if not direct:
        raise NotImplementedError(
            "prewarm of the store's volumes (manifest, pool reservations, dials) is not "
            "ported yet; see ROADMAP.md, queue A, item A11"
        )
    try:
        from torchstore_tpu_torch.direct_weight_sync import _local_shard, device_rung_eligible

        flat, _ = state_dict_utils.flatten_state_dict(state_dict)
        shards = {k: _local_shard(v) for k, v in flat.items()}
        if device_rung_eligible(shards, client(store_name).config):
            from torchstore_tpu_torch.transport.device_transfer import prewarm_engine

            return {"ok": True, "errors": {}, "local_segments": 0, "bytes": 0, "device": True,
                    "device_server": prewarm_engine()}
        sizes: dict[int, int] = {}
        for shard in shards.values():
            if shard is None:
                continue
            t = shard[1]
            dtype = transfer_dtype if transfer_dtype is not None and t.is_floating_point() \
                else t.dtype
            size = t.numel() * torch.empty((), dtype=dtype).element_size()
            sizes[size] = sizes.get(size, 0) + 1
        result = await asyncio.get_running_loop().run_in_executor(
            None, local_pool().provision, sizes)
    except Exception as exc:  # noqa: BLE001 - advisory, never raises
        return advisory_failure("local_staging", exc)
    if result.get("error"):
        return advisory_failure("local_staging", RuntimeError(result["error"]))
    return {"ok": True, "errors": {}, "local_segments": result["created"],
            "bytes": result["bytes"], "clamped_bytes": result["clamped_bytes"]}


def state_dict_stream(
    key: str,
    transfer_dtype: Optional[torch.dtype] = None,
    transfer_quant: Optional[str] = None,
    store_name: str = DEFAULT_STORE,
):
    """Open a layer-streamed publish of ``key``: ``await stream.put(...)``
    each fragment as its tensors become ready, then ``await
    stream.seal()``. Each fragment is watermarked per key, so streaming
    readers serve it at once, while barrier readers still wake only on the
    sealed dict. Delta encoding is the weight channel's
    (``WeightPublisher(delta=True)``)."""
    return state_dict_utils.stream_state_dict(
        client(store_name), key, transfer_dtype=transfer_dtype, transfer_quant=transfer_quant
    )


async def get_state_dict_streamed(
    key: str,
    user_state_dict: Any = None,
    key_order: Optional[list] = None,
    on_layer: Any = None,
    strict: bool = True,
    timeout: Optional[float] = None,
    wait_for_stream_s: Optional[float] = None,
    store_name: str = DEFAULT_STORE,
) -> Any:
    """Acquire a streamed publish layer by layer: each key once its
    watermark lands, in ``key_order`` when given, with ``on_layer(flat_key,
    value)`` per served leaf; ``wait_for_stream_s`` waits for a publisher
    that has not begun yet. Never mixes generations (``stream_sync``)."""
    from torchstore_tpu_torch import stream_sync

    return await stream_sync.get_state_dict_streamed(
        client(store_name), key, user_state_dict=user_state_dict, key_order=key_order,
        on_layer=on_layer, strict=strict, timeout=timeout,
        wait_for_stream_s=wait_for_stream_s,
    )


async def initialize_spmd(
    strategy: Optional[StoreStrategy] = None,
    store_name: str = DEFAULT_STORE,
    config: Optional[StoreConfig] = None,
    storage_dir: Optional[str] = None,
    recover: bool = False,
) -> None:
    """Collective bootstrap from a torchrun-style environment: call it on
    every rank (``spmd.initialize``). ``storage_dir``: each host's volumes
    persist under it; ``recover=True`` rebuilds the index from it on rank
    0."""
    from torchstore_tpu_torch import spmd

    await spmd.initialize(strategy=strategy, store_name=store_name, config=config,
                          storage_dir=storage_dir, recover=recover)


async def barrier(name: str, store_name: str = DEFAULT_STORE, timeout: float = 300.0) -> None:
    """A barrier across the SPMD world that initialized this store
    (put, barrier, get is the exchange); needs ``initialize_spmd``."""
    from torchstore_tpu_torch import spmd

    session = spmd._spmd_sessions.get(store_name)
    if session is None:
        raise RuntimeError(
            f"barrier requires an SPMD-initialized store (none for {store_name!r}); "
            "call initialize_spmd() first"
        )
    await session.client.barrier(name, session.env.world_size, timeout=timeout)


async def shutdown(store_name: str = DEFAULT_STORE) -> None:
    """Tear down a store: release its direct-sync staging and the client's
    segment attachments, reset and stop the volume and controller
    processes. In a process that reached the store by its published handle,
    only this process's client and connections go. A store an SPMD session
    owns shuts down collectively (``spmd.shutdown``)."""
    from torchstore_tpu_torch import spmd
    from torchstore_tpu_torch.provision.pool import local_pool

    if await spmd.shutdown(store_name):
        return
    handle = _stores.pop(store_name, None)
    if handle is None:
        return
    await state_dict_utils.close_direct_caches(handle.client)
    if not _stores:
        local_pool().clear()  # staging prewarmed for sources never registered
    handle.client.close()
    if handle.volume_mesh is None and handle.inproc_volume is None:
        # A process that reached the store by its handle: the store lives on.
        await close_all_connections()
        return
    os.environ.pop(ENV_STORE_PREFIX + store_name, None)
    try:
        await handle.controller.teardown.call_one()
    except Exception:  # noqa: BLE001 - stop the processes regardless
        logger.exception("controller teardown failed")
    for mesh in [handle.volume_mesh, *handle.repair_meshes]:
        if mesh is not None:
            await mesh.stop()
    if handle.inproc_volume is not None:
        await _stop_colocated_volume(handle.inproc_volume)
    await stop_singleton(_controller_name(store_name))
    await close_all_connections()
    if shared_memory.is_available():
        # A killed volume could not unlink its segments; nothing else would.
        shared_memory.reap_orphaned_segments()


# ---- health and repair --------------------------------------------------------


async def volume_health(store_name: str = DEFAULT_STORE) -> dict:
    """The health supervisor's view: ``{volume_id: {"state": "ok" |
    "probation" | "quarantined", "misses", "oks"}}``."""
    c = client(store_name)
    await c._ensure_setup()
    return await c.controller.volume_health.call_one()


def _volume_rank(handle: _StoreHandle, ref: ActorRef, vid: str) -> int:
    """The spawn rank of the volume at ``ref`` (its env is that rank's)."""
    for rank, mine in enumerate(handle.volume_mesh.refs):
        if (mine.host, mine.port, mine.name) == (ref.host, ref.port, ref.name):
            return rank
    return handle.repair_ranks.get(vid, 0)


async def repair(store_name: str = DEFAULT_STORE) -> dict:
    """Replace dead volumes with fresh processes and copy back every key a
    surviving replica still holds. Runs in the process that initialized the
    store (with spawned volumes). Returns ``{"replaced": [volume ids],
    "rereplicated": keys copied back, "lost": [keys with no copy left, now
    out of the index: reads fail loudly as missing], "failed": [keys whose
    copy failed: their surviving copies stay indexed, run it again],
    "wedged": [volume ids alive but not answering]}``. Every dead volume is
    replaced first, then keys are copied key by key, each replacement
    getting exactly the slices the dead volume held, so a failure of
    several volumes repairs whatever any survivor holds. A wedged volume is
    never replaced (it may recover: kill it first to replace it). The
    replacement takes the dead volume's id and spawn environment; the
    segments the dead process left in ``/dev/shm`` are unlinked."""
    handle = _stores.get(store_name)
    if handle is None or handle.volume_mesh is None:
        raise RuntimeError(
            "repair must run in the process that initialized the store (with process-backed "
            "volumes)"
        )
    c = client(store_name)
    statuses = await handle.controller.check_volumes.call_one()
    dead = sorted(v for v, st in statuses.items() if st.startswith("dead"))
    wedged = sorted(v for v, st in statuses.items() if st.startswith("wedged"))
    if dead or wedged:
        # The last seconds of local history, before replacement moves things.
        obs_recorder.record("health", "repair", dead=dead, wedged=wedged)
        obs_recorder.dump_postmortem("repair")
    report = {"replaced": [], "rereplicated": 0, "lost": [], "failed": [], "wedged": wedged}
    strategy = await handle.controller.get_strategy.call_one()
    vmap = await handle.controller.get_volume_map.call_one()
    # Replace every dead volume before any copy: a key whose listed survivor
    # is another dead volume would otherwise fail the whole repair.
    recoverable_by_vid: dict[str, dict] = {}
    for vid in dead:
        rank = _volume_rank(handle, vmap[vid]["ref"], vid)
        mesh = await spawn_actors(
            1, StorageVolume, f"tst_{store_name}_volume_repair{len(handle.repair_meshes)}",
            strategy, env_fn=lambda _r, _rank=rank, _vid=vid: {
                **handle.volume_env_fn(_rank), ENV_VOLUME_ID: _vid},
        )
        handle.repair_meshes.append(mesh)
        handle.repair_ranks[vid] = rank
        new_ref = mesh.refs[0]
        info = await new_ref.get_id.call_one()
        result = await handle.controller.replace_volume.call_one(vid, new_ref, info["hostname"])
        report["replaced"].append(vid)
        report["lost"].extend(result["lost"])
        recoverable_by_vid[vid] = result["recoverable"]
    if dead and shared_memory.is_available():
        shared_memory.reap_orphaned_segments()
    await c.refresh_volumes()
    # Copy back key by key: one read of each region however many
    # replacements need it, and each replacement gets the slices it held.
    plan: dict[str, dict[str, Any]] = {}
    for vid, recoverable in recoverable_by_vid.items():
        for key, slices in recoverable.items():
            if key not in report["lost"]:  # its last copy died in a later replacement
                plan.setdefault(key, {})[vid] = slices
    for key, by_vid in plan.items():
        try:
            whole: Optional[list[Request]] = None
            regions: dict = {}
            for vid, slices in by_vid.items():
                if slices is None:
                    if whole is None:
                        whole = LocalClient._value_to_requests(key, await c.get(key))
                    requests = whole
                else:
                    requests = []
                    for ts in slices:
                        region = (ts.offsets, ts.local_shape)
                        if region not in regions:
                            regions[region] = await c.get(key, like=ts)
                        requests.append(Request.from_tensor_slice(key, ts, regions[region]))
                await c.replicate_to(vid, requests)
            report["rereplicated"] += 1
        except Exception as exc:  # noqa: BLE001 - reported, never fatal to the others
            logger.warning("repair: copying %r back onto %s failed: %s", key, sorted(by_vid), exc)
            report["failed"].append(key)
    if dead:
        logger.info("repair(%s): replaced %s, re-replicated %d key(s), lost %s", store_name,
                    report["replaced"], report["rereplicated"], report["lost"] or "none")
    return report


# ---- version retention and the spill tier -----------------------------------


async def version_catalog(channel: Optional[str] = None, store_name: str = DEFAULT_STORE) -> dict:
    """Every ``{channel}/v{n}`` group the store holds: keys, logical bytes,
    volumes, the tier split (resident vs spilled to disk) and the cohort
    leases pinning it."""
    return await client(store_name).version_catalog(channel)


async def lease_acquire(
    cohort: str, channel: str, version: int, ttl_s: Optional[float] = None,
    store_name: str = DEFAULT_STORE,
) -> dict:
    """Pin ``(channel, version)`` for ``cohort``: the publisher's GC skips
    it, the controller refuses deletes under it, and no spill pass demotes
    it while the lease lives. TTL'd (default
    ``TORCHSTORE_TORCH_LEASE_TTL_S``); renew to keep it. Returns the lease's
    description; its ``lease_id`` renews and releases it.
    ``WeightSubscriber.acquire(version=)`` holds a read-scoped one itself."""
    return await client(store_name).lease_acquire(cohort, channel, version, ttl_s)


async def lease_renew(lease_id: str, ttl_s: Optional[float] = None,
                      store_name: str = DEFAULT_STORE) -> dict:
    """Extend a live lease; ``KeyError`` once it expired (re-acquire and
    check the version still exists)."""
    return await client(store_name).lease_renew(lease_id, ttl_s)


async def lease_release(lease_id: str, store_name: str = DEFAULT_STORE) -> bool:
    """Drop a lease (idempotent); the version may be reaped or spilled once
    its last lease is gone."""
    return await client(store_name).lease_release(lease_id)


async def lease_list(channel: Optional[str] = None, store_name: str = DEFAULT_STORE) -> dict:
    """The live pins, ``{channel: {version: [cohort, ...]}}``."""
    return await client(store_name).lease_list(channel)


async def tier_sweep(store_name: str = DEFAULT_STORE) -> dict:
    """One spill pass over every volume now, in place of the background
    ``TORCHSTORE_TORCH_TIER_SWEEP_INTERVAL_S`` cadence; per volume its
    spills, fault-ins, resident and spilled bytes (``enabled: False`` when
    ``TORCHSTORE_TORCH_TIER_ENABLED`` is off)."""
    return await client(store_name).tier_sweep()


# ---- faults, metrics, traces ------------------------------------------------


async def inject_fault(
    name: str,
    action: str,
    count: Optional[int] = None,
    prob: Optional[float] = None,
    delay_ms: Optional[float] = None,
    scope: str = "volumes",
    store_name: str = DEFAULT_STORE,
) -> dict:
    """Arm a fault point (``faults.py``) in running processes of the store.
    ``scope``: ``"client"`` (this process), ``"controller"``, ``"volumes"``
    (every volume), a volume id, or ``"all"``. Returns ``{target: armed
    spec}``."""
    from torchstore_tpu_torch import faults

    c = client(store_name)
    await c._ensure_setup()
    kwargs = {"count": count, "prob": prob, "delay_ms": delay_ms}
    out: dict[str, dict] = {}
    if scope in ("client", "all"):
        out["client"] = faults.arm(name, action, **kwargs)
    if scope in ("controller", "all"):
        out["controller"] = await c.controller.inject_fault.call_one(name, action, **kwargs)
    if scope in ("volumes", "all"):
        targets = list(c._volume_refs)
    elif scope in c._volume_refs:
        targets = [scope]
    elif scope in ("client", "controller"):
        targets = []
    else:
        raise ValueError(
            f"unknown fault scope {scope!r}; expected 'client', 'controller', 'volumes', "
            f"'all', or a volume id ({sorted(c._volume_refs)})"
        )
    for vid in targets:
        out[f"volume:{vid}"] = await c._volume_refs[vid].actor.inject_fault.call_one(
            name, action, **kwargs
        )
    return out


async def clear_faults(name: Optional[str] = None, store_name: str = DEFAULT_STORE) -> int:
    """Disarm ``name`` (every fault point when None) in this process, the
    controller and every volume that answers; returns how many armed specs
    were dropped."""
    from torchstore_tpu_torch import faults

    cleared = faults.disarm(name)
    try:
        c = client(store_name)
        await c._ensure_setup()
    except Exception:  # noqa: BLE001 - no store: the local disarm is all
        return cleared
    refs = [c.controller] + [v.actor for v in c._volume_refs.values()]
    for ref in refs:
        try:
            cleared += await ref.clear_faults.call_one(name)
        except Exception:  # noqa: BLE001 - a dead process cannot disarm
            pass
    return cleared


def metrics_snapshot() -> dict:
    """This process's metrics registry, ``{name: {"kind", "help", "series"}}``.
    Metrics are per process: volumes and the controller return theirs in
    ``stats()``, and ``TORCHSTORE_TORCH_METRICS_DUMP`` makes every process
    dump its own."""
    return obs_metrics.metrics_snapshot()


def collect_trace(out_path: Optional[str] = None) -> Optional[dict]:
    """Merge every process's trace file (the ``TORCHSTORE_TORCH_TRACE`` base
    and its pid-suffixed siblings) into one timeline; call after
    ``shutdown`` so the actor processes have flushed. Returns ``{"path",
    "files", "events", "trace_ids"}``, or None when tracing is off."""
    return tracing.collect_trace(out_path)
