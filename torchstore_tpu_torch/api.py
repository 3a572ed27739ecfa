"""Public module-level async API.

Port of ``torchstore_tpu/api.py`` for one host: a registry of stores keyed
by ``store_name``; ``initialize`` spawns the storage volumes and the
controller as processes and wires them; ``put``/``get``/... delegate to the
store's ``LocalClient``. ``initialize`` publishes the controller's handle in
``TORCHSTORE_TORCH_STORE_<name>``, which ``runtime.spawn_actors`` hands to
its children, so an actor process reaches the store by name (a learner
publishing, a generator acquiring).
"""

from __future__ import annotations

import asyncio
import base64
import os
import pickle
from dataclasses import dataclass
from typing import Any, Optional

import torch

from torchstore_tpu_torch import state_dict_utils
from torchstore_tpu_torch.client import LocalClient
from torchstore_tpu_torch.config import ENV_PREFIX, StoreConfig, default_config
from torchstore_tpu_torch.controller import Controller
from torchstore_tpu_torch.logging import get_logger, set_log_level
from torchstore_tpu_torch.runtime import (
    ActorMesh,
    ActorRef,
    get_or_spawn_singleton,
    spawn_actors,
    stop_singleton,
)
from torchstore_tpu_torch.runtime.actors import close_all_connections
from torchstore_tpu_torch.storage_volume import StorageVolume
from torchstore_tpu_torch.strategy import LocalRankStrategy, SingletonStrategy, StoreStrategy

logger = get_logger("torchstore_tpu_torch.api")

DEFAULT_STORE = "default"
ENV_STORE_PREFIX = ENV_PREFIX + "STORE_"


@dataclass
class _StoreHandle:
    controller: ActorRef
    volume_mesh: Optional[ActorMesh]  # None in a process that did not initialize
    client: LocalClient


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
) -> ActorRef:
    """Boot a store on this host: spawn the volume processes and the
    controller process, and wire them."""
    if store_name in _stores:
        raise RuntimeError(f"store {store_name!r} already initialized")
    config = config or default_config()
    set_log_level(config.log_level)
    if strategy is None:
        strategy = SingletonStrategy() if num_storage_volumes == 1 else LocalRankStrategy()
    # Volumes and controller start together: each is a fresh interpreter.
    volumes, controller = await asyncio.gather(
        spawn_actors(num_storage_volumes, StorageVolume, f"tst_{store_name}_volume", strategy),
        get_or_spawn_singleton(_controller_name(store_name), Controller),
        return_exceptions=True,
    )
    try:
        for res in (volumes, controller):
            if isinstance(res, BaseException):
                raise res
        controller.rpc_timeout = config.rpc_timeout
        await controller.init.call_one(strategy, volumes.refs)
    except BaseException:
        if isinstance(volumes, ActorMesh):
            await volumes.stop()
        await stop_singleton(_controller_name(store_name))
        raise
    _stores[store_name] = _StoreHandle(
        controller=controller, volume_mesh=volumes, client=LocalClient(controller, config)
    )
    _publish_handle(store_name, controller)
    return controller


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


async def shutdown(store_name: str = DEFAULT_STORE) -> None:
    """Tear down a store: release its direct-sync staging and the client's
    segment attachments, reset and stop the volume and controller
    processes. In a process that reached the store by its published handle,
    only this process's client and connections go."""
    from torchstore_tpu_torch.provision.pool import local_pool

    handle = _stores.pop(store_name, None)
    if handle is None:
        return
    await state_dict_utils.close_direct_caches(handle.client)
    if not _stores:
        local_pool().clear()  # staging prewarmed for sources never registered
    handle.client.close()
    if handle.volume_mesh is None:
        # A process that reached the store by its handle: the store lives on.
        await close_all_connections()
        return
    os.environ.pop(ENV_STORE_PREFIX + store_name, None)
    try:
        await handle.controller.teardown.call_one()
    except Exception:  # noqa: BLE001 - stop the processes regardless
        logger.exception("controller teardown failed")
    await handle.volume_mesh.stop()
    await stop_singleton(_controller_name(store_name))
    await close_all_connections()
