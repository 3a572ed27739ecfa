"""Public module-level async API.

Port of ``torchstore_tpu/api.py`` for one host: a registry of stores keyed
by ``store_name``; ``initialize`` spawns the storage volumes and the
controller as processes and wires them; ``put``/``get``/... delegate to the
store's ``LocalClient``. Reaching a store from a process other than the one
that initialized it is later work.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Optional

import torch

from torchstore_tpu_torch import state_dict_utils
from torchstore_tpu_torch.client import LocalClient
from torchstore_tpu_torch.config import StoreConfig, default_config
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


@dataclass
class _StoreHandle:
    controller: ActorRef
    volume_mesh: ActorMesh
    client: LocalClient


_stores: dict[str, _StoreHandle] = {}


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
    return controller


def client(store_name: str = DEFAULT_STORE) -> LocalClient:
    """The ``LocalClient`` of ``store_name``."""
    handle = _stores.get(store_name)
    if handle is None:
        raise RuntimeError(
            f"store {store_name!r} is not initialized in this process; call initialize() first"
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
    """Page-locking seconds and the last pull's copied regions of the
    direct sync of ``key`` in this process."""
    return state_dict_utils.direct_sync_stats(client(store_name), key)


async def get_state_dict(
    key: str,
    user_state_dict: Any = None,
    direct: bool = False,
    strict: bool = True,
    store_name: str = DEFAULT_STORE,
) -> Any:
    """Fetch the state dict published under ``key``; with
    ``user_state_dict`` its tensors (CPU or CUDA) are filled in place."""
    return await state_dict_utils.get_state_dict(
        client(store_name), key, user_state_dict, direct=direct, strict=strict
    )


async def shutdown(store_name: str = DEFAULT_STORE) -> None:
    """Tear down a store: release its direct-sync staging and the client's
    segment attachments, reset and stop the volume and controller
    processes."""
    handle = _stores.pop(store_name, None)
    if handle is None:
        return
    await state_dict_utils.close_direct_caches(handle.client)
    handle.client.close()
    try:
        await handle.controller.teardown.call_one()
    except Exception:  # noqa: BLE001 - stop the processes regardless
        logger.exception("controller teardown failed")
    await handle.volume_mesh.stop()
    await stop_singleton(_controller_name(store_name))
    await close_all_connections()
