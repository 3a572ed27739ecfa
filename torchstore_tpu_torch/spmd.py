"""SPMD bootstrap: one store across a torchrun-style world.

Port of ``torchstore_tpu/spmd.py``. Every rank reads the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), meets the others on a rendezvous KV
server that rank 0 hosts, and:

- each host's local rank 0 spawns that host's storage volumes (one per
  rank for ``LocalRankStrategy``, one per host for ``HostStrategy``) and
  publishes their refs; with more than one host they bind every address
  (``TORCHSTORE_TORCH_BIND_HOST=0.0.0.0``) and advertise a reachable one;
- global rank 0 collects every host's refs, spawns the controller, runs
  ``Controller.init`` and broadcasts the pickled controller handle (or the
  error that stopped it, so no rank waits on a key never set);
- every rank builds its ``LocalClient`` from the broadcast handle.

Shutdown is two-phase: every rank signals it is done, rank 0 tears the
controller down and broadcasts the status, and rank 0 stops the rendezvous
server only once every rank has read it. With ``storage_dir`` each host's
volumes persist under it (durable volumes, ``storage_utils/file_store.py``),
and ``recover=True`` has rank 0 rebuild the index from what they hold
before the handle is broadcast.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional

from torchstore_tpu_torch import api
from torchstore_tpu_torch.client import LocalClient
from torchstore_tpu_torch.config import (
    ENV_BIND_HOST,
    ENV_STORAGE_DIR,
    StoreConfig,
    default_config,
)
from torchstore_tpu_torch.controller import Controller
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.runtime import (
    ActorMesh,
    get_or_spawn_singleton,
    spawn_actors,
    stop_singleton,
)
from torchstore_tpu_torch.runtime.actors import close_all_connections
from torchstore_tpu_torch.runtime.rendezvous import (
    RendezvousClient,
    RendezvousServer,
    pickle_handle,
    unpickle_handle,
)
from torchstore_tpu_torch.storage_volume import StorageVolume
from torchstore_tpu_torch.strategy import HostStrategy, LocalRankStrategy, StoreStrategy

logger = get_logger("torchstore_tpu_torch.spmd")


@dataclass(frozen=True)
class SPMDEnv:
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    master_addr: str
    master_port: int

    @classmethod
    def from_env(cls) -> "SPMDEnv":
        missing = [name for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if name not in os.environ]
        if missing:
            raise RuntimeError(
                f"SPMD env incomplete: missing {missing}; launch via a torchrun-style "
                "launcher or export them manually"
            )
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        local_rank = int(os.environ.get("LOCAL_RANK", rank % max(local_world, 1)))
        if not (0 <= rank < world):
            raise ValueError(f"RANK {rank} out of range for WORLD_SIZE {world}")
        if not (0 <= local_rank < local_world):
            raise ValueError(
                f"LOCAL_RANK {local_rank} out of range for LOCAL_WORLD_SIZE {local_world}"
            )
        if world % local_world != 0:
            raise ValueError(f"WORLD_SIZE {world} not divisible by LOCAL_WORLD_SIZE {local_world}")
        return cls(rank=rank, world_size=world, local_rank=local_rank,
                   local_world_size=local_world, master_addr=os.environ["MASTER_ADDR"],
                   master_port=int(os.environ["MASTER_PORT"]))

    @property
    def num_hosts(self) -> int:
        return self.world_size // self.local_world_size

    @property
    def host_rank(self) -> int:
        return self.rank // self.local_world_size


class _SPMDSession:
    def __init__(self, env: SPMDEnv, store_name: str, server: Optional[RendezvousServer],
                 client: RendezvousClient, volume_mesh: Optional[ActorMesh]) -> None:
        self.env = env
        self.store_name = store_name
        self.server = server
        self.client = client
        self.volume_mesh = volume_mesh

    async def shutdown(self) -> None:
        """Two phases: every rank signals done; rank 0 tears down and
        broadcasts the status; the others read it (so a failure on rank 0
        is seen everywhere)."""
        env = self.env
        key = f"spmd/{self.store_name}/shutdown"
        handle = api._stores.get(self.store_name)
        try:
            await self.client.add(f"{key}/ready", 1)
            if env.rank == 0:
                await self.client.wait_counter(f"{key}/ready", env.world_size)
                status = "ok"
                try:
                    if handle is not None:
                        await handle.controller.teardown.call_one()
                except Exception as exc:  # noqa: BLE001 - broadcast, then stop anyway
                    status = f"controller teardown failed: {exc!r}"
                await self.client.set(f"{key}/status", status)
            status = await self.client.get(f"{key}/status")
            if status != "ok":
                logger.warning("spmd shutdown status: %s", status)
            # Rank 0 stops the rendezvous server only once every rank has
            # read the status (a closed connection would fail a slow rank).
            await self.client.add(f"{key}/acked", 1)
            if env.rank == 0:
                await self.client.wait_counter(f"{key}/acked", env.world_size)
        finally:
            if handle is not None:
                from torchstore_tpu_torch import state_dict_utils

                await state_dict_utils.close_direct_caches(handle.client)
                handle.client.close()
            if self.volume_mesh is not None:
                await self.volume_mesh.stop()
            if env.rank == 0:
                await stop_singleton(api._controller_name(self.store_name))
            await self.client.close()
            if self.server is not None:
                await self.server.stop()
            api._stores.pop(self.store_name, None)
            os.environ.pop(api.ENV_STORE_PREFIX + self.store_name, None)
            await close_all_connections()


# This rank's sessions; actor children are never SPMD ranks.
_spmd_sessions: dict[str, _SPMDSession] = {}


def _loopback_bind_addr(addr: str) -> Optional[str]:
    """The resolved loopback IP when ``addr`` resolves to loopback only,
    else None. The listener binds exactly what the clients resolve (a
    hosts file may map the hostname to 127.0.1.1)."""
    try:
        ips = {info[4][0] for info in socket.getaddrinfo(addr, None)}
    except OSError:
        return None
    if ips and all(ip.startswith("127.") or ip == "::1" for ip in ips):
        return sorted(ips)[0]
    return None


async def initialize(
    strategy: Optional[StoreStrategy] = None,
    store_name: str = api.DEFAULT_STORE,
    config: Optional[StoreConfig] = None,
    storage_dir: Optional[str] = None,
    recover: bool = False,
) -> None:
    """Collective store bootstrap: call it on every rank of the world."""
    if recover and not storage_dir:
        raise ValueError("recover=True requires storage_dir")
    env = SPMDEnv.from_env()
    config = config or default_config()
    if strategy is None:
        strategy = LocalRankStrategy()
    if not isinstance(strategy, (LocalRankStrategy, HostStrategy)):
        raise ValueError(
            "SPMD initialization supports LocalRankStrategy and HostStrategy only "
            f"(got {type(strategy).__name__})"
        )
    total_volumes = env.world_size if isinstance(strategy, LocalRankStrategy) else env.num_hosts
    if strategy.replication > total_volumes:
        raise ValueError(
            f"replication={strategy.replication} needs at least that many storage volumes "
            f"(this SPMD world provides {total_volumes})"
        )
    if store_name in _spmd_sessions or store_name in api._stores:
        raise RuntimeError(f"store {store_name!r} already initialized")

    server = None
    if env.rank == 0:
        server = RendezvousServer()
        # A loopback MASTER_ADDR: every rank is local, so the rendezvous
        # port (it unpickles) stays private. Else every interface: binding
        # MASTER_ADDR itself can pick one peers cannot route to (NAT).
        await server.start(_loopback_bind_addr(env.master_addr) or "0.0.0.0", env.master_port)
        from torchstore_tpu_torch.runtime.auth import get_secret

        if env.num_hosts > 1 and not get_secret():
            logger.warning(
                "multi-host SPMD without TORCHSTORE_TORCH_AUTH_SECRET: the rendezvous, "
                "actor and bulk listeners accept any host that reaches them; set the "
                "same secret on every host"
            )
    client = RendezvousClient(env.master_addr, env.master_port)
    ns = f"spmd/{store_name}"
    volume_mesh: Optional[ActorMesh] = None

    async def spawn_local_volumes() -> ActorMesh:
        extra = {ENV_BIND_HOST: "0.0.0.0"} if env.num_hosts > 1 else {}
        if storage_dir:
            extra[ENV_STORAGE_DIR] = storage_dir
        if isinstance(strategy, LocalRankStrategy):
            num_local = env.local_world_size
            base_rank = env.host_rank * env.local_world_size

            def env_fn(i: int) -> dict[str, str]:
                return {"RANK": str(base_rank + i), "LOCAL_RANK": str(i),
                        "WORLD_SIZE": str(env.world_size),
                        "LOCAL_WORLD_SIZE": str(env.local_world_size), **extra}
        else:  # HostStrategy: one volume per host
            num_local = 1

            def env_fn(i: int) -> dict[str, str]:
                return dict(extra)

        return await spawn_actors(num_local, StorageVolume,
                                  f"tst_{store_name}_volume_h{env.host_rank}", strategy,
                                  env_fn=env_fn)

    # Rank 0 publishes a status covering the whole bootstrap (the handle, or
    # the error): a failure on rank 0 fails every rank at once.
    try:
        await client.connect()
        if env.rank == 0:
            try:
                volume_mesh = await spawn_local_volumes()
                await client.set(f"{ns}/volumes/{env.host_rank}", pickle_handle(volume_mesh.refs))
                all_refs = []
                for host in range(env.num_hosts):
                    all_refs.extend(unpickle_handle(await client.get(f"{ns}/volumes/{host}")))
                controller = await get_or_spawn_singleton(api._controller_name(store_name),
                                                          Controller)
                controller.rpc_timeout = config.rpc_timeout
                await controller.init.call_one(strategy, all_refs)
                if recover:
                    recovered = await controller.rebuild_index.call_one()
                    logger.info("spmd recovered %d entries from %s", recovered, storage_dir)
            except BaseException as exc:
                await client.set(f"{ns}/controller_status", ("error", repr(exc)))
                raise
            await client.set(f"{ns}/controller_status", ("ok", pickle_handle(controller)))
        elif env.local_rank == 0:
            volume_mesh = await spawn_local_volumes()
            await client.set(f"{ns}/volumes/{env.host_rank}", pickle_handle(volume_mesh.refs))
        status, payload = await client.get(f"{ns}/controller_status")
        if status != "ok":
            raise RuntimeError(f"SPMD bootstrap failed on rank 0: {payload}")
        controller = unpickle_handle(payload)
    except BaseException:
        # Spawned volumes never outlive a failed bootstrap.
        if volume_mesh is not None:
            await volume_mesh.stop()
        if env.rank == 0:
            await stop_singleton(api._controller_name(store_name))
        await client.close()
        if server is not None:
            await server.stop()
        raise

    api._publish_handle(store_name, controller)
    api._stores[store_name] = api._StoreHandle(
        controller=controller, volume_mesh=None, client=LocalClient(controller, config)
    )
    _spmd_sessions[store_name] = _SPMDSession(env, store_name, server, client, volume_mesh)
    await client.barrier(f"{ns}/ready", env.world_size)


async def shutdown(store_name: str = api.DEFAULT_STORE) -> bool:
    """Collective shutdown; False when no SPMD session owns the store (the
    caller takes the plain ``api.shutdown`` path)."""
    session = _spmd_sessions.pop(store_name, None)
    if session is None:
        return False
    await session.shutdown()
    return True
