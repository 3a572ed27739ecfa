"""Actor runtime: processes hosting actors, and RPC between them."""

from torchstore_tpu_torch.runtime.actors import (
    Actor,
    ActorDiedError,
    ActorMesh,
    ActorMeshRef,
    ActorRef,
    ActorTimeoutError,
    RemoteActorError,
    endpoint,
    get_or_spawn_singleton,
    spawn_actors,
    stop_singleton,
)

__all__ = [
    "Actor",
    "ActorDiedError",
    "ActorMesh",
    "ActorMeshRef",
    "ActorRef",
    "ActorTimeoutError",
    "RemoteActorError",
    "endpoint",
    "get_or_spawn_singleton",
    "spawn_actors",
    "stop_singleton",
]
