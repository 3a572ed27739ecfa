"""torchstore_tpu_torch: the PyTorch / CUDA port of torchstore_tpu.

A distributed asynchronous tensor store built for RL weight sync, on torch
tensors (CPU and CUDA). The JAX package ``torchstore_tpu`` is the reference
this port is held against; the port imports none of it.

    import torchstore_tpu_torch as ts

    await ts.initialize()
    await ts.put_state_dict("policy", model.state_dict(), transfer_dtype=torch.bfloat16)
    await ts.get_state_dict("policy", generator_state_dict)
    await ts.shutdown()
"""

from torchstore_tpu_torch.api import (
    DEFAULT_STORE,
    client,
    delete,
    direct_staging_buffers,
    exists,
    get,
    get_batch,
    get_state_dict,
    initialize,
    keys,
    put,
    put_batch,
    put_state_dict,
    shutdown,
)
from torchstore_tpu_torch.config import StoreConfig
from torchstore_tpu_torch.state_dict_utils import NoMatchingPush, from_numpy_tree
from torchstore_tpu_torch.strategy import LocalRankStrategy, SingletonStrategy

__all__ = [
    "DEFAULT_STORE",
    "LocalRankStrategy",
    "NoMatchingPush",
    "SingletonStrategy",
    "StoreConfig",
    "client",
    "delete",
    "direct_staging_buffers",
    "exists",
    "from_numpy_tree",
    "get",
    "get_batch",
    "get_state_dict",
    "initialize",
    "keys",
    "put",
    "put_batch",
    "put_state_dict",
    "shutdown",
]
