"""torchstore_tpu_torch: the PyTorch / CUDA port of torchstore_tpu.

A distributed asynchronous tensor store built for RL weight sync, on torch
tensors (CPU and CUDA). The JAX package ``torchstore_tpu`` is the reference
this port is held against; the port imports none of it.

    import torchstore_tpu_torch as ts

    await ts.initialize()
    await ts.put_state_dict("policy", model.state_dict(), transfer_dtype=torch.bfloat16)
    await ts.get_state_dict("policy", generator_state_dict)
    await ts.shutdown()

Leaves and targets may be sharded: a ``Shard(data, TensorSlice)`` or a
DTensor is put as its local shard under its mesh coordinates, and a get
with a ``Shard`` or DTensor target fills it with its region of the stored
tensor, whatever layout the tensor was put in. ``transfer_quant`` ships
floating leaves as fused int8/int4 blobs (``quantize_transfer``,
``parse_quant_blob``; ``DeltaEncoder`` / ``DeltaDecoder`` for the delta
tier), byte-identical to the JAX package's.

``WeightPublisher`` / ``WeightSubscriber`` package the RL loop as a
versioned channel (publish, block for the next version, GC old ones), and
``state_dict_stream`` / ``get_state_dict_streamed`` sync layer by layer
under per-key watermarks, so a generator starts on the first layers while
the trainer still publishes the last.
"""

from torchstore_tpu_torch.api import (
    DEFAULT_STORE,
    client,
    delete,
    delete_prefix,
    direct_staging_buffers,
    direct_sync_stats,
    exists,
    get,
    get_batch,
    get_state_dict,
    get_state_dict_streamed,
    initialize,
    keys,
    prewarm,
    put,
    put_batch,
    put_state_dict,
    shutdown,
    state_dict_stream,
    wait_for,
)
from torchstore_tpu_torch.client import Shard
from torchstore_tpu_torch.config import StoreConfig
from torchstore_tpu_torch.state_dict_utils import (
    DeltaDecoder,
    DeltaEncoder,
    NoMatchingPush,
    from_numpy_tree,
    parse_quant_blob,
    quantize_transfer,
    shards_from_numpy,
)
from torchstore_tpu_torch.strategy import HostStrategy, LocalRankStrategy, SingletonStrategy
from torchstore_tpu_torch.stream_sync import MixedGenerationError
from torchstore_tpu_torch.transport.types import TensorSlice
from torchstore_tpu_torch.weight_channel import WeightPublisher, WeightSubscriber

__all__ = [
    "DEFAULT_STORE",
    "DeltaDecoder",
    "DeltaEncoder",
    "HostStrategy",
    "LocalRankStrategy",
    "MixedGenerationError",
    "NoMatchingPush",
    "Shard",
    "SingletonStrategy",
    "StoreConfig",
    "TensorSlice",
    "WeightPublisher",
    "WeightSubscriber",
    "client",
    "delete",
    "delete_prefix",
    "direct_staging_buffers",
    "direct_sync_stats",
    "exists",
    "from_numpy_tree",
    "get",
    "get_batch",
    "get_state_dict",
    "get_state_dict_streamed",
    "initialize",
    "keys",
    "prewarm",
    "put",
    "put_batch",
    "parse_quant_blob",
    "put_state_dict",
    "quantize_transfer",
    "shards_from_numpy",
    "shutdown",
    "state_dict_stream",
    "wait_for",
]
