"""Device ops of the port (hand-written CUDA kernels and their plain
versions, and the sequence-parallel attention ops built on them)."""

from torchstore_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_stats,
    flash_stats_eligible,
)
from torchstore_tpu_torch.ops.ring_attention import ring_attention, ring_attention_sharded
from torchstore_tpu_torch.ops.staging import cast_kernel, cast_reference, device_cast
from torchstore_tpu_torch.ops.ulysses_attention import (
    ulysses_attention,
    ulysses_attention_sharded,
)

__all__ = [
    "cast_kernel",
    "cast_reference",
    "device_cast",
    "flash_attention",
    "flash_attention_stats",
    "flash_stats_eligible",
    "ring_attention",
    "ring_attention_sharded",
    "ulysses_attention",
    "ulysses_attention_sharded",
]
