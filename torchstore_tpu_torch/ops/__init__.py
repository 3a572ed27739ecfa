"""Device ops of the port (hand-written CUDA kernels and their plain
versions)."""

from torchstore_tpu_torch.ops.staging import cast_kernel, cast_reference, device_cast

__all__ = ["cast_kernel", "cast_reference", "device_cast"]
