"""Runnable drives of the port: ``python -m torchstore_tpu_torch.examples.<name>``."""
