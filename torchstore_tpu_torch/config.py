"""Store configuration, seeded from ``TORCHSTORE_TORCH_*`` variables.

Port of the fields of ``torchstore_tpu/config.py`` that the weight-sync path
reads. The prefix is ``TORCHSTORE_TORCH_`` and not ``TORCHSTORE_TPU_TORCH_``:
the reference's actor runtime copies every ``TORCHSTORE_TPU_*`` variable into
its children, so the two packages keep their settings apart.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

ENV_PREFIX = "TORCHSTORE_TORCH_"
ENV_RPC_TIMEOUT = ENV_PREFIX + "RPC_TIMEOUT"
ENV_SHM_ENABLED = ENV_PREFIX + "SHM_ENABLED"
ENV_LOG_LEVEL = ENV_PREFIX + "LOG_LEVEL"

_FALSE = ("0", "false", "no", "off")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return float(raw) if raw not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    return raw.strip().lower() not in _FALSE


@dataclass
class StoreConfig:
    """``rpc_timeout``: seconds a control RPC may take (data-plane RPCs add
    time per byte; <= 0 disables deadlines). ``shm_enabled``: same-host
    puts, gets and direct staging go through ``/dev/shm`` segments, else
    through RPC frames and TCP reads."""

    rpc_timeout: float = field(default_factory=lambda: _env_float(ENV_RPC_TIMEOUT, 300.0))
    shm_enabled: bool = field(default_factory=lambda: _env_bool(ENV_SHM_ENABLED, True))
    log_level: str = field(
        default_factory=lambda: os.environ.get(ENV_LOG_LEVEL, "WARNING")
    )


_default_config: Optional[StoreConfig] = None


def default_config() -> StoreConfig:
    """The process's config from the environment, read once."""
    global _default_config
    if _default_config is None:
        _default_config = StoreConfig()
    return _default_config
