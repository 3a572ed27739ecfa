"""Store configuration, seeded from ``TORCHSTORE_TORCH_*`` variables.

Port of the fields of ``torchstore_tpu/config.py`` that the weight-sync path
and the shared-memory segment pool read. The prefix is ``TORCHSTORE_TORCH_``
and not ``TORCHSTORE_TPU_TORCH_``: the reference's actor runtime copies every
``TORCHSTORE_TPU_*`` variable into its children, so the two packages keep
their settings apart.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

ENV_PREFIX = "TORCHSTORE_TORCH_"
ENV_RPC_TIMEOUT = ENV_PREFIX + "RPC_TIMEOUT"
ENV_SHM_ENABLED = ENV_PREFIX + "SHM_ENABLED"
ENV_LOG_LEVEL = ENV_PREFIX + "LOG_LEVEL"
ENV_ZERO_COPY_GET = ENV_PREFIX + "ZERO_COPY_GET"
ENV_SHM_POOL_MAX_BYTES = ENV_PREFIX + "SHM_POOL_MAX_BYTES"
ENV_LANDING_THREADS = ENV_PREFIX + "LANDING_THREADS"
ENV_ARENA_MAX_BYTES = ENV_PREFIX + "ARENA_MAX_BYTES"
ENV_TRANSFER_QUANT = ENV_PREFIX + "TRANSFER_QUANT"
ENV_TRANSFER_QUANT_BLOCK = ENV_PREFIX + "TRANSFER_QUANT_BLOCK"
ENV_DELTA_KEYFRAME = ENV_PREFIX + "DELTA_KEYFRAME"
ENV_DELTA_SKIP_EPS = ENV_PREFIX + "DELTA_SKIP_EPS"
ENV_PLAN_CACHE = ENV_PREFIX + "PLAN_CACHE"
ENV_STREAM_POLL_S = ENV_PREFIX + "STREAM_POLL_S"
ENV_STREAM_RETRIES = ENV_PREFIX + "STREAM_RETRIES"
ENV_ICI_ENABLED = ENV_PREFIX + "ICI_ENABLED"
ENV_DIRECT_SETTLE_TIMEOUT = ENV_PREFIX + "DIRECT_SETTLE_TIMEOUT"

_FALSE = ("0", "false", "no", "off")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return float(raw) if raw not in (None, "") else default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw not in (None, "") else default


def _env_str(name: str, default: str) -> str:
    raw = os.environ.get(name)
    return raw if raw not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    return raw.strip().lower() not in _FALSE


def _default_shm_pool_cap() -> int:
    """A quarter of /dev/shm's available space at startup, clamped to
    [4 GB, 64 GB]: room is left for live and retired segments and for other
    tenants, and the ceiling bounds the tmpfs pages recycled segments pin.
    A model-scale sync (16 GB for Llama-3-8B in bf16) needs the pool to hold
    about one working set, or its puts fall back to cold segments."""
    try:
        stat = os.statvfs("/dev/shm")
        avail = stat.f_frsize * stat.f_bavail
    except OSError:
        return 4 << 30
    return max(4 << 30, min(avail // 4, 64 << 30))


@dataclass
class StoreConfig:
    """``rpc_timeout``: seconds a control RPC may take (data-plane RPCs add
    time per byte; <= 0 disables deadlines). ``shm_enabled``: same-host
    puts, gets and direct staging go through ``/dev/shm`` segments, else
    through RPC frames and TCP reads. ``zero_copy_get``: a same-host get
    without a destination returns a copy-on-write view of the volume's
    segment (held under a read lease) instead of a copy.
    ``shm_pool_max_bytes``: cap on the volume's pool of warm, recycled
    segments; the oldest go beyond it. ``landing_threads``: threads of the
    host-copy pool (0: one per core, at most 4). ``arena_max_bytes``:
    tensors of a put batch at or under this size share one segment (0: no
    arena).

    ``transfer_quant``: default wire quantization of state-dict publishes
    (none|int8|int8_block|int4_block): floating leaves ship as one fused
    blob each (packed codes and their f32 scale table in one segment); an
    explicit ``transfer_quant`` or ``transfer_dtype`` argument overrides
    it. ``quant_block``: elements per block of the blockwise modes (even
    for int4_block; part of the plan signature, so a change is a
    restructure). ``delta_keyframe``: the delta tier ships a full keyframe
    every this many versions of a key, bounding the chain a joining reader
    walks. ``delta_skip_eps``: absolute slack on the delta tier's skip
    threshold (a block ships nothing while its residual is within half its
    keyframe step plus this). ``plan_cache``: iteration-stable transfer
    plans for ``put_state_dict`` / ``get_state_dict``, validated by the
    placement epoch.

    ``stream_poll_s``: seconds of one long-poll round of a layer-streamed
    acquire on the controller (``wait_for_stream``; the acquire re-polls
    after each round to refresh its lag and deadline; wakeups come from
    the notifies, never a spin). ``stream_retries``: how many times a
    streamed acquire restarts after a superseded or mixed-generation
    stream before it fails loudly.

    ``ici_enabled``: a direct publish whose tensor leaves all live on
    cards takes the device rung (CUDA IPC on one host: dests copy card to
    card from the source's card-side staging), as the reference's field of
    the same name turns on its device rung; off, every direct publish
    stages through the host. ``direct_settle_timeout``: seconds a direct
    pull waits for a source whose staging is being overwritten (the
    generation odd) before it gives up; a model-scale refresh or another
    dest's host-fallback staging legitimately holds it odd for seconds."""

    rpc_timeout: float = field(default_factory=lambda: _env_float(ENV_RPC_TIMEOUT, 300.0))
    shm_enabled: bool = field(default_factory=lambda: _env_bool(ENV_SHM_ENABLED, True))
    log_level: str = field(
        default_factory=lambda: os.environ.get(ENV_LOG_LEVEL, "WARNING")
    )
    zero_copy_get: bool = field(default_factory=lambda: _env_bool(ENV_ZERO_COPY_GET, True))
    shm_pool_max_bytes: int = field(
        default_factory=lambda: _env_int(ENV_SHM_POOL_MAX_BYTES, _default_shm_pool_cap())
    )
    landing_threads: int = field(default_factory=lambda: _env_int(ENV_LANDING_THREADS, 0))
    arena_max_bytes: int = field(
        default_factory=lambda: _env_int(ENV_ARENA_MAX_BYTES, 256 << 10)
    )
    transfer_quant: str = field(default_factory=lambda: _env_str(ENV_TRANSFER_QUANT, "none"))
    quant_block: int = field(default_factory=lambda: _env_int(ENV_TRANSFER_QUANT_BLOCK, 256))
    delta_keyframe: int = field(default_factory=lambda: _env_int(ENV_DELTA_KEYFRAME, 8))
    delta_skip_eps: float = field(default_factory=lambda: _env_float(ENV_DELTA_SKIP_EPS, 0.0))
    plan_cache: bool = field(default_factory=lambda: _env_bool(ENV_PLAN_CACHE, True))
    stream_poll_s: float = field(default_factory=lambda: _env_float(ENV_STREAM_POLL_S, 10.0))
    stream_retries: int = field(default_factory=lambda: _env_int(ENV_STREAM_RETRIES, 2))
    ici_enabled: bool = field(default_factory=lambda: _env_bool(ENV_ICI_ENABLED, True))
    direct_settle_timeout: float = field(
        default_factory=lambda: _env_float(ENV_DIRECT_SETTLE_TIMEOUT, 30.0)
    )


_default_config: Optional[StoreConfig] = None


def default_config() -> StoreConfig:
    """The process's config from the environment, read once."""
    global _default_config
    if _default_config is None:
        _default_config = StoreConfig()
    return _default_config
