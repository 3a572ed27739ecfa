"""Store configuration, seeded from ``TORCHSTORE_TORCH_*`` variables.

Port of ``torchstore_tpu/config.py``: the fields the port reads, the
``RetryPolicy`` every retrying layer derives its schedule from, and
``ENV_REGISTRY``, one ``EnvVar`` per variable the port reads. The prefix is
``TORCHSTORE_TORCH_`` and not ``TORCHSTORE_TPU_TORCH_``: the reference's
actor runtime copies every ``TORCHSTORE_TPU_*`` variable into its children,
so the two packages keep their settings apart.
"""

from __future__ import annotations

import os
import random
import time
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
ENV_AUTH_SECRET = ENV_PREFIX + "AUTH_SECRET"
ENV_HANDSHAKE_TIMEOUT = ENV_PREFIX + "HANDSHAKE_TIMEOUT"
ENV_MP_CONTEXT = ENV_PREFIX + "MP_CONTEXT"
ENV_HOSTNAME = ENV_PREFIX + "HOSTNAME"
ENV_RETRY_BASE_S = ENV_PREFIX + "RETRY_BASE_S"
ENV_RETRY_MAX_S = ENV_PREFIX + "RETRY_MAX_S"
ENV_RETRY_MULTIPLIER = ENV_PREFIX + "RETRY_MULTIPLIER"
ENV_RETRY_JITTER = ENV_PREFIX + "RETRY_JITTER"
ENV_RETRY_DEADLINE_S = ENV_PREFIX + "RETRY_DEADLINE_S"
ENV_BULK_TCP_ENABLED = ENV_PREFIX + "BULK_TCP_ENABLED"
ENV_BULK_STRIPE_THRESHOLD = ENV_PREFIX + "BULK_STRIPE_THRESHOLD"
ENV_BULK_EMULATE_GBPS = ENV_PREFIX + "BULK_EMULATE_GBPS"
ENV_BIND_HOST = ENV_PREFIX + "BIND_HOST"
ENV_ADVERTISE_HOST = ENV_PREFIX + "ADVERTISE_HOST"
ENV_USE_NATIVE = ENV_PREFIX + "USE_NATIVE"
ENV_TIER_ENABLED = ENV_PREFIX + "TIER_ENABLED"
ENV_TIER_DIR = ENV_PREFIX + "TIER_DIR"
ENV_TIER_BUDGET_BYTES = ENV_PREFIX + "TIER_BUDGET_BYTES"
ENV_TIER_HIGH_PCT = ENV_PREFIX + "TIER_HIGH_PCT"
ENV_TIER_LOW_PCT = ENV_PREFIX + "TIER_LOW_PCT"
ENV_TIER_SWEEP_INTERVAL_S = ENV_PREFIX + "TIER_SWEEP_INTERVAL_S"
ENV_LEASE_TTL_S = ENV_PREFIX + "LEASE_TTL_S"
ENV_STORAGE_DIR = ENV_PREFIX + "STORAGE_DIR"
ENV_VOLUME_ID = ENV_PREFIX + "VOLUME_ID"
ENV_RECLAIM_DELAYS = ENV_PREFIX + "RECLAIM_DELAYS"
ENV_HEALTH_INTERVAL_S = ENV_PREFIX + "HEALTH_INTERVAL_S"
ENV_HEALTH_MISS_THRESHOLD = ENV_PREFIX + "HEALTH_MISS_THRESHOLD"
ENV_AUTO_REPAIR = ENV_PREFIX + "AUTO_REPAIR"
ENV_PREWARM_AUTO = ENV_PREFIX + "PREWARM_AUTO"
ENV_PREWARM_AUTO_MIN_BYTES = ENV_PREFIX + "PREWARM_AUTO_MIN_BYTES"


@dataclass(frozen=True)
class EnvVar:
    """One operator setting. ``default=None``: unset, or computed (the doc
    says how)."""

    name: str
    type: str  # "bool" | "int" | "float" | "str" | "path"
    default: object
    doc: str


# Every TORCHSTORE_TORCH_* variable the port reads, with the reference's
# name under the prefix swap.
ENV_REGISTRY: tuple[EnvVar, ...] = (
    # --- transports
    EnvVar(ENV_SHM_ENABLED, "bool", True,
           "Same-host puts, gets and direct staging go through /dev/shm segments."),
    EnvVar(ENV_BULK_TCP_ENABLED, "bool", True,
           "Volumes on another host are reached over the bulk TCP rung (striped transfers)."),
    EnvVar(ENV_BULK_STRIPE_THRESHOLD, "int", 64 << 20,
           "Bulk payloads above this many bytes are striped across the stripe connections."),
    EnvVar(ENV_BULK_EMULATE_GBPS, "float", 0,
           "When > 0, every bulk payload frame adds the time a link of this many GB/s "
           "would take (one box emulates a cross-host link)."),
    EnvVar(ENV_USE_NATIVE, "bool", True,
           "Host copies go through the native library (csrc/host_copy.cc, built at "
           "first use); off: torch copies. One setting per process tree: volumes "
           "spawned by the process inherit it."),
    EnvVar(ENV_ICI_ENABLED, "bool", True,
           "A direct publish whose leaves all live on cards takes the device rung."),
    EnvVar(ENV_ZERO_COPY_GET, "bool", True,
           "A same-host get without a destination returns a copy-on-write view."),
    EnvVar(ENV_SHM_POOL_MAX_BYTES, "int", None,
           "Cap on the volume's pool of recycled segments, bytes (default: a "
           "quarter of /dev/shm's free space, 4-64 GB)."),
    EnvVar(ENV_LANDING_THREADS, "int", 0,
           "Threads of the host-copy pool (0: one per core, at most 4)."),
    EnvVar(ENV_ARENA_MAX_BYTES, "int", 256 << 10,
           "Tensors of a put batch at or under this size share one segment."),
    # --- version retention and the disk tier
    EnvVar(ENV_TIER_ENABLED, "bool", False,
           "Each volume demotes cold, unleased version groups to a disk spill tier under "
           "the watermark policy; a get of a spilled key faults it back in."),
    EnvVar(ENV_TIER_DIR, "path", None,
           "Root of the disk spill tier, one subdirectory per volume id (default: "
           "<tmpdir>/torchstore_torch_tier). Writes are write-temp, fsync, rename."),
    EnvVar(ENV_TIER_BUDGET_BYTES, "int", None,
           "Resident bytes the spill watermarks apply to (default: the segment pool's cap)."),
    EnvVar(ENV_TIER_HIGH_PCT, "float", 0.85,
           "A volume whose resident bytes exceed this fraction of the budget starts "
           "demoting (least recently used version groups first, leased ones exempt)."),
    EnvVar(ENV_TIER_LOW_PCT, "float", 0.65,
           "Demotion stops once resident bytes are at or under this fraction of the budget."),
    EnvVar(ENV_TIER_SWEEP_INTERVAL_S, "float", 2.0,
           "Seconds between the controller's spill passes (<= 0: none in the background; "
           "tier_sweep() runs one on demand)."),
    EnvVar(ENV_LEASE_TTL_S, "float", 30.0,
           "Default TTL, seconds, of a cohort retention lease (renew to keep the pin)."),
    EnvVar(ENV_STORAGE_DIR, "path", None,
           "Durable directory of the storage volumes (one subdirectory per volume id; "
           "unset: memory only). Set by initialize(storage_dir=)."),
    # --- state-dict layer
    EnvVar(ENV_TRANSFER_QUANT, "str", "none",
           "Default wire quantization of state-dict publishes."),
    EnvVar(ENV_TRANSFER_QUANT_BLOCK, "int", 256, "Elements per block of the blockwise modes."),
    EnvVar(ENV_DELTA_KEYFRAME, "int", 8, "The delta tier ships a keyframe every N versions."),
    EnvVar(ENV_DELTA_SKIP_EPS, "float", 0.0, "Absolute slack on the delta tier's skip threshold."),
    EnvVar(ENV_PLAN_CACHE, "bool", True, "Iteration-stable transfer plans for state-dict syncs."),
    EnvVar(ENV_STREAM_POLL_S, "float", 10.0, "Seconds of one long-poll round of a streamed acquire."),
    EnvVar(ENV_STREAM_RETRIES, "int", 2, "Restarts of a streamed acquire before it fails."),
    # --- security and timeouts
    EnvVar(ENV_AUTH_SECRET, "str", "",
           "Shared secret of the HMAC challenge on every listener (empty: off)."),
    EnvVar(ENV_RPC_TIMEOUT, "float", 300.0, "Seconds a control RPC may take (<= 0: no deadline)."),
    EnvVar(ENV_HANDSHAKE_TIMEOUT, "float", 60.0,
           "Seconds a transport handshake or a direct-sync dial may take."),
    EnvVar(ENV_DIRECT_SETTLE_TIMEOUT, "float", 30.0,
           "Seconds a direct pull waits for a source's staging to settle."),
    EnvVar(ENV_LOG_LEVEL, "str", "WARNING", "Log level of the torchstore_tpu_torch loggers."),
    # --- observability
    EnvVar(ENV_PREFIX + "TRACE", "path", None,
           "Chrome-trace file of every span (pid-suffixed per process)."),
    EnvVar(ENV_PREFIX + "TRACE_RUN", "str", None,
           "Run id shared by a process tree (set by the first tracing process)."),
    EnvVar(ENV_PREFIX + "METRICS_DUMP", "path", None,
           "Periodic metrics dump of every process (.prom for Prometheus text)."),
    EnvVar(ENV_PREFIX + "METRICS_INTERVAL_S", "float", 60, "Seconds between metrics dumps."),
    EnvVar(ENV_PREFIX + "FLIGHT_RECORDER", "bool", True, "Record the flight-recorder ring."),
    EnvVar(ENV_PREFIX + "FLIGHT_EVENTS", "int", 4096, "Events the flight-recorder ring holds."),
    EnvVar(ENV_PREFIX + "FLIGHT_DIR", "path", None,
           "Directory of post-mortem dumps (default: <tmpdir>/torchstore_torch_flight)."),
    EnvVar(ENV_PREFIX + "FLIGHT_MIN_INTERVAL_S", "float", 30,
           "Least seconds between two dumps of one trigger kind."),
    # --- runtime
    EnvVar(ENV_MP_CONTEXT, "str", "forkserver",
           "Start method of actor processes: forkserver (preloads the runtime) or spawn."),
    EnvVar(ENV_HOSTNAME, "str", None, "Host identity override (tests emulate hosts with it)."),
    EnvVar(ENV_BIND_HOST, "str", "127.0.0.1",
           "Address the actor, bulk and direct-sync listeners bind (0.0.0.0 across hosts)."),
    EnvVar(ENV_ADVERTISE_HOST, "str", None,
           "Reachable address put in actor refs and bulk and direct-sync endpoints "
           "(default: the bind address, or the hostname when binding 0.0.0.0 or ::)."),
    EnvVar(ENV_VOLUME_ID, "str", None,
           "Force a spawned storage volume's id (repair's replacement of a dead volume)."),
    # --- replication, reclaims and the health supervisor
    EnvVar(ENV_RECLAIM_DELAYS, "str", None,
           "Comma-separated backoff delays, seconds, of the controller's stale-copy reclaim "
           "drainer (default 1,5,15,60; a malformed value falls back to it)."),
    EnvVar(ENV_HEALTH_INTERVAL_S, "float", 2.0,
           "Seconds between the controller's heartbeats to every volume (<= 0: no "
           "supervisor, so no quarantine and no auto-repair)."),
    EnvVar(ENV_HEALTH_MISS_THRESHOLD, "int", 3,
           "Consecutive missed heartbeats that quarantine a volume; as many answered ones "
           "reinstate it through probation."),
    EnvVar(ENV_AUTO_REPAIR, "bool", True,
           "A quarantine re-replicates every key the volume held that keeps a healthy copy "
           "onto healthy volumes, volume to volume (off: until repair())."),
    # --- cold-start provisioning (prewarm)
    EnvVar(ENV_PREWARM_AUTO, "bool", False,
           "put_state_dict derives a manifest and provisions pools and dials before the "
           "first data-plane puts of a large working set."),
    EnvVar(ENV_PREWARM_AUTO_MIN_BYTES, "int", 32 << 20,
           "Working sets below this many bytes skip the automatic prewarm hint."),
    # --- faults and retries
    EnvVar(ENV_PREFIX + "FAULTPOINTS", "str", None,
           "Fault points armed at start: name=action[:count=N][:prob=P][:delay_ms=D];..."),
    EnvVar(ENV_RETRY_BASE_S, "float", 0.05, "RetryPolicy: first backoff, seconds."),
    EnvVar(ENV_RETRY_MAX_S, "float", 2.0, "RetryPolicy: largest backoff, seconds."),
    EnvVar(ENV_RETRY_MULTIPLIER, "float", 2.0, "RetryPolicy: backoff growth per attempt."),
    EnvVar(ENV_RETRY_JITTER, "float", 0.1, "RetryPolicy: randomized fraction of each backoff."),
    EnvVar(ENV_RETRY_DEADLINE_S, "float", 30.0,
           "RetryPolicy: total retry budget of one logical operation, seconds."),
)

# Families of names: one variable per store (the published handles).
ENV_PREFIXES: tuple[str, ...] = (ENV_PREFIX + "STORE_",)


def env_registry_entry(name: str) -> Optional[EnvVar]:
    for entry in ENV_REGISTRY:
        if entry.name == name:
            return entry
    return None

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


@dataclass(frozen=True)
class RetryPolicy:
    """The one retry and backoff vocabulary of the store: the client's get
    failover, the single-volume put's transport demotion and the replicated
    put's all-failed retry take their schedules from it.

    The delay before retry ``i`` (0-based) is ``min(max_s, base_s *
    multiplier**i)``, a ``jitter`` fraction of it randomized, unless
    ``delays`` pins a schedule (which is then the attempt budget).
    ``deadline_s`` bounds the time one logical operation spends retrying.
    Frozen and picklable: it rides ``StoreConfig`` through RPCs."""

    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline_s: float = 30.0
    delays: Optional[tuple[float, ...]] = None

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            base_s=_env_float(ENV_RETRY_BASE_S, 0.05),
            max_s=_env_float(ENV_RETRY_MAX_S, 2.0),
            multiplier=_env_float(ENV_RETRY_MULTIPLIER, 2.0),
            jitter=_env_float(ENV_RETRY_JITTER, 0.1),
            deadline_s=_env_float(ENV_RETRY_DEADLINE_S, 30.0),
        )

    @classmethod
    def from_delays(cls, delays, deadline_s: Optional[float] = None) -> "RetryPolicy":
        delays = tuple(float(d) for d in delays)
        if not delays:
            raise ValueError("explicit delay schedule must not be empty")
        return cls(deadline_s=sum(delays) * 2 if deadline_s is None else deadline_s,
                   delays=delays)

    @property
    def max_attempts(self) -> Optional[int]:
        """Bound on retries (not first attempts); None: the deadline bounds."""
        return len(self.delays) if self.delays is not None else None

    def backoff(self, attempt: int) -> float:
        """The jittered delay before retry ``attempt`` (0-based)."""
        if self.delays is not None:
            delay = self.delays[min(attempt, len(self.delays) - 1)]
        else:
            delay = min(self.max_s, self.base_s * self.multiplier**attempt)
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return max(0.0, delay)

    def start(self) -> float:
        """The monotonic deadline of one logical operation's retries."""
        return time.monotonic() + self.deadline_s

    def should_retry(self, attempt: int, deadline: float) -> bool:
        """Whether retry ``attempt`` (0-based) may run: within the attempt
        cap of a pinned schedule and the time budget."""
        if self.delays is not None and attempt >= len(self.delays):
            return False
        return time.monotonic() < deadline


DEFAULT_RECLAIM_DELAYS = (1.0, 5.0, 15.0, 60.0)


def reclaim_policy() -> RetryPolicy:
    """The reclaim drainer's schedule: ``TORCHSTORE_TORCH_RECLAIM_DELAYS``,
    else 1, 5, 15, 60 s. The schedule is the attempt budget (no deadline:
    a slow volume makes each attempt's RPC wait out its own timeout, which
    is what the long tail is for). A malformed value falls back to the
    default and never raises: a drainer that died on it would leave its
    volume's reclaims wedged."""
    raw = os.environ.get(ENV_RECLAIM_DELAYS)
    if raw:
        try:
            return RetryPolicy.from_delays(raw.split(","), deadline_s=float("inf"))
        except ValueError:
            pass
    return RetryPolicy.from_delays(DEFAULT_RECLAIM_DELAYS, deadline_s=float("inf"))


def _lenient(read, name: str, default):
    try:
        return read(name, default)
    except ValueError:
        return default


def health_interval_s() -> float:
    """Seconds between the supervisor's heartbeats (<= 0: no supervisor)."""
    return _lenient(_env_float, ENV_HEALTH_INTERVAL_S, 2.0)


def health_miss_threshold() -> int:
    """Consecutive misses that quarantine a volume (at least 1)."""
    return max(1, _lenient(_env_int, ENV_HEALTH_MISS_THRESHOLD, 3))


def auto_repair_enabled() -> bool:
    return _env_bool(ENV_AUTO_REPAIR, True)


def bind_host() -> str:
    """The address this process's listeners bind."""
    return _env_str(ENV_BIND_HOST, "127.0.0.1")


def advertise_host(bound: Optional[str] = None) -> str:
    """The address peers dial to reach a listener bound to ``bound`` (this
    process's bind address by default): ``ADVERTISE_HOST`` when set, else
    the machine's hostname for a wildcard bind, else the bind address."""
    bound = bind_host() if bound is None else bound
    advertised = os.environ.get(ENV_ADVERTISE_HOST)
    if advertised:
        return advertised
    if bound in ("0.0.0.0", "::", ""):
        import socket

        return socket.gethostname()
    return bound


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
    dest's host-fallback staging legitimately holds it odd for seconds.

    ``auth_secret``: the shared secret of the HMAC challenge every listener
    (actor servers, the direct-sync source) puts to a new connection before
    it parses a frame; empty turns auth off. One per process.
    ``handshake_timeout``: seconds a transport handshake RPC or a
    direct-sync dial may take. ``retry``: the ``RetryPolicy`` of the
    client's retries and failovers.

    ``bulk_tcp_enabled``: a volume on another host is reached over the
    bulk TCP rung (striped transfers on connections of their own), else
    over RPC frames. The native host copies are gated per process, by
    ``TORCHSTORE_TORCH_USE_NATIVE`` alone (``native.enabled``).

    ``prewarm_auto``: the first ``put_state_dict`` of a working set of at
    least ``prewarm_auto_min_bytes`` provisions the volumes' pools and the
    bulk dials before its data-plane puts (once per size signature per
    client; advisory). Off by default, where the reference has it on: the
    hint runs on the put's critical path, and making the segments there
    costs what the cold put's own making does (PERF.md, Findings). An
    explicit ``prewarm`` or ``WeightPublisher.register`` ahead of the first
    sync is what takes that cost off it."""

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
    auth_secret: str = field(default_factory=lambda: os.environ.get(ENV_AUTH_SECRET, ""))
    handshake_timeout: float = field(
        default_factory=lambda: _env_float(ENV_HANDSHAKE_TIMEOUT, 60.0)
    )
    retry: RetryPolicy = field(default_factory=RetryPolicy.from_env)
    bulk_tcp_enabled: bool = field(
        default_factory=lambda: _env_bool(ENV_BULK_TCP_ENABLED, True)
    )
    prewarm_auto: bool = field(default_factory=lambda: _env_bool(ENV_PREWARM_AUTO, False))
    prewarm_auto_min_bytes: int = field(
        default_factory=lambda: _env_int(ENV_PREWARM_AUTO_MIN_BYTES, 32 << 20)
    )


_default_config: Optional[StoreConfig] = None


def default_config() -> StoreConfig:
    """The process's config from the environment, read once."""
    global _default_config
    if _default_config is None:
        _default_config = StoreConfig()
    return _default_config
