"""Flight recorder: a bounded ring of the process's recent events.

Port of ``torchstore_tpu/observability/recorder.py``. Each store process
keeps a ``deque(maxlen=...)`` of recent events (appends are O(1) and
atomic under the GIL, so the hot path takes no lock):

    op          completed client ops
    transfer    transport-level moves (transport, volume, bytes)
    fault       every fault point that fired
    error       failures worth a post-mortem line

``dump_postmortem`` writes the ring as one JSON file under
``TORCHSTORE_TORCH_FLIGHT_DIR`` (default ``<tmpdir>/torchstore_torch_flight``),
one file per (trigger, pid); a ``die`` fault writes it before the process
exits, and ``arm_exit_dump`` writes it at interpreter exit when faults or
errors were recorded since the last dump. Dumps of one trigger kind are
rate-limited (``TORCHSTORE_TORCH_FLIGHT_MIN_INTERVAL_S``, default 30).
``TORCHSTORE_TORCH_FLIGHT_RECORDER=0`` turns recording off;
``TORCHSTORE_TORCH_FLIGHT_EVENTS`` sizes the ring (default 4096).
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Any, Optional

from torchstore_tpu_torch.observability import metrics as obs_metrics

ENV_FLIGHT = "TORCHSTORE_TORCH_FLIGHT_RECORDER"
ENV_FLIGHT_EVENTS = "TORCHSTORE_TORCH_FLIGHT_EVENTS"
ENV_FLIGHT_DIR = "TORCHSTORE_TORCH_FLIGHT_DIR"
ENV_FLIGHT_MIN_INTERVAL = "TORCHSTORE_TORCH_FLIGHT_MIN_INTERVAL_S"

# Kinds whose presence since the last dump makes an exit unclean.
ALERT_KINDS = frozenset({"fault", "error", "health", "slo"})

_DUMPS = obs_metrics.counter(
    "ts_flight_dumps_total", "Flight-recorder post-mortems written, by reason"
)
_DROPPED = obs_metrics.counter(
    "ts_flight_dumps_dropped_total",
    "Post-mortems suppressed by the per-kind rate limit, by reason",
)


def _env_enabled() -> bool:
    return os.environ.get(ENV_FLIGHT, "1").strip().lower() not in ("0", "false", "no", "off", "")


def _env_events() -> int:
    try:
        return max(64, int(os.environ.get(ENV_FLIGHT_EVENTS, "4096")))
    except ValueError:
        return 4096


def flight_dir() -> str:
    return os.environ.get(ENV_FLIGHT_DIR) or os.path.join(
        tempfile.gettempdir(), "torchstore_torch_flight"
    )


def _min_interval_s() -> float:
    try:
        return max(0.0, float(os.environ.get(ENV_FLIGHT_MIN_INTERVAL, "30")))
    except ValueError:
        return 30.0


class FlightRecorder:
    """The bounded per-process event ring."""

    def __init__(self, maxlen: Optional[int] = None) -> None:
        self.enabled = _env_enabled()
        self._ring: collections.deque = collections.deque(maxlen=maxlen or _env_events())
        self._alerts_since_dump = 0
        self._exit_armed = False
        self._last_dump: dict[str, float] = {}  # trigger kind -> monotonic time

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def record(self, kind: str, name: str, **detail: Any) -> None:
        if not self.enabled:
            return
        self._ring.append((time.time(), kind, name, detail or None))
        if kind in ALERT_KINDS:
            self._alerts_since_dump += 1

    def snapshot(self) -> list[dict]:
        """The ring as JSON-serializable events, oldest first."""
        pid = os.getpid()
        return [
            {"ts": ts, "pid": pid, "kind": kind, "name": name,
             **({"detail": detail} if detail else {})}
            for ts, kind, name, detail in list(self._ring)
        ]

    def clear(self) -> None:
        self._ring.clear()
        self._alerts_since_dump = 0

    def dump(self, trigger: str, extra_events: Optional[list[dict]] = None) -> Optional[str]:
        """Write the ring (plus ``extra_events``) atomically and return the
        path; None when off, rate-limited, empty, or the write failed."""
        if not self.enabled:
            return None
        reason = trigger.split(":", 1)[0]
        interval = _min_interval_s()
        now = time.monotonic()
        if interval > 0:
            last = self._last_dump.get(reason)
            if last is not None and now - last < interval:
                _DROPPED.inc(reason=reason)
                return None
        events = self.snapshot() + list(extra_events or ())
        if not events:
            return None
        events.sort(key=lambda e: e.get("ts") or 0)
        safe = "".join(ch if ch.isalnum() or ch in "-_" else "_" for ch in trigger)[:80]
        path = os.path.join(flight_dir(), f"flight_{safe}_{os.getpid()}.json")
        from torchstore_tpu_torch.utils import get_hostname

        payload = {"trigger": trigger, "ts": time.time(), "pid": os.getpid(),
                   "host": get_hostname(), "events": events}
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(flight_dir(), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            return None
        self._alerts_since_dump = 0
        self._last_dump[reason] = now
        _DUMPS.inc(reason=reason)
        from torchstore_tpu_torch.logging import get_logger

        get_logger("torchstore_tpu_torch.observability").warning(
            "flight recorder post-mortem (%s): %d event(s) -> %s", trigger, len(events), path
        )
        return path

    def arm_exit_dump(self) -> None:
        """Dump at interpreter exit if alert events came since the last
        dump. Idempotent."""
        if self._exit_armed:
            return
        self._exit_armed = True
        import atexit

        def _maybe_dump() -> None:
            if self._alerts_since_dump:
                self.dump("unclean_exit")

        atexit.register(_maybe_dump)


_recorder = FlightRecorder()
_reinit_lock = threading.Lock()


def recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, name: str, **detail: Any) -> None:
    _recorder.record(kind, name, **detail)


def snapshot() -> list[dict]:
    return _recorder.snapshot()


def dump_postmortem(trigger: str, extra_events: Optional[list[dict]] = None) -> Optional[str]:
    return _recorder.dump(trigger, extra_events)


def reset_recorder() -> None:
    _recorder.clear()


def reinit_after_fork() -> None:
    """A forked actor child starts with an empty ring and the enabled flag
    of its own env."""
    with _reinit_lock:
        _recorder.clear()
        _recorder.enabled = _env_enabled()
        _recorder._exit_armed = False
        _recorder._last_dump.clear()
