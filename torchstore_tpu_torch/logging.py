"""Logging and per-step latency / throughput tracking.

Port of ``torchstore_tpu/logging.py``: the level comes from
``TORCHSTORE_TORCH_LOG_LEVEL`` (or ``StoreConfig.log_level``), and
``LatencyTracker`` records named steps plus the end-to-end time, with GB/s
where a byte count is given. With ``TORCHSTORE_TORCH_TRACE`` set each step
also lands in the trace, as ``{name}/{step}``, beside the spans of
``observability.tracing``. Counters and gauges live in
``observability.metrics``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from torchstore_tpu_torch.config import ENV_LOG_LEVEL
from torchstore_tpu_torch.observability import tracing

_trace = tracing.collector()

ROOT = "torchstore_tpu_torch"


def get_logger(name: str) -> logging.Logger:
    root = logging.getLogger(ROOT)
    if root.level == logging.NOTSET:
        root.setLevel(
            getattr(logging, os.environ.get(ENV_LOG_LEVEL, "WARNING").upper(), logging.WARNING)
        )
    return logging.getLogger(name)


def set_log_level(level_name: str) -> None:
    logging.getLogger(ROOT).setLevel(
        getattr(logging, level_name.upper(), logging.WARNING)
    )


def _format_throughput(nbytes: int, seconds: float) -> str:
    if seconds <= 0:
        return "inf GB/s"
    return f"{nbytes / seconds / 1e9:.3f} GB/s"


class LatencyTracker:
    """``track_step`` records the time since the previous mark;
    ``log_summary`` logs one line per step plus the total."""

    def __init__(self, name: str, logger: Optional[logging.Logger] = None) -> None:
        self.name = name
        self.logger = logger or get_logger(f"{ROOT}.latency")
        self._start = time.perf_counter()
        self._last = self._start
        self.steps: list[tuple[str, float, Optional[int]]] = []

    def track_step(self, step: str, nbytes: Optional[int] = None) -> float:
        now = time.perf_counter()
        elapsed = now - self._last
        if _trace.enabled:
            _trace.add(self.name, step, self._last, elapsed, nbytes)
        self._last = now
        self.steps.append((step, elapsed, nbytes))
        return elapsed

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def log_summary(self, level: int = logging.DEBUG) -> None:
        total = self.elapsed
        total_bytes = 0
        for step, elapsed, nbytes in self.steps:
            extra = ""
            if nbytes is not None:
                total_bytes += nbytes
                extra = f" ({_format_throughput(nbytes, elapsed)})"
            self.logger.log(level, "[%s] %s: %.4fs%s", self.name, step, elapsed, extra)
        extra = f" ({_format_throughput(total_bytes, total)})" if total_bytes else ""
        self.logger.log(level, "[%s] e2e: %.4fs%s", self.name, total, extra)
