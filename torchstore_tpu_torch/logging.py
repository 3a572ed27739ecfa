"""Logging and per-step latency / throughput tracking.

Port of ``torchstore_tpu/logging.py``: the level comes from
``TORCHSTORE_TORCH_LOG_LEVEL`` (or ``StoreConfig.log_level``), and
``LatencyTracker`` records named steps plus the end-to-end time, with GB/s
where a byte count is given. ``Counter`` is a plain in-process counter and
``Gauge`` a plain last value, by label set, under the reference's metric
names.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from torchstore_tpu_torch.config import ENV_LOG_LEVEL

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


class Counter:
    """A monotonic count per label set: ``inc(n, op="get")``,
    ``value(op="get")`` (one label set), ``total()`` (every label set)."""

    def __init__(self, name: str, help_text: str = "") -> None:
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0)

    def total(self) -> float:
        return sum(self._values.values())


class Gauge:
    """A last-set value per label set: ``set(x, channel="policy")``,
    ``value(channel="policy")``."""

    def __init__(self, name: str, help_text: str = "") -> None:
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels: str) -> None:
        self._values[tuple(sorted(labels.items()))] = value

    def value(self, **labels: str) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0)


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
