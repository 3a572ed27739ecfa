"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

Port of ``torchstore_tpu/observability/metrics.py``. Every process of a
store (clients, volumes, the controller) keeps its own registry; volumes and
the controller return theirs in their ``stats()``. Exporters:
``render_prometheus()`` (text format 0.0.4) and ``snapshot()`` /
``render_json()``.

``TORCHSTORE_TORCH_METRICS_DUMP=/path.json`` (``.prom`` for Prometheus text)
makes each process rewrite its own file atomically (pid-suffixed when
another live process owns the base name) every
``TORCHSTORE_TORCH_METRICS_INTERVAL_S`` seconds (default 60) and at exit.
"""

from __future__ import annotations

import atexit
import bisect
import json
import os
import threading
import time
from typing import Any, Optional

ENV_METRICS_DUMP = "TORCHSTORE_TORCH_METRICS_DUMP"
ENV_METRICS_INTERVAL = "TORCHSTORE_TORCH_METRICS_INTERVAL_S"


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """One named instrument holding one series per label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict[tuple, Any] = {}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def _snapshot_series(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(key), "value": value} for key, value in self._series.items()]

    def snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help, "series": self._snapshot_series()}


class Counter(Metric):
    """Monotonic: ``inc(n, **labels)`` with n >= 0."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)

    def total(self) -> float:
        """The sum over every label set."""
        with self._lock:
            return sum(self._series.values())


class Gauge(Metric):
    """A point-in-time value per label set."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = v

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


# From microseconds (colocated gets) to minutes (model-scale syncs).
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
DEFAULT_BYTES_BUCKETS = (
    1024.0, 16384.0, 65536.0, 1 << 20, 16 << 20, 64 << 20, 256 << 20,
    1 << 30, 4 << 30, 16 << 30,
)


class Histogram(Metric):
    """Fixed buckets with Prometheus semantics (cumulative ``le`` buckets,
    ``sum``, ``count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets: Optional[tuple] = None) -> None:
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS))

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = {
                    "counts": [0] * (len(self.buckets) + 1), "sum": 0.0, "count": 0,
                }
            state["counts"][bisect.bisect_left(self.buckets, v)] += 1
            state["sum"] += v
            state["count"] += 1

    def value(self, **labels) -> Optional[dict]:
        """``{"sum", "count", "buckets": {le: cumulative count}}`` or None."""
        with self._lock:
            state = self._series.get(_label_key(labels))
            return None if state is None else self._cumulative(state)

    def _cumulative(self, state: dict) -> dict:
        out: dict[str, Any] = {"sum": state["sum"], "count": state["count"]}
        cum = 0
        buckets: dict[str, int] = {}
        for le, n in zip(self.buckets, state["counts"]):
            cum += n
            buckets[repr(le)] = cum
        buckets["+Inf"] = cum + state["counts"][-1]
        out["buckets"] = buckets
        return out

    def _snapshot_series(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(key), "value": self._cumulative(state)}
                    for key, state in self._series.items()]


class MetricsRegistry:
    """Named instruments, made on first use. One per process; tests may make
    their own."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> Metric:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help, **kwargs)
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {metric.kind}, not {cls.kind}"
                )
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets: Optional[tuple] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        """Zero every series; the instruments (held in module globals) stay
        registered."""
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            metric.clear()

    def snapshot(self) -> dict:
        """``{name: {"kind", "help", "series": [...]}}``, JSON-serializable."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: metric.snapshot() for name, metric in sorted(metrics.items())}

    def render_json(self) -> str:
        return json.dumps({"ts": time.time(), "pid": os.getpid(), "metrics": self.snapshot()})

    def render_prometheus(self) -> str:
        return render_prometheus_snapshot(self.snapshot())


def render_prometheus_snapshot(snapshot: dict) -> str:
    """Prometheus text (0.0.4) of any registry-shaped snapshot."""
    lines: list[str] = []
    for name, snap in sorted(snapshot.items()):
        if snap.get("help"):
            lines.append(f"# HELP {name} {snap['help']}")
        lines.append(f"# TYPE {name} {snap['kind']}")
        for series in snap["series"]:
            labels = series["labels"]
            if snap["kind"] == "histogram":
                value = series["value"]
                for le, cum in value["buckets"].items():
                    lines.append(f"{name}_bucket{_fmt_labels({**labels, 'le': le})} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {value['sum']}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {value['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} {series['value']}")
    return "\n".join(lines) + "\n"


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())) + "}"


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def counter(name: str, help: str = "") -> Counter:
    return _registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _registry.gauge(name, help)


def histogram(name: str, help: str = "", buckets: Optional[tuple] = None) -> Histogram:
    return _registry.histogram(name, help, buckets=buckets)


def metrics_snapshot() -> dict:
    """This process's registry (``MetricsRegistry.snapshot``)."""
    return _registry.snapshot()


def reset_metrics() -> None:
    _registry.reset()


# ---- env-gated periodic dumper --------------------------------------------
# A forked actor child re-arms it (``reinit_dumper_after_fork``): the flag
# survives the fork, the thread does not.

_dumper_lock = threading.Lock()
_dumper_started = False
_dumper_thread: Optional[threading.Thread] = None
_dump_path: Optional[str] = None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True  # exists, or unknowable: the claim stands


def _resolve_dump_path(base: str) -> str:
    """Claim ``base`` for this process through a ``<base>.owner`` file that
    holds the claimant's pid; another live owner sends this process to a
    pid-suffixed sibling, a dead one's claim is taken over."""
    root, ext = os.path.splitext(base)
    pid = os.getpid()
    pid_path = f"{root}.{pid}{ext or '.json'}"
    owner_path = f"{base}.owner"
    try:
        fd = os.open(owner_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        os.write(fd, str(pid).encode())
        os.close(fd)
        return base
    except FileExistsError:
        try:
            with open(owner_path) as f:
                owner = int(f.read().strip() or 0)
        except (OSError, ValueError):
            owner = 0
        if owner == pid:
            return base
        if not owner or not _pid_alive(owner):
            try:
                tmp = f"{owner_path}.tmp.{pid}"
                with open(tmp, "w") as f:
                    f.write(str(pid))
                os.replace(tmp, owner_path)
                return base
            except OSError:
                pass
        return pid_path
    except OSError:
        return pid_path


def dump_metrics(path: Optional[str] = None) -> Optional[str]:
    """Write this process's metrics to ``path`` (default: the claimed
    env-configured path) atomically; ``.prom`` gets Prometheus text, else
    JSON. Returns the path written, or None."""
    global _dump_path
    if path is None:
        base = os.environ.get(ENV_METRICS_DUMP)
        if not base:
            return None
        if _dump_path is None:
            _dump_path = _resolve_dump_path(base)
        path = _dump_path
    payload = _registry.render_prometheus() if path.endswith(".prom") else _registry.render_json()
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def maybe_start_dumper() -> bool:
    """Start the periodic dump thread once per process when
    ``TORCHSTORE_TORCH_METRICS_DUMP`` is set; returns whether one runs."""
    global _dumper_started, _dumper_thread
    if not os.environ.get(ENV_METRICS_DUMP):
        return False
    with _dumper_lock:
        if _dumper_started:
            return True
        _dumper_started = True
    try:
        interval = float(os.environ.get(ENV_METRICS_INTERVAL, "60"))
    except ValueError:
        interval = 60.0
    interval = max(1.0, interval)

    def loop() -> None:
        while True:
            time.sleep(interval)
            dump_metrics()

    thread = threading.Thread(target=loop, name="torchstore-torch-metrics-dump", daemon=True)
    thread.start()
    _dumper_thread = thread
    atexit.register(dump_metrics)
    return True


def reinit_dumper_after_fork() -> bool:
    """Re-arm the dumper in an actor child: a forked child inherits the
    started flag but not the thread; a spawned child's own import already
    started a live one, and only its claimed path is dropped."""
    global _dumper_started, _dump_path, _dumper_thread
    with _dumper_lock:
        _dump_path = None
        if _dumper_thread is not None and _dumper_thread.is_alive():
            return True
        _dumper_started = False
        _dumper_thread = None
    return maybe_start_dumper()
