"""Store-wide observability: metrics, span tracing, trace context and the
flight recorder.

Port of the core of ``torchstore_tpu/observability/``:

- ``metrics``: process-local counters, gauges and histograms with
  Prometheus-text and JSON exporters. ``metrics_snapshot()`` in the API
  returns the calling process's registry; volumes and the controller return
  theirs in ``stats()``. ``TORCHSTORE_TORCH_METRICS_DUMP=/path`` makes every
  process rewrite a dump periodically (``TORCHSTORE_TORCH_METRICS_INTERVAL_S``,
  default 60) and at exit.
- ``tracing``: ``span(name, **attrs)`` writes Chrome-trace events when
  ``TORCHSTORE_TORCH_TRACE=/path/trace.json`` is set; ``collect_trace``
  merges the per-process files into one timeline.
- ``context``: the ``trace_id`` / ``parent_span_id`` every actor RPC frame
  carries, so the client's, the controller's and the volume's spans share
  one trace.
- ``recorder``: the bounded ring of recent events, dumped post mortem.

The fleet aggregation, HTTP exporter, history, ledger and timeline of the
reference are not ported yet.
"""

from torchstore_tpu_torch.observability import context, recorder
from torchstore_tpu_torch.observability.metrics import (
    ENV_METRICS_DUMP,
    ENV_METRICS_INTERVAL,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    dump_metrics,
    gauge,
    get_registry,
    histogram,
    maybe_start_dumper,
    metrics_snapshot,
    render_prometheus_snapshot,
    reset_metrics,
)
from torchstore_tpu_torch.observability.tracing import (
    ENV_TRACE,
    TraceCollector,
    collect_trace,
    collector,
    flush_trace,
    merge_traces,
    span,
    trace_enabled,
)


def reinit_after_fork() -> None:
    """Re-arm every env-gated facility in a freshly forked actor child, after
    its env was corrected: the forkserver imported this package under its own
    env, and its dumper thread did not survive the fork."""
    from torchstore_tpu_torch.observability import metrics as _metrics

    collector().reinit_after_fork()
    _metrics.reinit_dumper_after_fork()
    recorder.reinit_after_fork()


__all__ = [
    "ENV_METRICS_DUMP",
    "ENV_METRICS_INTERVAL",
    "ENV_TRACE",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TraceCollector",
    "collect_trace",
    "collector",
    "context",
    "counter",
    "dump_metrics",
    "flush_trace",
    "gauge",
    "get_registry",
    "histogram",
    "maybe_start_dumper",
    "merge_traces",
    "metrics_snapshot",
    "recorder",
    "reinit_after_fork",
    "render_prometheus_snapshot",
    "reset_metrics",
    "span",
    "trace_enabled",
]
