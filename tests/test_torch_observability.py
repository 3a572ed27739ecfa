"""The observability core against the JAX package's: the Prometheus text
and snapshot of a registry equal the JAX registry's for the same series
(exact), the trace context's semantics, ``merge_traces`` on the same files,
span and trace-id propagation across a real actor RPC, the flight
recorder's bounds and dumps, and the metrics every process's ``stats()``
carries."""

import asyncio
import json
import os
import uuid

import pytest
import torch

import torchstore_tpu_torch as ts
from torchstore_tpu.observability import context as ref_context
from torchstore_tpu.observability import metrics as ref_metrics
from torchstore_tpu.observability import tracing as ref_tracing
from torchstore_tpu_torch.logging import LatencyTracker
from torchstore_tpu_torch.observability import context, metrics, recorder, tracing
from torchstore_tpu_torch.runtime import Actor, endpoint, spawn_actors


def fill(registry) -> None:
    c = registry.counter("ts_ops_total", "Ops by kind")
    c.inc(op="put")
    c.inc(3, op="get")
    c.inc(2.5, op="get", transport='s"h\\m\n')
    g = registry.gauge("ts_inflight", "In flight")
    g.set(4, volume="0")
    g.inc(2, volume="0")
    g.dec(1, volume="1")
    h = registry.histogram("ts_op_seconds", "Op time")
    for v in (0.00005, 0.003, 0.003, 0.7, 45.0, 100.0):
        h.observe(v, op="put")
    registry.histogram("ts_bytes", "Bytes", buckets=metrics.DEFAULT_BYTES_BUCKETS).observe(
        5 << 20)
    registry.counter("ts_empty_total")


def test_prometheus_text_and_snapshot_equal_reference():
    port, ref = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    fill(port)
    fill(ref)
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert metrics.DEFAULT_LATENCY_BUCKETS == ref_metrics.DEFAULT_LATENCY_BUCKETS
    assert metrics.DEFAULT_BYTES_BUCKETS == ref_metrics.DEFAULT_BYTES_BUCKETS
    assert port.counter("ts_ops_total").total() == 6.5
    assert port.histogram("ts_op_seconds").value(op="put")["buckets"]["+Inf"] == 6
    with pytest.raises(ValueError):
        port.counter("ts_ops_total").inc(-1)
    with pytest.raises(TypeError):
        port.gauge("ts_ops_total")
    port.reset()
    assert port.counter("ts_ops_total").total() == 0 and port.get("ts_ops_total") is not None


def test_dump_metrics_writes_json_and_prometheus(tmp_path, monkeypatch):
    reg = metrics.get_registry()
    reg.counter("ts_dump_probe_total").inc(probe="x")
    path = metrics.dump_metrics(str(tmp_path / "m.json"))
    payload = json.loads(open(path).read())
    assert payload["pid"] == os.getpid()
    assert payload["metrics"]["ts_dump_probe_total"]["series"][0]["labels"] == {"probe": "x"}
    prom = metrics.dump_metrics(str(tmp_path / "m.prom"))
    assert open(prom).read() == reg.render_prometheus()
    monkeypatch.setenv(metrics.ENV_METRICS_DUMP, str(tmp_path / "env.json"))
    monkeypatch.setattr(metrics, "_dump_path", None)
    assert metrics.dump_metrics() == str(tmp_path / "env.json")  # claimed the base


def test_context_semantics_equal_reference():
    def run(ctx_mod):
        out = [ctx_mod.current()]
        with ctx_mod.ensure_root():
            tid = ctx_mod.trace_id()
            with ctx_mod.ensure_root():
                out.append(ctx_mod.trace_id() == tid)  # nested ops join
            token = ctx_mod.push_span("s1")
            out.append(ctx_mod.current() == {"trace_id": tid, "parent_span_id": "s1"})
            out.append(ctx_mod.token_parent(token))
            ctx_mod.pop_span(token)
        out.append(ctx_mod.current())
        with ctx_mod.activate({"trace_id": "abc", "parent_span_id": "p"}):
            out.append(ctx_mod.current())
        with ctx_mod.activate(None):
            out.append(ctx_mod.current())
        out.append(len(ctx_mod.new_id()))
        return out

    assert run(context) == run(ref_context) == [
        None, True, True, None, None, {"trace_id": "abc", "parent_span_id": "p"}, None, 16]


def write_trace(path, events, closed: bool) -> None:
    with open(path, "w") as f:
        f.write("[\n" + ",\n".join(json.dumps(e) for e in events) + ("\n]" if closed else ""))


def test_merge_traces_equals_reference(tmp_path):
    base = tmp_path / "trace.json"
    a = [{"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "client[1]"}},
         {"name": "put_batch", "ph": "X", "ts": 30.0, "dur": 5, "pid": 1,
          "args": {"trace_id": "t1", "span_id": "s1"}}]
    b = [{"name": "process_name", "ph": "M", "pid": 2, "args": {"name": "tst-vol-0[2]"}},
         {"name": "rpc/put", "ph": "X", "ts": 31.0, "dur": 2, "pid": 2,
          "args": {"trace_id": "t1", "parent_id": "s1"}},
         {"name": "rpc/get", "ph": "X", "ts": 10.0, "dur": 1, "pid": 2,
          "args": {"trace_id": "t0"}}]
    write_trace(base, a, closed=False)  # a live process's file has no closing ]
    write_trace(tmp_path / "trace.2.json", b, closed=True)
    (tmp_path / "trace.merged.json").write_text("[]")  # never an input
    files = tracing.trace_files(str(base))
    assert files == ref_tracing.trace_files(str(base)) == [str(base),
                                                           str(tmp_path / "trace.2.json")]
    port = tracing.merge_traces(files, str(tmp_path / "port.json"))
    ref = ref_tracing.merge_traces(files, str(tmp_path / "ref.json"))
    assert {k: v for k, v in port.items() if k != "path"} == {
        k: v for k, v in ref.items() if k != "path"}
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "ref.json").read_text())
    assert port["events"] == 3 and port["trace_ids"] == ["t0", "t1"]


@pytest.fixture
def trace_on(tmp_path, monkeypatch):
    """Tracing on in this process (and the actors it spawns) for one test."""
    path = str(tmp_path / "trace.json")
    monkeypatch.setenv(tracing.ENV_TRACE, path)
    monkeypatch.setenv(tracing.ENV_TRACE_RUN, f"{os.getpid()}.{uuid.uuid4().hex[:8]}")
    tracing.collector().reinit_after_fork()
    yield path
    monkeypatch.delenv(tracing.ENV_TRACE)
    tracing.collector().reinit_after_fork()


def test_span_and_latency_steps_land_in_the_trace(trace_on):
    with context.ensure_root():
        with tracing.span("outer", key="k", nbytes=4096) as sp:
            sp.set(volume="0")
            with tracing.span("inner"):
                pass
    tracker = LatencyTracker("direct_pull_device")
    tracker.track_step("open")
    tracker.track_step("land", 1 << 20)
    with pytest.raises(RuntimeError):
        with tracing.span("failing"):
            raise RuntimeError("x")
    tracing.flush_trace()
    events = tracing.load_trace_events(trace_on)
    by = {e["name"]: e for e in events}
    assert by["process_name"]["ph"] == "M"
    outer, inner = by["outer"]["args"], by["inner"]["args"]
    assert outer["bytes"] == 4096 and outer["volume"] == "0" and "GBps" in outer
    assert inner["parent_id"] == outer["span_id"] and inner["trace_id"] == outer["trace_id"]
    assert by["direct_pull_device/land"]["args"]["bytes"] == 1 << 20
    assert "direct_pull_device/open" in by
    assert by["failing"]["args"]["error"] == "RuntimeError"


def test_span_off_costs_no_events():
    assert not tracing.trace_enabled()
    n = len(tracing.collector().events)
    with tracing.span("nothing", nbytes=1):
        pass
    assert len(tracing.collector().events) == n


class _Traced(Actor):
    @endpoint
    async def work(self, x):
        with tracing.span("inside"):
            return x + 1


async def test_trace_id_propagates_across_an_actor_rpc(trace_on):
    mesh = await spawn_actors(1, _Traced, "tst_traced")
    try:
        with context.ensure_root():
            with tracing.span("caller") as sp:
                assert await mesh.refs[0].work.call_one(1) == 2
                caller_id = sp._span_id
            tid = context.trace_id()
    finally:
        await mesh.stop()  # the child flushes its file on exit
    merged = tracing.collect_trace()
    events = json.load(open(merged["path"]))
    rpc = [e for e in events if e.get("name") == "rpc/work"]
    inside = [e for e in events if e.get("name") == "inside"]
    assert len(rpc) == 1 and len(inside) == 1
    assert rpc[0]["pid"] != os.getpid() and tid in merged["trace_ids"]
    assert rpc[0]["args"]["trace_id"] == tid and rpc[0]["args"]["parent_id"] == caller_id
    assert inside[0]["args"]["parent_id"] == rpc[0]["args"]["span_id"]
    labels = [e["args"]["name"] for e in events if e.get("ph") == "M"]
    assert any(label.startswith("tst-tst_traced-0") for label in labels)


def test_flight_recorder_bounds_and_dump(tmp_path, monkeypatch):
    monkeypatch.setenv(recorder.ENV_FLIGHT_DIR, str(tmp_path))
    monkeypatch.setenv(recorder.ENV_FLIGHT_MIN_INTERVAL, "30")
    rec = recorder.FlightRecorder(maxlen=64)
    for i in range(100):
        rec.record("op", f"put{i}", keys=1)
    snap = rec.snapshot()
    assert len(snap) == 64 and snap[0]["name"] == "put36" and snap[-1]["name"] == "put99"
    assert snap[0]["detail"] == {"keys": 1} and snap[0]["pid"] == os.getpid()
    rec.record("fault", "volume.put", action="raise")
    path = rec.dump("fault_die:volume.put")
    payload = json.load(open(path))
    assert payload["trigger"] == "fault_die:volume.put" and len(payload["events"]) == 64
    assert rec.dump("fault_die:volume.get") is None  # one dump per kind per interval
    assert rec.dump("quarantine:0") is not None  # another kind is not shadowed
    rec.set_enabled(False)
    rec.record("op", "ignored")
    assert rec.snapshot()[-1]["name"] != "ignored"
    monkeypatch.setenv(recorder.ENV_FLIGHT, "0")
    assert recorder.FlightRecorder().enabled is False


async def test_stats_carry_each_process_registry():
    name = f"tst_obs_{uuid.uuid4().hex[:6]}"
    await ts.initialize(store_name=name)
    try:
        await ts.put("k", torch.ones(4), store_name=name)
        await ts.get("k", store_name=name)
        stats = await ts.client(name).controller.stats.call_one(include_volumes=True)
        vol = stats["volumes"]["0"]["metrics"]
        assert vol["ts_volume_put_ops_total"]["series"][0]["value"] >= 1
        assert vol["ts_volume_get_ops_total"]["series"][0]["value"] >= 1
        assert "ts_volume_entries" in vol and "metrics" in stats
        local = ts.metrics_snapshot()
        ops = {tuple(sorted(s["labels"].items())): s["value"]
               for s in local["ts_transport_ops_total"]["series"]}
        assert ops[(("op", "put"), ("transport", "shm"))] >= 1
    finally:
        await ts.shutdown(name)
    await asyncio.sleep(0)
