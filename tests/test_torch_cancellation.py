"""Cancellation and fire-and-forget: the spawn_logged and put-lifecycle
cases of tests/test_cancellation.py on the port.

- A cancelled put propagates through the transport buffer's lifecycle:
  its error accounting re-raises, never swallows, and ``drop()`` still
  runs; the same for a get.
- ``utils.spawn_logged`` keeps its task until done, and logs and counts
  (``ts_background_task_errors_total``) a failure instead of losing it;
  cancellation is not a failure. Both packages count the same events.
"""

import asyncio
import logging

import pytest
import torch

from torchstore_tpu.observability import metrics as ref_metrics
from torchstore_tpu.utils import spawn_logged as ref_spawn_logged
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.strategy import StorageVolumeRef
from torchstore_tpu_torch.transport.buffers import TransportBuffer, TransportContext
from torchstore_tpu_torch.transport.types import Request
from torchstore_tpu_torch.utils import spawn_logged


class _HangingEndpoint:
    """Stands in for ``volume.actor.put`` / ``.get``: hangs until cancelled."""

    def __init__(self) -> None:
        self.started = asyncio.Event()

    def with_timeout(self, timeout):
        return self

    def effective_timeout(self):
        return None

    async def call_one(self, *args, **kwargs):
        self.started.set()
        await asyncio.Event().wait()


class _FakeActor:
    def __init__(self) -> None:
        self.put = _HangingEndpoint()
        self.get = _HangingEndpoint()


class _NullBuffer(TransportBuffer):
    transport_name = "test_cancel"
    requires_handshake = False

    def __init__(self) -> None:
        self.dropped = 0

    def _handle_storage_volume_response(self, volume, remote, requests):
        return []

    def handle_put_request(self, ctx, metas, existing):
        return {}

    def handle_get_request(self, ctx, metas, entries):
        return None

    def drop(self) -> None:
        self.dropped += 1


def _errors(op: str) -> float:
    return obs_metrics.counter("ts_transport_errors_total").value(transport="test_cancel", op=op)


@pytest.mark.parametrize("op", ["put", "get"])
def test_cancellation_propagates_through_the_lifecycle(op):
    async def main():
        buf = _NullBuffer()
        actor = _FakeActor()
        volume = StorageVolumeRef(actor=actor, volume_id="v0",
                                  transport_context=TransportContext())
        req = Request.from_tensor("k", torch.zeros(16))
        before = _errors(op)
        if op == "put":
            task = asyncio.create_task(buf.put_to_storage_volume(volume, [req]))
        else:
            task = asyncio.create_task(buf.get_from_storage_volume(volume, [req]))
        await asyncio.wait_for(getattr(actor, op).started.wait(), 10)
        task.cancel()
        # CancelledError comes back out: the error accounting re-raises.
        with pytest.raises(asyncio.CancelledError):
            await task
        assert task.cancelled()
        assert buf.dropped == 1  # the release in ``finally`` ran
        assert _errors(op) == before + 1  # the aborted transfer counted

    asyncio.run(main())


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_spawn_logged_counts_and_logs_failures(caplog, impl):
    fn, registry, logger_name = (
        (spawn_logged, obs_metrics, "torchstore_tpu_torch.tasks") if impl == "port"
        else (ref_spawn_logged, ref_metrics, "torchstore_tpu.tasks"))

    async def main():
        tasks: set = set()

        async def boom():
            raise RuntimeError("kaboom")

        counter = registry.counter("ts_background_task_errors_total")
        before = counter.value(task="test.boom")
        with caplog.at_level(logging.ERROR, logger=logger_name):
            t = fn(boom(), name="test.boom", tasks=tasks)
            assert t in tasks  # kept while in flight
            with pytest.raises(RuntimeError):
                await t
            await asyncio.sleep(0)  # the done callback runs
        assert t not in tasks
        assert counter.value(task="test.boom") == before + 1
        assert any("test.boom" in rec.getMessage() for rec in caplog.records)

    asyncio.run(main())


def test_spawn_logged_cancellation_is_not_an_error():
    async def main():
        tasks: set = set()

        async def forever():
            await asyncio.Event().wait()

        counter = obs_metrics.counter("ts_background_task_errors_total")
        before = counter.value(task="test.cancelled")
        t = spawn_logged(forever(), name="test.cancelled", tasks=tasks)
        await asyncio.sleep(0)
        t.cancel()
        with pytest.raises(asyncio.CancelledError):
            await t
        await asyncio.sleep(0)
        assert t not in tasks
        assert counter.value(task="test.cancelled") == before

    asyncio.run(main())


def test_spawn_logged_success_keeps_result():
    async def main():
        async def work():
            return 42

        t = spawn_logged(work(), name="test.ok")
        assert await t == 42

    asyncio.run(main())
