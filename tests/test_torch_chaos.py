"""Port twin of tests/test_chaos.py: continuous publish and acquire traffic
through the weight channel while faults fire (volume kills, injected
raises and delays, wedged publishers, a kill mid-spill).

The oracle is the reference's invariants, not the reference itself (this
file imports nothing of the JAX package):

- no committed generation is lost: every version the publisher committed
  stays readable until superseded, and every acquired state dict holds one
  version's weights, never a mix;
- the dead volume is quarantined by the health supervisor and its keys
  re-replicated with no ``repair()`` call anywhere in this file;
- no get or acquire raises to the caller after failover.

The five deterministic cases run in tier 1; the randomized soak is
``slow``, as in the reference. Each case runs under its own time limit.
The reference's fault schedule also holds ``shm.landing_stamp`` (the
one-sided planes, ROADMAP A10), which the port does not have; the other
five chaos cases of the reference wait on unported pieces (ROADMAP A11.2,
A12)."""

import asyncio
import time

import pytest
import torch

import torchstore_tpu_torch as tst
from torchstore_tpu_torch import stream_sync
from torchstore_tpu_torch.faults import FaultInjectedError

CASE_S = 60.0  # each tier-1 case; the reference's cases take 1.8-5.2 s on a CPU
SOAK_S = 180.0


@pytest.fixture
def fast_health(monkeypatch):
    monkeypatch.setenv("TORCHSTORE_TORCH_HEALTH_INTERVAL_S", "0.25")
    monkeypatch.setenv("TORCHSTORE_TORCH_HEALTH_MISS_THRESHOLD", "2")


def _state_dict(version: int, keys: int = 4, numel: int = 1024) -> dict:
    # Every tensor carries the version as its fill value: an acquired dict
    # mixing generations shows as more than one distinct value.
    return {f"w{i}": torch.full((numel,), float(version)) for i in range(keys)}


def _assert_consistent(sd: dict, version: int) -> None:
    for key, t in sd.items():
        vals = torch.unique(torch.as_tensor(t))
        assert vals.numel() == 1, f"{key} mixes generations: {vals.tolist()}"
        assert vals.item() == float(version), (
            f"{key} holds generation {vals.item()}, acquired version {version}"
        )


async def _kill_volume(store_name: str, volume_id: str) -> None:
    """SIGKILL the process hosting ``volume_id``."""
    from torchstore_tpu_torch import api

    vmap = await tst.client(store_name).controller.get_volume_map.call_one()
    target = vmap[volume_id]["ref"]
    handle = api._stores[store_name]
    for mesh in [handle.volume_mesh, *handle.repair_meshes]:
        for idx, ref in enumerate(mesh.refs):
            if (ref.host, ref.port, ref.name) == (target.host, target.port, target.name):
                proc = mesh._processes[idx]
                proc.kill()
                proc.join(5)
                return
    raise AssertionError(f"no process found for volume {volume_id!r}")


async def _wait_quarantined(store_name: str, volume_id: str, limit_s: float = 30.0) -> None:
    deadline = time.monotonic() + limit_s
    while True:
        vh = await tst.volume_health(store_name)
        if vh[volume_id]["state"] == "quarantined":
            return
        assert time.monotonic() < deadline, f"never quarantined: {vh}"
        await asyncio.sleep(0.1)


async def _run_chaos(store_name: str, versions: int, chaos, publish_interval: float = 0.0,
                     limit_s: float = CASE_S) -> dict:
    """Publish ``versions`` versions while an acquire loop drains them and
    ``chaos(version)`` fires scheduled faults; returns a report. Publish
    and acquire run at once: the schedule interleaves with live traffic."""
    publisher = tst.WeightPublisher("chaos", store_name=store_name, keep=3)
    subscriber = tst.WeightSubscriber("chaos", store_name=store_name)
    report = {"published": [], "acquired": [], "publish_errors": [], "acquire_errors": []}
    done = asyncio.Event()

    async def publish_loop():
        try:
            for v in range(versions):
                await chaos(v)
                if v % 3 == 2:
                    # Every third version is layer-streamed (one fragment a
                    # key): the barrier acquire loop must never see it
                    # unsealed.
                    cs = publisher.stream()
                    for key, t in _state_dict(v).items():
                        await cs.put({key: t})
                    version = await cs.seal()
                else:
                    version = await publisher.publish(_state_dict(v))
                report["published"].append(version)
                if publish_interval:
                    await asyncio.sleep(publish_interval)
        except BaseException as exc:  # noqa: BLE001 - reported by the test
            report["publish_errors"].append(repr(exc))
            raise
        finally:
            done.set()

    async def acquire_loop():
        try:
            while not (done.is_set() and subscriber.last_version == versions - 1):
                try:
                    sd, version = await asyncio.wait_for(subscriber.acquire(timeout=30.0),
                                                         timeout=limit_s)
                except (TimeoutError, asyncio.TimeoutError):
                    if done.is_set():
                        return  # the publisher finished; nothing more is coming
                    raise
                _assert_consistent(sd, version)
                report["acquired"].append(version)
        except asyncio.CancelledError:
            raise
        except BaseException as exc:  # noqa: BLE001 - reported by the test
            # Recorded, so the zero-error assertion reads what happened.
            report["acquire_errors"].append(repr(exc))
            raise

    pub_task = asyncio.ensure_future(publish_loop())
    acq_task = asyncio.ensure_future(acquire_loop())
    try:
        await asyncio.wait_for(asyncio.gather(pub_task, acq_task), timeout=limit_s)
    finally:
        for task in (pub_task, acq_task):
            if not task.done():
                task.cancel()
        await asyncio.gather(pub_task, acq_task, return_exceptions=True)
    return report


async def test_chaos_deterministic_kill_and_reconverge(fast_health):
    """Kill one of three volumes mid-traffic: publishes and acquires keep
    succeeding, the supervisor quarantines and auto-repairs, and the last
    version's keys are back on two healthy volumes, with no repair()."""
    name = "tst_chaos_kill"
    await tst.initialize(num_storage_volumes=3, store_name=name,
                         strategy=tst.LocalRankStrategy(replication=2))
    victim = {}

    async def body():
        client = tst.client(name)
        await client._ensure_setup()

        async def chaos(version: int):
            if version == 6:
                # Kill a volume that holds channel data.
                located = await client.controller.locate_volumes.call_one(["chaos/v5/w0"])
                victim["vid"] = sorted(located["chaos/v5/w0"])[0]
                await _kill_volume(name, victim["vid"])

        report = await _run_chaos(name, versions=18, chaos=chaos)
        assert report["publish_errors"] == []
        assert report["acquire_errors"] == []
        assert report["published"] == list(range(18))
        # The subscriber may skip versions (it acquires the latest) but ends
        # on the last one.
        assert report["acquired"][-1] == 17
        await _wait_quarantined(name, victim["vid"])
        deadline = time.monotonic() + 30.0
        keys = [f"chaos/v17/w{i}" for i in range(4)]
        while True:
            located = await client.controller.locate_volumes.call_one(keys)
            placements = {k: set(located[k]) for k in keys}
            if all(victim["vid"] not in p and len(p) == 2 for p in placements.values()):
                break
            assert time.monotonic() < deadline, f"fleet did not reconverge: {placements}"
            await asyncio.sleep(0.3)
        _assert_consistent(await tst.get_state_dict("chaos/v17", store_name=name), 17)

    try:
        await asyncio.wait_for(body(), CASE_S)
    finally:
        await tst.shutdown(name)


async def test_chaos_deterministic_fault_schedule(fast_health):
    """Raise and delay faults on the volumes' data plane and a delayed
    watermark step in the controller fire inside live publish and acquire
    traffic; the retries absorb every one (zero errors either side)."""
    name = "tst_chaos_sched"
    await tst.initialize(num_storage_volumes=2, store_name=name,
                         strategy=tst.LocalRankStrategy(replication=2))

    async def body():
        async def chaos(version: int):
            if version == 3:
                await tst.inject_fault("volume.put", "raise", count=1, scope="volumes",
                                       store_name=name)
            elif version == 6:
                await tst.inject_fault("volume.get", "raise", count=2, scope="volumes",
                                       store_name=name)
            elif version == 7:
                # Version 8 is streamed: its watermarks stay invisible to
                # streaming readers for 150 ms inside the notify.
                await tst.inject_fault("channel.watermark", "delay", count=2, delay_ms=150,
                                       scope="controller", store_name=name)
            elif version == 9:
                await tst.inject_fault("volume.handshake", "delay", count=2, delay_ms=150,
                                       store_name=name)

        report = await _run_chaos(name, versions=12, chaos=chaos)
        assert report["publish_errors"] == []
        assert report["acquire_errors"] == []
        assert report["acquired"][-1] == 11
        _assert_consistent(await tst.get_state_dict("chaos/v11", store_name=name), 11)

    try:
        await asyncio.wait_for(body(), CASE_S)
    finally:
        await tst.clear_faults(store_name=name)
        await tst.shutdown(name)


async def test_chaos_wedged_stream_publisher_never_mixes(fast_health):
    """A publisher wedged mid-stream (``channel.publish_layer``) never
    yields a mixed acquire: barrier subscribers get the previous sealed
    version, a streaming subscriber serves only the wedged stream's
    committed prefix and then times out, and a resumed publisher reclaims
    the partial before publishing the same version number."""
    name = "tst_chaos_wedge"
    await tst.initialize(num_storage_volumes=2, store_name=name,
                         strategy=tst.LocalRankStrategy(replication=2))

    async def body():
        pub = tst.WeightPublisher("chaos", store_name=name, keep=3)
        sub = tst.WeightSubscriber("chaos", store_name=name)
        cs = pub.stream()
        for key, t in _state_dict(0).items():
            await cs.put({key: t})
        assert await cs.seal() == 0
        sd, version = await sub.acquire(timeout=30)
        assert version == 0
        _assert_consistent(sd, 0)
        # v1: two layers land, then the publisher wedges on the third.
        cs1 = pub.stream()
        sd1 = _state_dict(1)
        keys = sorted(sd1)
        await cs1.put({keys[0]: sd1[keys[0]]})
        await cs1.put({keys[1]: sd1[keys[1]]})
        await tst.inject_fault("channel.publish_layer", "wedge", count=1, scope="client",
                               store_name=name)

        async def wedged_rest():
            for key in keys[2:]:
                await cs1.put({key: sd1[key]})
            await cs1.seal()

        wedged = asyncio.ensure_future(wedged_rest())
        await asyncio.sleep(0.3)
        assert not wedged.done()
        # A barrier subscriber joining now reads v0 whole.
        sub2 = tst.WeightSubscriber("chaos", store_name=name)
        sd, version = await sub2.acquire(timeout=15)
        assert version == 0
        _assert_consistent(sd, 0)
        # A streaming subscriber serves only v1's committed prefix, then
        # times out: it never returns a state dict.
        served = []
        sub3 = tst.WeightSubscriber("chaos", store_name=name)
        with pytest.raises((TimeoutError, asyncio.TimeoutError)):
            await sub3.acquire_streamed(
                on_layer=lambda fk, v: served.append((fk, float(v[0]))), timeout=3)
        assert {k for k, _ in served} <= set(keys[:2])
        assert all(val == 1.0 for _, val in served)
        # The publisher crashes; a fresh one resumes.
        wedged.cancel()
        await asyncio.gather(wedged, return_exceptions=True)
        await tst.clear_faults(store_name=name)
        pub2 = tst.WeightPublisher("chaos", store_name=name, keep=3)
        version = await pub2.publish(_state_dict(1))
        assert version == 1  # the partial v1 reclaimed, its number reused
        sd, version = await sub2.acquire(timeout=30)
        assert version == 1
        _assert_consistent(sd, 1)

    try:
        await asyncio.wait_for(body(), CASE_S)
    finally:
        await tst.clear_faults(store_name=name)
        await tst.shutdown(name)


async def test_chaos_wedged_delta_publisher_never_mixes_or_drifts(fast_health):
    """A delta publisher wedged mid-version leaves barrier readers on the
    previous sealed version (consistent watermarks); the resumed publisher,
    with no baselines, keyframes again and readers converge bit for bit on
    its baselines; an injected ``channel.delta_baseline`` raise fails the
    next delta publish loudly instead of shipping anything stale."""
    from torchstore_tpu_torch import state_dict_utils

    name = "tst_chaos_delta"
    await tst.initialize(num_storage_volumes=2, store_name=name,
                         strategy=tst.LocalRankStrategy(replication=2))

    def publisher():
        return tst.WeightPublisher("dchan", store_name=name, keep=5,
                                   transfer_quant="int8_block", delta=True, keyframe_every=4)

    async def body():
        pub = publisher()
        sub = tst.WeightSubscriber("dchan", store_name=name)
        gen = torch.Generator().manual_seed(13)
        w = {f"w{i}": torch.randn(512, generator=gen) for i in range(4)}

        async def stream_publish():
            cs = pub.stream()
            for key in sorted(w):
                await cs.put({key: w[key]})
            return await cs.seal()

        def within_step(sd):
            for key in w:
                tol = w[key].abs().max().item() / 127 + 1e-6
                torch.testing.assert_close(torch.as_tensor(sd[key]).float(), w[key],
                                           rtol=0, atol=tol)

        def assert_exact(sd, source):
            for key in w:
                got = torch.as_tensor(sub._delta_decoder().state[key]["blocks"])
                base = torch.as_tensor(source._codec.entries[key]["baseline"])
                assert torch.equal(got, base), key
            within_step(sd)

        assert await stream_publish() == 0
        sd, v = await sub.acquire(timeout=30)
        assert v == 0
        assert_exact(sd, pub)
        w["w0"][:64] += 0.1
        assert await stream_publish() == 1
        sd, v = await sub.acquire(timeout=30)
        assert v == 1
        assert_exact(sd, pub)

        # v2 wedges after two layers.
        keys = sorted(w)
        w[keys[0]][:64] += 0.1
        cs2 = pub.stream()
        await cs2.put({keys[0]: w[keys[0]]})
        await cs2.put({keys[1]: w[keys[1]]})
        await tst.inject_fault("channel.publish_layer", "wedge", count=1, scope="client",
                               store_name=name)

        async def wedged_rest():
            for key in keys[2:]:
                await cs2.put({key: w[key]})
            await cs2.seal()

        wedged = asyncio.ensure_future(wedged_rest())
        await asyncio.sleep(0.3)
        assert not wedged.done()
        # A barrier join mid-wedge reads the previous sealed version, with
        # consistent watermarks for all it serves.
        sub2 = tst.WeightSubscriber("dchan", store_name=name)
        _, v2 = await sub2.acquire(timeout=15)
        assert v2 == 1
        state1 = await tst.client(name).stream_state("dchan/v1")
        assert stream_sync.inconsistent_keys(
            state1, [f"dchan/v1/{k}" for k in keys], state1["version"]) == []
        # The wedged publisher crashes; a resumed one has no baselines and
        # keyframes (never a delta over a lost baseline).
        wedged.cancel()
        await asyncio.gather(wedged, return_exceptions=True)
        await tst.clear_faults(store_name=name)
        pub2 = publisher()
        assert await pub2.publish(w) == 2  # the partial v2 reclaimed, its number reused
        info = state_dict_utils.parse_quant_blob(
            await tst.client(name).get(f"dchan/v2/{keys[0]}"))
        assert info["flags"] & state_dict_utils._FLAG_KEYFRAME
        sd, v = await sub.acquire(timeout=30)
        assert v == 2
        assert_exact(sd, pub2)
        # Baseline loss injected: the next delta publish fails loudly.
        await tst.inject_fault("channel.delta_baseline", "raise", count=1, scope="client",
                               store_name=name)
        w[keys[0]][:64] += 0.1
        with pytest.raises(FaultInjectedError):
            await pub2.publish(w)
        await tst.clear_faults(store_name=name)
        version = await pub2.publish(w)
        sd, v = await sub.acquire(timeout=30)
        assert v == version
        within_step(sd)

    try:
        await asyncio.wait_for(body(), CASE_S)
    finally:
        await tst.clear_faults(store_name=name)
        await tst.shutdown(name)


async def test_chaos_tiered_cohorts_kill_mid_spill_and_fault_in(fast_health, monkeypatch,
                                                               tmp_path):
    """Three cohorts pinned to three versions read at once while the
    publisher advances and the spill writer runs: no mixed read, no pinned
    version reaped or spilled-then-lost while leased. The schedule kills a
    volume mid-spill (``volume.spill`` die) and raises in fault-ins
    (``volume.fault_in``); the pinned cohorts carry on through replica
    failover and auto-repair, with no repair()."""
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_ENABLED", "1")
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_DIR", str(tmp_path / "tier"))
    # A tiny budget: past a few versions every sweep demotes.
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_BUDGET_BYTES", str(48 * 1024))
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_HIGH_PCT", "0.5")
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_LOW_PCT", "0.25")
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_SWEEP_INTERVAL_S", "0")  # the test sweeps
    name = "tst_chaos_tier"
    await tst.initialize(num_storage_volumes=3, store_name=name,
                         strategy=tst.LocalRankStrategy(replication=2))
    pins = {"rollout-v0": 0, "eval-v1": 1, "canary-v2": 2}
    report = {"pinned_reads": 0, "pinned_errors": [], "sweep_rounds": 0}
    stop = asyncio.Event()
    victim = {}

    async def body():
        client = tst.client(name)
        await client._ensure_setup()
        pub = tst.WeightPublisher("chaos", store_name=name, keep=3)
        for v in range(3):
            await pub.publish(_state_dict(v))
        leases = {cohort: await client.lease_acquire(cohort, "chaos", v, ttl_s=300)
                  for cohort, v in pins.items()}
        assert all(le["resident_keys"] > 0 for le in leases.values())

        async def cohort_loop(cohort: str, version: int):
            sub = tst.WeightSubscriber("chaos", store_name=name, cohort=cohort)
            try:
                while not stop.is_set():
                    sd, got = await sub.acquire(version=version)
                    assert got == version
                    _assert_consistent(sd, version)
                    report["pinned_reads"] += 1
                    await asyncio.sleep(0.05)
            except BaseException as exc:  # noqa: BLE001 - reported below
                report["pinned_errors"].append(f"{cohort}: {exc!r}")
                raise

        async def sweep_loop():
            while not stop.is_set():
                await tst.tier_sweep(name)
                report["sweep_rounds"] += 1
                await asyncio.sleep(0.15)

        async def publish_loop():
            try:
                for v in range(3, 11):
                    if v == 5:
                        # The die fires inside the next sweep's spill pass,
                        # after the demotion decision, before the disk
                        # write commits.
                        located = await client.controller.locate_volumes.call_one(
                            ["chaos/v3/w0"])
                        victim["vid"] = sorted(located["chaos/v3/w0"])[0]
                        await tst.inject_fault("volume.spill", "die", count=1,
                                               scope=victim["vid"], store_name=name)
                    if v == 8:
                        # Fault-ins raise mid-promotion on every survivor.
                        for vid in sorted(client._volume_refs):
                            if vid != victim.get("vid"):
                                await tst.inject_fault("volume.fault_in", "raise", count=2,
                                                       scope=vid, store_name=name)
                    await pub.publish(_state_dict(v))
                    await asyncio.sleep(0.1)
            finally:
                stop.set()

        tasks = [asyncio.ensure_future(cohort_loop(c, v)) for c, v in pins.items()]
        tasks.append(asyncio.ensure_future(sweep_loop()))
        try:
            await publish_loop()
            await asyncio.gather(*tasks)
        finally:
            stop.set()
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        assert report["pinned_errors"] == []
        assert report["pinned_reads"] >= 3 * 3  # every cohort read repeatedly
        assert report["sweep_rounds"] > 0
        # No pinned version was reaped while leased (keep=3 moved the cutoff
        # far past all three), and each still serves.
        for cohort, v in pins.items():
            assert await client.keys(f"chaos/v{v}") != [], f"v{v} reaped"
            sd, _ = await tst.WeightSubscriber("chaos", store_name=name,
                                               cohort=cohort).acquire(version=v)
            _assert_consistent(sd, v)
        # An unleased version from mid-run was reaped as usual.
        assert await client.keys("chaos/v4") == []
        catalog = await tst.version_catalog("chaos", store_name=name)
        for cohort, v in pins.items():
            assert cohort in [le["cohort"] for le in catalog["chaos"][v]["leases"]]
        # The kill mid-spill was seen: quarantined, no repair() anywhere.
        await _wait_quarantined(name, victim["vid"])
        for lease in leases.values():
            await client.lease_release(lease["lease_id"])

    try:
        await asyncio.wait_for(body(), CASE_S)
    finally:
        stop.set()
        await tst.clear_faults(store_name=name)
        await tst.shutdown(name)


@pytest.mark.slow
async def test_chaos_soak_randomized(fast_health):
    """Probabilistic raise and delay faults across the fleet plus a volume
    kill mid-run, under sustained publish and acquire traffic: the same
    invariants at a longer run."""
    name = "tst_chaos_soak"
    await tst.initialize(num_storage_volumes=3, store_name=name,
                         strategy=tst.LocalRankStrategy(replication=2))

    async def body():
        client = tst.client(name)
        await client._ensure_setup()
        await tst.inject_fault("volume.get", "raise", prob=0.05, scope="volumes",
                               store_name=name)
        await tst.inject_fault("volume.put", "delay", prob=0.1, delay_ms=50, store_name=name)
        killed = {}

        async def chaos(version: int):
            if version == 20:
                vmap = await client.controller.get_volume_map.call_one()
                killed["vid"] = sorted(vmap)[-1]
                await _kill_volume(name, killed["vid"])

        report = await _run_chaos(name, versions=60, chaos=chaos, publish_interval=0.05,
                                  limit_s=SOAK_S)
        assert report["publish_errors"] == []
        assert report["acquire_errors"] == []
        assert report["published"] == list(range(60))
        assert report["acquired"][-1] == 59
        vh = await tst.volume_health(name)
        assert vh[killed["vid"]]["state"] == "quarantined"
        _assert_consistent(await tst.get_state_dict("chaos/v59", store_name=name), 59)

    try:
        await asyncio.wait_for(body(), SOAK_S)
    finally:
        await tst.clear_faults(store_name=name)
        await tst.shutdown(name)
