"""The port's version retention and spill tier (``torchstore_tpu_torch/
tiering/``), held to the JAX package.

- ``TestVersionGroup`` and ``TestLeaseRegistry`` run the reference's unit
  cases on the port, and the same calls through both packages give the same
  answers.
- Every fleet case of ``tests/test_tiering.py`` runs as one scripted
  sequence of publishes, leases, sweeps and reads through both packages'
  public APIs, each store with its own tier directory under ``tmp_path``
  (budget 32 KB, watermarks 0.5 / 0.25, no background sweeper, as the
  reference's fixture). The JAX package is the oracle: the same sequence
  gives the same ``version_catalog`` (keys, bytes, tier split, cohorts) and
  the same values; the reference's own assertions are held on the port.
  The JAX store runs off shared memory, so it adds no ``ts_shm_*`` segment
  to the machine-wide counts of its own tests.
- Two port-only cases: a sweep racing a get of the same key (the served
  segment retires under its read lease, never unlinked under the reader),
  and a plan-cached reget of a spilled key (no locate, and the volume still
  faults it in).

Each package runs one session of every case (module fixtures); the tests
hold the recorded results.
"""

import asyncio
import contextlib
import multiprocessing
import os
import time
import uuid

import ml_dtypes
import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import config as ref_config
from torchstore_tpu import state_dict_utils as ref_sdu
from torchstore_tpu import tiering as ref_tiering
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.tiering.leases import LeaseRegistry as RefLeaseRegistry
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu_torch import state_dict_utils as port_sdu
from torchstore_tpu_torch import tiering
from torchstore_tpu_torch.tiering.leases import LeaseRegistry
from torchstore_tpu_torch.transport import shared_memory as port_shm

N_KEYS = 4
N_ELEM = 1024  # 4 KB per tensor


def run(coro_fn, *args):
    return asyncio.run(asyncio.wait_for(coro_fn(*args), timeout=420))


def np_of(value) -> np.ndarray:
    """A leaf of either package as numpy (bf16 as its uint16 bits)."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view(np.uint16).copy()
        return value.numpy().copy()
    arr = np.asarray(value)
    if arr.dtype == ml_dtypes.bfloat16:
        return arr.view(np.uint16).copy()
    return arr.copy()


# ---------------------------------------------------------------------------
# unit: version grouping and the lease registry
# ---------------------------------------------------------------------------

GROUP_KEYS = ["chan/v7/w0", "a/b/v12/MAPPING", "chan/v7", "chan/LATEST", "plain_key",
              "chan/vx/w0", "v3/w0", "a/v1/b/v2/c", "x/v007/y", "x/v/y"]


class TestVersionGroup:
    def test_channel_version_keys(self):
        assert tiering.version_group("chan/v7/w0") == ("chan", 7)
        assert tiering.version_group("a/b/v12/MAPPING") == ("a/b", 12)
        assert tiering.version_group("chan/v7") == ("chan", 7)

    def test_non_version_keys(self):
        assert tiering.version_group("chan/LATEST") is None
        assert tiering.version_group("plain_key") is None
        assert tiering.version_group("chan/vx/w0") is None
        # A bare leading v-segment has no channel in front of it.
        assert tiering.version_group("v3/w0") is None

    def test_first_version_segment_wins(self):
        assert tiering.version_group("a/v1/b/v2/c") == ("a", 1)

    @pytest.mark.parametrize("key", GROUP_KEYS)
    def test_equals_reference(self, key):
        assert tiering.version_group(key) == ref_tiering.version_group(key)
        assert tiering.group_key("c/d", 3) == ref_tiering.group_key("c/d", 3)
        assert (tiering.RESIDENT, tiering.TIERED) == (ref_tiering.RESIDENT, ref_tiering.TIERED)


def _registry_script(reg) -> list:
    """One sequence of registry calls; its answers with times taken out."""
    def strip(d):
        return {k: v for k, v in d.items() if k not in ("expires_in_s", "created_ts")}

    out = []
    a = reg.acquire("eval", "chan", 3)
    out.append(strip(a))
    out.append(strip(reg.acquire("eval", "chan", 3, ttl_s=90)))
    out.append(strip(reg.acquire("canary", "chan", 3)))
    out.append(strip(reg.acquire("eval", "other", 1)))
    out.append(sorted(reg.pinned_groups()))
    out.append({c: {v: sorted(cs) for v, cs in vs.items()} for c, vs in reg.pins().items()})
    out.append([reg.blocks_delete(k) for k in ("chan/v3/w0", "chan/v4/w0", "chan/LATEST",
                                               "other/v1/MAPPING")])
    out.append(strip(reg.renew(a["lease_id"], ttl_s=60)))
    out.append([reg.release(a["lease_id"]), reg.release(a["lease_id"]), len(reg)])
    for bad in (lambda: reg.acquire("", "chan", 1), lambda: reg.acquire("e", "chan", 1, ttl_s=0),
                lambda: reg.renew("nope")):
        try:
            bad()
            out.append(None)
        except (ValueError, KeyError) as exc:
            out.append(type(exc).__name__)
    out.append(sorted(strip(d)["lease_id"] for d in reg.describe()))
    reg.clear()
    out.append(len(reg))
    return out


class TestLeaseRegistry:
    def test_acquire_renew_release(self):
        reg = LeaseRegistry(ttl_s=30)
        lease = reg.acquire("eval", "chan", 3)
        assert reg.is_pinned("chan", 3) and not reg.is_pinned("chan", 4)
        assert reg.pinned_groups() == {"chan/v3"}
        assert reg.blocks_delete("chan/v3/w0")
        assert not reg.blocks_delete("chan/v4/w0")
        assert not reg.blocks_delete("chan/LATEST")
        renewed = reg.renew(lease["lease_id"], ttl_s=60)
        assert renewed["ttl_s"] == 60
        assert reg.release(lease["lease_id"]) is True
        assert reg.release(lease["lease_id"]) is False  # idempotent
        assert not reg.is_pinned("chan", 3)

    def test_ttl_expiry(self):
        reg = LeaseRegistry(ttl_s=0.05)
        lease = reg.acquire("eval", "chan", 1)
        assert reg.is_pinned("chan", 1)
        time.sleep(0.08)
        assert not reg.is_pinned("chan", 1)  # lazy expiry on every query
        with pytest.raises(KeyError):
            reg.renew(lease["lease_id"])  # expired: re-acquire instead

    def test_reacquire_renews_instead_of_stacking(self):
        reg = LeaseRegistry(ttl_s=30)
        a = reg.acquire("eval", "chan", 1)
        b = reg.acquire("eval", "chan", 1, ttl_s=90)
        assert a["lease_id"] == b["lease_id"] and len(reg) == 1
        # The coalesce is reported: a read-scoped caller must not release
        # a pin it merely refreshed.
        assert a["renewed"] is False and b["renewed"] is True
        # A different cohort's pin on the same version is its own lease.
        reg.acquire("canary", "chan", 1)
        assert len(reg) == 2
        assert sorted(reg.pins("chan")["chan"][1]) == ["canary", "eval"]

    def test_script_equals_reference(self):
        assert _registry_script(LeaseRegistry(ttl_s=30)) == _registry_script(
            RefLeaseRegistry(ttl_s=30))

    def test_default_ttl_from_each_prefix(self, monkeypatch):
        monkeypatch.setenv("TORCHSTORE_TORCH_LEASE_TTL_S", "7.5")
        monkeypatch.setenv("TORCHSTORE_TPU_LEASE_TTL_S", "7.5")
        assert LeaseRegistry().default_ttl_s == RefLeaseRegistry().default_ttl_s == 7.5


# ---------------------------------------------------------------------------
# fleet: both packages through one script of cases
# ---------------------------------------------------------------------------


class Pkg:
    """One package as the cases drive it: its API module, its env prefix,
    its leaves and its state-dict module (for the slow-pull cases)."""

    def __init__(self, name: str, root: str) -> None:
        self.name = name
        self.root = root
        self.ts = tst if name == "port" else ts_ref
        self.prefix = "TORCHSTORE_TORCH_" if name == "port" else "TORCHSTORE_TPU_"
        self.sdu = port_sdu if name == "port" else ref_sdu
        self.config = None

    def full(self, value: float):
        if self.name == "port":
            return torch.full((N_ELEM,), float(value))
        return np.full(N_ELEM, float(value), np.float32)

    def sd(self, version: int) -> dict:
        return {f"w{i}": self.full(version) for i in range(N_KEYS)}

    def store(self, case: str) -> str:
        return f"{case}_{self.name}_{uuid.uuid4().hex[:6]}"

    @contextlib.contextmanager
    def env(self, case: str, tier: bool = True, **extra):
        """The reference fixture's settings under this package's prefix,
        with a tier directory of the case's own."""
        values = {}
        if tier:
            values.update({
                "TIER_ENABLED": "1", "TIER_DIR": os.path.join(self.root, self.name, case),
                "TIER_BUDGET_BYTES": str(32 * 1024), "TIER_HIGH_PCT": "0.5",
                "TIER_LOW_PCT": "0.25", "TIER_SWEEP_INTERVAL_S": "0",
            })
        values.update(extra)
        names = [self.prefix + k for k in values]
        saved = {n: os.environ.get(n) for n in names}
        os.environ.update({self.prefix + k: v for k, v in values.items()})
        try:
            yield
        finally:
            for n, v in saved.items():
                if v is None:
                    os.environ.pop(n, None)
                else:
                    os.environ[n] = v

    async def initialize(self, store: str) -> None:
        await self.ts.initialize(store_name=store, config=self.config)


def values_of(sd: dict) -> dict:
    return {k: np.unique(np_of(v)).tolist() for k, v in sorted(sd.items())}


def catalog_view(cat: dict, chan: str, cohorts: bool = True) -> dict:
    """The comparable part of one channel's catalog."""
    out = {}
    for v, rec in sorted(cat.get(chan, {}).items()):
        row = {k: rec[k] for k in ("keys", "bytes", "resident_keys", "spilled_keys")}
        row["leases"] = (sorted(le["cohort"] for le in rec["leases"]) if cohorts
                         else len(rec["leases"]))
        out[int(v)] = row
    return out


def sweep_view(report: dict) -> dict:
    (rep,) = report.values()
    return {k: rep.get(k) for k in ("enabled", "spilled", "fault_ins", "spilled_keys")}


async def case_spill(pkg: Pkg) -> dict:
    """test_spill_faults_in_and_exempts_leased"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier1")
    with pkg.env("tier1"):
        await pkg.initialize(store)
    try:
        pub = ts.WeightPublisher("cap", store_name=store, keep=10)
        out["versions"] = [await pub.publish(pkg.sd(v)) for v in range(4)]
        client = ts.client(store)
        lease = await client.lease_acquire("hot-cohort", "cap", 1)
        out["lease"] = (lease["resident_keys"], lease["renewed"])
        out["sweep"] = sweep_view(await ts.tier_sweep(store))
        cat = await ts.version_catalog("cap", store_name=store)
        out["catalog"] = catalog_view(cat, "cap")
        spilled = [v for v, rec in cat["cap"].items()
                   if rec["keys"] and rec["spilled_keys"] == rec["keys"]]
        out["spilled_versions"] = sorted(spilled)
        v = sorted(spilled)[0]
        out["fault_in"] = (v, values_of(await ts.get_state_dict(f"cap/v{v}", store_name=store)))
        out["sweep2"] = sweep_view(await ts.tier_sweep(store))
        out["catalog2"] = catalog_view(await ts.version_catalog("cap", store_name=store), "cap")
        if pkg.name == "port":
            stats = await client.controller.stats.call_one(include_volumes=True)
            (vol,) = stats["volumes"].values()
            out["disk"] = (vol["tier"]["spill_bytes"], vol["tier"]["fault_in_bytes"])
            snap = vol["metrics"]
            out["counters"] = {name: sum(s["value"] for s in snap[name]["series"])
                               for name in ("ts_spills_total", "ts_fault_ins_total")}
        else:
            matrix = await ts.traffic_matrix(store)
            (disk,) = matrix["disk"].values()
            out["disk"] = (disk["spill_bytes"], disk["fault_in_bytes"])
        await client.lease_release(lease["lease_id"])
    finally:
        await ts.shutdown(store)
    return out


async def case_gc(pkg: Pkg) -> dict:
    """test_delete_guard_and_lease_aware_gc"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier2")
    with pkg.env("tier2"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        pub = ts.WeightPublisher("gc", store_name=store, keep=2)
        for v in range(3):
            await pub.publish(pkg.sd(v))
        lease = await client.lease_acquire("eval", "gc", 1, ttl_s=120)
        for v in range(3, 6):
            await pub.publish(pkg.sd(v))
        sd, version = await ts.WeightSubscriber("gc", store_name=store,
                                                cohort="eval").acquire(version=1)
        out["pinned"] = (version, values_of(sd))
        out["reaped"] = (await client.keys("gc/v0"), await client.keys("gc/v2"))
        out["catalog"] = catalog_view(await ts.version_catalog("gc", store_name=store), "gc")
        await client.delete_prefix("gc/v1")
        out["after_raw_delete"] = len(await client.keys("gc/v1"))
        if pkg.name == "port":
            stats = await client.controller.stats.call_one()
            series = stats["metrics"]["ts_lease_blocked_deletes_total"]["series"]
            out["blocked"] = sum(s["value"] for s in series)
        await client.lease_release(lease["lease_id"])
        await pub.publish(pkg.sd(6))
        out["after_release"] = await client.keys("gc/v1")
        try:
            await ts.WeightSubscriber("gc", store_name=store).acquire(version=1)
            out["gone"] = None
        except KeyError as exc:
            out["gone"] = "does not retain" in str(exc)
    finally:
        await ts.shutdown(store)
    return out


async def case_streamed(pkg: Pkg) -> dict:
    """test_pinned_streamed_acquire"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier3")
    with pkg.env("tier3"):
        await pkg.initialize(store)
    try:
        pub = ts.WeightPublisher("st", store_name=store, keep=10)
        for v in range(2):
            cs = pub.stream()
            for key, arr in pkg.sd(v).items():
                await cs.put({key: arr})
            out.setdefault("sealed", []).append(await cs.seal())
        client = ts.client(store)
        lease = await client.lease_acquire("replay", "st", 0, ttl_s=120)
        out["sweep"] = sweep_view(await ts.tier_sweep(store))
        served = []
        sub = ts.WeightSubscriber("st", store_name=store, cohort="replay")
        sd, version = await sub.acquire_streamed(
            version=0, key_order=[f"w{i}" for i in range(N_KEYS)],
            on_layer=lambda fk, val: served.append(fk), timeout=30)
        out["pinned"] = (version, values_of(sd), served)
        out["catalog"] = catalog_view(await ts.version_catalog("st", store_name=store), "st")
        await client.lease_release(lease["lease_id"])
    finally:
        await ts.shutdown(store)
    return out


async def case_expired(pkg: Pkg) -> dict:
    """test_expired_lease_unpins"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier4")
    with pkg.env("tier4"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        pub = ts.WeightPublisher("ttl", store_name=store, keep=2)
        for v in range(3):
            await pub.publish(pkg.sd(v))
        await client.lease_acquire("flaky", "ttl", 1, ttl_s=0.2)
        await asyncio.sleep(0.3)
        await pub.publish(pkg.sd(3))
        await pub.publish(pkg.sd(4))
        out["keys_v1"] = await client.keys("ttl/v1")
        out["catalog"] = catalog_view(await ts.version_catalog("ttl", store_name=store), "ttl")
    finally:
        await ts.shutdown(store)
    return out


async def case_failed_spill(pkg: Pkg) -> dict:
    """test_failed_spill_leaves_entry_resident"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier5")
    with pkg.env("tier5"):
        await pkg.initialize(store)
    try:
        pub = ts.WeightPublisher("ab", store_name=store, keep=10)
        for v in range(4):
            await pub.publish(pkg.sd(v))
        await ts.inject_fault("volume.spill", "raise", count=100, scope="volumes",
                              store_name=store)
        out["faulted"] = sweep_view(await ts.tier_sweep(store))
        await ts.clear_faults(store_name=store)
        out["values"] = [values_of(await ts.get_state_dict(f"ab/v{v}", store_name=store))
                         for v in range(4)]
        out["after"] = sweep_view(await ts.tier_sweep(store))
        out["catalog"] = catalog_view(await ts.version_catalog("ab", store_name=store), "ab")
    finally:
        await ts.clear_faults(store_name=store)
        await ts.shutdown(store)
    return out


async def case_overwrite(pkg: Pkg) -> dict:
    """test_overwrite_discards_stale_disk_copy"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier6")
    with pkg.env("tier6"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        items = {f"ow/v0/w{i}": pkg.full(1.0) for i in range(N_KEYS)}
        await ts.put_batch(items, store_name=store)
        for v in range(1, 4):
            await ts.put_batch({f"ow/v{v}/w{i}": pkg.full(v + 1) for i in range(N_KEYS)},
                               store_name=store)
        out["sweep"] = sweep_view(await client.tier_sweep())
        out["catalog"] = catalog_view(await ts.version_catalog("ow", store_name=store), "ow")
        await ts.put_batch({k: pkg.full(9.0) for k in items}, store_name=store)
        out["fresh"] = float(np_of(await ts.get("ow/v0/w0", store_name=store))[0])
        out["sweep2"] = sweep_view(await client.tier_sweep())
        out["after_sweep"] = float(np_of(await ts.get("ow/v0/w1", store_name=store))[0])
    finally:
        await ts.shutdown(store)
    return out


async def case_shared_cohort(pkg: Pkg) -> dict:
    """test_shared_cohort_pinned_reads_hold_independent_leases"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier8")
    with pkg.env("tier8"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        pub = ts.WeightPublisher("fleet", store_name=store, keep=10)
        for v in range(2):
            await pub.publish(pkg.sd(v))
        a = ts.WeightSubscriber("fleet", store_name=store, cohort="eval-fleet-2")
        b = ts.WeightSubscriber("fleet", store_name=store, cohort="eval-fleet-2")
        lease_a = await a._pinned_lease(client, 1)
        lease_b = await b._pinned_lease(client, 1)
        out["distinct"] = lease_a["lease_id"] != lease_b["lease_id"]
        out["renewed"] = (lease_a["renewed"], lease_b["renewed"])
        await client.lease_release(lease_a["lease_id"])
        cat = await ts.version_catalog("fleet", store_name=store)
        out["owners"] = [le["cohort"] for le in cat["fleet"][1]["leases"]]
        await client.lease_release(lease_b["lease_id"])
        out["reads"] = [(version, values_of(sd)) for sd, version in await asyncio.gather(
            a.acquire(version=1), b.acquire(version=1))]
        cat = await ts.version_catalog("fleet", store_name=store)
        out["leases_after"] = cat["fleet"][1]["leases"]
    finally:
        await ts.shutdown(store)
    return out


async def case_resumed(pkg: Pkg) -> dict:
    """test_resumed_publisher_skips_leased_survivor"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier9")
    with pkg.env("tier9"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        pub = ts.WeightPublisher("res", store_name=store, keep=10)
        for v in range(3):
            await pub.publish(pkg.sd(v))
        await ts.put_batch({f"res/v5/w{i}": pkg.full(5.0) for i in range(N_KEYS)},
                           store_name=store)
        lease = await client.lease_acquire("canary", "res", 5, ttl_s=120)
        pub2 = ts.WeightPublisher("res", store_name=store, keep=10)
        out["published"] = await pub2.publish(pkg.sd(6))
        out["survivor_keys"] = len(await client.keys("res/v5"))
        out["survivor"] = float(np_of(await ts.get("res/v5/w0", store_name=store))[0])
        await client.lease_release(lease["lease_id"])
        for v in range(7, 17):
            await pub2.publish(pkg.sd(v))
        out["reaped"] = await client.keys("res/v5")
    finally:
        await ts.shutdown(store)
    return out


async def case_resume_jump(pkg: Pkg) -> dict:
    """test_resume_jump_keeps_gc_window"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier13")
    with pkg.env("tier13"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        pub = ts.WeightPublisher("gap", store_name=store, keep=2)
        for v in range(3):
            await pub.publish(pkg.sd(v))
        await ts.put_batch({f"gap/v6/w{i}": pkg.full(6.0) for i in range(N_KEYS)},
                           store_name=store)
        lease = await client.lease_acquire("canary", "gap", 6, ttl_s=120)
        pub2 = ts.WeightPublisher("gap", store_name=store, keep=2)
        out["published"] = await pub2.publish(pkg.sd(7))
        out["v2_keys"] = len(await client.keys("gap/v2"))
        out["v1_keys"] = await client.keys("gap/v1")
        out["v2"] = values_of(await ts.get_state_dict("gap/v2", store_name=store))
        out["next"] = await pub2.publish(pkg.sd(8))
        out["v2_after"] = await client.keys("gap/v2")
        await client.lease_release(lease["lease_id"])
    finally:
        await ts.shutdown(store)
    return out


async def case_guard_refused(pkg: Pkg) -> dict:
    """test_guard_refused_reclaim_still_advances_numbering"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier14")
    with pkg.env("tier14"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        pub = ts.WeightPublisher("hic", store_name=store, keep=10)
        for v in range(3):
            await pub.publish(pkg.sd(v))
        await ts.put_batch({f"hic/v5/w{i}": pkg.full(5.0) for i in range(N_KEYS)},
                           store_name=store)
        lease = await client.lease_acquire("canary", "hic", 5, ttl_s=120)

        async def broken_lease_list(channel=None):
            raise RuntimeError("lease plane unavailable")

        real_lease_list = client.lease_list
        client.lease_list = broken_lease_list
        try:
            pub2 = ts.WeightPublisher("hic", store_name=store, keep=10)
            out["published"] = await pub2.publish(pkg.sd(6))
        finally:
            client.lease_list = real_lease_list
        out["survivor_keys"] = len(await client.keys("hic/v5"))
        out["survivor"] = float(np_of(await ts.get("hic/v5/w0", store_name=store))[0])
        await client.lease_release(lease["lease_id"])
    finally:
        await ts.shutdown(store)
    return out


async def case_recreated(pkg: Pkg) -> dict:
    """test_recreated_channel_numbering_skips_leased_survivor"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier10")
    with pkg.env("tier10"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        pub = ts.WeightPublisher("re", store_name=store, keep=10)
        for v in range(3):
            await pub.publish(pkg.sd(v))
        lease = await client.lease_acquire("replay", "re", 1, ttl_s=120)
        await pub.close(delete=True)
        out["survived"] = len(await client.keys("re/v1"))
        pub2 = ts.WeightPublisher("re", store_name=store, keep=10)
        out["published"] = await pub2.publish(pkg.sd(9))
        sd, version = await ts.WeightSubscriber("re", store_name=store,
                                                cohort="replay").acquire(version=1)
        out["pinned"] = (version, values_of(sd))
        await client.lease_release(lease["lease_id"])
    finally:
        await ts.shutdown(store)
    return out


@contextlib.contextmanager
def slow_pulls(pkg: Pkg, seconds: float):
    """Every ``get_state_dict`` of ``pkg`` waits ``seconds`` first."""
    real = pkg.sdu.get_state_dict

    async def slow_get(*args, **kwargs):
        await asyncio.sleep(seconds)
        return await real(*args, **kwargs)

    pkg.sdu.get_state_dict = slow_get
    try:
        yield
    finally:
        pkg.sdu.get_state_dict = real


async def case_timeout(pkg: Pkg) -> dict:
    """test_pinned_acquire_timeout_enforced"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier11")
    with pkg.env("tier11"):
        await pkg.initialize(store)
    try:
        pub = ts.WeightPublisher("to", store_name=store, keep=10)
        await pub.publish(pkg.sd(0))
        sub = ts.WeightSubscriber("to", store_name=store)
        with slow_pulls(pkg, 5.0):
            try:
                await sub.acquire(version=0, timeout=0.2)
                out["timed_out"] = False
            except TimeoutError:
                out["timed_out"] = True
        cat = await ts.version_catalog("to", store_name=store)
        out["leases"] = cat["to"][0]["leases"]
    finally:
        await ts.shutdown(store)
    return out


async def case_outlives_ttl(pkg: Pkg) -> dict:
    """test_pinned_read_outlives_lease_ttl"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier12")
    with pkg.env("tier12", LEASE_TTL_S="0.3"):
        await pkg.initialize(store)
    try:
        pub = ts.WeightPublisher("slow", store_name=store, keep=1)
        await pub.publish(pkg.sd(0))
        sub = ts.WeightSubscriber("slow", store_name=store, cohort="reader")
        with slow_pulls(pkg, 0.9):
            read = asyncio.ensure_future(sub.acquire(version=0))
            for v in range(1, 4):
                await asyncio.sleep(0.2)
                await pub.publish(pkg.sd(v))
            sd, version = await read
        out["pinned"] = (version, values_of(sd))
    finally:
        await ts.shutdown(store)
    return out


async def case_disabled(pkg: Pkg) -> dict:
    """test_tier_disabled_is_inert"""
    ts, out = pkg.ts, {}
    store = pkg.store("tier7")
    with pkg.env("tier7", tier=False):
        await pkg.initialize(store)
    try:
        pub = ts.WeightPublisher("off", store_name=store, keep=10)
        for v in range(3):
            await pub.publish(pkg.sd(v))
        out["sweep"] = list((await ts.tier_sweep(store)).values())
        out["catalog"] = catalog_view(await ts.version_catalog("off", store_name=store), "off")
        sd, version = await ts.WeightSubscriber("off", store_name=store).acquire(version=1)
        out["pinned"] = (version, values_of(sd))
    finally:
        await ts.shutdown(store)
    return out


CASES = {
    "spill": case_spill, "gc": case_gc, "streamed": case_streamed, "expired": case_expired,
    "failed_spill": case_failed_spill, "overwrite": case_overwrite,
    "shared_cohort": case_shared_cohort, "resumed": case_resumed,
    "resume_jump": case_resume_jump, "guard_refused": case_guard_refused,
    "recreated": case_recreated, "timeout": case_timeout, "outlives_ttl": case_outlives_ttl,
    "disabled": case_disabled,
}


# ---------------------------------------------------------------------------
# port-only: a sweep racing a get, a plan-cached reget of a spilled key
# ---------------------------------------------------------------------------


async def case_sweep_races_get(pkg: Pkg) -> dict:
    """A get and a spill pass of the same key at once, many times: every
    get returns the key's bytes, and the served segment is retired under
    its read lease (it is never unlinked under the reader)."""
    ts, out = pkg.ts, {}
    store = pkg.store("race")
    # Budget below one version: every pass demotes what is resident.
    with pkg.env("race", TIER_BUDGET_BYTES=str(4 * 1024), TIER_HIGH_PCT="0.5",
                 TIER_LOW_PCT="0.5"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        big = {f"rc/v0/w{i}": torch.full((64, 1024), float(i)) for i in range(N_KEYS)}
        await ts.put_batch(big, store_name=store)
        ok, sweeps_spilled = [], 0
        for _ in range(12):
            got, rep = await asyncio.gather(ts.get("rc/v0/w1", store_name=store),
                                            ts.tier_sweep(store))
            ok.append(bool(torch.all(got == 1.0)))
            sweeps_spilled += next(iter(rep.values()))["spilled"]
            del got
        stats = await client.controller.stats.call_one(include_volumes=True)
        (vol,) = stats["volumes"].values()
        out.update(ok=ok, sweeps_spilled=sweeps_spilled, fault_ins=vol["tier"]["fault_ins"],
                   bytes=(vol["stored_bytes"], vol["resident_bytes"]))
    finally:
        await ts.shutdown(store)
    return out


async def case_served_segment_retires(pkg: Pkg) -> dict:
    """The order the race above may take, made certain: the volume serves
    a get (the reader's lease granted on the segment), then a spill pass
    demotes the key before the reader attaches. The segment must still be
    there, holding the bytes, for the reader that attaches after the
    serve; it is retired, not unlinked."""
    from torchstore_tpu_torch.transport.types import Request, TensorMeta

    ts, out = pkg.ts, {}
    store = pkg.store("served")
    with pkg.env("served", TIER_BUDGET_BYTES="1"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        await ts.put("sv/v0/w", torch.full((64, 1024), 5.0), store_name=store)
        (volume,) = client._volume_refs.values()
        meta = Request(key="sv/v0/w", tensor_meta=TensorMeta((64, 1024), "float32"))
        served = await volume.actor.get.call_one(
            port_shm.SharedMemoryTransportBuffer(client.config), [meta])
        desc = served.descriptors[0]
        out["sweep"] = sweep_view(await ts.tier_sweep(store))
        out["segment_kept"] = os.path.exists(port_shm.ShmSegment.path(desc.segment_name))
        if out["segment_kept"]:
            seg = port_shm.ShmSegment.attach(desc.segment_name, desc.segment_size)
            out["value"] = float(seg.view(desc.meta, desc.offset)[0, 0])
            del seg
        stats = await client.controller.stats.call_one(include_volumes=True)
        (vol,) = stats["volumes"].values()
        out["retired"] = vol["shm"]["retired_segments"]
        out["refetched"] = float((await ts.get("sv/v0/w", store_name=store))[0, 0])
    finally:
        await ts.shutdown(store)
    return out


async def case_plan_cached_reget(pkg: Pkg) -> dict:
    """A warm ``get_state_dict`` takes a plan hit with no locate; after a
    spill pass the same warm reget still returns the bytes, the volume
    faulting them in."""
    ts, out = pkg.ts, {}
    store = pkg.store("plan")
    with pkg.env("plan", TIER_BUDGET_BYTES=str(8 * 1024)):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        src = {f"w{i}": torch.full((N_ELEM,), float(i)) for i in range(N_KEYS)}
        await ts.put_state_dict("pc/v0", src, store_name=store)
        targets = {k: torch.zeros(N_ELEM) for k in src}
        await ts.get_state_dict("pc/v0", targets, store_name=store)  # builds the plan
        await ts.get_state_dict("pc/v0", targets, store_name=store)  # a plan hit
        locates = (await client.controller.stats.call_one())["locates"]
        out["sweep"] = sweep_view(await ts.tier_sweep(store))
        for t in targets.values():
            t.zero_()
        await ts.get_state_dict("pc/v0", targets, store_name=store)
        stats = await client.controller.stats.call_one(include_volumes=True)
        (vol,) = stats["volumes"].values()
        out["locates"] = stats["locates"] - locates
        out["fault_ins"] = vol["tier"]["fault_ins"]
        out["bytes"] = (vol["stored_bytes"], vol["resident_bytes"])
        out["equal"] = all(torch.equal(targets[k], src[k]) for k in src)
        out["plan_hits"] = sum(
            s["value"] for s in tst.metrics_snapshot()["ts_plan_cache_hits_total"]["series"]
            if s["labels"].get("op") == "get")
    finally:
        await ts.shutdown(store)
    return out


async def case_fault_in_fault(pkg: Pkg) -> dict:
    """``volume.fault_in`` raising once: the get's first attempt fails
    before the disk is read, the key stays spilled, and the client's retry
    faults it in."""
    ts, out = pkg.ts, {}
    store = pkg.store("finf")
    with pkg.env("finf", TIER_BUDGET_BYTES="1"):
        await pkg.initialize(store)
    try:
        client = ts.client(store)
        await ts.put("fi/v0/w", torch.full((N_ELEM,), 3.0), store_name=store)
        out["sweep"] = sweep_view(await ts.tier_sweep(store))
        await ts.inject_fault("volume.fault_in", "raise", count=1, scope="volumes",
                              store_name=store)
        retries = tst.metrics_snapshot()["ts_client_fetch_retries_total"]["series"]
        before = sum(x["value"] for x in retries)
        out["value"] = float((await ts.get("fi/v0/w", store_name=store))[0])
        retries = tst.metrics_snapshot()["ts_client_fetch_retries_total"]["series"]
        out["retries"] = sum(x["value"] for x in retries) - before
        stats = await client.controller.stats.call_one(include_volumes=True)
        (vol,) = stats["volumes"].values()
        out["fault_ins"] = vol["tier"]["fault_ins"]
        out["fired"] = sum(x["value"] for x in vol["metrics"]["ts_faults_fired_total"]["series"]
                           if x["labels"].get("point") == "volume.fault_in")
    finally:
        await ts.clear_faults(store_name=store)
        await ts.shutdown(store)
    return out


async def session(name: str, root: str) -> dict:
    pkg = Pkg(name, root)
    pids = {os.getpid()}
    out: dict = {}
    with contextlib.ExitStack() as stack:
        if name == "ref":
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(ref_config, "_default_config", None)
            mp.setattr(ref_shm, "is_available", lambda: False)
            mp.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
            mp.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
            pkg.config = RefStoreConfig(shm_enabled=False, bulk_tcp_enabled=False)
        for case, fn in CASES.items():
            out[case] = await fn(pkg)
            pids |= {p.pid for p in multiprocessing.active_children()}
        if name == "port":
            out["race"] = await case_sweep_races_get(pkg)
            out["served"] = await case_served_segment_retires(pkg)
            out["plan"] = await case_plan_cached_reget(pkg)
            out["fault_in_fault"] = await case_fault_in_fault(pkg)
            pids |= {p.pid for p in multiprocessing.active_children()}
    await asyncio.sleep(0.3)
    out["alive"] = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    if name == "port":
        out["segments"] = [n for n in os.listdir(port_shm.SHM_DIR)
                           if n.startswith(port_shm.PREFIX)
                           and int(n[len(port_shm.PREFIX):].split("_")[0]) in pids]
        out["tier_files"] = [os.path.join(d, f) for d, _, files in
                             os.walk(os.path.join(root, name)) for f in files]
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run(session, "port", str(tmp_path_factory.mktemp("tiers")))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run(session, "ref", str(tmp_path_factory.mktemp("tiers")))


def _assert_version(values: dict, version: int) -> None:
    assert len(values) == N_KEYS
    for key, vals in values.items():
        assert vals == [float(version)], (key, vals)


# ---------------------------------------------------------------------------
# the reference's fleet cases, each held on the port and against the oracle
# ---------------------------------------------------------------------------


def test_spill_faults_in_and_exempts_leased(port, reference):
    got = port["spill"]
    assert got["versions"] == [0, 1, 2, 3]
    assert got["lease"] == (N_KEYS + 1, False)  # tensors + MAPPING
    assert got["sweep"]["spilled"]
    cat = got["catalog"]
    assert cat[1]["spilled_keys"] == 0 and cat[1]["leases"] == ["hot-cohort"]
    assert got["spilled_versions"]
    v, values = got["fault_in"]
    _assert_version(values, v)
    assert got["catalog2"][v]["spilled_keys"] == 0
    assert got["disk"][0] > 0 and got["disk"][1] > 0
    assert got["counters"]["ts_spills_total"] > 0 and got["counters"]["ts_fault_ins_total"] > 0
    want = reference["spill"]
    for field in ("versions", "lease", "catalog", "spilled_versions", "fault_in", "catalog2"):
        assert got[field] == want[field], field
    assert got["sweep"] == want["sweep"] and got["sweep2"] == want["sweep2"]
    assert got["disk"] == want["disk"]


def test_delete_guard_and_lease_aware_gc(port, reference):
    got = port["gc"]
    assert got["pinned"][0] == 1
    _assert_version(got["pinned"][1], 1)
    assert got["reaped"] == ([], [])
    assert got["after_raw_delete"] == N_KEYS + 1
    assert got["blocked"] >= N_KEYS + 1
    assert got["after_release"] == [] and got["gone"] is True
    for field in ("pinned", "reaped", "catalog", "after_raw_delete", "after_release", "gone"):
        assert got[field] == reference["gc"][field], field


def test_pinned_streamed_acquire(port, reference):
    got = port["streamed"]
    assert got["sealed"] == [0, 1]
    version, values, served = got["pinned"]
    assert version == 0 and served == [f"w{i}" for i in range(N_KEYS)]
    _assert_version(values, 0)
    assert got["catalog"][0]["leases"] == ["replay"]
    for field in ("sealed", "sweep", "pinned", "catalog"):
        assert got[field] == reference["streamed"][field], field


def test_expired_lease_unpins(port, reference):
    got = port["expired"]
    assert got["keys_v1"] == [] and 1 not in got["catalog"]
    assert got == reference["expired"]


def test_failed_spill_leaves_entry_resident(port, reference):
    got = port["failed_spill"]
    assert got["faulted"]["spilled"] == 0 and got["faulted"]["spilled_keys"] == 0
    for v, values in enumerate(got["values"]):
        _assert_version(values, v)
    assert got["after"]["spilled"]
    assert got == reference["failed_spill"]


def test_overwrite_discards_stale_disk_copy(port, reference):
    got = port["overwrite"]
    assert got["catalog"][0]["spilled_keys"] == got["catalog"][0]["keys"] == N_KEYS
    assert got["fresh"] == 9.0 and got["after_sweep"] == 9.0
    assert got == reference["overwrite"]


def test_shared_cohort_pinned_reads_hold_independent_leases(port, reference):
    got = port["shared_cohort"]
    assert got["distinct"] and got["renewed"] == (False, False)
    assert len(got["owners"]) == 1 and got["owners"][0].startswith("eval-fleet-2:")
    for version, values in got["reads"]:
        assert version == 1
        _assert_version(values, 1)
    assert got["leases_after"] == []
    want = reference["shared_cohort"]
    assert (got["distinct"], got["renewed"], got["reads"], got["leases_after"]) == (
        want["distinct"], want["renewed"], want["reads"], want["leases_after"])


def test_resumed_publisher_skips_leased_survivor(port, reference):
    got = port["resumed"]
    assert got["published"] == 6
    assert got["survivor_keys"] == N_KEYS and got["survivor"] == 5.0
    assert got["reaped"] == []
    assert got == reference["resumed"]


def test_resume_jump_keeps_gc_window(port, reference):
    got = port["resume_jump"]
    assert got["published"] == 7
    assert got["v2_keys"] == N_KEYS + 1 and got["v1_keys"] == []
    _assert_version(got["v2"], 2)
    assert got["next"] == 8 and got["v2_after"] == []
    assert got == reference["resume_jump"]


def test_guard_refused_reclaim_still_advances_numbering(port, reference):
    got = port["guard_refused"]
    assert got["published"] == 6
    assert got["survivor_keys"] == N_KEYS and got["survivor"] == 5.0
    assert got == reference["guard_refused"]


def test_recreated_channel_numbering_skips_leased_survivor(port, reference):
    got = port["recreated"]
    assert got["survived"] == N_KEYS + 1
    assert got["published"] == 2
    assert got["pinned"][0] == 1
    _assert_version(got["pinned"][1], 1)
    assert got == reference["recreated"]


def test_pinned_acquire_timeout_enforced(port, reference):
    assert port["timeout"] == {"timed_out": True, "leases": []}
    assert port["timeout"] == reference["timeout"]


def test_pinned_read_outlives_lease_ttl(port, reference):
    version, values = port["outlives_ttl"]["pinned"]
    assert version == 0
    _assert_version(values, 0)
    assert port["outlives_ttl"] == reference["outlives_ttl"]


def test_tier_disabled_is_inert(port, reference):
    got = port["disabled"]
    assert all(rep.get("enabled") is False for rep in got["sweep"])
    assert all(rec["spilled_keys"] == 0 for rec in got["catalog"].values())
    assert got["pinned"][0] == 1
    _assert_version(got["pinned"][1], 1)
    assert got == reference["disabled"]


# ---------------------------------------------------------------------------
# port-only cases and the session's hygiene
# ---------------------------------------------------------------------------


def test_sweep_racing_a_get_serves_the_key(port):
    got = port["race"]
    assert all(got["ok"]) and len(got["ok"]) == 12
    # The race was real: passes demoted the key and gets faulted it back.
    assert got["sweeps_spilled"] > 0 and got["fault_ins"] > 0
    # The watermark's running count equals a walk of the entries.
    stored, resident = got["bytes"]
    assert stored == resident


def test_spill_retires_a_served_segment_under_its_read_lease(port):
    got = port["served"]
    assert got["sweep"]["spilled"] == 1
    assert got["segment_kept"] and got["value"] == 5.0 and got["retired"] >= 1
    assert got["refetched"] == 5.0  # and the next get faults the key in


def test_plan_cached_reget_of_a_spilled_key_faults_in(port):
    got = port["plan"]
    assert got["sweep"]["spilled"]  # the version left memory
    assert got["locates"] == 0  # the reget took its cached plan
    assert got["fault_ins"] >= N_KEYS and got["equal"]
    assert got["plan_hits"] >= 2
    assert got["bytes"][0] == got["bytes"][1] == N_KEYS * N_ELEM * 4


def test_fault_in_fault_point_leaves_the_key_spilled_for_the_retry(port):
    got = port["fault_in_fault"]
    assert got["sweep"]["spilled"] == 1
    assert got["value"] == 3.0 and got["retries"] == 1
    assert got["fired"] == 1 and got["fault_ins"] == 1


def test_session_leaves_no_process_segment_or_tier_file(port):
    assert port["alive"] == [] and port["segments"] == [] and port["tier_files"] == []


@pytest.mark.parametrize("leased", [True, False], ids=["leased", "unleased"])
def test_retire_key_never_unlinks_a_leased_segment(leased):
    """A demotion drops the entry as a same-layout re-put does: a segment a
    reader holds a lease on retires (its file stays until the release), an
    unleased one goes to the pool. ``delete_key`` would unlink both."""
    cache = port_shm.ShmServerCache()
    try:
        seg = port_shm.ShmSegment.create(4096)
        meta = port_shm.TensorMeta((1024,), "float32")
        cache.put("c/v0/w", None, seg, meta, 0, seg.view(meta))
        if leased:
            cache.grant(seg.name)
        cache.retire_key("c/v0/w")
        assert os.path.exists(port_shm.ShmSegment.path(seg.name))
        assert cache.lookup("c/v0/w", None) is None
        assert (seg.name in cache.retired) == leased
        assert (seg.name in cache.free) == (not leased)
        cache.release(seg.name)  # the reader's release pools a retired segment
        assert seg.name in cache.free and seg.name not in cache.retired
    finally:
        cache.clear()
