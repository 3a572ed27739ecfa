"""The port's config against the JAX package's: RetryPolicy schedules and
deadlines (exact: same delays from the same seed), and the env registry,
whose names map one to one onto the reference's under the prefix swap."""

import random
import re
import time
from pathlib import Path

import pytest

from torchstore_tpu import config as ref_config
from torchstore_tpu_torch import config as port_config

ROOT = Path(__file__).resolve().parent.parent
PORT, REF = "TORCHSTORE_TORCH_", "TORCHSTORE_TPU_"


def schedules(policy_cls, seed: int, **kwargs) -> list[float]:
    policy = policy_cls(**kwargs)
    random.seed(seed)
    return [policy.backoff(i) for i in range(12)]


@pytest.mark.parametrize("kwargs", [
    {"jitter": 0.0},
    {},
    {"base_s": 0.2, "max_s": 1.0, "multiplier": 3.0, "jitter": 0.0},
    {"base_s": 0.01, "max_s": 5.0, "multiplier": 1.5, "jitter": 0.4},
], ids=["no_jitter", "defaults", "steep_capped", "wide_jitter"])
@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_schedule_equals_reference(kwargs, seed):
    port = schedules(port_config.RetryPolicy, seed, **kwargs)
    ref = schedules(ref_config.RetryPolicy, seed, **kwargs)
    assert port == ref
    if kwargs.get("jitter") == 0.0:
        base = kwargs.get("base_s", 0.05)
        mult = kwargs.get("multiplier", 2.0)
        cap = kwargs.get("max_s", 2.0)
        assert port == [min(cap, base * mult**i) for i in range(12)]


def test_defaults_equal_reference():
    fields = ("base_s", "max_s", "multiplier", "jitter", "deadline_s", "delays")
    port, ref = port_config.RetryPolicy(), ref_config.RetryPolicy()
    assert [getattr(port, f) for f in fields] == [getattr(ref, f) for f in fields]
    assert (port.base_s, port.max_s, port.multiplier, port.jitter, port.deadline_s) == (
        0.05, 2.0, 2.0, 0.1, 30.0)


@pytest.mark.parametrize("delays,deadline", [((0.1, 0.2, 0.4), None), ((1.0,), 5.0),
                                             ((0.0, 0.5), None)])
def test_explicit_schedule_equals_reference(delays, deadline):
    port = port_config.RetryPolicy.from_delays(delays, deadline)
    ref = ref_config.RetryPolicy.from_delays(delays, deadline)
    assert port.deadline_s == ref.deadline_s
    assert port.max_attempts == ref.max_attempts == len(delays)
    random.seed(3)
    p = [port.backoff(i) for i in range(6)]
    random.seed(3)
    r = [ref.backoff(i) for i in range(6)]
    assert p == r
    far = time.monotonic() + 100
    assert [port.should_retry(i, far) for i in range(6)] == [
        ref.should_retry(i, far) for i in range(6)]
    with pytest.raises(ValueError):
        port_config.RetryPolicy.from_delays(())


def test_deadline_bounds_retries():
    for cls in (port_config.RetryPolicy, ref_config.RetryPolicy):
        policy = cls(deadline_s=0.05)
        t0 = time.monotonic()
        deadline = policy.start()
        assert abs(deadline - t0 - 0.05) < 0.01
        assert policy.should_retry(0, deadline)
        assert not policy.should_retry(0, time.monotonic() - 1.0)
        assert policy.max_attempts is None


def test_from_env_under_each_prefix(monkeypatch):
    values = {"RETRY_BASE_S": "0.3", "RETRY_MAX_S": "4", "RETRY_MULTIPLIER": "1.5",
              "RETRY_JITTER": "0", "RETRY_DEADLINE_S": "9"}
    for name, value in values.items():
        monkeypatch.setenv(PORT + name, value)
        monkeypatch.setenv(REF + name, value)
    port, ref = port_config.RetryPolicy.from_env(), ref_config.RetryPolicy.from_env()
    assert port == port_config.RetryPolicy(base_s=0.3, max_s=4.0, multiplier=1.5, jitter=0.0,
                                           deadline_s=9.0)
    assert (port.base_s, port.max_s, port.multiplier, port.jitter, port.deadline_s) == (
        ref.base_s, ref.max_s, ref.multiplier, ref.jitter, ref.deadline_s)


def test_store_config_fields(monkeypatch):
    monkeypatch.setenv(PORT + "AUTH_SECRET", "s3")
    monkeypatch.setenv(PORT + "HANDSHAKE_TIMEOUT", "7")
    monkeypatch.setenv(PORT + "RETRY_DEADLINE_S", "2")
    cfg = port_config.StoreConfig()
    assert cfg.auth_secret == "s3" and cfg.handshake_timeout == 7.0
    assert cfg.retry.deadline_s == 2.0
    monkeypatch.delenv(PORT + "AUTH_SECRET")
    monkeypatch.delenv(PORT + "HANDSHAKE_TIMEOUT")
    cfg = port_config.StoreConfig()
    assert cfg.auth_secret == "" and cfg.handshake_timeout == 60.0


def test_registry_maps_one_to_one_onto_reference():
    names = [e.name for e in port_config.ENV_REGISTRY]
    assert len(names) == len(set(names))
    assert all(n.startswith(PORT) for n in names)
    ref = {e.name: e for e in ref_config.ENV_REGISTRY}
    mapped = [REF + n[len(PORT):] for n in names]
    missing = [m for m in mapped if m not in ref]
    assert missing == []
    assert len(set(mapped)) == len(mapped)
    for entry, ref_name in zip(port_config.ENV_REGISTRY, mapped):
        assert entry.type == ref[ref_name].type, entry.name
        assert port_config.env_registry_entry(entry.name) is entry
    assert port_config.env_registry_entry(PORT + "NOPE") is None
    assert [REF + p[len(PORT):] for p in port_config.ENV_PREFIXES] == [
        p for p in ref_config.ENV_PREFIXES if p.endswith("STORE_")]


def test_every_env_read_of_the_port_is_registered():
    """Each TORCHSTORE_TORCH_* name the port's source spells out is in the
    registry (or a registered family)."""
    registered = {e.name for e in port_config.ENV_REGISTRY}
    names = set()
    for path in sorted((ROOT / "torchstore_tpu_torch").rglob("*.py")):
        text = path.read_text()
        names |= set(re.findall(r"TORCHSTORE_TORCH_[A-Z0-9_]*[A-Z0-9]", text))
        names |= {PORT + m for m in re.findall(r'ENV_PREFIX \+ "([A-Z0-9_]+)"', text)}
    unregistered = sorted(
        n for n in names
        if n not in registered and not any(n.startswith(p) for p in port_config.ENV_PREFIXES)
        and n + "_" not in port_config.ENV_PREFIXES
    )
    assert unregistered == []
