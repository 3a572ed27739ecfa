"""Deterministic fault injection: named fault points in the hot paths.

Port of ``torchstore_tpu/faults.py``. The retry, failover and detach paths
are only credible if their failures can be made on demand inside the real
process topology, a forked volume's put included. The fault points that
have a site in this package:

    controller.notify      Controller.notify_put_batch entry
    controller.locate      the index's locate (Controller.locate_volumes)
    channel.watermark      the controller's watermark step of a streamed put
    volume.handshake       StorageVolume.handshake entry (every transport)
    volume.put             StorageVolume.put entry
    volume.get             StorageVolume.get entry
    volume.spill           each key a spill pass demotes, before its disk
                           write (a raise leaves that key resident)
    volume.fault_in        each spilled key a get or put lands back in
                           memory, before its disk read
    shm.handshake          the volume's side of the shared-memory handshake
    channel.publish_layer  every layer batch a streamed publish puts
    channel.delta_baseline the delta tier's baseline reads (publisher and
                           reader)
    actor.ping             the actor server's ping control (per process)
    bulk.send_frame        every bulk TCP frame a client or volume sends
                           (``drop-frame`` loses it silently)
    bulk.recv_frame        every frame header the volume's bulk server
                           parses (``drop-frame`` drains and drops it)
    rendezvous.dispatch    every op the SPMD rendezvous server serves

A disarmed point costs one dict lookup. Sync sites call :func:`fire`,
async ones :func:`afire`.

Arming:

- env: ``TORCHSTORE_TORCH_FAULTPOINTS="volume.put=raise:count=2;actor.ping=wedge"``,
  parsed at import and again in every actor child, so faults ride into
  freshly spawned volumes and controllers;
- ``inject_fault(name, action, count=, prob=, delay_ms=, scope=)`` in the
  API arms running processes through the controller's and the volumes'
  ``inject_fault`` endpoints.

Actions: ``raise`` (``FaultInjectedError``), ``delay`` (``delay_ms``, 100 by
default), ``wedge`` (hang far past any deadline), ``die`` (``os._exit(17)``,
after a flight-recorder dump) and ``drop-frame`` (returned for the site to
interpret). ``count=N`` fires N times then disarms; ``prob=P`` fires with
probability P per pass; neither fires on every pass until disarmed.
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability import recorder as obs_recorder

logger = get_logger("torchstore_tpu_torch.faults")

ENV_FAULTPOINTS = "TORCHSTORE_TORCH_FAULTPOINTS"

# Every fault point a site fires; arming another name fails loudly, so a
# typo never makes a chaos test vacuous.
REGISTRY: frozenset[str] = frozenset(
    {
        "controller.notify",
        "controller.locate",
        "volume.put",
        "volume.get",
        "volume.handshake",
        "volume.spill",
        "volume.fault_in",
        "shm.handshake",
        "channel.publish_layer",
        "channel.watermark",
        "channel.delta_baseline",
        "actor.ping",
        "bulk.send_frame",
        "bulk.recv_frame",
        "rendezvous.dispatch",
    }
)

ACTIONS = ("raise", "delay", "wedge", "die", "drop-frame")

# How long a wedge hangs: past any deadline, short enough that an orphaned
# wedged task does not outlive a test session by much.
WEDGE_S = 600.0

_FIRED = obs_metrics.counter(
    "ts_faults_fired_total", "Fault injections triggered, by point and action"
)


class FaultInjectedError(RuntimeError):
    """Raised at a fault point armed with action='raise'."""


@dataclass
class FaultSpec:
    """One armed fault; ``count`` is the remaining budget (None: no limit)."""

    name: str
    action: str
    count: Optional[int] = None
    prob: Optional[float] = None
    delay_ms: float = 100.0
    fired: int = field(default=0)

    def describe(self) -> dict[str, Any]:
        return {"name": self.name, "action": self.action, "count": self.count,
                "prob": self.prob, "delay_ms": self.delay_ms, "fired": self.fired}


# This process's armed faults; actor children re-arm from their env.
_armed: dict[str, FaultSpec] = {}


def arm(
    name: str,
    action: str,
    count: Optional[int] = None,
    prob: Optional[float] = None,
    delay_ms: Optional[float] = None,
) -> dict[str, Any]:
    """Arm one fault point in this process; returns the armed spec."""
    if name not in REGISTRY:
        raise ValueError(f"unknown faultpoint {name!r}; registered: {sorted(REGISTRY)}")
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r}; have {ACTIONS}")
    if count is not None and count <= 0:
        raise ValueError("count must be positive (or None for unlimited)")
    if prob is not None and not (0.0 < prob <= 1.0):
        raise ValueError("prob must be in (0, 1]")
    spec = FaultSpec(name=name, action=action, count=count, prob=prob,
                     delay_ms=100.0 if delay_ms is None else float(delay_ms))
    _armed[name] = spec
    logger.warning("faultpoint armed: %s=%s count=%s prob=%s delay_ms=%s [pid %d]",
                   name, action, count, prob, spec.delay_ms, os.getpid())
    return spec.describe()


def disarm(name: Optional[str] = None) -> int:
    """Disarm one fault point (every one when ``name`` is None); returns how
    many were dropped."""
    if name is None:
        n = len(_armed)
        _armed.clear()
        return n
    return 1 if _armed.pop(name, None) is not None else 0


def armed() -> list[dict[str, Any]]:
    """Every fault armed in this process."""
    return [spec.describe() for spec in _armed.values()]


def _take(spec: FaultSpec) -> bool:
    """Whether this pass fires; a firing pass spends one of ``count``."""
    if spec.prob is not None and random.random() >= spec.prob:
        return False
    if spec.count is not None:
        if spec.count <= 0:
            _armed.pop(spec.name, None)
            return False
        spec.count -= 1
        if spec.count == 0:
            _armed.pop(spec.name, None)
    spec.fired += 1
    _FIRED.inc(point=spec.name, action=spec.action)
    obs_recorder.record("fault", spec.name, action=spec.action)
    logger.warning("faultpoint FIRING: %s action=%s (fire #%d) [pid %d]",
                   spec.name, spec.action, spec.fired, os.getpid())
    return True


def _die(spec: FaultSpec) -> None:
    # os._exit skips atexit: the ring's dump is the only post-mortem left.
    obs_recorder.dump_postmortem(f"fault_die:{spec.name}")
    os._exit(17)


def _execute_sync(spec: FaultSpec) -> Optional[str]:
    if spec.action == "die":
        _die(spec)
    if spec.action == "raise":
        raise FaultInjectedError(f"injected fault at {spec.name!r}")
    if spec.action == "delay":
        time.sleep(spec.delay_ms / 1000.0)
        return None
    if spec.action == "wedge":
        time.sleep(WEDGE_S)
        return None
    return spec.action  # drop-frame: the site interprets it


async def _execute_async(spec: FaultSpec) -> Optional[str]:
    if spec.action == "die":
        _die(spec)
    if spec.action == "raise":
        raise FaultInjectedError(f"injected fault at {spec.name!r}")
    if spec.action == "delay":
        await asyncio.sleep(spec.delay_ms / 1000.0)
        return None
    if spec.action == "wedge":
        await asyncio.sleep(WEDGE_S)
        return None
    return spec.action


def fire(name: str) -> Optional[str]:
    """A sync fault point (a delay or wedge here blocks the event loop)."""
    spec = _armed.get(name)
    if spec is None or not _take(spec):
        return None
    return _execute_sync(spec)


async def afire(name: str) -> Optional[str]:
    """An async fault point: a delay or wedge suspends only the firing task."""
    spec = _armed.get(name)
    if spec is None or not _take(spec):
        return None
    return await _execute_async(spec)


def parse_spec(text: str) -> list[dict[str, Any]]:
    """``name=action[:count=N][:prob=P][:delay_ms=D];...`` as ``arm`` keyword
    arguments; a malformed entry raises ``ValueError``."""
    out: list[dict[str, Any]] = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        head, _, opts = chunk.partition(":")
        name, sep, action = head.partition("=")
        if not sep:
            raise ValueError(f"malformed faultpoint entry {chunk!r}")
        kwargs: dict[str, Any] = {"name": name.strip(), "action": action.strip()}
        for opt in filter(None, (o.strip() for o in opts.split(":"))):
            k, sep, v = opt.partition("=")
            if not sep or k not in ("count", "prob", "delay_ms"):
                raise ValueError(f"malformed faultpoint option {opt!r}")
            kwargs[k] = int(v) if k == "count" else float(v)
        out.append(kwargs)
    return out


def _arm_from_env() -> None:
    text = os.environ.get(ENV_FAULTPOINTS)
    if not text:
        return
    try:
        for kwargs in parse_spec(text):
            arm(**kwargs)
    except ValueError:
        # A malformed schedule must not kill a booting volume: nothing armed.
        logger.exception("ignoring malformed %s=%r", ENV_FAULTPOINTS, text)


def reinit_after_fork() -> None:
    """Re-arm from the child's corrected env (a forked child inherits the
    forkserver's state, not its spawner's)."""
    _armed.clear()
    _arm_from_env()


_arm_from_env()
