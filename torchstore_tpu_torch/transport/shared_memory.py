"""Shared-memory transport: the same-host fast path.

Port of ``torchstore_tpu/transport/shared_memory.py`` without the one-sided
stamped reads. Segments are files in ``/dev/shm`` mapped with mmap; tensor
views over them are ``torch.frombuffer`` on the mapping. The volume's
stored tensor is a view of its segment, so a put is one copy on the client
and none on the volume.

PUT: a handshake RPC asks the volume for warm segments: spares it announced
     in an earlier put reply first, then its free pool. The client copies
     every payload into its offered segment (a CUDA payload device-to-host
     on the card's side stream) or, on a miss, into a segment it creates
     cold; the put RPC carries only descriptors. The volume adopts offered
     segments as they are, renames cold ones to its own pid (the name's pid
     is the owner's, for the orphan reaper) and starts warming same-sized
     spares for the next rotation. Tensors of a batch at or under
     ``arena_max_bytes`` share one arena segment; a batch of at most
     ``SMALL_INLINE_BYTES`` rides the put RPC and skips the handshake.
GET: the volume answers with the descriptor of the segment a key (or one
     shard) lives in and the index of the wanted box, and grants a read
     lease on the segment. A client with a destination copies the box out
     (host-to-device for a CUDA target) and releases the lease once the copy
     landed; a client without one keeps a copy-on-write view of its own
     mapping (zero copy) and releases when the last view of that mapping
     dies. Releases ride the client's next RPC to that volume, numbered, and
     are applied exactly once. Entries no segment backs are staged into a
     segment the client unlinks after its copy.

A put never writes into a live segment: the one it replaces is retired
while read leases are out and returns to the free pool when the last is
released, so a view a reader holds stays a stable snapshot and a working
set rotates between two warm sets. The client caches its attachments (they
follow the volume's renames) and page-locks one the second time a CUDA copy
goes through it, and a spare a put from a card announced, in the
background between its copies, so a warm rotation copies at pinned rates
and no put or get waits for a registration.

A prewarm pre-sizes the volume's free pool for a manifest
(``ShmServerCache.provision``: huge pages advised, pages prefaulted) and
the client attaches what it made (``pre_attach_segments``), so the first
put of that working set is offered every segment. Each provisioned segment
has a twin, populated in the background, that its first put announces as a
spare: the second put finds the rotation's other set warm too.

Segment names start with ``tst_shm_``, never ``ts_shm_``: the reference's
orphan reaper and leak checks match its own prefix only.
"""

from __future__ import annotations

import asyncio
import mmap
import os
import threading
import time
import uuid
import weakref
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Optional

import torch

from torchstore_tpu_torch import native
from torchstore_tpu_torch.config import StoreConfig, default_config
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.transport import landing
from torchstore_tpu_torch.transport.buffers import (
    Served,
    TransportBuffer,
    TransportCache,
    TransportContext,
    land,
)
from torchstore_tpu_torch.transport.pinning import host_register, host_unregister
from torchstore_tpu_torch.transport.types import Request, TensorMeta
from torchstore_tpu_torch.utils import spawn_logged

logger = get_logger("torchstore_tpu_torch.transport.shm")

SHM_DIR = "/dev/shm"
PREFIX = "tst_shm_"

# A put batch of at most this many bytes rides inline in the put RPC (one
# RPC, no handshake); the volume lands it into pooled segments.
SMALL_INLINE_BYTES = 64 * 1024

STAGED_TTL_S = 120.0  # staged-get segments a crashed client never unlinked
RETIRED_TTL_S = 600.0  # leased-then-replaced segments never released
RESERVED_TTL_S = 60.0  # handshake offers whose put never arrived
# /dev/shm left free by provisioning, for other tenants and the live set.
PROVISION_MARGIN_BYTES = 256 << 20

# Handshake-reply key of the batch's arena offer; request indices are >= 0.
ARENA_OFFER_KEY = -1

# Threads that prefault warm-up segments. Warm-ups run while the client
# copies its put into cold segments; more threads allocating tmpfs pages at
# once slow that copy more than they speed the warm-up.
WARM_THREADS = 1

# Seconds the client's page-locking thread pauses between registrations,
# so the process's other CUDA calls, which the driver serializes with
# them, are not starved.
PIN_YIELD_S = 0.005


def is_available() -> bool:
    return os.path.isdir(SHM_DIR) and os.access(SHM_DIR, os.W_OK)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def owner_pid(name: str) -> Optional[int]:
    """The pid a ``tst_shm_*`` segment name carries (its creator, or the
    volume that adopted it), or None for another name."""
    if not name.startswith(PREFIX):
        return None
    try:
        return int(name[len(PREFIX) :].split("_")[0])
    except ValueError:
        return None


def reap_orphaned_segments() -> int:
    """Unlink ``tst_shm_*`` segments whose creating process is gone."""
    reaped = 0
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return 0
    for name in names:
        pid = owner_pid(name)
        if pid is None:
            continue
        if not _pid_alive(pid):
            try:
                os.unlink(os.path.join(SHM_DIR, name))
                reaped += 1
            except OSError:
                pass
    return reaped


def shm_available_bytes() -> int:
    """Bytes /dev/shm can still take (0 when unreadable). Provisioning
    clamps to it: a write past a full tmpfs is a SIGBUS, not an
    exception."""
    try:
        stat = os.statvfs(SHM_DIR)
    except OSError:
        return 0
    return stat.f_frsize * stat.f_bavail


def _new_name() -> str:
    return f"{PREFIX}{os.getpid()}_{uuid.uuid4().hex[:12]}"


class ShmSegment:
    """A named shared-memory segment (a file in /dev/shm plus its mapping).
    On the client, an attachment also counts the CUDA copies made through
    it and holds the pointer ``cudaHostRegister`` locked."""

    _POPULATE = getattr(mmap, "MAP_POPULATE", 0)

    def __init__(self, name: str, size: int, mm: mmap.mmap) -> None:
        self.name = name
        self.size = size
        self.mmap = mm
        self.cuda_uses = 0
        self.pinned: Optional[int] = None
        self._pin_lock = threading.Lock()  # the pin thread locks, the loop unlocks
        self.busy = 0  # copies in flight through this attachment
        self.dropped = False  # left the client's cache: unpin once idle, never pin
        self.was_live = False  # on a volume: backed an entry before it was pooled
        self.provisioned = False  # on a volume: made by a prewarm, not taken yet

    @staticmethod
    def path(name: str) -> str:
        return os.path.join(SHM_DIR, name)

    @classmethod
    def create(cls, size: int, populate: bool = True) -> "ShmSegment":
        """A new segment of ``size`` bytes named after this process. With
        ``populate`` its pages are allocated and zeroed inside the mmap call
        (MAP_POPULATE), not one fault per page during the copy that
        follows."""
        name = _new_name()
        fd = os.open(cls.path(name), os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            flags = mmap.MAP_SHARED | (cls._POPULATE if populate else 0)
            mm = mmap.mmap(fd, size, flags=flags)
        finally:
            os.close(fd)
        return cls(name, size, mm)

    @classmethod
    def create_warm(cls, size: int) -> "ShmSegment":
        """``create`` with every page allocated before it returns."""
        seg = cls.create(size)
        if not cls._POPULATE and size:
            torch.frombuffer(seg.mmap, dtype=torch.uint8)[::4096].zero_()
        return seg

    @classmethod
    def create_provisioned(cls, size: int, nthreads: int = 0) -> "ShmSegment":
        """Cold-start provisioning variant of ``create_warm`` (the prewarm
        path, off the first sync's critical path): mapped without
        MAP_POPULATE, advised onto transparent huge pages while untouched
        (the advice must precede the faults), then every page prefaulted by
        the native library's threads (``nthreads`` 0: by size), or by one
        stride touch with the library off."""
        seg = cls.create(size, populate=False)
        if not size:
            return seg
        seg.madvise_hugepage()
        base = torch.frombuffer(seg.mmap, dtype=torch.uint8)
        if not native.prefault(base.data_ptr(), size, nthreads):
            base[::4096].zero_()
        return seg

    def populate(self) -> None:
        """Allocate every page of the segment without writing one: a second
        mapping with MAP_POPULATE, closed at once (the pages stay in the
        file). Safe while another process copies into the segment, which
        a prefault's writes are not."""
        if not self._POPULATE or not self.size:
            return
        try:
            ShmSegment.attach(self.name, self.size, populate=True).mmap.close()
        except OSError:
            pass  # unlinked meanwhile

    def madvise_hugepage(self) -> None:
        """Ask for transparent huge pages behind the mapping (fewer TLB
        misses on the copies). Fail-open: a kernel without huge pages on
        tmpfs leaves plain pages."""
        advice = getattr(mmap, "MADV_HUGEPAGE", None)
        if advice is None or self.size == 0:
            return
        try:
            self.mmap.madvise(advice)
        except (OSError, ValueError):
            pass

    @classmethod
    def attach(
        cls, name: str, size: int, private: bool = False, populate: bool = False
    ) -> "ShmSegment":
        """Map an existing segment. ``private`` maps it copy-on-write: the
        reader sees the segment's bytes, and its own writes stay its own.
        ``populate`` wires the page tables up front (MAP_POPULATE) for a
        reader about to copy every byte; a private mapping never populates,
        as that would copy every page."""
        fd = os.open(cls.path(name), os.O_RDWR)
        try:
            if private:
                flags = mmap.MAP_PRIVATE
            else:
                flags = mmap.MAP_SHARED | (cls._POPULATE if populate else 0)
            mm = mmap.mmap(fd, size, flags=flags)
        finally:
            os.close(fd)
        return cls(name, size, mm)

    def view(self, meta: TensorMeta, offset: int = 0) -> torch.Tensor:
        """A CPU tensor of ``meta`` over the mapping's bytes at ``offset``;
        it keeps the mapping alive for as long as it lives."""
        nbytes = meta.nbytes
        if nbytes == 0:
            return torch.empty(meta.shape, dtype=meta.torch_dtype)
        flat = torch.frombuffer(self.mmap, dtype=torch.uint8, count=nbytes, offset=offset)
        return flat.view(meta.torch_dtype).reshape(meta.shape)

    def pin(self) -> float:
        """Page-lock the whole mapping (client attachments only); returns the
        seconds it took (0 when it was locked already)."""
        with self._pin_lock:
            if self.pinned is not None or self.dropped:
                return 0.0
            t0 = time.perf_counter()
            self.pinned = host_register(torch.frombuffer(self.mmap, dtype=torch.uint8))
            return time.perf_counter() - t0

    def unpin(self) -> None:
        """Undo ``pin``; runs before the mapping can go."""
        with self._pin_lock:
            if self.pinned is not None:
                host_unregister([self.pinned])
                self.pinned = None

    def idle(self) -> None:
        """One use of the attachment ended: unpin it if the cache dropped it
        meanwhile."""
        self.busy -= 1
        if self.dropped and not self.busy:
            self.unpin()

    def rename_to_owner(self) -> None:
        """Rename so the name carries this process's pid: a volume adopting
        a client's segment becomes its owner for the orphan reaper."""
        new_name = _new_name()
        os.rename(self.path(self.name), self.path(new_name))
        self.name = new_name

    def unlink(self) -> None:
        """Remove the name. Mappings (and tensor views) stay valid until
        their last reference goes."""
        try:
            os.unlink(self.path(self.name))
        except FileNotFoundError:
            pass


@dataclass(frozen=True)
class ShmDescriptor:
    """A tensor in a segment: the stored tensor's meta at ``offset``, and
    the index of the wanted box in it (None: all of it). ``owner`` is
    'volume' for a leased serve or an offer, 'client' for a segment staged
    for one get that the client unlinks after its copy."""

    segment_name: str
    segment_size: int
    meta: TensorMeta
    offset: int = 0
    index: Optional[tuple] = None
    owner: str = "volume"


@dataclass
class _Entry:
    """One stored (key, coordinates) tensor in a volume-owned segment;
    ``ptr`` is the stored view's address (0 when empty)."""

    seg: ShmSegment
    meta: TensorMeta
    offset: int
    ptr: int


class ShmServerCache(TransportCache):
    """Volume side: live entries and their segments, read leases, retired
    (leased, then replaced) segments, the free pool of warm segments under
    ``pool_cap``, the twins of provisioned segments, handshake reservations
    and announced spares, staged-get segments, background warm-ups, and the
    pool's counters."""

    def __init__(self) -> None:
        self.by_key: dict[str, dict[Optional[tuple], _Entry]] = {}
        # name -> live entries in the segment (> 1 for an arena)
        self.seg_refs: dict[str, int] = {}
        self.staged: dict[str, tuple[ShmSegment, float]] = {}
        self.grants: dict[str, int] = {}  # name -> outstanding read leases
        self.last_applied: dict[str, int] = {}  # client -> last release batch
        self.retired: dict[str, tuple[ShmSegment, float]] = {}
        self.free: "OrderedDict[str, ShmSegment]" = OrderedDict()  # oldest first
        self.free_by_size: dict[int, list[str]] = {}
        self.free_bytes = 0
        self.pool_cap = default_config().shm_pool_max_bytes
        self.reserved: dict[str, tuple[ShmSegment, float]] = {}
        self.spare_by_size: dict[int, list[str]] = {}
        self._warming: dict[int, int] = {}  # size -> warm-ups in flight
        # size -> twins of provisioned segments: the rotation after the
        # first put of a prewarmed working set draws them (see provision).
        self.rotation: dict[int, list[ShmSegment]] = {}
        self._populating: dict[str, int] = {}  # twin -> size, pages not allocated yet
        self._warm_tasks: set = set()
        self._warm_executor: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self.counts = {
            "spare": 0, "pooled": 0, "miss": 0,  # handshake offers by outcome
            "created": 0, "recycled": 0, "reaped": 0,  # segments
            "spares_announced": 0,
        }

    def adopt_config(self, config: Optional[StoreConfig]) -> None:
        if config is not None:
            self.pool_cap = config.shm_pool_max_bytes

    def sweep(self) -> None:
        """Unlink staged, retired and reserved segments past their TTLs."""
        now = time.monotonic()
        for name, (seg, ts) in list(self.staged.items()):
            if now - ts > STAGED_TTL_S:
                seg.unlink()
                del self.staged[name]
                self.counts["reaped"] += 1
        for name, (seg, ts) in list(self.retired.items()):
            if now - ts > RETIRED_TTL_S:
                # The reader never released (it likely died); live mappings
                # keep their pages after the unlink.
                seg.unlink()
                del self.retired[name]
                self.grants.pop(name, None)
                self.counts["reaped"] += 1
        for name, (seg, ts) in list(self.reserved.items()):
            if now - ts > RESERVED_TTL_S:
                # Unlinked, not pooled: the late put may still be copying in.
                del self.reserved[name]
                seg.unlink()
                self.counts["reaped"] += 1
                if seg.provisioned:  # its put never came: nor will its twin's
                    twin = self.take_twin(seg.size)
                    if twin is not None:
                        twin.unlink()
                names = self.spare_by_size.get(seg.size)
                if names is not None and name in names:
                    names.remove(name)
                    if not names:
                        del self.spare_by_size[seg.size]

    # ---- leases ----------------------------------------------------------

    def grant(self, name: str) -> None:
        self.grants[name] = self.grants.get(name, 0) + 1

    def release(self, name: str) -> None:
        """End one lease this process granted itself (a bulk send of the
        segment finished); a retired segment pools once unleased."""
        have = self.grants.get(name)
        if have is None:
            return
        if have > 1:
            self.grants[name] = have - 1
            return
        del self.grants[name]
        entry = self.retired.pop(name, None)
        if entry is not None:
            self._add_free(entry[0])

    def apply_releases(self, payload: Optional[dict]) -> None:
        """Apply a client's numbered release batches exactly once: they are
        sent again until acknowledged, and an over-release would recycle a
        segment under a live reader."""
        if not payload:
            return
        client_id = payload["client"]
        last = self.last_applied.get(client_id, 0)
        for seq, counts in sorted(payload["batches"]):
            if seq <= last:
                continue
            last = seq
            for name, n in counts.items():
                have = self.grants.get(name)
                if have is None:
                    continue
                if have > n:
                    self.grants[name] = have - n
                    continue
                del self.grants[name]
                entry = self.retired.pop(name, None)
                if entry is not None:
                    self._add_free(entry[0])
        self.last_applied[client_id] = last

    # ---- free pool -------------------------------------------------------

    def _add_free(self, seg: ShmSegment) -> None:
        self.free[seg.name] = seg
        self.free_by_size.setdefault(seg.size, []).append(seg.name)
        self.free_bytes += seg.size
        while self.free_bytes > self.pool_cap and self.free:
            _, victim = self.free.popitem(last=False)
            self._unpool(victim)
            victim.unlink()

    def _unpool(self, seg: ShmSegment) -> None:
        names = self.free_by_size[seg.size]
        names.remove(seg.name)
        if not names:
            del self.free_by_size[seg.size]
        self.free_bytes -= seg.size

    def take_free(self, size: int) -> Optional[ShmSegment]:
        """The most recently pooled segment of exactly ``size`` bytes."""
        names = self.free_by_size.get(size)
        if not names:
            return None
        seg = self.free.pop(names[-1])
        self._unpool(seg)
        return seg

    def note_reuse(self, seg: ShmSegment) -> None:
        """``seg`` leaves the pool for a new put: recycled when it backed an
        entry before (not a segment fresh from a warm-up)."""
        if seg.was_live:
            self.counts["recycled"] += 1

    def schedule_warm(self, sizes: list[int]) -> None:
        """A put missed the pool: create and prefault same-sized segments in
        the background, so the next rotation of this working set draws warm
        ones. Segments pooled, warming or reserved count against the want,
        so a rotating set never warms a second spare set."""
        wanted: dict[int, int] = {}
        for size in sizes:
            wanted[size] = wanted.get(size, 0) + 1
        reserved_by_size: dict[int, int] = {}
        for seg, _ in self.reserved.values():
            reserved_by_size[seg.size] = reserved_by_size.get(seg.size, 0) + 1
        budget = self.pool_cap - self.spare_bytes()
        for size, count in wanted.items():
            have = (
                len(self.free_by_size.get(size, ()))
                + self._warming.get(size, 0)
                + reserved_by_size.get(size, 0)
            )
            for _ in range(max(0, count - have)):
                if budget < size:
                    break
                budget -= size
                self._warming[size] = self._warming.get(size, 0) + 1
                spawn_logged(
                    self._warm_one(size), name="shm.pool_warm", tasks=self._warm_tasks, log=logger
                )

    async def _warm_one(self, size: int) -> None:
        """MAP_POPULATE on an executor thread, so the page zeroing never
        stalls the volume's event loop."""
        try:
            loop = asyncio.get_running_loop()
            if self._warm_executor is None:
                self._warm_executor = ThreadPoolExecutor(WARM_THREADS, "tst-shm-warm")
            seg = await loop.run_in_executor(self._warm_executor, ShmSegment.create_warm, size)
            self.counts["created"] += 1
            if self._closed:
                seg.unlink()
            else:
                self._add_free(seg)
        except OSError as exc:
            logger.warning("shm pool warm-up of %d bytes failed: %r", size, exc)
        finally:
            left = self._warming.get(size, 1) - 1
            if left > 0:
                self._warming[size] = left
            else:
                self._warming.pop(size, None)

    def spare_bytes(self) -> int:
        """Bytes held for the rotations to come, under ``pool_cap``: the
        free pool, warm-ups in flight and twins."""
        return (self.free_bytes + sum(size * n for size, n in self._warming.items())
                + sum(size * len(twins) for size, twins in self.rotation.items()))

    def unpopulated_bytes(self) -> int:
        """Bytes of twins whose pages /dev/shm has not allocated yet."""
        return sum(self._populating.values())

    def take_twin(self, size: int) -> Optional[ShmSegment]:
        twins = self.rotation.get(size)
        if not twins:
            return None
        twin = twins.pop()
        if not twins:
            del self.rotation[size]
        return twin

    async def provision(self, sizes: dict[int, int]) -> dict:
        """Pre-size the free pool for a manifest (prewarm's shared-memory
        leg): for each ``{size: count}``, create and prefault enough
        segments that the pool can serve that many handshake offers,
        counting segments pooled, warming or reserved against the want.
        Largest sizes first, within what ``pool_cap`` leaves and what
        /dev/shm holds less a margin (a prefault past a full tmpfs is a
        SIGBUS). Creation and prefault run on executor threads, the pool's
        bookkeeping back on the loop; a ``clear`` meanwhile unlinks what
        was made.

        A put never writes into a live segment, so the put after the first
        needs a second set: each segment made gets a twin within what is
        left, named now and populated on the warm-up thread, which the
        first put that takes the segment announces as its spare. Returns
        the counts and the names of the first set, which the prewarming
        client attaches."""
        loop = asyncio.get_running_loop()
        reserved_by_size: dict[int, int] = {}
        for seg, _ in self.reserved.values():
            reserved_by_size[seg.size] = reserved_by_size.get(seg.size, 0) + 1
        budget = max(0, self.pool_cap - self.spare_bytes())
        budget = min(budget, max(0, shm_available_bytes() - self.unpopulated_bytes()
                                 - PROVISION_MARGIN_BYTES))
        already = clamped_bytes = 0
        plan: list[int] = []
        for size in sorted(sizes, reverse=True):
            count = int(sizes[size])
            if size <= 0 or count <= 0:
                continue
            have = (len(self.free_by_size.get(size, ())) + self._warming.get(size, 0)
                    + reserved_by_size.get(size, 0))
            want = max(0, count - have)
            already += count - want
            fits = min(want, budget // size)
            budget -= fits * size
            clamped_bytes += (want - fits) * size
            plan.extend([size] * fits)
        made = await asyncio.gather(
            *(loop.run_in_executor(None, ShmSegment.create_provisioned, size) for size in plan),
            return_exceptions=True,
        )
        created = created_bytes = errors = 0
        names: list[tuple[str, int]] = []
        for seg in made:
            if isinstance(seg, BaseException):
                errors += 1
                logger.warning("shm provisioning of a segment failed: %r", seg)
                continue
            if self._closed:
                seg.unlink()  # cleared meanwhile: leak nothing
                continue
            seg.provisioned = True
            self._add_free(seg)
            created += 1
            created_bytes += seg.size
            names.append((seg.name, seg.size))
        self.counts["created"] += created
        # Pool-cap evictions of _add_free may have unlinked some already.
        names = [(n, size) for n, size in names if n in self.free]
        twins = await self._make_twins(sorted((size for _, size in names), reverse=True),
                                       budget)
        return {"created": created, "bytes": created_bytes, "already_pooled": already,
                "clamped_bytes": clamped_bytes, "errors": errors, "names": names,
                "rotation": len(twins), "rotation_bytes": sum(t.size for t in twins)}

    async def _make_twins(self, sizes: list[int], budget: int) -> list[ShmSegment]:
        """One unpopulated twin per size, largest first within ``budget``,
        kept in ``rotation``; their pages are allocated in the background."""
        fits = []
        for size in sizes:
            if size <= budget:
                budget -= size
                fits.append(size)
        if not fits:
            return []
        try:
            twins = await asyncio.get_running_loop().run_in_executor(
                None, lambda: [ShmSegment.create(size, populate=False) for size in fits])
        except OSError as exc:
            logger.warning("shm provisioning of the rotation's twins failed: %r", exc)
            return []
        if self._closed:
            for twin in twins:
                twin.unlink()
            return []
        for twin in twins:
            self.rotation.setdefault(twin.size, []).append(twin)
            self._populating[twin.name] = twin.size
        self.counts["created"] += len(twins)
        spawn_logged(self._populate_twins(twins), name="shm.populate_twins",
                     tasks=self._warm_tasks, log=logger)
        return twins

    async def _populate_twins(self, twins: list[ShmSegment]) -> None:
        """Allocate the twins' pages one at a time on the warm-up thread,
        which leaves the cores to the puts meanwhile. A twin announced
        already may be copied into as this runs: the populate writes
        nothing."""
        loop = asyncio.get_running_loop()
        if self._warm_executor is None:
            self._warm_executor = ThreadPoolExecutor(WARM_THREADS, "tst-shm-warm")
        try:
            for twin in twins:
                if self._closed:
                    break
                await loop.run_in_executor(self._warm_executor, twin.populate)
                self._populating.pop(twin.name, None)
        finally:
            for twin in twins:
                self._populating.pop(twin.name, None)

    async def wait_warmups(self) -> None:
        """Wait for the warm-ups in flight (after ``clear`` they unlink
        what they made), then stop the warm-up thread."""
        while self._warm_tasks:
            await asyncio.gather(*list(self._warm_tasks), return_exceptions=True)
        if self._closed and self._warm_executor is not None:
            self._warm_executor.shutdown()
            self._warm_executor = None

    # ---- entries ---------------------------------------------------------

    def track_staged(self, seg: ShmSegment) -> None:
        self.staged[seg.name] = (seg, time.monotonic())

    def lookup(self, key: str, coords: Optional[tuple]) -> Optional[_Entry]:
        return self.by_key.get(key, {}).get(coords)

    def put(
        self, key: str, coords: Optional[tuple], seg: ShmSegment, meta: TensorMeta,
        offset: int, view: torch.Tensor,
    ) -> None:
        entries = self.by_key.setdefault(key, {})
        prev = entries.get(coords)
        entries[coords] = _Entry(seg, meta, offset, view.data_ptr() if view.numel() else 0)
        if prev is not None and prev.seg.name == seg.name:
            return
        self.seg_refs[seg.name] = self.seg_refs.get(seg.name, 0) + 1
        if prev is not None and self._release_entry_ref(prev.seg):
            self._retire_or_free(prev.seg)

    def _release_entry_ref(self, seg: ShmSegment) -> bool:
        """One entry stopped using ``seg``; True when it was the last."""
        left = self.seg_refs.get(seg.name, 1) - 1
        if left > 0:
            self.seg_refs[seg.name] = left
            return False
        self.seg_refs.pop(seg.name, None)
        return True

    def _retire_or_free(self, seg: ShmSegment) -> None:
        seg.was_live = True
        if self.grants.get(seg.name):
            self.retired[seg.name] = (seg, time.monotonic())
        else:
            self._add_free(seg)

    def delete_key(self, key: str) -> None:
        for entry in self.by_key.pop(key, {}).values():
            if self._release_entry_ref(entry.seg):
                entry.seg.unlink()
                self.grants.pop(entry.seg.name, None)

    def retire_key(self, key: str) -> None:
        """Drop ``key``'s entries as a same-layout re-put does: a segment
        still leased to a reader retires (the reader attaches after the
        serve), an unleased one goes to the pool. The spill tier demotes
        through this, never unlinking a segment under a reader."""
        for entry in self.by_key.pop(key, {}).values():
            if self._release_entry_ref(entry.seg):
                self._retire_or_free(entry.seg)

    def stats(self) -> dict:
        live = {e.seg.name: e.seg.size for es in self.by_key.values() for e in es.values()}
        return {
            "live_segments": len(live),
            "live_bytes": sum(live.values()),
            "arena_segments": sum(1 for refs in self.seg_refs.values() if refs > 1),
            "retired_segments": len(self.retired),
            "retired_bytes": sum(seg.size for seg, _ in self.retired.values()),
            "pool_segments": len(self.free),
            "pool_bytes": self.free_bytes,
            "pool_cap": self.pool_cap,
            "reserved_segments": len(self.reserved),
            "read_leases": sum(self.grants.values()),
            "staged": len(self.staged),
            "warming": sum(self._warming.values()) + len(self._populating),
            "rotation_segments": sum(len(twins) for twins in self.rotation.values()),
            "offers": {k: self.counts[k] for k in ("spare", "pooled", "miss")},
            "segments_created": self.counts["created"],
            "segments_recycled": self.counts["recycled"],
            "spares_announced": self.counts["spares_announced"],
            "segments_reaped": self.counts["reaped"],
        }

    def clear(self) -> None:
        """Unlink every segment this cache holds: live, staged, retired,
        pooled, reserved, and those warm-ups still make (they see
        ``_closed``)."""
        for entries in self.by_key.values():
            for entry in entries.values():
                entry.seg.unlink()
        self.by_key.clear()
        self.seg_refs.clear()
        segs = [seg for seg, _ in self.staged.values()]
        segs += [seg for seg, _ in self.retired.values()]
        segs += [seg for seg, _ in self.reserved.values()]
        segs += list(self.free.values())
        segs += [twin for twins in self.rotation.values() for twin in twins]
        for seg in segs:
            seg.unlink()
        self.rotation.clear()
        self.staged.clear()
        self.retired.clear()
        self.reserved.clear()
        self.spare_by_size.clear()
        self.free.clear()
        self.free_by_size.clear()
        self.free_bytes = 0
        self.grants.clear()
        self._closed = True


class ShmClientCache(TransportCache):
    """Client side: attachments by segment name (they follow the volume's
    renames), the keys each serves, announced spares attached in the
    background, and read-lease releases per volume, numbered and sent
    again until acknowledged so that a failed RPC neither loses one nor
    applies one twice."""

    def __init__(self) -> None:
        self.client_id = uuid.uuid4().hex
        self.segments: dict[str, ShmSegment] = {}
        self.key_to_segments: dict[str, set[str]] = {}
        self.pending: dict[str, dict[str, int]] = {}  # volume -> {name: n}
        self.unacked: dict[str, dict[int, dict[str, int]]] = {}
        self.seq: dict[str, int] = {}
        # (volume, name) of zero-copy mappings whose last view died; a
        # finalizer may append from any thread, so it only appends here.
        self._dead_views: deque = deque()
        self._pre_attach_tasks: set = set()
        self._pre_attached: dict[str, float] = {}  # spare name -> attach time
        self.counts = {"offer_hit": 0, "cold_create": 0, "pinned": 0}
        self.pin_seconds = 0.0
        self.pin_wait_seconds = 0.0  # landings held behind a registration
        # Attachments to page-lock, one at a time on a thread of their own
        # (it runs while the caller's thread trains, outside the event
        # loop). cudaHostRegister serializes with the copies in the driver,
        # so a registration and a landing of this client exclude each
        # other under ``_pin_cond``: no registration starts while a landing
        # is in flight, and a landing that finds one in progress waits for
        # that one only.
        self._pin_queue: deque = deque()
        self._pin_cond = threading.Condition()
        self._pin_thread: Optional[threading.Thread] = None
        self._pinning = False
        self._pin_error: Optional[Exception] = None
        self._landings = 0

    # ---- attachments -----------------------------------------------------

    def attach(self, desc: ShmDescriptor, key: str) -> ShmSegment:
        seg = self.segments.get(desc.segment_name)
        if seg is None:
            seg = ShmSegment.attach(desc.segment_name, desc.segment_size, populate=True)
            self.segments[desc.segment_name] = seg
        self._pre_attached.pop(desc.segment_name, None)
        self.key_to_segments.setdefault(key, set()).add(desc.segment_name)
        return seg

    def add_cold(self, seg: ShmSegment, key: str) -> None:
        """Keep a segment this client created for a put the pool could not
        serve."""
        self.segments[seg.name] = seg
        self.key_to_segments.setdefault(key, set()).add(seg.name)
        self.counts["cold_create"] += 1

    def rekey(self, old_name: str, new_name: str) -> None:
        """The volume adopted and renamed a segment this client created:
        the mapping stays valid and is kept under the new name."""
        seg = self.segments.pop(old_name, None)
        if seg is not None:
            seg.name = new_name
            self.segments[new_name] = seg
        for names in self.key_to_segments.values():
            if old_name in names:
                names.discard(old_name)
                names.add(new_name)

    def pre_attach(self, spares: list[tuple[str, int]], pin: bool) -> None:
        """Attach the spares a put reply announced, off the event loop, so
        the next handshake's offers of them find their attachments; with
        ``pin`` (the put copied from a card) page-lock them too, so the
        next rotation copies at the DMA rate."""
        self.evict_stale_pre_attached()
        for name, size in spares:
            spawn_logged(self._attach_spare(name, size, pin), name="shm.pre_attach",
                         tasks=self._pre_attach_tasks, log=logger)

    async def _attach_spare(self, name: str, size: int, pin: bool) -> int:
        """Attach one offered-to-be segment (populated) on an executor
        thread, and queue it for page-locking with ``pin``; 1 when it made
        a fresh attachment."""
        fresh = 0
        seg = self.segments.get(name)
        if seg is None:
            try:
                seg = await asyncio.get_running_loop().run_in_executor(
                    None, ShmSegment.attach, name, size, False, True
                )
            except OSError:
                return 0  # reaped or reset meanwhile
            if name in self.segments:  # an attach on the loop won
                seg.mmap.close()
                seg = self.segments[name]
            else:
                self.segments[name] = seg
                self._pre_attached[name] = time.monotonic()
                fresh = 1
        if pin:
            self.schedule_pin([seg])
        return fresh

    def evict_stale_pre_attached(self) -> None:
        """Drop spares never offered within the volume's reservation TTL: it
        has unlinked them, and only this mapping keeps their pages."""
        cutoff = time.monotonic() - RESERVED_TTL_S
        for name, ts in list(self._pre_attached.items()):
            if ts < cutoff:
                self._drop(name)

    def evict_unlinked(self) -> None:
        """Drop attachments of segments the volume unlinked (deleted, evicted
        from its pool, reaped): their mappings would keep the pages."""
        for name, seg in list(self.segments.items()):
            if not seg.busy and not os.path.exists(ShmSegment.path(name)):
                self._drop(name)

    def forget_dead(self) -> int:
        """Drop the attachments of segments whose owning process is gone (a
        killed volume's): no read may go through them again, and their
        mappings would keep the pages after the reaper unlinks them.
        Returns how many went."""
        gone = [name for name in self.segments
                if (pid := owner_pid(name)) is not None and not _pid_alive(pid)]
        for name in gone:
            self._drop(name)
        return len(gone)

    def _drop(self, name: str) -> None:
        self._pre_attached.pop(name, None)
        seg = self.segments.pop(name, None)
        if seg is not None:
            seg.dropped = True
            if not seg.busy:  # else its last use unpins it
                seg.unpin()

    def note_card_use(self, segs: list[ShmSegment]) -> None:
        """Count one CUDA copy batch through each of ``segs``; one reused
        (its second batch) is queued to be page-locked."""
        for seg in segs:
            seg.cuda_uses += 1
        self.schedule_pin([s for s in segs if s.cuda_uses == 2])

    def schedule_pin(self, segs: list[ShmSegment]) -> None:
        with self._pin_cond:
            queued = {id(s) for s in self._pin_queue}
            self._pin_queue.extend(
                s for s in segs if s.pinned is None and not s.dropped and id(s) not in queued
            )
            if self._pin_queue and self._pin_thread is None:
                self._pin_thread = threading.Thread(
                    target=self._pin_worker, name="tst-shm-pin", daemon=True
                )
                self._pin_thread.start()
            self._pin_cond.notify()

    def _pin_worker(self) -> None:
        while True:
            with self._pin_cond:
                while (
                    not self._pin_queue or self._landings
                ) and self._pin_thread is not None:
                    self._pin_cond.wait()
                if self._pin_thread is None:  # clear() stopped it
                    return
                seg = self._pin_queue.popleft()
                self._pinning = True
            try:
                took = seg.pin()
                if took:
                    self.counts["pinned"] += 1
                    self.pin_seconds += took
            except Exception as exc:  # noqa: BLE001 - raised by the next landing
                self._pin_error = self._pin_error or exc
            finally:
                with self._pin_cond:
                    self._pinning = False
                    self._pin_cond.notify_all()
            # The driver serializes a registration with the process's other
            # CUDA calls: leave them a gap before the next one.
            time.sleep(PIN_YIELD_S)

    def pin_pending(self) -> int:
        """Attachments queued or being page-locked."""
        with self._pin_cond:
            return len(self._pin_queue) + self._pinning

    async def wait_pinned(self) -> float:
        """Wait until the announced spares are attached and every queued
        page-lock ran; returns the seconds."""
        t0 = time.perf_counter()
        while self._pre_attach_tasks:
            await asyncio.gather(*list(self._pre_attach_tasks), return_exceptions=True)
        while self._pin_queue or self._pinning:
            await asyncio.sleep(0.01)
        self.raise_pin_error()
        return time.perf_counter() - t0

    async def begin_landing(self) -> None:
        """Hold off page-locking for one landing: keep new registrations
        from starting until ``end_landing``, then wait out the one in
        progress (counted in ``pin_wait_seconds``)."""
        with self._pin_cond:
            self._landings += 1
            if not self._pinning:
                return
        t0 = time.perf_counter()
        try:
            while self._pinning:
                await asyncio.sleep(0.002)
        except BaseException:
            self.end_landing()
            raise
        self.pin_wait_seconds += time.perf_counter() - t0

    def end_landing(self) -> None:
        with self._pin_cond:
            self._landings -= 1
            self._pin_cond.notify_all()

    def raise_pin_error(self) -> None:
        """A failed page-lock surfaces in the caller, not in the log."""
        if self._pin_error is not None:
            exc, self._pin_error = self._pin_error, None
            raise exc

    # ---- read leases -----------------------------------------------------

    def track_view(self, volume_id: str, seg: ShmSegment) -> None:
        """Release the lease of ``seg`` (a private mapping of one zero-copy
        get) when its last view dies."""
        weakref.finalize(seg.mmap, self._dead_views.append, (volume_id, seg.name))

    def count_release(self, volume_id: str, name: str, n: int = 1) -> None:
        counts = self.pending.setdefault(volume_id, {})
        counts[name] = counts.get(name, 0) + n

    def collect_released(self, volume_id: str) -> Optional[dict]:
        """The release payload for ``volume_id``'s next RPC: every batch not
        acknowledged yet, with a new one for what was released since."""
        self.evict_stale_pre_attached()
        self.evict_unlinked()
        while self._dead_views:
            vid, name = self._dead_views.popleft()
            self.count_release(vid, name)
        fresh = self.pending.pop(volume_id, None)
        if fresh:
            seq = self.seq[volume_id] = self.seq.get(volume_id, 0) + 1
            self.unacked.setdefault(volume_id, {})[seq] = fresh
        batches = self.unacked.get(volume_id)
        if not batches:
            return None
        return {"client": self.client_id, "batches": sorted(batches.items())}

    def ack_released(self, volume_id: str, payload: Optional[dict]) -> None:
        if not payload:
            return
        batches = self.unacked.get(volume_id)
        if batches:
            for seq, _ in payload["batches"]:
                batches.pop(seq, None)

    def delete_key(self, key: str) -> None:
        for name in self.key_to_segments.pop(key, ()):
            self._drop(name)

    def clear(self) -> None:
        """Unpin and drop every attachment (``LocalClient.close``)."""
        with self._pin_cond:
            self._pin_queue.clear()
            thread, self._pin_thread = self._pin_thread, None
            self._pin_cond.notify_all()
        if thread is not None:
            thread.join()
        for name in list(self.segments):
            self._drop(name)
        self.key_to_segments.clear()
        self.pending.clear()
        self.unacked.clear()
        self.seq.clear()


async def pre_attach_segments(volume, names: list[tuple[str, int]], pin: bool = False) -> int:
    """Prewarm's client half of the shared-memory leg: attach the segments
    the volume provisioned (populated, so the first put's copies take no
    page-table faults) into this client's cache and wait for it, so the
    first put's offers find their attachments; with ``pin`` (a working set
    on a card) queue them for page-locking too (``ShmClientCache.
    wait_pinned`` waits for it). Tracked as pre-attached spares: one not
    offered within the reservation TTL is dropped and attached again
    lazily. Returns the fresh attachments."""
    cache: ShmClientCache = volume.transport_context.get_cache(ShmClientCache)
    cache.evict_stale_pre_attached()
    fresh = await asyncio.gather(*(cache._attach_spare(n, size, pin) for n, size in names))
    return sum(fresh)


class SharedMemoryTransportBuffer(TransportBuffer):
    transport_name = "shm"
    requires_handshake = True

    def __init__(self, config: Optional[StoreConfig] = None, inproc_copy: bool = False) -> None:
        # Travels with the buffer: the volume reads its pool cap from it.
        self.config = config
        # A colocated volume's endpoints are called without serialization:
        # objects would be stored and served by reference (tensors are safe,
        # they live in segments), so they are copied.
        self.inproc_copy = inproc_copy
        self.descriptors: dict[int, ShmDescriptor] = {}
        self.inline: dict[int, torch.Tensor] = {}
        self.objects: dict[int, Any] = {}
        # {"offsets": {request index: byte offset}, "sizes", "total"}, and
        # once resolved "segment" / "segment_size".
        self.arena_plan: Optional[dict] = None
        self.released: Optional[dict] = None  # client -> volume
        self.renames: dict[str, str] = {}  # volume -> client (put reply)
        self.spares: list[tuple[str, int]] = []  # volume -> client (put reply)
        self._cold: list[ShmSegment] = []  # client-only: created, not adopted yet

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_cold"] = []
        return state

    def _config(self) -> StoreConfig:
        return self.config or default_config()

    # ---- client: put -----------------------------------------------------

    async def put_to_storage_volume(self, volume, requests: list[Request]) -> None:
        if sum(r.nbytes for r in requests) <= SMALL_INLINE_BYTES:
            self.handshake_ops = ()  # one RPC: the payloads ride it
        else:
            self.arena_plan = self._compute_arena_plan(requests)
        await super().put_to_storage_volume(volume, requests)

    def _compute_arena_plan(self, requests: list[Request]) -> Optional[dict]:
        """Every tensor at or under ``arena_max_bytes`` packed into one
        segment: one offer, one rotation and one index pass for the batch's
        small tail instead of a segment per key."""
        limit = self._config().arena_max_bytes
        if limit <= 0:
            return None
        members = [
            idx for idx, req in enumerate(requests)
            if not req.is_object and req.nbytes <= limit
        ]
        if len(members) < 2:
            return None
        sizes = [requests[idx].nbytes for idx in members]
        offsets, total = landing.compute_arena_layout(sizes)
        return {"offsets": dict(zip(members, offsets)), "sizes": sizes, "total": total}

    async def _pre_put_hook(self, volume, requests: list[Request]) -> None:
        if self.handshake_ops:
            return  # the handshake already staged the payloads
        cache: ShmClientCache = volume.transport_context.get_cache(ShmClientCache)
        self.released = cache.collect_released(volume.volume_id)
        for idx, req in enumerate(requests):
            if req.is_object:
                self.objects[idx] = req.objects
            else:
                self.inline[idx] = req.tensor_val.detach().to("cpu").contiguous()

    def _pre_handshake(self, volume, requests, op) -> None:
        cache: ShmClientCache = volume.transport_context.get_cache(ShmClientCache)
        self.released = cache.collect_released(volume.volume_id)

    async def _post_handshake(self, volume, requests: list[Request], reply, op) -> None:
        cache: ShmClientCache = volume.transport_context.get_cache(ShmClientCache)
        cache.ack_released(volume.volume_id, self.released)  # the handshake took them
        self.released = None
        offered: dict[int, ShmDescriptor] = reply or {}
        arena = self.arena_plan
        arena_seg = self._attach_arena(cache, offered, requests) if arena else None
        copies: list[tuple[torch.Tensor, torch.Tensor, ShmSegment]] = []
        misses: list[tuple[int, Request, TensorMeta]] = []
        for idx, req in enumerate(requests):
            if req.is_object:
                self.objects[idx] = req.objects
                continue
            meta = req.meta_only().tensor_meta
            if arena_seg is not None and idx in arena["offsets"]:
                cache.key_to_segments.setdefault(req.key, set()).add(arena_seg.name)
                copies.append((arena_seg.view(meta, arena["offsets"][idx]), req.tensor_val,
                               arena_seg))
                continue
            desc = offered.get(idx)
            if desc is None or desc.meta != meta:
                misses.append((idx, req, meta))
                continue
            seg = cache.attach(desc, req.key)
            cache.counts["offer_hit"] += 1
            # THE hot copy: client tensor (host or device) -> shared segment.
            copies.append((seg.view(meta, desc.offset), req.tensor_val, seg))
            self.descriptors[idx] = desc
        for (idx, req, meta), seg in zip(misses, await self._create_cold(misses)):
            cache.add_cold(seg, req.key)
            copies.append((seg.view(meta), req.tensor_val, seg))
            self.descriptors[idx] = ShmDescriptor(seg.name, seg.size, meta)
        await _land(cache, copies, self._config())

    async def _create_cold(self, misses: list) -> list[ShmSegment]:
        """Segments for the requests the pool missed, made on the landing
        pool's threads at once: allocating their pages is most of a cold
        put."""
        loop = asyncio.get_running_loop()
        pool = landing.get_executor(self._config())
        made = await asyncio.gather(
            *(loop.run_in_executor(pool, ShmSegment.create, max(meta.nbytes, 1))
              for _, _, meta in misses),
            return_exceptions=True,
        )
        self._cold.extend(seg for seg in made if isinstance(seg, ShmSegment))
        for seg in made:
            if isinstance(seg, BaseException):
                raise seg
        return made

    def _attach_arena(self, cache: ShmClientCache, offered: dict, requests) -> ShmSegment:
        """The batch's arena segment: the handshake's offer, else a cold one."""
        arena = self.arena_plan
        desc = offered.get(ARENA_OFFER_KEY)
        first_key = requests[next(iter(arena["offsets"]))].key
        if desc is not None and desc.segment_size >= arena["total"]:
            seg = cache.attach(desc, first_key)
            cache.counts["offer_hit"] += 1
        else:
            seg = ShmSegment.create(arena["total"])
            cache.add_cold(seg, first_key)
            self._cold.append(seg)
        arena["segment"] = seg.name
        arena["segment_size"] = seg.size
        return seg

    def _handle_put_reply(self, volume, reply, requests) -> None:
        cache: ShmClientCache = volume.transport_context.get_cache(ShmClientCache)
        if self.released:  # an inline put carried them
            cache.ack_released(volume.volume_id, self.released)
            self.released = None
        self._cold = []  # the volume adopted them
        if not reply:
            return
        for old_name, new_name in reply.get("renames", {}).items():
            cache.rekey(old_name, new_name)
        if reply.get("spares"):
            on_card = any(not r.is_object and r.tensor_val.is_cuda for r in requests)
            cache.pre_attach(reply["spares"], pin=on_card)

    def drop(self) -> None:
        # A failed put's cold segments never reached the volume.
        for seg in self._cold:
            seg.unlink()
        self._cold = []
        self.descriptors = {}
        self.inline = {}
        self.objects = {}
        self.arena_plan = None
        self.released = None
        self.renames = {}
        self.spares = []

    # ---- server: put -----------------------------------------------------

    def recv_handshake(
        self, ctx: TransportContext, metas: list[Request], existing: dict[int, Any], op: str
    ) -> Any:
        # A sync fault point: a wedge here blocks the volume's event loop, so
        # the whole process (pings included) looks stuck.
        from torchstore_tpu_torch import faults

        faults.fire("shm.handshake")
        if op != "put":
            return None
        cache: ShmServerCache = ctx.get_cache(ShmServerCache)
        cache.adopt_config(self.config)
        cache.apply_releases(self.released)
        cache.sweep()
        offered: dict[int, ShmDescriptor] = {}
        misses: list[int] = []
        arena = self.arena_plan
        if arena:
            # One offer serves the batch's whole small tail.
            seg = self._offer_from_pool(cache, arena["total"])
            if seg is None:
                misses.append(arena["total"])
            else:
                offered[ARENA_OFFER_KEY] = ShmDescriptor(
                    seg.name, seg.size, TensorMeta((arena["total"],), "uint8")
                )
        members = arena["offsets"] if arena else {}
        for idx, meta in enumerate(metas):
            if meta.tensor_meta is None or idx in members:
                continue
            # Never the live segment: a reader may be copying out of it.
            size = max(meta.tensor_meta.nbytes, 1)
            seg = self._offer_from_pool(cache, size)
            if seg is None:
                misses.append(size)
            else:
                offered[idx] = ShmDescriptor(seg.name, seg.size, meta.tensor_meta)
        if misses:
            # Warm spares while the client copies into its cold segments.
            cache.schedule_warm(misses)
        return offered

    @staticmethod
    def _offer_from_pool(cache: ShmServerCache, size: int) -> Optional[ShmSegment]:
        """One offer, reserved for the put in flight: an announced spare of
        ``size`` first (the client may have attached it already), then a
        pooled segment."""
        names = cache.spare_by_size.get(size)
        while names:
            name = names.pop()
            entry = cache.reserved.get(name)
            if entry is not None:  # reserved means linked: only sweep unlinks
                cache.reserved[name] = (entry[0], time.monotonic())
                cache.counts["spare"] += 1
                cache.note_reuse(entry[0])
                return entry[0]
        pooled = cache.take_free(size)
        if pooled is not None:
            cache.counts["pooled"] += 1
            cache.note_reuse(pooled)
            cache.reserved[pooled.name] = (pooled, time.monotonic())
            return pooled
        cache.counts["miss"] += 1
        return None

    def handle_put_request(
        self, ctx: TransportContext, metas: list[Request], existing: dict[int, Any]
    ) -> dict[int, Any]:
        cache: ShmServerCache = ctx.get_cache(ShmServerCache)
        cache.adopt_config(self.config)
        cache.apply_releases(self.released)
        out: dict[int, Any] = {
            idx: _copy_obj(obj) if self.inproc_copy else obj for idx, obj in self.objects.items()
        }
        cold_sizes: list[int] = []
        cold_inline: list[int] = []
        for idx, tensor in self.inline.items():
            # Inline payloads land in (pooled) segments too, so their gets
            # are served zero-copy like any other.
            size = max(tensor.numel() * tensor.element_size(), 1)
            seg = cache.take_free(size)
            if seg is not None:
                cache.note_reuse(seg)
            else:
                # At most 64 KB: its pages fault during the copy below, and
                # the dispatch does not wait for MAP_POPULATE.
                seg = ShmSegment.create(size, populate=False)
                cache.counts["created"] += 1
                cold_inline.append(size)
            meta = TensorMeta.of(tensor)
            view = seg.view(meta)
            view.copy_(tensor)
            cache.put(metas[idx].key, _coords(metas[idx]), seg, meta, 0, view)
            out[idx] = view
        if cold_inline:
            cache.schedule_warm(cold_inline)
        arena = self.arena_plan
        if arena and "segment" in arena:
            seg = self._adopt(cache, arena["segment"], arena["segment_size"], cold_sizes)
            for idx, off in arena["offsets"].items():
                meta = metas[idx]
                view = seg.view(meta.tensor_meta, off)
                cache.put(meta.key, _coords(meta), seg, meta.tensor_meta, off, view)
                out[idx] = view
        for idx, desc in self.descriptors.items():
            meta = metas[idx]
            seg = self._adopt(cache, desc.segment_name, desc.segment_size, cold_sizes)
            view = seg.view(desc.meta, desc.offset)
            cache.put(meta.key, _coords(meta), seg, desc.meta, desc.offset, view)
            out[idx] = view
        if cold_sizes:
            # Missed the pool: warm same-sized spares, and announce those
            # warm already (warm-ups started at the handshake ran during the
            # client's copy) so the client attaches them off the critical
            # path and the next handshake offers exactly these.
            cache.schedule_warm(cold_sizes)
            for size in cold_sizes:
                seg = cache.take_free(size)
                if seg is not None:
                    self._announce(cache, seg)
        return out

    def _announce(self, cache: ShmServerCache, seg: ShmSegment) -> None:
        """Reserve ``seg`` for the next rotation and name it in the put
        reply, so the client attaches it off the critical path and the next
        handshake offers exactly it."""
        cache.reserved[seg.name] = (seg, time.monotonic())
        cache.spare_by_size.setdefault(seg.size, []).append(seg.name)
        cache.counts["spares_announced"] += 1
        self.spares.append((seg.name, seg.size))

    def _adopt(self, cache: ShmServerCache, name: str, size: int, cold: list[int]) -> ShmSegment:
        """The segment a put landed in: a reserved offer as it is, or a cold
        client segment attached and renamed to this volume. A provisioned
        segment's first put announces its twin: the live set then draws
        nothing from the pool, and the next put would miss."""
        reserved = cache.reserved.pop(name, None)
        if reserved is not None:
            seg = reserved[0]
            if seg.provisioned:
                seg.provisioned = False
                twin = cache.take_twin(seg.size)
                if twin is not None:
                    self._announce(cache, twin)
            return seg
        seg = ShmSegment.attach(name, size)
        seg.rename_to_owner()
        self.renames[name] = seg.name
        cold.append(size)
        return seg

    def put_reply(self) -> Any:
        reply = {}
        if self.renames:
            reply["renames"] = self.renames
        if self.spares:
            reply["spares"] = self.spares
        return reply or None

    # ---- server: get -----------------------------------------------------

    def handle_get_request(
        self, ctx: TransportContext, metas: list[Request], entries: list[Any]
    ) -> None:
        cache: ShmServerCache = ctx.get_cache(ShmServerCache)
        cache.adopt_config(self.config)
        cache.apply_releases(self.released)
        cache.sweep()
        for idx, (meta, entry) in enumerate(zip(metas, entries)):
            if meta.is_object:
                self.objects[idx] = _copy_obj(entry) if self.inproc_copy else entry
                continue
            served: Served = entry
            part = served.part()
            if part.numel() == 0:
                self.inline[idx] = part
                continue
            found = cache.lookup(*served.cache_key)
            if found is not None and found.ptr == served.tensor.data_ptr():
                # A lease on every volume-owned serve: a concurrent put can
                # then never be offered this segment mid-read.
                cache.grant(found.seg.name)
                self.descriptors[idx] = ShmDescriptor(
                    found.seg.name, found.seg.size, found.meta, found.offset, served.index
                )
                continue
            # No segment backs it (an RPC put): stage a copy the client
            # unlinks after landing (the sweep reaps it otherwise).
            tmeta = TensorMeta.of(part)
            seg = ShmSegment.create(max(tmeta.nbytes, 1))
            cache.counts["created"] += 1
            seg.view(tmeta).copy_(part)
            cache.track_staged(seg)
            self.descriptors[idx] = ShmDescriptor(seg.name, seg.size, tmeta, owner="client")

    # ---- client: get -----------------------------------------------------

    async def _pre_get_hook(self, volume, requests) -> None:
        cache: ShmClientCache = volume.transport_context.get_cache(ShmClientCache)
        self.released = cache.collect_released(volume.volume_id)

    async def _handle_storage_volume_response(
        self, volume, remote: "SharedMemoryTransportBuffer", requests: list[Request]
    ) -> list[Any]:
        cache: ShmClientCache = volume.transport_context.get_cache(ShmClientCache)
        cache.ack_released(volume.volume_id, self.released)  # the get took them
        self.released = None
        vid = volume.volume_id
        results: list[Any] = []
        copies: list[tuple[torch.Tensor, torch.Tensor, Optional[ShmSegment]]] = []
        done = []  # after every copy landed: lease releases, staged unlinks
        for idx, req in enumerate(requests):
            if idx in remote.objects:
                results.append(remote.objects[idx])
                continue
            if idx in remote.inline:
                results.append(land(req.destination_view, remote.inline[idx]))
                continue
            desc = remote.descriptors[idx]
            dest = req.destination_view
            if desc.owner == "client":
                seg = ShmSegment.attach(desc.segment_name, desc.segment_size, populate=True)
                src = seg.view(desc.meta)
                landed = dest if dest is not None else torch.empty_like(src)
                copies.append((landed, src, None))
                done.append(seg.unlink)
                results.append(landed)
            elif dest is None and self._config().zero_copy_get:
                # Zero copy: a copy-on-write mapping of its own, whose lease
                # is released when the last view of it dies (a slice of the
                # result may outlive the result).
                seg = ShmSegment.attach(desc.segment_name, desc.segment_size, private=True)
                cache.track_view(vid, seg)
                results.append(_part(seg.view(desc.meta, desc.offset), desc.index))
            else:
                seg = cache.attach(desc, req.key)
                src = _part(seg.view(desc.meta, desc.offset), desc.index)
                landed = dest if dest is not None else torch.empty_like(src)
                copies.append((landed, src, seg))
                done.append(lambda name=desc.segment_name: cache.count_release(vid, name))
                results.append(landed)
        await _land(cache, copies, self._config())
        for fn in done:
            fn()
        return results


def _copy_obj(obj: Any) -> Any:
    import copy

    return copy.deepcopy(obj)


def _coords(meta: Request) -> Optional[tuple]:
    return None if meta.tensor_slice is None else meta.tensor_slice.coordinates


def _part(view: torch.Tensor, index: Optional[tuple]) -> torch.Tensor:
    return view if index is None else view[index]


async def _land(
    cache: ShmClientCache,
    copies: list[tuple[torch.Tensor, torch.Tensor, Optional[ShmSegment]]],
    config: StoreConfig,
) -> None:
    """Land (dst, src, cached attachment) copies through ``landing``, then
    count the CUDA uses of the attachments (a reused one is queued to be
    page-locked). Attachments in use are not evicted, nor unpinned before
    they are idle."""
    segs = list({id(s): s for d, src, s in copies if s is not None}.values())
    on_card = list(
        {id(s): s for d, src, s in copies if s is not None and (d.is_cuda or src.is_cuda)}.values()
    )
    cache.raise_pin_error()
    await cache.begin_landing()
    for seg in segs:
        seg.busy += 1
    try:
        await landing.land_async([(d, s) for d, s, _ in copies], config)
    finally:
        cache.end_landing()
        for seg in segs:
            seg.idle()
    cache.note_card_use(on_card)
