"""Port parity for direct (one-hop) weight sync: the port's source and dest
against the reference's (host path) on the same numpy inputs, over shared
memory and TCP, with refresh, transfer-dtype cast, copy-free staging
buffers and torn-pull detection. Results are compared bit for bit.

Leaves on cards are emulated on the CPU (``FakeCards``): which tensors
count as on which card, the cast kernel's chunks (cast by ``x.to()``), the
side streams and ``cudart``'s host registration are stubbed and logged, to
hold what a publish and a pull do per card and in what order. The same
paths on real cards are the ``cuda`` tests at the end."""

import anyio
import ml_dtypes
import numpy as np
import pytest
import torch

from torchstore_tpu import state_dict_utils as ref_sdu
from torchstore_tpu.direct_weight_sync import (
    DirectWeightSyncDest as RefDest,
    DirectWeightSyncSource as RefSource,
)
from torchstore_tpu_torch import direct_weight_sync as port_dws
from torchstore_tpu_torch import state_dict_utils as port_sdu
from torchstore_tpu_torch.ops import staging
from torchstore_tpu_torch.direct_weight_sync import (
    DirectWeightSyncDest,
    DirectWeightSyncSource,
    PullRaceError,
)
from torchstore_tpu_torch.transport import shared_memory as port_shm

TIMEOUT_S = 60


@pytest.fixture
async def pair(request):
    use_shm = getattr(request, "param", True)
    source = DirectWeightSyncSource(use_shm=use_shm)
    dest = DirectWeightSyncDest()
    yield source, dest
    await dest.close()
    await source.close()


async def reference_pull(tree, targets, transfer_dtype=None, update=None):
    # The reference over TCP: its results do not depend on the rung, and it
    # adds no ts_shm_* segments to the reference's own machine-wide counts.
    source = RefSource(use_shm=False, device=False)
    dest = RefDest()
    try:
        handles = await source.register(tree, transfer_dtype=transfer_dtype)
        out = await dest.pull(handles, targets)
        first = {k: np.array(v) for k, v in out.items() if isinstance(v, np.ndarray)}
        if update is None:
            return first, None
        source.update_sources(update)
        await source.refresh()
        out = await dest.pull(handles, targets)
        return first, {k: np.array(v) for k, v in out.items() if isinstance(v, np.ndarray)}
    finally:
        await dest.close()
        await source.close()


def np_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((16, 8)).astype(np.float32),
        "b": rng.standard_normal(8).astype(np.float32),
        "steps": np.arange(4, dtype=np.int64),
    }


def as_port(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def assert_bits_equal(port: torch.Tensor, ref: np.ndarray, key: str):
    if port.dtype == torch.bfloat16:
        np.testing.assert_array_equal(
            port.view(torch.int16).numpy().view(np.uint16), ref.view(np.uint16), err_msg=key
        )
    else:
        np.testing.assert_array_equal(port.numpy(), ref, err_msg=key)


@pytest.mark.parametrize("pair", [True, False], ids=["shm", "tcp"], indirect=True)
async def test_pull_and_refresh_match_reference(pair):
    source, dest = pair
    tree, update = np_tree(0), np_tree(1)
    with anyio.fail_after(TIMEOUT_S):
        ref_first, ref_second = await reference_pull(
            tree, {k: np.zeros_like(v) for k, v in tree.items()}, update=update
        )
        src = as_port(tree)
        handles = await source.register(src)
        assert all((h[0].shm_name is not None) == source.use_shm for h in handles.values())
        targets = {k: torch.zeros_like(v) for k, v in src.items()}
        out = await dest.pull(handles, targets)
        assert all(out[k] is targets[k] for k in targets)  # filled in place
        for k, v in ref_first.items():
            assert_bits_equal(out[k], v, k)
        source.update_sources(as_port(update))
        await source.refresh()
        out = await dest.pull(handles, targets)
        for k, v in ref_second.items():
            assert_bits_equal(out[k], v, k)


async def test_transfer_dtype_cast_matches_reference(pair):
    source, dest = pair
    tree = np_tree(2)
    bf16 = ml_dtypes.bfloat16
    with anyio.fail_after(TIMEOUT_S):
        ref, _ = await reference_pull(
            tree,
            {k: np.zeros(v.shape, bf16 if v.dtype == np.float32 else v.dtype)
             for k, v in tree.items()},
            transfer_dtype=bf16,
        )
        handles = await source.register(as_port(tree), transfer_dtype=torch.bfloat16)
        assert handles["w"][0].meta.dtype == "bfloat16"
        assert handles["steps"][0].meta.dtype == "int64"  # non-floating: no cast
        targets = {
            k: torch.zeros(v.shape, dtype=torch.bfloat16 if v.dtype == np.float32 else torch.int64)
            for k, v in tree.items()
        }
        out = await dest.pull(handles, targets)
    for k, v in ref.items():
        assert_bits_equal(out[k], v, k)


async def test_non_tensor_leaves_skipped(pair):
    source, dest = pair
    with anyio.fail_after(TIMEOUT_S):
        handles = await source.register({"w": torch.ones(4), "cfg": {"lr": 1e-3}})
        assert "cfg/lr" not in handles
        out = await dest.pull(handles, {"w": torch.zeros(4), "cfg": {"lr": 0.0}})
    assert torch.equal(out["w"], torch.ones(4))
    assert out["cfg"]["lr"] == 0.0  # untouched by the direct path


async def test_staging_buffers_make_publishes_copy_free(pair):
    source, dest = pair
    with anyio.fail_after(TIMEOUT_S):
        handles = await source.register({"w": torch.zeros(6), "step": 3})
        staging = source.staging_state_dict()
        assert staging["step"] == 3
        staging["w"].fill_(5.0)  # the trainer writes straight into the buffer
        source.update_sources(staging)
        await source.refresh()  # nothing to copy: the buffer is the source
        out = await dest.pull(handles, {"w": torch.zeros(6)})
    assert torch.equal(out["w"], torch.full((6,), 5.0))


async def test_non_contiguous_target_and_errors(pair):
    source, dest = pair
    w = torch.arange(12.0).reshape(3, 4)
    with anyio.fail_after(TIMEOUT_S):
        handles = await source.register({"w": w})
        target = torch.zeros(4, 3).t()  # non-contiguous, filled through a stand-in
        out = await dest.pull(handles, {"w": target})
        assert out["w"] is target and torch.equal(target, w)
        with pytest.raises(KeyError, match="published no handle"):
            await dest.pull(handles, {"other": torch.zeros(1)})
        with pytest.raises(ValueError, match="source shape"):
            await dest.pull(handles, {"w": torch.zeros(4, 3)})
        source.update_sources({"w": torch.zeros(2, 2)})
        with pytest.raises(ValueError, match="re-register"):
            await source.refresh()


async def test_pull_waits_out_a_refresh_then_gives_up(pair, monkeypatch):
    source, dest = pair
    with anyio.fail_after(TIMEOUT_S):
        handles = await source.register({"w": torch.ones(4)})
        source._set_busy(True)  # a refresh that never finishes
        monkeypatch.setattr(port_dws.default_config(), "direct_settle_timeout", 0.2)
        with pytest.raises(PullRaceError, match="never settled"):
            await dest.pull(handles, {"w": torch.zeros(4)})
        source._set_busy(False)
        out = await dest.pull(handles, {"w": torch.zeros(4)})
    assert torch.equal(out["w"], torch.ones(4))


async def test_close_unlinks_staging_segments():
    source = DirectWeightSyncSource(use_shm=True)
    handles = await source.register({"w": torch.ones(1024)})
    name = handles["w"][0].shm_name
    assert name.startswith(port_shm.PREFIX)
    assert name in port_shm.os.listdir(port_shm.SHM_DIR)
    await source.close()
    assert name not in port_shm.os.listdir(port_shm.SHM_DIR)


# --------------------------------------------------------------------------
# leaves on cards: the casts and copies of a publish, and page-locking
# --------------------------------------------------------------------------


class FakeCards:
    """Stands in for CUDA on the CPU: the tensors named in ``devices`` (by
    data pointer) count as living on those cards; ``cast_kernel.chunks``
    casts the planned chunks by ``x.to()`` and logs each call's device;
    the side streams, the pull's device waits and ``cudart``'s host
    registration log what they would do."""

    def __init__(self, monkeypatch) -> None:
        self.devices: dict[int, torch.device] = {}
        self.chunk_calls: list = []
        self.events: list = []
        self.registered: list = []
        self.unregistered: list = []
        cards = self

        def card_of(t):
            return cards.devices.get(t.data_ptr()) if t.numel() else None

        def chunks(tensors, dtype, max_chunk_bytes=staging.DEFAULT_CHUNK_BYTES, outs=None):
            cards.chunk_calls.append({card_of(t) for t in tensors})
            for chunk in staging.plan_chunks(tensors, dtype, max_chunk_bytes):
                ys = [tensors[i].to(dtype) for i in chunk.indices]
                if outs is not None:
                    ys = [outs[i].copy_(y) for i, y in zip(chunk.indices, ys)]
                yield chunk, ys

        class Stream:
            def __init__(self, device):
                self.device = device

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                pass

            def synchronize(self):
                cards.events.append(("sync", self.device))

        class Cudart:
            def cudaHostRegister(self, ptr, size, flags):
                cards.registered.append(ptr)
                return 0

            def cudaHostUnregister(self, ptr):
                cards.unregistered.append(ptr)
                return 0

        monkeypatch.setattr(staging, "card_of", card_of)
        monkeypatch.setattr(staging.cast_kernel, "chunks", chunks)
        monkeypatch.setattr(port_dws, "_D2HStream", Stream)
        monkeypatch.setattr(port_dws, "_synchronize",
                            lambda device: cards.events.append(("sync", device)))
        monkeypatch.setattr(torch.cuda, "cudart", lambda: Cudart())

    def place(self, tensor, index):
        self.devices[tensor.data_ptr()] = torch.device("cuda", index)
        return tensor


@pytest.fixture
def cards(monkeypatch):
    return FakeCards(monkeypatch)


async def test_stage_casts_each_card_in_its_own_group(cards):
    """Leaves on two cards: one ``chunks`` call per card (one cast group
    takes one device), where a single call over both raised."""
    tree = {f"w{i}": cards.place(torch.randn(64, generator=torch.Generator().manual_seed(i)),
                                 i % 2) for i in range(4)}
    tree["host"] = torch.randn(8)
    source = DirectWeightSyncSource(use_shm=False)
    try:
        handles = await source.register(tree, transfer_dtype=torch.bfloat16)
        assert sorted(map(sorted, cards.chunk_calls), key=str) == [
            [torch.device("cuda", 0)], [torch.device("cuda", 1)]]
        for k, v in tree.items():
            staged = source.server.buffers[handles[k][0].buffer_id]
            assert torch.equal(staged, v.to(torch.bfloat16)), k
        cards.chunk_calls.clear()
        await source.refresh()
        assert len(cards.chunk_calls) == 2
    finally:
        await source.close()


async def test_refresh_that_raises_leaves_buffers_and_generation():
    """A leaf that no longer matches its buffer is found before any buffer
    is overwritten: the others keep the last publish, and the generation
    does not move (a reader would otherwise take a torn publish for a
    stable one)."""
    tree = {"a": torch.ones(16), "b": torch.ones(4, 4)}
    source = DirectWeightSyncSource(use_shm=False)
    try:
        handles = await source.register(tree)
        gen = source._read_gen()
        source.update_sources({"a": torch.full((16,), 2.0), "b": torch.zeros(2, 8)})
        with pytest.raises(ValueError, match="re-register"):
            await source.refresh()
        assert source._read_gen() == gen
        for k, v in tree.items():
            assert torch.equal(source.server.buffers[handles[k][0].buffer_id], v), k
        source.update_sources({"a": torch.full((16,), 2.0), "b": torch.zeros(4, 4)})
        await source.refresh()
        assert source._read_gen() == gen + 2
        assert torch.equal(source.server.buffers[handles["a"][0].buffer_id], torch.full((16,), 2.0))
    finally:
        await source.close()


async def test_uncovered_pair_on_a_card_casts_like_the_reference(cards):
    """A float64 leaf on a card with a bf16 transfer dtype: the kernel does
    not cover the pair, so both legs cast it by ``x.to()`` (the reference's
    ``astype``), counted in ``cast_kernel.fallbacks``; the fp32 leaf still
    goes through the kernel's chunks."""
    rng = np.random.default_rng(9)
    tree = {"w64": rng.standard_normal((8, 8)), "w32": rng.standard_normal(32).astype(np.float32)}
    port = {k: cards.place(torch.from_numpy(v.copy()), 0) for k, v in tree.items()}
    bf16 = ml_dtypes.bfloat16
    ref_direct, _ = await reference_pull(
        tree, {k: np.zeros(v.shape, bf16) for k, v in tree.items()}, transfer_dtype=bf16
    )
    before = staging.cast_kernel.fallbacks
    buffered = port_sdu.cast_floating_tensors(port, torch.bfloat16)
    assert staging.cast_kernel.fallbacks == before + 1
    source = DirectWeightSyncSource(use_shm=False)
    try:
        handles = await source.register(port, transfer_dtype=torch.bfloat16)
        assert staging.cast_kernel.fallbacks == before + 2
        assert len(cards.chunk_calls) == 2  # the fp32 leaf, once per leg
        for k, want in ref_sdu.cast_floating_tensors(tree, bf16).items():
            assert_bits_equal(buffered[k], np.asarray(want), k)
            staged = source.server.buffers[handles[k][0].buffer_id]
            assert_bits_equal(staged, ref_direct[k], k)
    finally:
        await source.close()


@pytest.mark.parametrize("use_shm", [True, False], ids=["shm", "process"])
async def test_page_locking_pairs_and_sync_order(cards, use_shm):
    """Staging buffers a card copies into are registered once at register
    and unregistered at close; a refresh waits for its copies before the
    generation moves; a dest page-locks each attachment once and waits for
    its copies to the card before it reads the generations again."""
    src = {"w": cards.place(torch.randn(256), 0), "b": cards.place(torch.randn(8), 0),
           "empty": torch.zeros(0)}
    source = DirectWeightSyncSource(use_shm=use_shm)
    dest = DirectWeightSyncDest()
    try:
        handles = await source.register(src, transfer_dtype=torch.bfloat16)
        assert len(cards.registered) == 2  # the empty buffer holds no memory
        assert source.pin_seconds >= 0.0
        gens = []
        cards.events.clear()
        real_bump = source._bump_gen
        source._bump_gen = lambda n=2: (gens.append(("bump", list(cards.events))), real_bump(n))
        await source.refresh()
        assert gens == [("bump", [("sync", torch.device("cuda", 0))])]
        targets = {k: cards.place(torch.zeros(v.shape, dtype=torch.bfloat16), 1) if v.numel()
                   else torch.zeros(0, dtype=torch.bfloat16) for k, v in src.items()}
        cards.events.clear()
        real_read = dest._read_gen

        async def read_gen(host, port):
            cards.events.append("gen")
            return await real_read(host, port)

        dest._read_gen = read_gen
        for _ in range(2):
            out = await dest.pull(handles, targets)
        for k, v in src.items():
            assert torch.equal(out[k], v.to(torch.bfloat16)), k
        sync = ("sync", torch.device("cuda", 1))
        assert cards.events == ["gen", sync, "gen"] * 2
        assert len(cards.registered) == (4 if use_shm else 2)  # attachments: once each
    finally:
        await dest.close()
        await source.close()
    assert sorted(cards.unregistered) == sorted(cards.registered)


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
async def test_leaves_on_two_cards_publish_and_pull(two_cards):
    """On two real cards, on the host rung: one kernel launch per card for the fp32 leaves,
    a float64 leaf cast by x.to(), every staged byte equal to x.to()."""
    d0, d1 = two_cards
    gen = torch.Generator().manual_seed(3)
    tree = {"a": torch.randn(4096, generator=gen).to(d0), "b": torch.randn(512, generator=gen).to(d1),
            "c": torch.randn(64, generator=gen, dtype=torch.float64).to(d1)}
    source = DirectWeightSyncSource(use_shm=True, device=False)
    dest = DirectWeightSyncDest()
    before = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
    try:
        handles = await source.register(tree, transfer_dtype=torch.bfloat16)
        assert staging.cast_kernel.launches - before[0] == 2
        assert staging.cast_kernel.fallbacks - before[1] == 1
        for k, v in tree.items():
            staged = source.server.buffers[handles[k][0].buffer_id]
            assert staged.is_pinned()
            assert torch.equal(staged, v.to(torch.bfloat16).cpu()), k
        targets = {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=d0) for k, v in tree.items()}
        await dest.pull(handles, targets)
        for k, v in tree.items():
            assert torch.equal(targets[k], v.to(torch.bfloat16).to(d0)), k
    finally:
        await dest.close()
        await source.close()


async def test_close_releases_the_source_leaves():
    """A closed source holds no reference to the trainer's tensors, so they
    go when the trainer drops them, not when the cycle collector runs."""
    import gc
    import weakref

    gc.disable()
    try:
        w = torch.ones(1024)
        alive = weakref.ref(w)
        source = DirectWeightSyncSource(use_shm=True)
        await source.register({"w": w})
        await source.close()
        del w
        assert alive() is None
    finally:
        gc.enable()
