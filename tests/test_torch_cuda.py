"""The port's flash kernel and grouped cast kernel against their plain
versions on an NVIDIA GPU, and the quantized wire tier on the card (blobs
and delta sequences byte-equal to the CPU encode, gets decoded on the card).

This file imports torch, numpy and the port only (no JAX), so it runs on a
machine with the card:

    python -m pytest -o addopts="" -m cuda tests/test_torch_cuda.py -q

Without a card every test skips. Tolerances as chip_smoke.py's
flash_parity phase: m, l and o within 1e-5 + 1e-4 |want| (o in bf16 within
1e-5 + 2**-7 |want|, about two bf16 ulps), acc the same after dividing by
the plain version's l (acc sums sk terms whose magnitudes add up to ~l).
The grouped cast is bit-equal to ``x.to()`` outside NaN, NaN positions equal.
Calls that ``sm90_eligible`` sends to the sm90 kernel are held against its
arithmetic twin ``stats_blockwise_reference`` with the same bounds plus
``flip_allowance``: both round an fp32 p to bf16, and where the two p differ
in their last bits they can round to adjacent values (one bf16 ulp, at most
2**-7 p_j |v_j| / l in o); the allowance covers two such terms at p <= 1.
"""

import importlib

import numpy as np
import pytest
import torch

from torchstore_tpu_torch.ops import staging

fa = importlib.import_module("torchstore_tpu_torch.ops.flash_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def qkv(seed, b, sq, sk, h, hk, d, dtype, device):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in shapes]


def flip_allowance(v, l, h):
    """2**-6 max_k |v_kd| / l per (b, h, sq, d) (see the module docstring)."""
    vmax = v.float().abs().amax(dim=1).repeat_interleave(h // v.shape[2], dim=1)
    return 2.0**-6 * vmax[:, :, None, :] / l[..., None]


def counts():
    return (dict(fa.stats_kernel.launches_by_variant),
            dict(fa.attention_kernel.launches_by_variant))


def run_and_check(q, k, v, causal, dtype):
    """Both modes against the plain version of the variant that ran; returns
    the variant."""
    variant = "sm90" if fa.sm90_eligible(q, k, v) else "simt"
    before = counts()
    acc, m, l = fa.flash_attention_stats(q, k, v, causal_diag=causal)
    o = fa.flash_attention(q, k, v, causal=causal)
    after = counts()
    for b_, a_ in zip(before, after):
        assert a_ == {**b_, variant: b_[variant] + 1}
    if variant == "sm90":
        want_acc, want_m, want_l = fa.stats_blockwise_reference(q, k, v, causal, 128)
        flip = flip_allowance(v, want_l, q.shape[2])
        want_o = fa.attention_blockwise_reference(q, k, v, causal, 128)
    else:
        want_acc, want_m, want_l = fa.stats_reference(q, k, v, causal)
        flip = torch.zeros((), device=q.device)
        want_o = fa.attention_reference(q, k, v, causal)
    norm = want_l[..., None]
    err = (acc / norm - want_acc / norm).abs()
    assert bool((err <= 1e-5 + 1e-4 * (want_acc / norm).abs() + flip).all()), float(err.max())
    torch.testing.assert_close(m, want_m, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(l, want_l, rtol=1e-4, atol=1e-5)
    assert o.dtype == dtype and o.shape == q.shape
    rtol = 1e-4 if dtype == torch.float32 else 2.0**-7
    o_err = (o.float() - want_o.float()).abs()
    allowed = 1e-5 + rtol * want_o.float().abs() + (flip.transpose(1, 2) if flip.dim() else flip)
    assert bool((o_err <= allowed).all()), float(o_err.max())
    return variant


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(1, 200, 333, 8, 2, 64), (2, 130, 130, 4, 4, 256),
                                   (1, 77, 40, 6, 3, 72)])
def test_kernel_matches_plain_version_on_cuda(cuda, shape, causal, dtype):
    b, sq, sk, h, hk, d = shape
    q, k, v = qkv(9, b, sq, sk, h, hk, d, dtype, cuda)
    variant = run_and_check(q, k, v, causal, dtype)
    assert variant == ("sm90" if dtype == torch.bfloat16 and d == 64 else "simt")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(1, 200, 333, 8, 2, 128), (2, 130, 130, 4, 4, 64)])
def test_sm90_matches_blockwise_reference_on_cuda(cuda, shape, causal):
    b, sq, sk, h, hk, d = shape
    q, k, v = qkv(10, b, sq, sk, h, hk, d, torch.bfloat16, cuda)
    assert run_and_check(q, k, v, causal, torch.bfloat16) == "sm90"


@pytest.mark.cuda
def test_ineligible_bf16_head_dim_launches_simt(cuda):
    q, k, v = qkv(11, 1, 77, 40, 6, 3, 72, torch.bfloat16, cuda)
    assert not fa.sm90_eligible(q, k, v)
    assert run_and_check(q, k, v, True, torch.bfloat16) == "simt"


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_sm90_reads_packed_projection_views(cuda, causal):
    """q, k, v sliced from one (b, s, h + 2 hk, d) tensor run on sm90 through
    their strides and give what contiguous copies give, bit for bit."""
    b, s, h, hk, d = 2, 300, 8, 2, 128
    rng = np.random.default_rng(12)
    qkv_ = torch.from_numpy(rng.standard_normal((b, s, h + 2 * hk, d)).astype(np.float32))
    qkv_ = qkv_.to(cuda, torch.bfloat16)
    views = (qkv_[:, :, :h], qkv_[:, :, h:h + hk], qkv_[:, :, h + hk:])
    assert not views[0].is_contiguous() and fa.sm90_eligible(*views)
    copies = tuple(x.contiguous() for x in views)
    got = fa.flash_attention_stats(*views, causal_diag=causal)
    want = fa.flash_attention_stats(*copies, causal_diag=causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(fa.flash_attention(*views, causal=causal),
                       fa.flash_attention(*copies, causal=causal))


@pytest.mark.cuda
def test_stats_backward_recomputes_through_plain_version(cuda):
    q, k, v = (t.requires_grad_() for t in qkv(3, 1, 96, 96, 4, 2, 32, torch.float32, cuda))
    outs = fa.flash_attention_stats(q, k, v, causal_diag=True)
    cts = [torch.randn_like(t) for t in outs]
    got = torch.autograd.grad(outs, (q, k, v), cts)
    want = torch.autograd.grad(fa.stats_reference(q, k, v, True), (q, k, v), cts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_kernel_refuses_strided_head_dim(cuda):
    q, k, v = qkv(0, 1, 16, 16, 2, 2, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.stats_kernel(q[..., ::2], k[..., ::2], v[..., ::2], False)


# --------------------------------------------------------------------------
# the grouped cast kernel
# --------------------------------------------------------------------------

_INT = {4: (torch.int32, np.uint32), 2: (torch.int16, np.uint16)}


def random_bits(dtype, n, seed, device):
    """``n`` random bit patterns of ``dtype`` (every class of value)."""
    int_t, np_t = _INT[torch.empty((), dtype=dtype).element_size()]
    raw = np.random.default_rng(seed).integers(0, np.iinfo(np_t).max + 1, n, dtype=np.uint64)
    return torch.from_numpy(raw.astype(np_t).view(np_t)).view(int_t).view(dtype).to(device)


def assert_bits_equal(got, want):
    """Bit-equal outside NaN, NaN positions equal."""
    int_t = _INT[got.element_size()][0]
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(int_t)[~nan], want.view(int_t)[~nan])


def mixed_group(src, device, seed):
    """Sizes 0 to 2**20 + 3 and views at every storage offset in one group."""
    ts = [random_bits(src, n, seed + n, device)
          for n in (0, 1, 7, 8, 9, 1023, 4096, 4097, (1 << 20) + 3)]
    base = random_bits(src, 10_000, seed, device)
    return ts + [base[k:] for k in range(1, 9)] + [base[3:9000].view(-1, 8997)]


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", staging.PAIRS, ids=str)
def test_cast_group_matches_plain_version_on_cuda(cuda, src, dst):
    ts = mixed_group(src, cuda, seed=3)
    before = staging.cast_kernel.launches
    got = staging.cast_group(ts, dst)
    assert staging.cast_kernel.launches - before == len(staging.plan_chunks(ts, dst)) == 1
    for x, y in zip(ts, got):
        assert y.dtype == dst and y.shape == x.shape and y.is_contiguous()
        assert_bits_equal(y, staging.cast_reference(x, dst))


@pytest.mark.cuda
@pytest.mark.parametrize("max_chunk_bytes", [1 << 16, 1 << 30])
def test_cast_group_launches_once_per_chunk(cuda, max_chunk_bytes):
    rng = np.random.default_rng(5)
    ts = [random_bits(torch.float32, int(n), i, cuda)
          for i, n in enumerate(rng.integers(1, 40_000, 60))]
    ts += [random_bits(torch.float16, 3, i, cuda) for i in range(1200)]  # > one table
    plan = staging.plan_chunks(ts, torch.bfloat16, max_chunk_bytes)
    assert len(plan) >= 2
    before = staging.cast_kernel.launches
    got = staging.cast_group(ts, torch.bfloat16, max_chunk_bytes=max_chunk_bytes)
    assert staging.cast_kernel.launches - before == len(plan)
    for x, y in zip(ts, got):
        assert_bits_equal(y, x.to(torch.bfloat16))


@pytest.mark.cuda
def test_cast_group_refuses_what_it_does_not_take(cuda):
    ok = torch.zeros(8, device=cuda)
    before = staging.cast_kernel.launches
    with pytest.raises(TypeError, match="does not cover"):
        staging.cast_group([ok, torch.zeros(8, dtype=torch.float64, device=cuda)], torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        staging.cast_group([ok, torch.zeros(8)], torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        staging.cast_group([ok, torch.zeros(8, 8, device=cuda).t()], torch.bfloat16)
    assert staging.cast_kernel.launches == before


@pytest.mark.cuda
def test_both_legs_cast_an_uncovered_pair_outside_the_kernel(cuda):
    """A float64 leaf with a bf16 transfer dtype is cast by x.to() (counted
    in ``fallbacks``) on the buffered leg; the fp32 leaves still take one
    launch per chunk."""
    from torchstore_tpu_torch.state_dict_utils import cast_floating_tensors

    flat = {"w": random_bits(torch.float32, 5000, 1, cuda),
            "d": torch.randn(64, dtype=torch.float64, device=cuda), "n": torch.arange(3)}
    before = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
    out = cast_floating_tensors(flat, torch.bfloat16)
    assert staging.cast_kernel.launches - before[0] == 1
    assert staging.cast_kernel.fallbacks - before[1] == 1
    for k in ("w", "d"):
        assert_bits_equal(out[k], flat[k].to(torch.bfloat16))
    assert out["n"] is flat["n"]


@pytest.mark.cuda
def test_direct_sync_page_locks_and_lands_sharded_targets(cuda):
    """A direct source on the card, on the host rung: its staging buffers read as pinned, a
    float64 leaf is cast outside the kernel, a refresh lands, and a dest
    pulls row and column shards into CUDA targets through pinned
    attachments."""
    import asyncio

    from torchstore_tpu_torch.client import Shard
    from torchstore_tpu_torch.direct_weight_sync import (
        DirectWeightSyncDest,
        DirectWeightSyncSource,
    )
    from torchstore_tpu_torch.transport.types import TensorSlice

    gen = torch.Generator(device=cuda).manual_seed(11)
    w = torch.randn(256, 512, generator=gen, device=cuda)
    halves = [Shard(w[r * 128:(r + 1) * 128], TensorSlice((r * 128, 0), (128, 512), (256, 512),
                                                          (r,), (2,))) for r in range(2)]
    extra = torch.randn(33, dtype=torch.float64, device=cuda)

    async def run():
        sources = [DirectWeightSyncSource(use_shm=True, device=False) for _ in halves]
        dest = DirectWeightSyncDest()
        try:
            before = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
            handles: dict = {}
            for r, (source, half) in enumerate(zip(sources, halves)):
                tree = {"w": half, "x": extra} if r == 0 else {"w": half}
                for k, hs in (await source.register(tree, r, torch.bfloat16)).items():
                    handles.setdefault(k, []).extend(hs)
            assert staging.cast_kernel.launches - before[0] == 2
            assert staging.cast_kernel.fallbacks - before[1] == 1
            for source in sources:
                assert all(b.is_pinned() for b in source.server.buffers.values())
            assert sources[0].pin_seconds > 0
            cols = [TensorSlice((0, c * 256), (256, 256), (256, 512), (c,), (2,)) for c in range(2)]
            for step in range(2):
                for c, ts in enumerate(cols):
                    target = {"w": Shard(torch.zeros(256, 256, dtype=torch.bfloat16, device=cuda),
                                         ts), "x": torch.zeros(33, dtype=torch.bfloat16,
                                                               device=cuda)}
                    await dest.pull(handles, target)
                    want = w[:, c * 256:(c + 1) * 256].to(torch.bfloat16)
                    assert_bits_equal(target["w"].data, want)
                    assert_bits_equal(target["x"], extra.to(torch.bfloat16))
                w.add_(1.0)
                for source in sources:
                    await source.refresh()
            assert dest.pin_seconds > 0
        finally:
            await dest.close()
            for source in sources:
                await source.close()

    asyncio.run(run())


@pytest.mark.cuda
def test_buffered_rotation_through_pinned_attachments(cuda, monkeypatch):
    """The buffered leg of an RL loop on the card: a put and a get into CUDA
    targets, then two re-puts and re-gets after in-place updates. Every
    get is bit-equal to the source's bf16 cast and the later puts draw warm
    segments (no cold create); after the second rotation the client's
    attachments read as pinned; a zero-copy CPU view keeps its snapshot
    across a re-put; shutdown unregisters every locked attachment."""
    import asyncio
    import uuid

    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.transport import shared_memory as shm

    unpinned = []
    real_unregister = shm.host_unregister
    monkeypatch.setattr(shm, "host_unregister",
                        lambda ptrs: (unpinned.extend(ptrs), real_unregister(ptrs)))
    gen = torch.Generator(device=cuda).manual_seed(5)
    src = {"a": torch.randn(512, 512, generator=gen, device=cuda),
           "b": torch.randn(1024, 300, generator=gen, device=cuda),
           "n1": torch.randn(256, generator=gen, device=cuda),
           "n2": torch.randn(256, generator=gen, device=cuda)}
    bf16 = torch.bfloat16
    store = f"cuda_{uuid.uuid4().hex[:8]}"

    async def warm(client):
        for _ in range(200):
            stats = await client.controller.stats.call_one(include_volumes=True)
            (vstats,) = stats["volumes"].values()
            if vstats.get("shm", {}).get("warming", 0) == 0:
                return
            await asyncio.sleep(0.05)
        raise TimeoutError("pool warm-ups still in flight")

    async def run():
        await tst.initialize(store_name=store)
        client = tst.client(store)
        try:
            targets = {k: torch.zeros(v.shape, dtype=bf16, device=cuda) for k, v in src.items()}
            colds = []
            for step in range(3):
                await warm(client)
                cache = client._ctx.peek(shm.ShmClientCache)
                before = 0 if cache is None else cache.counts["cold_create"]
                await tst.put_state_dict("policy", src, transfer_dtype=bf16, store_name=store)
                cache = client._ctx.peek(shm.ShmClientCache)
                colds.append(cache.counts["cold_create"] - before)
                await tst.get_state_dict("policy", targets, store_name=store)
                torch.cuda.synchronize()
                for k in src:
                    assert_bits_equal(targets[k], src[k].to(bf16))
                snap_want = {k: v.to(bf16).cpu() for k, v in src.items()}
                for v in src.values():
                    v.add_(1.0)
            assert colds[0] > 0 and colds[1:] == [0, 0]
            await cache.wait_pinned()  # locking runs between the copies
            names = set().union(*(cache.key_to_segments[f"policy/{k}"] for k in src))
            segs = [cache.segments[n] for n in names if n in cache.segments]
            assert len(segs) >= 4  # two rotations of the arena and the large keys
            assert all(s.pinned is not None for s in segs)
            assert all(torch.frombuffer(s.mmap, dtype=torch.uint8).is_pinned() for s in segs)
            assert cache.pin_seconds > 0
            snap = await tst.get_state_dict("policy", store_name=store)  # CPU views
            for _ in range(2):
                await tst.put_state_dict("policy", src, transfer_dtype=bf16, store_name=store)
                for v in src.values():
                    v.add_(1.0)
            for k in src:
                assert snap[k].device.type == "cpu"
                assert_bits_equal(snap[k], snap_want[k])  # survived two re-puts
            pinned = [s.pinned for s in cache.segments.values() if s.pinned is not None]
        finally:
            await tst.shutdown(store)
        assert sorted(unpinned) == sorted(pinned)
        assert not cache.segments

    asyncio.run(run())


# --------------------------------------------------------------------------
# the quantized wire tier on the card
# --------------------------------------------------------------------------


def quant_leaves(seed, device):
    """f32, bf16 and f16 leaves with ragged tails, a scalar and an empty
    one, from one numpy seed."""
    rng = np.random.default_rng(seed)
    leaves = {
        "w": rng.standard_normal((300, 17)).astype(np.float32) * 3.0,
        "b": rng.standard_normal(1000).astype(np.float32) * 0.01,
        "s": np.asarray(1.5, np.float32),
        "e": np.zeros((0, 8), np.float32),
    }
    out = {k: torch.from_numpy(v).to(device) for k, v in leaves.items()}
    out["h"] = torch.from_numpy(rng.standard_normal(513).astype(np.float32)).to(device,
                                                                               torch.float16)
    out["bf"] = torch.from_numpy(rng.standard_normal((7, 9)).astype(np.float32)).to(
        device, torch.bfloat16)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int8_block", "int4_block"])
def test_card_blobs_equal_the_cpu_encode(cuda, fmt):
    from torchstore_tpu_torch import state_dict_utils as sdu

    leaves = quant_leaves(4, cuda)
    out, meta = sdu.quantize_transfer(leaves, fmt, 256)
    want, want_meta = sdu.quantize_transfer({k: v.cpu() for k, v in leaves.items()}, fmt, 256)
    assert meta == want_meta
    for k in leaves:
        assert out[k].is_cuda and out[k].dtype == torch.uint8
        assert torch.equal(out[k].cpu(), want[k]), k
        got_info, want_info = sdu.parse_quant_blob(out[k]), sdu.parse_quant_blob(want[k])
        got = sdu._dequant_codes(got_info["codes"], got_info["scales"][:, None])
        assert torch.equal(got.cpu(), sdu._dequant_codes(want_info["codes"],
                                                         want_info["scales"][:, None]))


@pytest.mark.cuda
def test_quantized_get_decodes_on_the_card(cuda):
    """A CUDA leaf is encoded on its card, the get lands the blobs' bytes on
    the card and decodes them into bf16 targets there; nothing f32 is left
    allocated after the get."""
    import asyncio

    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch import state_dict_utils as sdu

    gen = torch.Generator(device=cuda).manual_seed(2)
    src = {"a": torch.randn(1024, 384, generator=gen, device=cuda),
           "b": torch.randn(4096, generator=gen, device=cuda)}
    targets = {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=cuda) for k, v in src.items()}

    async def go():
        await tst.initialize(store_name="qcuda")
        try:
            await tst.put_state_dict("q", src, transfer_quant="int8_block", store_name="qcuda")
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(cuda)
            out = await tst.get_state_dict("q", targets, store_name="qcuda")
            torch.cuda.synchronize()
            return out, torch.cuda.memory_allocated(cuda) - before
        finally:
            await tst.shutdown("qcuda")

    out, left = asyncio.run(go())
    assert left <= 0
    blobs, _ = sdu.quantize_transfer(src, "int8_block", 256)
    for k, t in targets.items():
        assert out[k] is t
        info = sdu.parse_quant_blob(blobs[k])
        plain = (info["codes"].float() * info["scales"][:, None]).reshape(-1)[: t.numel()]
        assert torch.equal(t, plain.reshape(t.shape).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8_block", "int4_block"])
def test_delta_sequence_on_the_card_matches_the_cpu(cuda, fmt):
    import asyncio

    from torchstore_tpu_torch import state_dict_utils as sdu

    rng = np.random.default_rng(8)
    hot = rng.standard_normal(5000).astype(np.float32)
    versions = [hot.copy()]
    for step in range(4):
        hot[step * 300:(step + 1) * 300] += 0.05 * (step + 1)
        versions.append(hot.copy())
    versions.append(hot.copy())  # unchanged

    async def go(device):
        enc, dec = sdu.DeltaEncoder(fmt, 256, keyframe_every=3), sdu.DeltaDecoder()
        blobs = []
        for v, x in enumerate(versions):
            blob, base = await enc.encode("hot", torch.from_numpy(x).to(device), v)
            blobs.append(None if blob is None else blob.cpu())
            if blob is not None:
                await dec.decode("hot", blob)
            assert torch.equal(dec.state["hot"]["blocks"], enc.entries["hot"]["baseline"])
            assert dec.state["hot"]["blocks"].device.type == device.type
        return blobs, enc.entries["hot"]["baseline"].cpu()

    card_blobs, card_base = asyncio.run(go(cuda))
    cpu_blobs, cpu_base = asyncio.run(go(torch.device("cpu")))
    assert [b is None for b in card_blobs] == [b is None for b in cpu_blobs]
    for a, b in zip(card_blobs, cpu_blobs):
        assert a is None or torch.equal(a, b)
    assert torch.equal(card_base, cpu_base)


@pytest.mark.cuda
def test_channel_barrier_round_trip_into_card_targets(cuda):
    """A bf16 channel publish of fp32 leaves on the card casts through the
    grouped kernel (one launch per planned chunk, no fallback) and an
    acquire fills bf16 targets on the card, bit-equal to the cast."""
    import asyncio

    import torchstore_tpu_torch as tst

    gen = torch.Generator(device=cuda).manual_seed(3)
    src = {"a": torch.randn(1024, 384, generator=gen, device=cuda),
           "b": torch.randn(4096, generator=gen, device=cuda)}
    targets = {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=cuda) for k, v in src.items()}
    chunks = len(staging.plan_chunks(list(src.values()), torch.bfloat16))

    async def go():
        await tst.initialize(store_name="chcuda")
        try:
            pub = tst.WeightPublisher("policy", store_name="chcuda")
            sub = tst.WeightSubscriber("policy", store_name="chcuda")
            launches = staging.cast_kernel.launches
            versions = []
            for step in range(3):
                if step:
                    for t in src.values():
                        t.add_(1.0)
                await pub.publish(src, transfer_dtype=torch.bfloat16)
                _, v = await sub.acquire(user_state_dict=targets, timeout=60)
                torch.cuda.synchronize()
                versions.append((v, all(torch.equal(targets[k], src[k].to(torch.bfloat16))
                                        for k in src)))
            return versions, staging.cast_kernel.launches - launches, \
                await tst.keys("policy", store_name="chcuda")
        finally:
            await tst.shutdown("chcuda")

    fallbacks = staging.cast_kernel.fallbacks
    versions, launched, keys = asyncio.run(go())
    assert versions == [(0, True), (1, True), (2, True)]
    assert launched == 3 * chunks and staging.cast_kernel.fallbacks == fallbacks
    assert {k.split("/")[1] for k in keys} == {"LATEST", "v1", "v2"}


@pytest.mark.cuda
def test_channel_streamed_round_trip_into_card_targets(cuda):
    """A streamed bf16 publish, one fragment per layer, served in forward
    order into bf16 card targets before the seal, bit-equal to the cast."""
    import asyncio

    import torchstore_tpu_torch as tst

    gen = torch.Generator(device=cuda).manual_seed(4)
    src = {f"layer_{i}": torch.randn(512, 256, generator=gen, device=cuda) for i in range(4)}
    targets = {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=cuda) for k, v in src.items()}

    async def go():
        await tst.initialize(store_name="stcuda")
        try:
            pub = tst.WeightPublisher("policy", store_name="stcuda")
            sub = tst.WeightSubscriber("policy", store_name="stcuda")
            served, first = [], asyncio.Event()

            def on_layer(fk, value):
                served.append((fk, value is targets[fk]))
                first.set()

            task = asyncio.ensure_future(sub.acquire_streamed(
                targets, key_order=list(src), on_layer=on_layer, timeout=60))
            cs = pub.stream(transfer_dtype=torch.bfloat16)
            names = list(src)
            await cs.put({names[0]: src[names[0]]})
            await asyncio.wait_for(first.wait(), 30)
            before_seal = len(served)
            for name in names[1:]:
                await cs.put({name: src[name]})
            await cs.seal()
            _, v = await task
            torch.cuda.synchronize()
            return v, before_seal, served
        finally:
            await tst.shutdown("stcuda")

    v, before_seal, served = asyncio.run(go())
    assert v == 0 and before_seal >= 1
    assert served == [(k, True) for k in src]
    for k in src:
        assert torch.equal(targets[k], src[k].to(torch.bfloat16))


# --------------------------------------------------------------------------
# the device rung of direct sync: CUDA IPC between processes
# --------------------------------------------------------------------------


def _ipc_targets(tree, dtype, card=0):
    """Target specs: floating leaves in ``dtype``, the others in their own."""
    return {k: (tuple(v.shape), str(dtype if v.is_floating_point() else v.dtype)
                .removeprefix("torch."), card) for k, v in tree.items()}


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.cuda
def test_device_rung_cross_process_ipc_pull(cuda):
    """A source on the card and a dest in another process: the dest opens
    the staging block once over IPC and pulls twice (after a refresh of an
    in-place step), bit-equal to the bf16 cast each time; K1 casts the
    staging in place, one launch per planned chunk per publish."""
    import asyncio

    import test_torch_sp_worker as worker

    from torchstore_tpu_torch import direct_weight_sync as dws

    gen = torch.Generator(device=cuda).manual_seed(21)
    tree = {"w": torch.randn(1024, 257, generator=gen, device=cuda),
            "b": torch.randn(33, generator=gen, device=cuda),
            "steps": torch.arange(5, device=cuda)}

    async def run():
        source = dws.DirectWeightSyncSource()
        launched = staging.cast_kernel.launches
        await source.register(tree, transfer_dtype=torch.bfloat16)
        chunks = len(staging.plan_chunks([tree["w"], tree["b"]], torch.bfloat16))
        assert staging.cast_kernel.launches - launched == chunks
        assert source.device_info is not None and len(source._blocks) == 1
        dest = worker.IpcDest([source.device_info], _ipc_targets(tree, torch.bfloat16))
        try:
            for step in range(2):
                status, got, opens = await asyncio.to_thread(dest.pull)
                assert status == "ok", (got, opens)
                assert opens == 1  # the block, opened once for both pulls
                for k, v in tree.items():
                    want = v.to(torch.bfloat16) if v.is_floating_point() else v
                    np.testing.assert_array_equal(got[k], _bits(want), err_msg=k)
                for v in tree.values():
                    v.add_(1)
                launched = staging.cast_kernel.launches
                await source.refresh()
                assert staging.cast_kernel.launches - launched == chunks
        finally:
            dest.close()
            await source.close()

    asyncio.run(run())


@pytest.mark.cuda
def test_device_rung_pull_after_close_raises(cuda):
    """After the source closed, the dest's next pull raises KeyError before
    it touches the staging it still holds open (the source's memory stays
    allocated until the dest lets go)."""
    import asyncio

    import test_torch_sp_worker as worker

    from torchstore_tpu_torch import direct_weight_sync as dws

    tree = {"w": torch.arange(4096.0, device=cuda)}

    async def run():
        source = dws.DirectWeightSyncSource()
        await source.register(tree)
        dest = worker.IpcDest([source.device_info], _ipc_targets(tree, torch.float32))
        try:
            status, got, _ = await asyncio.to_thread(dest.pull)
            assert status == "ok"
            np.testing.assert_array_equal(got["w"], _bits(tree["w"]))
            await source.close()
            reply = await asyncio.to_thread(dest.pull)
            assert reply[:2] == ("error", "KeyError"), reply
        finally:
            dest.close()
            await source.close()

    asyncio.run(run())


@pytest.mark.cuda
def test_device_rung_leaves_on_two_cards(cuda):
    """Leaves on two cards: one staging block each, both opened over IPC by
    a dest whose targets are all on card 0."""
    import asyncio

    import test_torch_sp_worker as worker

    from torchstore_tpu_torch import direct_weight_sync as dws

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    gen = torch.Generator().manual_seed(22)
    tree = {"a": torch.randn(4096, generator=gen).to("cuda:0"),
            "b": torch.randn(512, 3, generator=gen).to("cuda:1")}

    async def run():
        source = dws.DirectWeightSyncSource()
        await source.register(tree, transfer_dtype=torch.bfloat16)
        assert len(source._blocks) == 2
        dest = worker.IpcDest([source.device_info], _ipc_targets(tree, torch.bfloat16))
        try:
            status, got, opens = await asyncio.to_thread(dest.pull)
            assert status == "ok" and opens == 2, (got, opens)
            for k, v in tree.items():
                np.testing.assert_array_equal(got[k], _bits(v.to(torch.bfloat16)), err_msg=k)
        finally:
            dest.close()
            await source.close()

    asyncio.run(run())
