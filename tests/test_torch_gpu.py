"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  They import no JAX; ``--noconftest`` keeps pytest from
loading ``tests/conftest.py``, which does, so they run on a GPU machine
without JAX:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: int8 accumulators (one product on each of its three kernels,
or a batch on each of its three), stream words,
signs and stochastic accumulators (packed operands, activation codes
against streams, and codes against codes on the binary tensor-core
kernels, both of them, under all 9 generator pairings) bit-exact; paged attention float32
1e-5 (same math, keys streamed in chunks with rescaling), bf16 2e-2 (the
kernel rounds p to bf16 before the PV product, like the reference
kernel; the plain version keeps p in float32); on int8 pools float32
1e-5 (both sides compute in float32; the kernel scales each score and
output once where the plain version scales each code); decode on both
layouts is split over the keys and the splits merged in float32, and a
bf16 output adds one rounding, within 2e-2 on these O(1) outputs; flash
attention float32 1e-5,
bf16 4e-3 + 2^-7 |want| per element (its plain version rounds p to bf16
too, but against each row's final max where the kernel uses its running
max, and both round the output to bf16: one output ulp, 2^-7 of |want| at
most, on top of a small drift); the linear-recurrence scan rtol = atol =
2e-5, the reference kernel test's (the kernel folds carries across
chunks of the sequence and nvcc contracts ``a * h + b`` into one FMA;
the plain loop runs in order and rounds twice).  The attention kernels are held at
every head dim they are built for (16, 64, 128, 256).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bitstream import GENERATORS, encode_signed  # noqa: E402
from repro_torch.kernels.bts_encode import bts_encode  # noqa: E402
from repro_torch.kernels.bts_encode.ref import bts_encode_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as int8_ops  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    dense_decode_ref, paged_decode_ref, paged_prefill_ref,
)
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.stoch_matmul import ops as sm_ops  # noqa: E402
from repro_torch.kernels.stoch_matmul.ref import stoch_matmul_packed_ref  # noqa: E402


def _paged_inputs(rng, b, kvh, g, hd, bs, w, n_blocks):
    q = rng.standard_normal((b, kvh * g, hd)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, kvh, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, kvh, bs, hd)).astype(np.float32)
    table = rng.integers(1, n_blocks, (b, w)).astype(np.int32)
    table[0, -1] = 0  # an entry at scratch block 0
    return q, kp, vp, table


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,path", [
    (8, 2048, 2048, "stream"), (8, 5632, 2048, "stream"), (37, 320, 200, "wgmma"),
    (257, 2048, 5632, "wgmma"), (5, 100, 33, "mma"), (70, 1000, 129, "mma"),
    # each path's edges: one activation row, 16 (two n8 tiles), 17 (the
    # wgmma path on a split K), N past a tile, K past a step, few weight
    # rows with long K (the stream kernel's warps split it), ragged M with
    # unsplit K, the lm_head
    (1, 2048, 2048, "stream"), (16, 2048, 2048, "stream"), (17, 2048, 2048, "wgmma"),
    (8, 2048, 129, "stream"), (8, 2064, 2048, "stream"), (3, 16, 5, "stream"),
    (12, 9600, 40, "stream"), (8, 15360, 64, "stream"), (16, 12288, 40, "stream"),
    (12, 4608, 17000, "stream"), (1531, 2064, 129, "wgmma"),
    (1531, 2048, 2048, "wgmma"),
    (8, 2048, 100352, "stream"), (16, 100, 40, "mma"), (300, 17, 300, "mma")])
def test_int8_kernel_bit_exact_on_card(cuda, m, k, n, path):
    """One product on the kernel :func:`int8_gemm_plan` picks, twice in a
    row: int32 accumulators equal the plain version's, and that kernel's
    counter moved by two."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    w_t = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    want = int8_matmul_acc_ref(x, w_t)
    before = dict(int8_ops.int8_gemm.paths)
    for _ in range(2):
        assert torch.equal(int8_ops.int8_gemm(x, w_t), want)
    moved = {p: c - before[p] for p, c in int8_ops.int8_gemm.paths.items() if c != before[p]}
    assert moved == {path: 2}, moved


# causal prefill cases: suffix lengths (one row, fold boundaries inside a
# 64-row tile, one row past a tile) x softcap 0 / 30; block sizes 8, 12
# (not a multiple of 8), 16 (the serving pool's) and 128 (a key tile
# inside one block)
PREFILL_LENS = (1, 37, 65)
BLOCK_SIZES = (8, 12, 16, 128)


def _starts(bs):
    """Suffix starts: 0, mid-block, on a block edge, past one, two blocks in."""
    return np.asarray([0, bs // 2, bs, bs + 7, 2 * bs], np.int32)


def _check_prefill(cuda, q_shape, kp, vp, table, start, dtype, tol, scales=()):
    """paged_attention_prefill against its plain version at every suffix
    length and softcap: one launch each, counted (and counted on the int8
    branch for an int8 pool), the output in the query dtype."""
    rng = np.random.default_rng(3)
    fn = pa_ops.paged_attention_prefill
    for s in PREFILL_LENS:
        for softcap in (0.0, 30.0):
            q = torch.from_numpy(rng.standard_normal((*q_shape[:2], s, q_shape[2]))
                                 .astype(np.float32)).to(cuda, dtype)
            before = (fn.launches, fn.int8_launches)
            got = fn(q, kp, vp, table, start, *scales, softcap=softcap)
            int8 = int(kp.dtype == torch.int8)
            assert (fn.launches, fn.int8_launches) == (before[0] + 1, before[1] + int8)
            assert got.dtype == dtype and got.shape == q.shape
            kw = dict(zip(("k_scale", "v_scale"), scales))
            want = paged_prefill_ref(q, kp, vp, table, start, softcap=softcap, **kw)
            torch.testing.assert_close(got.float(), want, atol=tol, rtol=0,
                                       msg=lambda m: f"S={s} softcap={softcap}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4, 10])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_paged_kernels_match_plain_on_card(cuda, dtype, g, hd, bs):
    """Paged decode (ragged fills, kv_len 0) and causal prefill (starts 0,
    mid-block, on and past a block edge; S 1 / 37 / 65; softcap 0 / 30)
    through a table with an entry at scratch block 0."""
    kvh = 4
    w = -(-(2 * bs + max(PREFILL_LENS)) // bs) + 1
    rng = np.random.default_rng(0)
    kv_len = np.asarray([0, 1, bs, bs + 1, w * bs], np.int32)
    q, kp, vp, table = _paged_inputs(rng, 5, kvh, g, hd, bs, w, 5 * w + 1)
    tq, tk, tv = (x.to(cuda, dtype) for x in _t(q, kp, vp))
    tt, tl, ts = (x.to(cuda) for x in _t(table, kv_len, _starts(bs)))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    got = pa_ops.paged_attention_decode(tq, tk, tv, tt, tl).float()
    want = paged_decode_ref(tq, tk, tv, tt, tl)
    torch.testing.assert_close(got, want, atol=tol, rtol=0)
    _check_prefill(cuda, (5, kvh * g, hd), tk, tv, tt, ts, dtype, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 4, 10])
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_int8_pool_kernels_match_plain_on_card(cuda, hd, g, bs):
    """The int8-pool branch, decode and causal: ragged fills, kv_len 0
    (zeros), the prefill cases of the bf16/float32 test; both counters
    count each launch."""
    kvh = 4
    w = -(-(2 * bs + max(PREFILL_LENS)) // bs) + 1
    rng = np.random.default_rng(1)
    kv_len = np.asarray([0, 1, bs - 1, bs + 1, 3 * bs + 7, w * bs], np.int32)
    table = rng.integers(1, 6 * w + 1, (6, w)).astype(np.int32)
    table[1, 0] = 0  # an entry at scratch block 0
    q = rng.standard_normal((6, kvh * g, hd)).astype(np.float32)
    kp, vp = (rng.integers(-127, 128, (6 * w + 1, kvh, bs, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.03, kvh).astype(np.float32) for _ in range(2))
    tq, tk, tv, tt, tl, tks, tvs = (x.to(cuda) for x in _t(q, kp, vp, table, kv_len, ks, vs))
    before = pa_ops.paged_attention_decode.int8_launches
    got = pa_ops.paged_attention_decode(tq, tk, tv, tt, tl, tks, tvs)
    want = paged_decode_ref(tq, tk, tv, tt, tl, k_scale=tks, v_scale=tvs)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert not got[0].any()  # kv_len 0 -> zeros
    assert pa_ops.paged_attention_decode.int8_launches == before + 1
    ts = torch.from_numpy(np.append(_starts(bs), 0)).to(cuda)
    _check_prefill(cuda, (6, kvh * g, hd), tk, tv, tt, ts, torch.float32, 1e-5, (tks, tvs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("g,s,window,softcap", [(1, 100, 0, 0.0), (2, 70, 24, 0.0),
                                                (4, 37, 0, 30.0), (3, 130, 16, 5.0),
                                                (3, 50, 40, 0.0), (1, 200, 64, 0.0),
                                                (2, 129, 0, 20.0), (5, 77, 33, 3.0)])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, hd, g, s, window, softcap):
    """Causal flash attention: GQA folds that straddle the 64-row tile
    (fold boundaries inside a tile: 3 x 50, 5 x 77 rows), windows whose
    edge falls inside a 64-key tile (16, 24, 33, 40) or on one (64),
    softcap, S not a multiple of the tiles (37 .. 200, one key past two
    tiles at 129); one launch counted."""
    rng = np.random.default_rng(2)
    kvh = 2
    q = rng.standard_normal((2, kvh * g, s, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, kvh, s, hd)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (x.to(cuda, dtype) for x in _t(q, k, v))
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, window=window, softcap=softcap)
    assert fa_ops.flash_attention.launches == before + 1 and got.dtype == dtype
    want = flash_attention_ref(tq, tk, tv, causal=True, window=window, softcap=softcap)
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (4e-3, 2.0 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("window", [0, 40])
def test_flash_kernel_non_causal_on_card(cuda, dtype, hd, window):
    """Non-causal flash attention over whole reference key tiles (Sk 128,
    50 queries, G 2), with and without a window; one launch counted."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 50, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 128, hd)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (x.to(cuda, dtype) for x in _t(q, k, v))
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(tq, tk, tv, causal=False, window=window)
    assert fa_ops.flash_attention.launches == before + 1
    want = flash_attention_ref(tq, tk, tv, causal=False, window=window)
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (4e-3, 2.0 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("g", [1, 10])
@pytest.mark.parametrize("kvh,s,fills,split", [
    (1, 2048, (0, 1, 15, 16, 17, 270, 2047, 2048), True),
    (32, 512, (0, 1, 15, 16, 17, 130, 270, 511, 512), False),
], ids=["split", "one_split"])
def test_dense_decode_splits_on_card(cuda, dtype, hd, g, kvh, s, fills, split):
    """Dense decode split over the cache.  8 slots over one KV head of a
    2048-position cache take many splits, and fills 0, 1, 15, 16, 17, 270,
    2047 and 2048 leave splits empty or cut a chunk at its edge; 9 slots x
    32 KV heads over 512 positions fill the card with one split per cache,
    merged all the same.  Softcap; q in the cache dtype, so the merge
    writes it.  One launch counted per call."""
    rng = np.random.default_rng(5)
    kv_len = np.asarray(fills, np.int32)
    b = kv_len.size
    q = rng.standard_normal((b, kvh * g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, kvh, s, hd)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (x.to(cuda, dtype) for x in _t(q, k, v))
    tl = _t(kv_len)[0].to(cuda)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert (pa_ops.decode_split_plan(b, kvh, s, n_sm) > 1) == split
    before = pa_ops.dense_attention_decode.launches
    got = pa_ops.dense_attention_decode(tq, tk, tv, tl, softcap=5.0)
    assert pa_ops.dense_attention_decode.launches == before + 1
    assert got.dtype == dtype and not got[0].any()
    want = dense_decode_ref(tq, tk, tv, tl, softcap=5.0)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("pool,qdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.int8, torch.float32), (torch.int8, torch.bfloat16)])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("g", [1, 10])
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_paged_decode_splits_on_card(cuda, pool, qdt, hd, g, bs):
    """Paged decode split over the table's keys.  8 slots over one KV head
    of a 1536-position table take many splits, and fills 0, 1, 15, 16, 17,
    270, 1535 and 1536 leave splits empty, cut a chunk at its edge and, at
    block sizes 12 and 128, start splits inside a pool block; table entries
    at scratch block 0; softcap.  The merge writes the query dtype (bf16
    queries on an int8 pool too); one launch counted per call, and on the
    int8 branch for an int8 pool."""
    rng = np.random.default_rng(6)
    s = 1536
    w = s // bs
    kv_len = np.asarray([0, 1, 15, 16, 17, 270, s - 1, s], np.int32)
    b = kv_len.size
    table = (rng.permutation(b * w).reshape(b, w) + 1).astype(np.int32)
    table[1, 0] = 0  # entries at scratch block 0
    table[7, w // 2] = 0
    shape = (b * w + 1, 1, bs, hd)
    if pool == torch.int8:
        kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        scales = [x.to(cuda) for x in _t(*(rng.uniform(0.005, 0.03, 1).astype(np.float32)
                                           for _ in range(2)))]
    else:
        kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        scales = []
    q = rng.standard_normal((b, g, hd)).astype(np.float32)
    tk, tv = (x.to(cuda, pool) for x in _t(kp, vp))
    tq = _t(q)[0].to(cuda, qdt)
    tt, tl = (x.to(cuda) for x in _t(table, kv_len))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert pa_ops.decode_split_plan(b, 1, s, n_sm) > 1
    fn = pa_ops.paged_attention_decode
    before = (fn.launches, fn.int8_launches)
    got = fn(tq, tk, tv, tt, tl, *scales, softcap=5.0)
    assert (fn.launches, fn.int8_launches) == (before[0] + 1,
                                               before[1] + int(pool == torch.int8))
    assert got.dtype == qdt and got.shape == tq.shape and not got[0].any()
    kw = dict(zip(("k_scale", "v_scale"), scales))
    want = paged_decode_ref(tq, tk, tv, tt, tl, softcap=5.0, **kw)
    tol = 1e-5 if qdt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,g", [(16, 1), (16, 4), (64, 1), (64, 2), (128, 1), (128, 4),
                                  (128, 10), (256, 1), (256, 10)])
def test_dense_decode_kernel_matches_plain_on_card(cuda, dtype, hd, g):
    """Dense decode over S = 100 positions: kv_len 0 (zeros), 1, ragged,
    a full 64-key chunk, S; q cast to the cache dtype; one launch."""
    rng = np.random.default_rng(3)
    kvh, s = 2, 100
    kv_len = np.asarray([0, 1, 37, 64, 65, s], np.int32)
    q = rng.standard_normal((6, kvh * g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((6, kvh, s, hd)).astype(np.float32) for _ in range(2))
    tk, tv = (x.to(cuda, dtype) for x in _t(k, v))
    tq, tl = (x.to(cuda) for x in _t(q, kv_len))
    before = pa_ops.dense_attention_decode.launches
    got = pa_ops.dense_attention_decode(tq, tk, tv, tl, softcap=5.0)
    assert pa_ops.dense_attention_decode.launches == before + 1
    assert got.dtype == torch.float32 and not got[0].any()
    want = dense_decode_ref(tq.to(dtype), tk, tv, tl, softcap=5.0)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", [(2, 64, 16), (3, 100, 8), (1, 16, 4), (5, 37, 130),
                                   (8, 256, 2560), (2, 1, 300), (3, 37, 130), (8, 2048, 2560),
                                   (2, 33, 7), (1, 4096, 64)])
def test_rglru_scan_kernel_matches_plain_on_card(cuda, b, s, d):
    """Ragged B, S and D (no padding); S below one 32-step chunk, past it
    by one and ragged, the serving admission and a full window; D % 4 !=
    0 (the 4-byte copies); one launch counted, at its length too, float32
    out."""
    g = torch.Generator(device=cuda).manual_seed(4)
    a = torch.rand(b, s, d, generator=g, device=cuda) * 0.799 + 0.2
    x = torch.randn(b, s, d, generator=g, device=cuda)
    before, at_s = rg_ops.rglru_scan.launches, rg_ops.rglru_scan.lengths[s]
    got = rg_ops.rglru_scan(a, x)
    assert rg_ops.rglru_scan.launches == before + 1 and got.dtype == torch.float32
    assert rg_ops.rglru_scan.lengths[s] == at_s + 1
    torch.testing.assert_close(got, rglru_scan_ref(a, x), atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,m,k,n,path", [
    (256, 1, 64, 512, "stream"), (256, 1, 512, 64, "stream"), (64, 37, 64, 130, "tiles"),
    (3, 5, 100, 33, "mma"), (128, 160, 64, 176, "tiles"), (128, 160, 176, 64, "tiles"),
    # the tiles kernel's edges: M one past 16 and past an m16 pair, N of one
    # column and N % 4 != 0 (4-byte stores), N cut into two and three
    # tiles, K at 4096 in stages and past it (mma.sync), a long M
    (4, 17, 64, 1, "tiles"), (3, 45, 96, 33, "tiles"), (2, 33, 4096, 257, "tiles"),
    (2, 300, 64, 513, "tiles"), (2, 40, 4112, 64, "mma"), (1, 1531, 128, 384, "tiles"),
    # the stream kernel's edges: M 1 / 3 / 16 (one and two n8 tiles), K
    # 64 / 512 and one 16-byte chunk past a 64-byte step, N ragged and
    # past a chunk of weight rows (two stages in flight)
    (5, 1, 64, 5, "stream"), (4, 3, 512, 513, "stream"), (3, 16, 512, 512, "stream"),
    (3, 16, 80, 5, "stream"), (2, 9, 4096, 40, "stream"), (2, 1, 100, 512, "mma")])
def test_int8_batched_kernel_bit_exact_on_card(cuda, b, m, k, n, path):
    """The batch on the kernel :func:`int8_batched_plan` picks: int32
    accumulators equal the plain version's, that kernel's counter moved;
    -128 among the codes."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randint(-127, 128, (b, m, k), generator=g, device=cuda, dtype=torch.int8)
    w_t = torch.randint(-127, 128, (b, n, k), generator=g, device=cuda, dtype=torch.int8)
    x[0, 0], w_t[0, 0] = -128, -128
    fn = int8_ops.int8_gemm_batched
    before = dict(fn.paths)
    assert torch.equal(fn(x, w_t), int8_matmul_acc_ref(x, w_t))
    assert {p: c - before[p] for p, c in fn.paths.items() if c != before[p]} == {path: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(255,), (256,), (37, 50), (2048, 5632)])
@pytest.mark.parametrize("gen", GENERATORS)
def test_bts_encode_kernel_bit_exact_on_card(cuda, gen, shape):
    """(256,): every int8 code, -128 with the Pallas encoder's full stream."""
    q = torch.arange(-128 if shape == (256,) else -127, 128, device=cuda).to(torch.int8)
    if len(shape) > 1:
        g = torch.Generator(device=cuda).manual_seed(2)
        q = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
    words, sign = bts_encode(q, gen)
    want_w, want_s = bts_encode_ref(q, gen)
    assert torch.equal(words, want_w) and torch.equal(sign, want_s)


def _streams(cuda, lead, rows, k, gen, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randint(-127, 128, (*lead, rows, k), generator=g, device=cuda, dtype=torch.int8)
    return bts_encode_ref(q, gen)


@pytest.mark.gpu
@pytest.mark.parametrize("lead,m,k,n", [((), 8, 2048, 2048), ((), 8, 5632, 2048),
                                        ((), 5, 100, 33), ((), 70, 1000, 129),
                                        ((), 384, 2048, 5632), ((4,), 3, 64, 40)])
def test_stoch_matmul_kernel_bit_exact_on_card(cuda, lead, m, k, n):
    xs, sx = _streams(cuda, lead, m, k, "thermometer", 3)
    ws, sw = _streams(cuda, lead, n, k, "bresenham", 4)
    got = sm_ops.stoch_matmul_packed(xs, sx, ws, sw)
    assert torch.equal(got, stoch_matmul_packed_ref(xs, sx, ws, sw))


PAIRS = [(x, w) for x in GENERATORS for w in GENERATORS]


@pytest.mark.gpu
@pytest.mark.parametrize("x_gen,w_gen", PAIRS)
@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (5, 100, 33), (70, 1000, 129), (1, 17, 5)])
def test_stoch_codes_kernel_bit_exact_on_card(cuda, x_gen, w_gen, m, k, n):
    """Activation codes against a weight's streams: int32 accumulators
    equal ``bts_encode_ref`` then the packed plain version's, every code
    -127..127 among the activations; one launch counted."""
    g = torch.Generator(device=cuda).manual_seed(5)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    xq.view(-1)[:min(255, m * k)] = torch.arange(-127, 128, device=cuda,
                                                 dtype=torch.int8)[:min(255, m * k)]
    ws, sw = _streams(cuda, (), n, k, w_gen, 6)
    fn = sm_ops.stoch_matmul_codes
    before = fn.launches
    got = fn(xq, ws, sw, x_gen)
    assert fn.launches == before + 1
    xs, sx = bts_encode_ref(xq, x_gen)
    assert torch.equal(got, stoch_matmul_packed_ref(xs, sx, ws, sw))


def _all_codes(cuda, rows, k, seed):
    """Random int8 codes, rows 0 and 1 every code -128..127 (in turn)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randint(-127, 128, (rows, k), generator=g, device=cuda, dtype=torch.int8)
    every = torch.arange(-128, 128, device=cuda).to(torch.int8).repeat(-(-k // 256))[:k]
    q[0] = every
    if rows > 1:
        q[1] = every.flip(0)
    return q


# (M, K, N, kernel): ragged edges of both binary kernels (one row; 16 rows;
# K off the 16-code and 4-code paths; N off an n8 group and a tile; the
# smallest wgmma M; a K split) under every pairing, then the serving shapes
# (decode at 8 slots, the sc admission's 640 rows) under one pairing each
GEMM_EDGES = [(1, 17, 5, "stream"), (16, 130, 47, "stream"), (8, 256, 33, "stream"),
              (17, 64, 16, "wgmma"), (200, 2056, 300, "wgmma"), (40, 255, 9, "wgmma")]
GEMM_SERVING = [(8, 2048, 2048, "stream"), (8, 5632, 2048, "stream"), (8, 2048, 5632, "stream"),
                (640, 2048, 5632, "wgmma"), (640, 5632, 2048, "wgmma")]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,kernel,x_gen,w_gen",
                         [(*e, *p) for e in GEMM_EDGES for p in PAIRS]
                         + [(*e, *PAIRS[i]) for i, e in enumerate(GEMM_SERVING)])
def test_stoch_gemm_codes_kernel_bit_exact_on_card(cuda, m, k, n, kernel, x_gen, w_gen):
    """Codes against codes on the binary tensor cores: int32 accumulators
    equal both operands' ``encode_signed`` (the reference's staging: -128
    wraps) then the packed plain version's, every int8 code on both sides;
    the kernel the plan picks is the one counted."""
    xq, wq = _all_codes(cuda, m, k, 11), _all_codes(cuda, n, k, 12)
    fn = sm_ops.stoch_gemm_codes
    assert sm_ops.stoch_gemm_plan(m, n, k, torch.cuda.get_device_properties(
        cuda).multi_processor_count)[0] == kernel
    before = dict(fn.paths)
    got = fn(xq, wq, x_gen, w_gen)
    assert {p: c - before[p] for p, c in fn.paths.items() if c != before[p]} == {kernel: 1}
    (xs, sx), (ws, sw) = encode_signed(xq, x_gen), encode_signed(wq, w_gen)
    assert torch.equal(got, stoch_matmul_packed_ref(xs, sx.to(torch.int8), ws,
                                                    sw.to(torch.int8)))


@pytest.mark.gpu
@pytest.mark.parametrize("x_gen,w_gen", PAIRS)
@pytest.mark.parametrize("b,m,k,n", [(256, 1, 64, 512), (3, 70, 40, 9), (128, 160, 64, 176)])
def test_stoch_codes_batched_kernel_bit_exact_on_card(cuda, x_gen, w_gen, b, m, k, n):
    """Codes against codes, a batch: int32 accumulators equal both
    operands' ``bts_encode_ref`` then the packed plain version's."""
    g = torch.Generator(device=cuda).manual_seed(7)
    xq = torch.randint(-127, 128, (b, m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (b, n, k), generator=g, device=cuda, dtype=torch.int8)
    fn = sm_ops.stoch_matmul_codes_batched
    before = fn.launches
    got = fn(xq, wq, x_gen, w_gen)
    assert fn.launches == before + 1
    xs, sx = bts_encode_ref(xq, x_gen)
    ws, sw = bts_encode_ref(wq, w_gen)
    assert torch.equal(got, stoch_matmul_packed_ref(xs, sx, ws, sw))
