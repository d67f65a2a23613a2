"""The stochastic GEMM's codes entries against the reference, bit for bit,
on the CPU.

Both kernels (``csrc/stoch_matmul.cu``'s codes form and the binary
tensor-core kernel of ``csrc/stoch_gemm_sm90.cu``) read int8 codes and
stage each as ``table[|c|]`` with sign ``c < 0 ? -1 : +1``, from
:func:`stream_table`: so the tables, and that staging rule over every
int8 code (-128 included), are held here against the reference's
``encode`` / ``encode_signed``.  ``bts_encode`` keeps the reference
Pallas kernel's answer at -128 (the full stream), held against that
kernel in interpret mode.  The entries themselves run their plain
versions on a CPU tensor (codes against streams: ``encode_signed`` then
``stoch_matmul_packed_ref``; codes against codes: the sign-plane product
``stoch_gemm_codes_ref``), held against the reference's ``stoch_matmul``
(the Pallas kernel in interpret mode) at ragged shapes under several
generator pairings, with no launch counted.  The kernels are held against
the same plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``; ``tests/test_torch_sc_pairs.py`` holds the sign-plane
arithmetic itself.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitstream as jbits  # noqa: E402
from repro.core.quant import QTensor as JaxQTensor  # noqa: E402
from repro.kernels.bts_encode.ops import bts_encode as jax_bts_encode  # noqa: E402
from repro.kernels.stoch_matmul.ops import stoch_matmul as jax_stoch_matmul  # noqa: E402
from repro_torch.core.bitstream import GENERATORS  # noqa: E402
from repro_torch.core.bitstream import popcount as bitstream_popcount  # noqa: E402
from repro_torch.core.ossm import WeightCodes  # noqa: E402
from repro_torch.core.quant import QTensor  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.bts_encode import bts_encode  # noqa: E402
from repro_torch.kernels.bts_encode.ref import bts_encode_ref  # noqa: E402
from repro_torch.kernels.stoch_matmul import ops as sm_ops  # noqa: E402

# x scale 1/128 and w scale 1: the reference's ((acc * 128) * xs) * ws is
# then the int32 accumulator itself, exactly, in float32
X_SCALE, W_SCALE = 1.0 / 128, 1.0


def _want(xq: np.ndarray, wq: np.ndarray, x_gen: str, w_gen: str) -> np.ndarray:
    """The reference's ``stoch_matmul`` of codes ``xq [M, K]`` and ``wq [K,
    N]`` (the Pallas kernel in interpret mode) as int32 accumulators."""
    out = jax_stoch_matmul(JaxQTensor(jnp.asarray(xq), jnp.float32(X_SCALE)),
                           JaxQTensor(jnp.asarray(wq), jnp.float32(W_SCALE)), x_gen, w_gen,
                           interpret=True)
    acc = np.asarray(out)
    assert (acc == np.round(acc)).all()
    return acc.astype(np.int32)


@pytest.mark.parametrize("gen", GENERATORS)
def test_stream_table_equals_reference_encode(gen):
    """Every magnitude 0..127 under each generator, then row 128: the
    reference's ``encode_signed`` of an int8 -128 (its magnitude wraps to
    -128 in int8: ``[1, 1, 1, 1]`` under bresenham, empty otherwise)."""
    table = sm_ops.stream_table(gen)
    assert table.dtype == torch.int32 and table.shape == (sm_ops.TABLE_LEN, 4) == (129, 4)
    want = np.asarray(jbits.encode(jnp.arange(128, dtype=jnp.int32), gen))
    np.testing.assert_array_equal(table[:128].numpy().view(np.uint32), want)
    jw, _ = jbits.encode_signed(jnp.asarray([-128], jnp.int8), gen)
    np.testing.assert_array_equal(table[128:].numpy().view(np.uint32), np.asarray(jw))
    assert table[128].tolist() == ([1] * 4 if gen == "bresenham" else [0] * 4)
    assert sm_ops.stream_table(gen) is table  # built once per device and generator


@pytest.mark.parametrize("gen", GENERATORS)
def test_table_staging_rule_equals_encode_signed(gen):
    """The kernel's staging of a code c, ``table[|c|]`` with sign ``c < 0 ?
    -1 : +1``: the reference's ``encode_signed`` over every int8 code
    (-128 included, which quantize never gives; zero: the empty stream,
    sign +1).  The port's ``bts_encode_ref`` agrees on every code quantize
    gives and keeps the Pallas kernel's full stream at -128."""
    codes = np.arange(-128, 128).astype(np.int8)
    q = torch.from_numpy(codes)
    words = sm_ops.stream_table(gen)[q.to(torch.int64).abs()]
    sign = torch.where(q < 0, -1, 1)
    jw, js = jbits.encode_signed(jnp.asarray(codes), gen)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(js))
    ref_w, ref_s = bts_encode_ref(q, gen)
    assert torch.equal(words[1:], ref_w[1:]) and torch.equal(sign.to(torch.int8), ref_s)
    assert ref_w[0].eq(-1).all()


@pytest.mark.parametrize("gen", GENERATORS)
def test_bts_encode_plain_version_equals_reference_kernel(gen):
    """The port's ``bts_encode`` on a CPU tensor (its plain version) over
    every int8 code, against the reference's ``bts_encode_kernel`` in
    interpret mode, which takes the magnitude in int32: -128 gets the full
    stream there (not what the reference's ``encode_signed`` gives)."""
    codes = np.arange(-128, 128).astype(np.int8).reshape(4, 64)
    jw, js = jax_bts_encode(jnp.asarray(codes), gen, interpret=True)
    before = launch_counts()
    words, sign = bts_encode(torch.from_numpy(codes), gen)
    assert launch_counts() == before
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(js))
    assert (np.asarray(jw)[0, 0] == 0xFFFFFFFF).all()


# ragged (M, K, N) under (x_gen, w_gen): one row, K past the kernel's
# 16-position step, N past a tile, every pairing's generator on each side
CODES_CASES = [((1, 17, 5), ("thermometer", "bresenham")), ((9, 40, 33), ("lfsr", "lfsr")),
               ((5, 33, 17), ("bresenham", "thermometer")), ((3, 16, 7), ("lfsr", "bresenham"))]


@pytest.mark.parametrize("mkn,gens", CODES_CASES, ids=[f"{m}x{k}x{n}-{x}-{w}"
                                                       for (m, k, n), (x, w) in CODES_CASES])
def test_codes_entry_equals_reference_stoch_matmul(rng, mkn, gens):
    """Activation codes against a weight's streams, and the dequantizing
    ``stoch_matmul`` (``astra_matmul``'s sc branch) over the weight's codes."""
    (m, k, n), (x_gen, w_gen) = mkn, gens
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xq.flat[:3] = [0, -127, 127]
    want = _want(xq, wq, x_gen, w_gen)
    words, sign = bts_encode_ref(torch.from_numpy(wq.T.copy()), w_gen)
    before = launch_counts()
    got = sm_ops.stoch_matmul_codes(torch.from_numpy(xq), words, sign, x_gen)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    deq = sm_ops.stoch_matmul(QTensor(torch.from_numpy(xq), torch.tensor(X_SCALE)),
                              WeightCodes(torch.from_numpy(wq.T.copy()),
                                          torch.full((1, n), W_SCALE), w_gen), x_gen)
    np.testing.assert_array_equal(deq.numpy(), want.astype(np.float32))
    assert launch_counts() == before  # the plain versions ran


@pytest.mark.parametrize("gens", [("thermometer", "bresenham"), ("lfsr", "thermometer")])
def test_codes_batched_entry_equals_reference_stoch_matmul(rng, gens):
    """Codes against codes, a batch of ragged products (``astra_batched_
    matmul``'s sc branch): each element equals the reference's product."""
    x_gen, w_gen = gens
    b, m, k, n = 3, 2, 20, 9
    xq = rng.integers(-127, 128, (b, m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (b, k, n)).astype(np.int8)
    before = launch_counts()
    got = sm_ops.stoch_matmul_codes_batched(torch.from_numpy(xq),
                                            torch.from_numpy(wq.transpose(0, 2, 1).copy()),
                                            x_gen, w_gen)
    assert got.dtype == torch.int32 and got.shape == (b, m, n)
    assert launch_counts() == before
    for i in range(b):
        np.testing.assert_array_equal(got[i].numpy(), _want(xq[i], wq[i], x_gen, w_gen))


def test_codes_entries_refuse_other_devices():
    q = torch.zeros(3, 4, dtype=torch.int8, device="meta")
    words = torch.zeros(5, 4, 4, dtype=torch.int32, device="meta")
    sign = torch.zeros(5, 4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sm_ops.stoch_matmul_codes(q, words, sign)
    with pytest.raises(ValueError, match="CUDA"):
        sm_ops.stoch_matmul_codes_batched(q[None], q[None])
    with pytest.raises(ValueError, match="CUDA"):
        sm_ops.stoch_gemm_codes(q, q)
    with pytest.raises(ValueError, match="CUDA"):  # codes on the CPU, streams elsewhere
        sm_ops.stoch_matmul_codes(torch.zeros(3, 4, dtype=torch.int8), words, sign)


def test_thermometer_bresenham_popcount_is_rounded_product():
    """Under thermometer x bresenham, a stream pair's popcount is a
    function of the two magnitudes alone, ``(m_x * m_w + 64) >> 7``, for
    all 128 x 128 pairs: a product table could stand in for the streams."""
    mags = torch.arange(128)
    x = sm_ops.stream_table("thermometer")[mags][:, None]
    w = sm_ops.stream_table("bresenham")[mags][None, :]
    pc = bitstream_popcount(x & w)
    want = (mags[:, None] * mags[None, :] + 64) >> 7
    assert torch.equal(pc.long(), want)
    jx = jbits.encode(jnp.arange(128, dtype=jnp.int32), "thermometer")[:, None]
    jw = jbits.encode(jnp.arange(128, dtype=jnp.int32), "bresenham")[None, :]
    np.testing.assert_array_equal(np.asarray(jbits.popcount(jx & jw)), want.numpy())
