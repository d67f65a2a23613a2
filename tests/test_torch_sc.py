"""The port's stochastic mode (``sc``) and quantized dynamic sites against
the reference, bit for bit, on the CPU.

* ``core.bitstream`` — every generator, every magnitude 0..127, several
  phases: bits, packed words (the port's int32 words viewed as uint32),
  unpacking, popcounts and signed encoding equal the reference's.
* ``core.ossm`` — ``ossm_multiply``, ``sc_dot`` and ``sc_matmul_value``
  for every generator pairing: identical integers and float32 values.
* ``kernels.bts_encode`` / ``kernels.stoch_matmul`` — the wrappers (their
  plain versions on a CPU tensor) against the reference's Pallas kernels
  in interpret mode, as ``tests/test_kernels.py`` runs them, at ragged
  shapes of at most 64 per side.
* ``astra_matmul`` under ``sc`` (every pairing, cached streams or not,
  static activation scale) and ``astra_batched_matmul`` under ``int8`` and
  ``sc``: identical float32 outputs.
* ``prepare_params`` caches each ``sc`` weight's codes once (tagged with
  the site's ``w_gen``), exactly what the call would quantize.

The CUDA kernels are held against the same plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitstream as jbits  # noqa: E402
from repro.core import ossm as jossm  # noqa: E402
from repro.core.astra_layer import ComputeConfig as JaxCC  # noqa: E402
from repro.core.astra_layer import astra_batched_matmul as jax_batched  # noqa: E402
from repro.core.astra_layer import astra_matmul as jax_astra_matmul  # noqa: E402
from repro.core.quant import QTensor as JaxQTensor  # noqa: E402
from repro.core.quant import quantize as jax_quantize  # noqa: E402
from repro.kernels.bts_encode.ops import bts_encode as jax_bts_encode  # noqa: E402
from repro.kernels.stoch_matmul.ops import stoch_matmul as jax_stoch_matmul  # noqa: E402
from repro.kernels.stoch_matmul.ops import (  # noqa: E402
    stoch_matmul_packed as jax_stoch_matmul_packed,
)
from repro.kernels.stoch_matmul.ref import encode_operands as jax_encode_operands  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import bitstream, ossm  # noqa: E402
from repro_torch.core.astra_layer import (  # noqa: E402
    ComputeConfig, astra_batched_matmul, astra_matmul, sc_weight_t,
)
from repro_torch.core.quant import QTensor, quantize  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.bts_encode import bts_encode  # noqa: E402
from repro_torch.kernels.stoch_matmul import ops as sm_ops  # noqa: E402
from repro_torch.kernels.stoch_matmul.ref import (  # noqa: E402
    encode_operands, stoch_matmul_packed_ref, stoch_matmul_ref,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402

GENS = bitstream.GENERATORS
PAIRS = list(itertools.product(GENS, GENS))
MAGS = np.arange(128, dtype=np.int32)
CODES = np.arange(-127, 128, dtype=np.int8)


def _u32(words: torch.Tensor) -> np.ndarray:
    """The port's int32 words as the reference's uint32 array."""
    assert words.dtype == torch.int32
    return words.numpy().view(np.uint32)


def _i32(words) -> torch.Tensor:
    """The reference's uint32 words as the port's int32 tensor."""
    return torch.from_numpy(np.array(words).view(np.int32))


def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def test_constants_copied_from_reference():
    assert bitstream.LFSR_ORDER == jbits.LFSR_ORDER
    assert sorted(bitstream.LFSR_ORDER) == list(range(128))
    assert (bitstream.STREAM_LEN, bitstream.N_WORDS) == (jbits.STREAM_LEN, jbits.N_WORDS)
    assert (ossm.X_GEN, ossm.W_GEN) == (jossm.X_GEN, jossm.W_GEN)


@pytest.mark.parametrize("phase", [0, 1, 37, 127])
@pytest.mark.parametrize("gen", GENS)
def test_stream_bits_and_words_bit_identical(gen, phase):
    bits = bitstream.stream_bits(torch.from_numpy(MAGS), gen, phase)
    want = np.asarray(jbits.stream_bits(jnp.asarray(MAGS), gen, phase))
    np.testing.assert_array_equal(bits.numpy(), want)
    assert (bits.sum(-1).numpy() == MAGS).all()  # exactly m ones, whatever the placement
    words = bitstream.encode(torch.from_numpy(MAGS), gen, phase)
    jwords = np.asarray(jbits.encode(jnp.asarray(MAGS), gen, phase))
    np.testing.assert_array_equal(_u32(words), jwords)
    np.testing.assert_array_equal(bitstream.unpack_bits(words).numpy(), want)
    np.testing.assert_array_equal(bitstream.popcount(words).numpy(),
                                  np.asarray(jbits.popcount(jnp.asarray(jwords))))


@pytest.mark.parametrize("gen", GENS)
def test_encode_signed_bit_identical(gen):
    words, sign = bitstream.encode_signed(torch.from_numpy(CODES), gen)
    jw, js = jbits.encode_signed(jnp.asarray(CODES), gen)
    np.testing.assert_array_equal(_u32(words), np.asarray(jw))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(js))
    assert sign[CODES == 0].tolist() == [1]  # zero: sign +1, empty stream
    assert not words[CODES == 0].any()


@pytest.mark.parametrize("gen", GENS)
def test_encode_signed_minus_128_bit_identical(gen):
    """int8 -128, which quantize never gives: the reference's ``jnp.abs``
    wraps it to -128, and the generator's formula then gives bresenham
    ``[1, 1, 1, 1]`` and thermometer / lfsr the empty stream, sign -1; the
    port follows the same arithmetic."""
    q = np.array([-128, -127, 0, 127], np.int8)
    words, sign = bitstream.encode_signed(torch.from_numpy(q), gen)
    jw, js = jbits.encode_signed(jnp.asarray(q), gen)
    np.testing.assert_array_equal(_u32(words), np.asarray(jw))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(js))
    assert _u32(words)[0].tolist() == ([1] * 4 if gen == "bresenham" else [0] * 4)
    assert sign[0] == -1


def test_pack_bits_and_popcount_match_reference(rng):
    bits = rng.integers(0, 2, (6, 5, 128)).astype(np.int32)
    words = bitstream.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(words), np.asarray(jbits.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(bitstream.unpack_bits(words).numpy(), bits)
    np.testing.assert_array_equal(bitstream.popcount(words).numpy(), bits.sum(-1))
    edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    np.testing.assert_array_equal(
        bitstream.popcount_words(_i32(edge)).numpy(), [0, 1, 31, 1, 32])


@pytest.mark.parametrize("x_gen,w_gen", PAIRS)
def test_ossm_multiply_and_dot_bit_identical(x_gen, w_gen):
    qx, qw = CODES[:, None], CODES[None, ::7]
    got = ossm.ossm_multiply(torch.from_numpy(qx), torch.from_numpy(qw), x_gen, w_gen)
    want = jossm.ossm_multiply(jnp.asarray(qx), jnp.asarray(qw), x_gen, w_gen)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a, b = CODES[None, ::3], CODES[::-3][None].copy()
    np.testing.assert_array_equal(
        ossm.sc_dot(torch.from_numpy(a), torch.from_numpy(b), x_gen, w_gen).numpy(),
        np.asarray(jossm.sc_dot(jnp.asarray(a), jnp.asarray(b), x_gen, w_gen)))
    np.testing.assert_array_equal(
        ossm.ossm_expected(torch.from_numpy(qx), torch.from_numpy(qw)).numpy(),
        np.asarray(jossm.ossm_expected(jnp.asarray(qx), jnp.asarray(qw))))


@pytest.mark.parametrize("x_gen,w_gen", PAIRS)
def test_sc_matmul_value_bit_identical(rng, x_gen, w_gen):
    x = rng.standard_normal((6, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) / 5).astype(np.float32)
    jxq, jwq = jax_quantize(jnp.asarray(x)), jax_quantize(jnp.asarray(w), axis=0)
    txq, twq = quantize(torch.from_numpy(x)), quantize(torch.from_numpy(w), axis=0)
    want = np.asarray(jossm.sc_matmul_value(jxq, jwq, x_gen, w_gen))
    np.testing.assert_array_equal(ossm.sc_matmul_value(txq, twq, x_gen, w_gen).numpy(), want)
    np.testing.assert_array_equal(stoch_matmul_ref(txq, twq, x_gen, w_gen).numpy(), want)


@pytest.mark.parametrize("shape", [(37, 50), (64, 64), (1, 3)])
@pytest.mark.parametrize("gen", GENS)
def test_bts_encode_matches_reference_kernel(rng, gen, shape):
    q = _codes(rng, shape)
    q.flat[: min(q.size, 3)] = [0, -127, 127][: min(q.size, 3)]
    jw, js = jax_bts_encode(jnp.asarray(q), gen, interpret=True)
    before = launch_counts()["bts_encode"]
    words, sign = bts_encode(torch.from_numpy(q), gen)
    assert (words.dtype, sign.dtype) == (torch.int32, torch.int8)
    np.testing.assert_array_equal(_u32(words), np.asarray(jw))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(js))
    assert launch_counts()["bts_encode"] == before  # the plain version ran


@pytest.mark.parametrize("m,k,n", [(5, 33, 17), (40, 64, 50), (8, 64, 64), (1, 7, 3)])
def test_stoch_matmul_packed_matches_reference_kernel(rng, m, k, n):
    xq, wq = _codes(rng, (m, k)), _codes(rng, (k, n))
    xs, sx, ws, sw = jax_encode_operands(jnp.asarray(xq), jnp.asarray(wq))
    want = np.asarray(jax_stoch_matmul_packed(xs, sx, ws, sw, interpret=True))
    txs, tsx, tws, tsw = encode_operands(torch.from_numpy(xq), torch.from_numpy(wq))
    np.testing.assert_array_equal(_u32(txs), np.asarray(xs))
    np.testing.assert_array_equal(_u32(tws), np.asarray(ws))
    before = launch_counts()["stoch_matmul_packed"]
    got = sm_ops.stoch_matmul_packed(txs, tsx, tws, tsw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert launch_counts()["stoch_matmul_packed"] == before


def test_stoch_matmul_packed_batched_and_chunked(rng, monkeypatch):
    """A leading batch runs each product on its own; the plain version's
    walk over N in chunks gives the same integers as one step."""
    from repro_torch.kernels.stoch_matmul import ref as sm_ref

    xq, wq = _codes(rng, (3, 6, 20)), _codes(rng, (3, 20, 9))
    xs, sx = bitstream.encode_signed(torch.from_numpy(xq), "lfsr")
    ws, sw = bitstream.encode_signed(torch.from_numpy(wq).transpose(1, 2), "bresenham")
    sx, sw = sx.to(torch.int8), sw.to(torch.int8)
    whole = sm_ops.stoch_matmul_packed(xs, sx, ws, sw)
    for b in range(3):
        np.testing.assert_array_equal(
            whole[b].numpy(), np.asarray(jossm.sc_matmul_value(
                JaxQTensor(jnp.asarray(xq[b]), jnp.float32(1 / 128)),
                JaxQTensor(jnp.asarray(wq[b]), jnp.float32(1.0)), "lfsr", "bresenham")))
    monkeypatch.setattr(sm_ref, "_CHUNK", 7)
    np.testing.assert_array_equal(stoch_matmul_packed_ref(xs, sx, ws, sw).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("x_gen,w_gen", [("thermometer", "bresenham"), ("lfsr", "lfsr")])
def test_stoch_matmul_dequantized_matches_reference_kernel(rng, x_gen, w_gen):
    x = rng.standard_normal((9, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 20)) / 6).astype(np.float32)
    jxq, jwq = jax_quantize(jnp.asarray(x)), jax_quantize(jnp.asarray(w), axis=0)
    want = np.asarray(jax_stoch_matmul(jxq, jwq, x_gen, w_gen, interpret=True))
    got = sm_ops.stoch_matmul(quantize(torch.from_numpy(x)),
                              sc_weight_t(torch.from_numpy(w), w_gen), x_gen)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("act_scale", [None, 0.03])
@pytest.mark.parametrize("x_gen,w_gen", PAIRS)
def test_astra_matmul_sc_bit_identical(rng, x_gen, w_gen, act_scale):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) / 7).astype(np.float32)
    want = np.asarray(jax_astra_matmul(jnp.asarray(x), jnp.asarray(w), JaxCC(
        "sc", x_gen=x_gen, w_gen=w_gen, act_scale=act_scale)))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    cc = ComputeConfig("sc", x_gen=x_gen, w_gen=w_gen, act_scale=act_scale)
    stale = sc_weight_t(tw, next(g for g in GENS if g != w_gen))  # another generator's
    for cache in (None, sc_weight_t(tw, w_gen), stale):
        got = astra_matmul(tx, tw, cc, wsc_t=cache)
        assert got.dtype == torch.float32 and got.shape == (2, 5, 40)
        np.testing.assert_array_equal(got.numpy(), want)


def test_astra_matmul_sc_pallas_flag_and_bf16(rng):
    """The reference's Pallas and jnp paths agree, and a bf16 activation
    comes back in bf16 with the reference's values."""
    x = rng.standard_normal((4, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 16)) / 5).astype(np.float32)
    want = jax_astra_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                            JaxCC("sc", use_pallas=True))
    got = astra_matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                       ComputeConfig("sc", use_pallas=True))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("mode", ["int8", "sc"])
@pytest.mark.parametrize("shapes", [((2, 3, 5, 16), (2, 3, 16, 7)), ((4, 1, 24), (24, 6)),
                                    ((2, 2, 1, 12), (2, 2, 12, 9))])
def test_astra_batched_matmul_bit_identical(rng, mode, shapes):
    """Each batch element (slot x KV head) gets its own per-tensor x scale
    and per-column w scale, as the reference's vmap gives it."""
    xshape, wshape = shapes
    x = rng.standard_normal(xshape).astype(np.float32)
    w = rng.standard_normal(wshape).astype(np.float32)
    x[0] *= 40.0  # batch elements on different scales
    for act_scale in (None, 0.05):
        jcc = JaxCC(mode, act_scale=act_scale)
        want = np.asarray(jax_batched(jnp.asarray(x), jnp.asarray(w), jcc))
        got = astra_batched_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   ComputeConfig(mode, act_scale=act_scale))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("plan", ["sc", "mixed", '{"*_proj": {"mode": "sc", "w_gen": "lfsr"}, '
                                  '"default": "int8"}'])
def test_prepare_caches_streams_once(plan):
    """``prepare`` stores, for every sc site, the codes that the call would
    quantize, tagged with the site's ``w_gen`` (the generator of their
    streams); other sites get none."""
    cfg = get_arch("stablelm-1.6b").reduced(dtype="float32")
    model = Model(cfg, ModelOptions(plan=plan), device="cpu")
    params = model.init(0)
    prep = model.prepare(params)
    sites = {"wq": "q_proj", "wk": "kv_proj", "wv": "kv_proj", "wo": "o_proj"}
    seen = 0
    for li, blk in enumerate(prep["layers"]):
        weights = [(blk["core"][n], f"L{li}.attn.{op}") for n, op in sites.items()]
        weights += [(blk["mlp"][n], f"L{li}.attn.{'down' if n == 'down' else 'up'}")
                    for n in blk["mlp"]]
        for p, site in weights:
            cc = model.plan.resolve(site)
            assert ("wsc_t" in p) == (cc.mode == "sc"), site
            if cc.mode == "sc":
                seen += 1
                want = sc_weight_t(p["w"], cc.w_gen)
                assert p["wsc_t"].gen == cc.w_gen and p["wsc_t"].q.dtype == torch.int8
                for a, b in zip(p["wsc_t"][:2], want[:2]):
                    assert torch.equal(a, b)
        assert all("wsc_t" not in d for d in params["layers"][li]["core"].values())
    assert seen > 0
    assert ("wsc_t" in prep["head"]) == (model.plan.resolve("lm_head").mode == "sc")


def test_stoch_split_plan_covers_k():
    """Split-K plans cover K exactly once with 16-aligned chunks."""
    for m, n, k, b in [(8, 2048, 2048, 1), (8, 2048, 5632, 1), (8, 100352, 2048, 1),
                       (640, 5632, 2048, 1), (8, 5, 17, 1), (1, 512, 64, 256), (3, 7, 100, 4)]:
        cfg, kps, splits = sm_ops.split_plan(m, n, k, 132, b)
        assert cfg == (0 if m <= 8 else 1)
        assert kps % 16 == 0 and (splits - 1) * kps < k <= splits * kps
        assert b * splits <= 65535


def test_stochastic_wrappers_refuse_other_devices():
    q = torch.zeros(3, 4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bts_encode(q, "lfsr")
    with pytest.raises(ValueError, match="generator"):
        bts_encode(torch.zeros(3, 4, dtype=torch.int8), "bogus")
    xs = torch.zeros(3, 4, 4, dtype=torch.int32, device="meta")
    sx = torch.zeros(3, 4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sm_ops.stoch_matmul_packed(xs, sx, xs, sx)
