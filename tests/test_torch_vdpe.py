"""The port's noise-aware VDPE model (``core/vdpe.py``) against the
reference's ``repro.core.vdpe``, on the CPU.

Without noise ``sc_matmul`` is bit-equal to the reference at every lane
count (pass tiling and the PCA's float32 accumulation in the same order)
and to the port's OSSM functional model.  The shot noise comes from a
``torch.Generator`` (the reference's threefry draws cannot be replayed),
so a noisy result is held to the reference's statistical bounds
(``tests/test_vdpe.py``): error within reach of the noiseless one, below
0.15, growing as the output ADC loses bits; and to the reference's own
noisy error on the same operands within the spread of a few draws.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import vdpe as jvdpe  # noqa: E402
from repro.core.quant import quantize as jax_quantize  # noqa: E402
from repro_torch.core import photonics  # noqa: E402
from repro_torch.core.ossm import sc_matmul_value  # noqa: E402
from repro_torch.core.quant import quantize  # noqa: E402
from repro_torch.core.vdpe import VDPEConfig, sc_matmul, sc_matmul_error  # noqa: E402


@pytest.fixture()
def operands(rng):
    x = rng.standard_normal((8, 96)).astype(np.float32)
    w = rng.standard_normal((96, 12)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    port = (quantize(tx), quantize(tw, axis=0), tx @ tw)
    ref = (jax_quantize(jnp.asarray(x)), jax_quantize(jnp.asarray(w), axis=0),
           jnp.asarray(x) @ jnp.asarray(w))
    return port, ref


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("lanes,gens", [(8, ("thermometer", "bresenham")),
                                        (32, ("lfsr", "bresenham")),
                                        (96, ("thermometer", "lfsr")),
                                        (1024, ("thermometer", "bresenham"))])
def test_noiseless_equals_reference_bit_for_bit(operands, lanes, gens):
    """Pass tiling over K (1 to 12 passes) leaves the result as the
    reference's, and as the functional model's."""
    (xq, wq, _), (jxq, jwq, _) = operands
    x_gen, w_gen = gens
    got = sc_matmul(xq, wq, VDPEConfig(lanes=lanes, x_gen=x_gen, w_gen=w_gen))
    want = jvdpe.sc_matmul(jxq, jwq, jvdpe.VDPEConfig(lanes=lanes, x_gen=x_gen, w_gen=w_gen))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), sc_matmul_value(xq, wq, x_gen, w_gen).numpy(),
                               rtol=1e-6)


def test_accuracy_and_noise_bounds(operands):
    """The reference's bounds: noiseless error < 0.03; 8-bit noisy error at
    least 0.9x the noiseless and < 0.15; a 4-bit ADC worse than 8-bit."""
    (xq, wq, exact), (jxq, jwq, jexact) = operands
    clean = sc_matmul_error(xq, wq, VDPEConfig(lanes=1024), exact)
    assert clean < 0.03
    assert clean == pytest.approx(jvdpe.sc_matmul_error(jxq, jwq, jvdpe.VDPEConfig(), jexact),
                                  rel=1e-5)
    noisy = sc_matmul_error(xq, wq, VDPEConfig(noisy=True, adc_bits=8), exact, gen=_gen(1))
    assert clean * 0.9 <= noisy < 0.15
    e8 = sc_matmul_error(xq, wq, VDPEConfig(noisy=True, adc_bits=8), exact, gen=_gen(0))
    e4 = sc_matmul_error(xq, wq, VDPEConfig(noisy=True, adc_bits=4), exact, gen=_gen(0))
    assert e4 > e8


@pytest.mark.parametrize("adc_bits", [4, 8])
def test_noisy_error_matches_reference_statistics(operands, adc_bits):
    """Over 4 draws each, the port's mean noisy error lies within the
    reference's range of errors widened by their spread; an explicit
    generator replays, and no generator means one seeded 0."""
    (xq, wq, exact), (jxq, jwq, jexact) = operands
    cfg = VDPEConfig(noisy=True, adc_bits=adc_bits)
    ours = [sc_matmul_error(xq, wq, cfg, exact, gen=_gen(s)) for s in range(4)]
    ref = [jvdpe.sc_matmul_error(jxq, jwq, jvdpe.VDPEConfig(noisy=True, adc_bits=adc_bits),
                                 jexact, key=jax.random.PRNGKey(s)) for s in range(4)]
    spread = max(ref) - min(ref)
    assert min(ref) - spread <= np.mean(ours) <= max(ref) + spread, (ours, ref)
    again = sc_matmul(xq, wq, cfg, gen=_gen(3))
    assert torch.equal(again, sc_matmul(xq, wq, cfg, gen=_gen(3)))
    assert torch.equal(sc_matmul(xq, wq, cfg), sc_matmul(xq, wq, cfg, gen=_gen(0)))


def test_photonic_operating_point():
    """Fig. 4: shot noise grows with lanes, and at 1024 lanes it stays under
    half an 8-bit ADC step with the laser under 1 W per wavelength."""
    p = photonics.PhotonicParams()
    assert photonics.shot_noise_sigma_bits(p, 1024) > photonics.shot_noise_sigma_bits(p, 64)
    assert photonics.shot_noise_sigma_bits(p, 1024) < 0.5 * (1024 * 128.0 / 2**8)
    assert photonics.laser_power_w(p, 1024) < 1.0
