"""The linear-recurrence kernel's chunk and carry decomposition, on the CPU.

``csrc/rglru_scan.cu`` scans S in chunks of 32 steps, each a run of 4
steps per warp scanned from a zero state, the runs' (decay product, local
state) folded into the carry of the chunk before.
``ref.rglru_scan_chunked_ref`` is that order of operations in PyTorch.
It is held against the reference's Pallas kernel in interpret mode (at
``chunk=min(32, s)``, as ``tests/test_torch_rglru.py`` runs it) and
against its ``lax.scan`` oracle at rtol = atol = 2e-5, the reference
kernel test's tolerance (both reassociate the recurrence), at ragged B, S
and D, S shorter than one chunk and S not a multiple of the chunk, for
the kernel's chunk and run lengths and others.  The model's constants are
read back from the kernel source, so the model and the kernel cannot part.
The kernel itself is held on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ref  # noqa: E402

SRC = (Path(ref.__file__).parent / "csrc" / "rglru_scan.cu").read_text()
TOL = 2e-5
# (B, S, D): S below one chunk (1, 5, 31), exactly one and two chunks, past
# a chunk by one and ragged (37, 100), a long ragged S; D ragged (3, 130)
SHAPES = [(1, 1, 4), (3, 5, 7), (2, 31, 16), (2, 32, 8), (5, 37, 3), (3, 37, 130),
          (2, 64, 33), (4, 65, 5), (1, 100, 9), (2, 257, 6)]


def _inputs(b, s, d):
    rng = np.random.default_rng(b * 1000 + s * 10 + d)
    a = rng.uniform(0.2, 0.999, (b, s, d)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return a, x


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\w+)", SRC).group(1))


def test_model_constants_are_the_kernels():
    """The model's default chunk (warps x steps a warp) and run length are
    the kernel's ``WARPS * SPW`` and ``SPW``."""
    assert ref.STEPS_PER_WARP == _constant("SPW")
    assert ref.CHUNK == _constant("WARPS") * _constant("SPW")
    assert re.search(r"constexpr int CHUNK = WARPS \* SPW;", SRC)


@pytest.mark.parametrize("b,s,d", SHAPES, ids=["x".join(map(str, c)) for c in SHAPES])
def test_chunked_model_matches_reference_kernel(b, s, d):
    """The kernel's decomposition (chunk 32, runs of 4) against the
    reference's Pallas kernel in interpret mode and its sequential
    oracle."""
    a, x = _inputs(b, s, d)
    got = ref.rglru_scan_chunked_ref(torch.from_numpy(a), torch.from_numpy(x))
    assert got.shape == (b, s, d) and got.dtype == torch.float32
    for want in (jax_rglru_scan(jnp.asarray(a), jnp.asarray(x), chunk=min(32, s)),
                 jax_rglru_scan_ref(jnp.asarray(a), jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunk,spw", [(8, 2), (64, 8), (16, 16), (12, 1)])
def test_chunked_model_other_chunkings(chunk, spw):
    """Other chunk and run lengths (one run a chunk, runs of one step)
    give the same states within the tolerance, S ragged against each."""
    a, x = _inputs(3, 45, 11)
    got = ref.rglru_scan_chunked_ref(torch.from_numpy(a), torch.from_numpy(x), chunk, spw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_rglru_scan_ref(jnp.asarray(a),
                                                                           jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(),
                               ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(x)),
                               rtol=TOL, atol=TOL)


def test_chunked_model_carries_across_chunks():
    """Decays of exactly 1 and inputs of 1 make ``h_t = t + 1``: every
    carry, across runs and chunks, is exact; a chunk that is not whole
    runs is refused."""
    a = torch.ones(2, 70, 3)
    got = ref.rglru_scan_chunked_ref(a, torch.ones(2, 70, 3))
    want = torch.arange(1, 71, dtype=torch.float32)[None, :, None].expand(2, 70, 3)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="whole runs"):
        ref.rglru_scan_chunked_ref(a, a, chunk=10, steps_per_warp=4)


def test_scan_launches_are_counted_by_length():
    """The wrapper counts its launches by sequence length too (an
    admission's against a full window's): ``launch_counts`` reports a
    ``rglru_scan_s<S>`` key for each length launched, ``reset_launches``
    clears them, and a CPU call (the plain loop) counts none."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.rglru_scan import ops

    reset_launches()
    ops.rglru_scan(torch.full((2, 5, 3), 0.5), torch.ones(2, 5, 3))
    assert not any(k.startswith("rglru_scan_s") for k in launch_counts())
    ops.rglru_scan.lengths.update({256: 18, 2048: 1})
    counts = launch_counts()
    assert (counts["rglru_scan_s256"], counts["rglru_scan_s2048"]) == (18, 1)
    reset_launches()
    assert not ops.rglru_scan.lengths and set(launch_counts().values()) == {0}
