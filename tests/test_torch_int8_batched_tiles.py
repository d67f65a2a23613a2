"""The batched int8 entry's admission kernel (M > 16): its tiling, on the CPU.

``int8_gemm_batched_tiles_kernel`` (``csrc/int8_gemm_sm90.cu``) runs a
block a tile of 32 rows by up to 256 columns of one product, over its
whole K.  ``ref.int8_batched_tiles`` is that tiling and
``ref.int8_batched_tiles_ref`` computes a batch tile by tile after it,
with the tile constants read from the kernel source.  Held here:

* the tiled accumulators equal, bit for bit, the reference's Pallas
  kernel (``repro.kernels.int8_matmul``) in interpret mode on each
  product, at the ``mixed`` admission's qk and pv shapes (fewer
  products), ragged M and N, K at the kernel's limit of 4096, and codes
  of -128 and 127;
* the tiles cover every output element exactly once, N cut into several
  tiles included;
* the tiling keeps the kernel's rules (rows a tile, columns a multiple of
  8 and at most 256, the fewest column tiles) and the plan routes to it
  exactly the K the kernel takes.

The kernel's shared-memory layout (pitches, K stages, the staged output)
is held bit for bit on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.int8_matmul.kernel import int8_matmul_kernel  # noqa: E402
from repro_torch.kernels.int8_matmul import ops  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import (  # noqa: E402
    int8_batched_tiles, int8_batched_tiles_ref,
)

SRC = (Path(ops.__file__).parent / "csrc" / "int8_gemm_sm90.cu").read_text()
# (B, M, K, N): the mixed admission's qk and pv (stablelm-1.6b, 160 query
# rows against the 176-position view) on 3 of their 128 products; ragged
# M and N (one row past a tile, N past an n8 tile and N % 4 != 0), N cut
# into two and three tiles, K at the limit of 4096 in stages
CASES = [(3, 160, 64, 176), (3, 160, 176, 64), (2, 17, 16, 1), (3, 33, 48, 130),
         (2, 45, 96, 33), (2, 40, 64, 257), (1, 70, 32, 513), (2, 33, 4096, 176),
         (1, 40, 4096, 256)]


def _reference(x: np.ndarray, w_t: np.ndarray) -> np.ndarray:
    """The reference kernel on each product: operands zero-padded to its
    128-multiples, run in interpret mode, vmapped over the batch."""
    b, m, k = x.shape
    n = w_t.shape[1]
    pm, pk, pn = -m % 128, -k % 128, -n % 128
    xp = np.pad(x, ((0, 0), (0, pm), (0, pk)))
    wp = np.pad(np.swapaxes(w_t, 1, 2), ((0, 0), (0, pk), (0, pn)))
    run = jax.vmap(lambda a, c: int8_matmul_kernel(a, c, interpret=True))
    return np.asarray(run(jnp.asarray(xp), jnp.asarray(wp)))[:, :m, :n]


def _constant(name: str) -> int:
    """A ``constexpr int`` of the kernel source: an integer, or ``a << b``."""
    base, _, shift = re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1).partition("<<")
    return int(base) << int(shift or 0)


BM, MAX_BN = _constant("BA_BM"), _constant("BA_MAX_BN")


@pytest.mark.parametrize("bmkn", CASES, ids=["x".join(map(str, c)) for c in CASES])
def test_tiled_model_matches_reference_kernel(bmkn):
    b, m, k, n = bmkn
    rng = np.random.default_rng(m * 7 + k + n)
    x = rng.integers(-128, 128, (b, m, k)).astype(np.int8)
    w_t = rng.integers(-128, 128, (b, n, k)).astype(np.int8)
    x[0, 0], w_t[0, 0] = -128, -128  # the largest products: (-128)^2 a term
    x[-1, -1], w_t[-1, -1] = 127, -128
    assert ops.int8_batched_plan(m, n, k) == "tiles"
    got, visits = int8_batched_tiles_ref(torch.from_numpy(x), torch.from_numpy(w_t), BM, MAX_BN)
    assert got.dtype == torch.int32 and bool((visits == 1).all())
    np.testing.assert_array_equal(got.numpy(), _reference(x, w_t))


@pytest.mark.parametrize("m,n", [(17, 8), (32, 256), (33, 257), (160, 176), (64, 512),
                                 (95, 1000), (1531, 384), (20, 4096)])
def test_tiles_cover_every_output_once(m, n):
    x = torch.zeros(1, m, 16, dtype=torch.int8)
    _, visits = int8_batched_tiles_ref(x, torch.zeros(1, n, 16, dtype=torch.int8), BM, MAX_BN)
    assert bool((visits == 1).all())


@pytest.mark.parametrize("m,n,k", [(160, 176, 64), (160, 64, 176), (17, 1, 16), (40, 256, 4096),
                                   (33, 257, 4096), (300, 513, 4096), (64, 8, 2048),
                                   (5000, 8000, 16), (50, 200, 1008)])
def test_tiling_keeps_the_kernels_rules(m, n, k):
    tiles = int8_batched_tiles(m, n, BM, MAX_BN)
    row_starts = sorted({r.start for r, _ in tiles})
    col_starts = sorted({c.start for _, c in tiles})
    assert row_starts == list(range(0, m, BM))
    assert len(col_starts) == -(-n // MAX_BN)  # the fewest column tiles
    bn = col_starts[1] if len(col_starts) > 1 else -(-n // 8) * 8
    assert bn % 8 == 0 and 8 <= bn <= MAX_BN
    assert all(c.stop - c.start <= bn and r.stop - r.start <= BM for r, c in tiles)
    assert len(tiles) == len(row_starts) * len(col_starts)
    # the plan sends the kernel every K it takes and no other
    assert ops.int8_batched_plan(m, n, k) == "tiles"
    assert ops.int8_batched_plan(m, n, k + 8) == "mma"
    assert ops.int8_batched_plan(m, n, _constant("BA_MAX_K") + 16) == "mma"


def test_serving_shapes_take_the_tiles_kernel():
    """The mixed admission's qk and pv: one N tile of 176 and 64 columns,
    5 tiles of 32 rows a product (640 blocks over 128 products)."""
    qk, pv = int8_batched_tiles(160, 176, BM, MAX_BN), int8_batched_tiles(160, 64, BM, MAX_BN)
    assert {c.stop - c.start for _, c in qk} == {176} and len(qk) == 5
    assert {c.stop - c.start for _, c in pv} == {64} and len(pv) == 5
    assert 128 * len(qk) == 640
