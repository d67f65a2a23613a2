"""``int8_gemm_plan``: which kernel one int8 product takes, and its grid.

The plan is a pure function of the shapes and the SM count, so it is held
here on the CPU: the path at every serving shape of stablelm-1.6b and
recurrentgemma-2b (decode at 8 slots, admissions) and at each edge (M
1/8/16/17/1531/3072, K % 16 both ways), K ranges that cover K exactly
once in whole kernel steps, grids within CUDA's limits, and on the
``wgmma`` path K split only where the output tiles are fewer than the
SMs and, at the short admissions ``chip_smoke.py`` times, only where the
split was the faster on an H100.  ``int8_batched_plan`` (the batched
entry's kernel) is held the same way: the decode qk/pv products on the
stream kernel, the admission ones (M > 16) on the tiles kernel, K % 16 !=
0 or past 4096 on ``mma.sync``.  The kernels themselves are held bit
for bit on the card
(``tests/test_torch_gpu.py::test_int8_kernel_bit_exact_on_card``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.int8_matmul import ops  # noqa: E402

N_SM = 132  # an H100 SXM
D, F, V = 2048, 5632, 100352  # stablelm-1.6b
RG_D, RG_F, RG_V, RG_HD = 2560, 7680, 256000, 256  # recurrentgemma-2b
# (M, K, N) -> the path
SERVING = {
    (8, D, D): "stream", (8, D, F): "stream", (8, F, D): "stream", (8, D, V): "stream",
    (1531, D, D): "wgmma", (3072, D, F): "wgmma", (3072, F, D): "wgmma",
    (1531, D, V): "wgmma",
    (8, RG_D, 2 * RG_D): "stream", (8, RG_D, RG_D): "stream", (8, RG_D, RG_HD): "stream",
    (8, RG_D, RG_F): "stream", (8, RG_F, RG_D): "stream", (8, RG_D, RG_V): "stream",
    (2048, RG_D, 2 * RG_D): "wgmma", (2048, RG_D, RG_D): "wgmma",
    (2048, RG_D, RG_HD): "wgmma", (2048, RG_D, RG_F): "wgmma", (2048, RG_F, RG_D): "wgmma",
    (2048, RG_D, RG_V): "wgmma",
}
EDGES = {
    (1, D, D): "stream", (16, D, D): "stream", (17, D, D): "wgmma", (3072, D, D): "wgmma",
    (8, 2064, D): "stream", (17, 2064, 129): "wgmma", (8, 2056, D): "mma",
    (1531, 2056, D): "mma", (16, 100, 40): "mma", (17, 17, 3): "mma", (1, 16, 1): "stream",
    (12, 4608, 17000): "stream", (12, 9600, 40): "stream", (3, 16, 5): "stream",
    (8, 15360, 64): "stream", (16, 12288, 40): "stream", (8, 16, 256000): "stream",
}
CASES = sorted({**SERVING, **EDGES}.items())
# the kernels' K steps: split ranges are whole steps of the chosen kernel
# (the stream kernel takes K whole, a multiple of 16)
STEP = {"wgmma": 128, "stream": 16, "mma": 64}


@pytest.mark.parametrize("mkn,path", CASES, ids=[f"{m}x{k}x{n}" for (m, k, n), _ in CASES])
def test_int8_gemm_plan_path_and_split(mkn, path):
    m, k, n = mkn
    plan = ops.int8_gemm_plan(m, n, k, N_SM)
    assert plan.path == path
    # the K ranges cover K exactly once, each a whole number of steps
    assert plan.kps % STEP[path] == 0
    assert (plan.splits - 1) * plan.kps < k <= plan.splits * plan.kps
    gx, gy, gz = plan.grid
    assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    if path == "wgmma":
        tiles = -(-m // 128) * -(-n // 128)
        assert (gx, gy, gz) == (-(-m // 128), -(-n // 128), plan.splits)
        # split only when the tiles are fewer than the SMs, to about one
        # block per SM
        assert plan.splits == 1 or tiles < N_SM
        assert plan in (ops.wgmma_plan(m, n, k, 0), ops.wgmma_plan(m, n, k, N_SM))
        if plan.splits > 1:
            assert plan.splits == min(-(-N_SM // tiles), -(-k // 256))
    elif path == "stream":
        # one block per 16 weight rows; its warps split K, blocks never do
        assert m <= 16 and k % 16 == 0
        assert (gx, gy, gz) == (-(-n // 16), 1, 1) and (plan.kps, plan.splits) == (k, 1)
    else:
        cfg, kps, splits = ops.split_plan(m, n, k, N_SM)
        assert k % 16 != 0 and (plan.cfg, plan.kps, plan.splits) == (cfg, kps, splits)


def test_int8_gemm_plan_is_a_function_of_the_shapes():
    """The same shapes always give the same plan (no state, no device
    query); at any SM count, K is split only while the grid stays within
    one wave (two blocks an SM at most)."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        m, n = int(rng.integers(1, 4000)), int(rng.integers(1, 300000))
        k = int(rng.integers(1, 600)) * int(rng.choice([1, 16]))
        a, b = ops.int8_gemm_plan(m, n, k, N_SM), ops.int8_gemm_plan(m, n, k, N_SM)
        assert a == b
        assert (a.splits - 1) * a.kps < k <= a.splits * a.kps
        for sm in (N_SM, 2 * N_SM):
            p = ops.int8_gemm_plan(m, n, k, sm)
            tiles = int(np.prod(p.grid)) // p.splits
            assert p.splits == 1 or tiles * (p.splits - 1) < 2 * sm


def test_int8_gemm_counts_paths_apart_and_runs_plain_on_cpu():
    """On CPU tensors the plain version runs and no counter moves; the
    registry reports each kernel's counter and clears them all."""
    from repro_torch.kernels import launch_counts, reset_launches

    x = torch.ones(3, 32, dtype=torch.int8)
    w_t = torch.ones(5, 32, dtype=torch.int8)
    before = (ops.int8_gemm.launches, dict(ops.int8_gemm.paths))
    assert torch.equal(ops.int8_gemm(x, w_t), torch.full((3, 5), 32, dtype=torch.int32))
    assert (ops.int8_gemm.launches, ops.int8_gemm.paths) == before
    assert set(ops.int8_gemm.paths) == set(ops.PATHS) == {"wgmma", "stream", "mma"}
    ops.int8_gemm.paths["stream"] = 4
    assert launch_counts()["int8_gemm_stream"] == 4
    reset_launches()
    assert ops.int8_gemm.paths == dict.fromkeys(ops.PATHS, 0)
    assert all(launch_counts()[f"int8_gemm_{p}"] == 0 for p in ops.PATHS)


# short admissions (one and two 128-row tiles) at every serving (K, N) but
# the heads, where the wgmma plan may split K: (M, K, N) -> ms of the wgmma
# kernel unsplit and split to about one block per SM, as chip_smoke.py's
# "short admission" lines read them on an NVIDIA H100 80GB HBM3 at 700 W
SHORT = {
    (64, D, D): (0.0155, 0.0175), (64, D, F): (0.0168, 0.0189), (64, F, D): (0.0300, 0.0214),
    (256, D, D): (0.0161, 0.0216), (256, D, F): (0.0182, 0.0299),
    (256, F, D): (0.0305, 0.0298),
    (64, RG_D, 2 * RG_D): (0.0210, 0.0216), (64, RG_D, RG_D): (0.0180, 0.0186),
    (64, RG_D, RG_HD): (0.0162, 0.0115), (64, RG_D, RG_F): (0.0218, 0.0252),
    (64, RG_F, RG_D): (0.0391, 0.0233), (256, RG_D, 2 * RG_D): (0.0204, 0.0316),
    (256, RG_D, RG_D): (0.0188, 0.0271), (256, RG_D, RG_HD): (0.0165, 0.0142),
    (256, RG_D, RG_F): (0.0233, 0.0384), (256, RG_F, RG_D): (0.0411, 0.0353),
}


@pytest.mark.parametrize("mkn", sorted(SHORT), ids=[f"{m}x{k}x{n}" for m, k, n in sorted(SHORT)])
def test_wgmma_plan_splits_cover_k(mkn):
    """``wgmma_plan`` (the wgmma kernel's plan for a target number of
    blocks, which ``chip_smoke.py`` times unsplit against split): 0 leaves
    K whole; a target splits K in whole 128-byte steps, at least two a
    split, until the grid reaches it; ``int8_gemm_plan`` takes the one that
    read faster on the card (either, where the two are within 5%)."""
    m, k, n = mkn
    tiles = -(-m // 128) * -(-n // 128)
    whole = ops.wgmma_plan(m, n, k, 0)
    assert whole.splits == 1 and whole.kps >= k and whole.grid == (-(-m // 128), -(-n // 128), 1)
    split = ops.wgmma_plan(m, n, k, N_SM)
    assert split.kps % 128 == 0 and split.kps >= 256
    assert (split.splits - 1) * split.kps < k <= split.splits * split.kps
    assert split.grid == (-(-m // 128), -(-n // 128), split.splits)
    assert split.splits == 1 if tiles >= N_SM else tiles * (split.splits - 1) < N_SM
    plan = ops.int8_gemm_plan(m, n, k, N_SM)
    assert plan in (whole, split)
    unsplit_ms, split_ms = SHORT[mkn]
    if abs(unsplit_ms - split_ms) > 0.05 * min(unsplit_ms, split_ms):
        assert plan == (split if split_ms < unsplit_ms else whole)


# (B, M, K, N) of the batched entry -> its kernel: stablelm-1.6b's decode
# qk and pv under the mixed plan (8 slots x 32 KV heads, one query row,
# the 512-position view), ragged decode products, the mixed plan's
# admissions (M > 16) and their edges on the tiles kernel, and K % 16 != 0
# and K past 4096 on mma.sync
BATCHED = {
    (256, 1, 64, 512): "stream", (256, 1, 512, 64): "stream", (3, 16, 96, 5): "stream",
    (2, 3, 512, 513): "stream", (4, 16, 4096, 33): "stream", (1, 1, 16, 1): "stream",
    (128, 160, 64, 176): "tiles", (128, 160, 176, 64): "tiles", (5, 17, 64, 64): "tiles",
    (3, 5, 100, 33): "mma", (256, 1, 520, 64): "mma", (256, 1, 4112, 64): "mma",
    (2, 16, 8, 5): "mma", (2, 17, 4096, 513): "tiles", (2, 17, 4112, 64): "mma",
    (2, 40, 100, 64): "mma",
}


@pytest.mark.parametrize("bmkn", sorted(BATCHED), ids=["x".join(map(str, c)) for c in sorted(BATCHED)])
def test_int8_batched_plan_routes_by_shape(bmkn):
    b, m, k, n = bmkn
    path = ops.int8_batched_plan(m, n, k)
    assert path == BATCHED[bmkn] and path in ops.BATCHED_PATHS
    assert (path == "stream") == (m <= 16 and k % 16 == 0 and k <= 4096)
    assert (path == "tiles") == (m > 16 and k % 16 == 0 and k <= 4096)


def test_int8_gemm_batched_counts_paths_apart_and_runs_plain_on_cpu():
    """On CPU tensors the batched plain version runs and no counter moves;
    the registry reports each batched kernel's counter and clears them."""
    from repro_torch.kernels import launch_counts, reset_launches

    x = torch.ones(2, 1, 64, dtype=torch.int8)
    w_t = torch.full((2, 5, 64), -1, dtype=torch.int8)
    fn = ops.int8_gemm_batched
    before = (fn.launches, dict(fn.paths))
    assert torch.equal(fn(x, w_t), torch.full((2, 1, 5), -64, dtype=torch.int32))
    assert (fn.launches, fn.paths) == before
    assert set(fn.paths) == {"stream", "tiles", "mma"}
    fn.paths["stream"] = 3
    assert launch_counts()["int8_gemm_batched_stream"] == 3
    reset_launches()
    assert fn.paths == dict.fromkeys(ops.BATCHED_PATHS, 0)
    assert launch_counts()["int8_gemm_batched_mma"] == 0
    assert launch_counts()["int8_gemm_batched_tiles"] == 0
