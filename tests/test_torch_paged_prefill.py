"""The causal prefill kernels' tile walk, against the reference kernel.

``csrc/paged_prefill.cu`` gives each 64-row query tile of a (slot, KV
head) the keys ``[0, k_hi)`` below its last row position and masks only
the key tiles that straddle the diagonal, the key end or a GQA fold
boundary; ``ref.paged_prefill_tiles`` is that walk in Python.  Here the
walk is checked pair by pair against the reference kernel's causal mask
(``kernel.py:111``: key ``kp`` is visible to row ``r`` when ``kp <=
start + r % q_len``, among the table's ``W * BS`` positions), and a plain
emulation of the kernels' tiled softmax over only the visited tiles
(masks only where the walk says, the reference's ``m_safe``/``alpha``
guards, keys gathered through the table) is held against the reference's
``paged_attention_prefill`` (interpret mode, as
``tests/test_torch_dense_split.py`` runs the reference) within 1e-5 in
float32: only the summation order and the tile boundaries differ.  Both
key tiles are walked: 64 keys (the bf16 kernel) and 32 (float32 and int8
pools).
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention_prefill as jax_prefill,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_prefill_ref, paged_prefill_tiles,
)

ROWS = 64  # query rows per block in both kernels
KEY_TILES = (64, 32)  # bf16 kernel, float32 kernel


def _starts(bs: int) -> np.ndarray:
    """Suffix starts at 0, mid-block and past a block edge."""
    return np.asarray([0, max(1, bs // 2), bs + 3], np.int32)


def _blocks(start: np.ndarray, q_len: int, bs: int) -> int:
    """Table width covering every suffix, plus one block past it."""
    return -(-int(start.max() + q_len) // bs) + 1


@pytest.mark.parametrize("bs", [4, 8, 16, 128])
@pytest.mark.parametrize("g", [1, 4, 10])
@pytest.mark.parametrize("q_len", [1, 37, 64, 65])
def test_walk_covers_the_causal_mask(q_len, g, bs):
    """Every (row, key) pair the reference's mask allows lies in a visited
    tile, no tile holds only keys above every row, and no unmasked tile
    holds a masked pair; the rows tile ``[0, g * q_len)`` exactly."""
    start = _starts(bs)
    for ctx in (_blocks(start, q_len, bs) * bs, bs):  # a table past the suffixes; one block
        for keys in KEY_TILES:
            walk = paged_prefill_tiles(start, q_len, g, ctx, ROWS, keys)
            assert len(walk) == start.size
            for n, tiles in zip(start, walk):
                assert [t[0] for t in tiles] == list(range(0, g * q_len, ROWS))
                assert tiles[-1][1] == g * q_len
                for r0, r1, k_hi, masked in tiles:
                    pos = int(n) + np.arange(r0, r1) % q_len
                    kp = np.arange(ctx + keys)
                    allowed = (kp[None] <= pos[:, None]) & (kp[None] < ctx)
                    assert not allowed[:, k_hi:].any()  # every allowed pair is visited
                    assert k_hi == int(np.minimum(pos + 1, ctx).max())  # and no more
                    assert len(masked) == -(-k_hi // keys)
                    for t, msk in enumerate(masked):
                        tile = allowed[:, t * keys:(t + 1) * keys]
                        if not msk:
                            assert tile.all(), (r0, t)


def _tiled_prefill(q, k_pool, v_pool, table, start, softcap, keys, k_scale=None,
                   v_scale=None):
    """The kernels' arithmetic in float32 numpy: per 64-row tile, the
    streaming softmax over the walk's key tiles only, keys gathered
    through the table (past ``k_hi`` as zeros), masked only where the walk
    says.  q [B, H, S, hd] -> [B, H, S, hd]."""
    b, h, s, hd = q.shape
    kvh, bs = k_pool.shape[1], k_pool.shape[2]
    g, ctx = h // kvh, table.shape[1] * bs
    if k_scale is not None:  # an int8 pool: float(code) * scale of the KV head
        k_pool = k_pool.astype(np.float32) * k_scale[None, :, None, None]
        v_pool = v_pool.astype(np.float32) * v_scale[None, :, None, None]
    qg = q.reshape(b, kvh, g * s, hd)
    out = np.zeros_like(qg)
    for bi, tiles in enumerate(paged_prefill_tiles(start, s, g, ctx, ROWS, keys)):
        for r0, r1, k_hi, masked in tiles:
            pos = int(start[bi]) + np.arange(r0, r1) % s
            for kh in range(kvh):
                m = np.full(r1 - r0, -1e30, np.float32)
                l = np.zeros(r1 - r0, np.float32)
                acc = np.zeros((r1 - r0, hd), np.float32)
                for t, msk in enumerate(masked):
                    kp = np.arange(t * keys, (t + 1) * keys)
                    live = kp < k_hi
                    kc = np.minimum(kp, ctx - 1)
                    blk = table[bi, kc // bs]
                    k = np.where(live[:, None], k_pool[blk, kh, kc % bs], 0).astype(np.float32)
                    v = np.where(live[:, None], v_pool[blk, kh, kc % bs], 0).astype(np.float32)
                    sc = (qg[bi, kh, r0:r1] @ k.T) * np.float32(hd ** -0.5)
                    if softcap > 0:
                        sc = np.tanh(sc / softcap) * softcap
                    if msk:
                        sc = np.where((kp[None] <= pos[:, None]) & live[None], sc, -1e30)
                    m_new = np.maximum(m, sc.max(-1))
                    m_safe = np.where(m_new <= -1e30 / 2, 0, m_new)
                    p = np.where(sc > -1e30 / 2, np.exp(sc - m_safe[:, None]), 0)
                    alpha = np.where(m <= -1e30 / 2, 0, np.exp(m - m_safe))
                    l = alpha * l + p.sum(-1)
                    acc = alpha[:, None] * acc + p.astype(np.float32) @ v
                    m = m_new.astype(np.float32)
                out[bi, kh, r0:r1] = acc / np.maximum(l, 1e-30)[:, None]
    return out.reshape(b, h, s, hd)


@pytest.mark.parametrize("q_len,g,bs,softcap,int8", [
    (1, 1, 4, 0.0, False),      # one suffix row per slot: decode-shaped prefill
    (37, 4, 8, 30.0, False),    # fold boundaries inside a 64-row tile, softcap
    (64, 10, 16, 0.0, False),   # recurrentgemma's G, tiles on fold boundaries
    (65, 1, 128, 30.0, False),  # one row past a tile; a key tile inside one block
    (65, 4, 16, 0.0, True),     # int8 pool: keys dequantized by the KV head's scale
    (37, 10, 4, 30.0, True),    # int8 pool, small blocks, softcap
])
def test_tiled_softmax_matches_reference_kernel(q_len, g, bs, softcap, int8):
    rng = np.random.default_rng(q_len * 100 + g * 10 + bs)
    kvh, hd = 2, 16
    start = _starts(bs)
    w = _blocks(start, q_len, bs)
    nb = start.size * w + 1
    table = (rng.permutation(nb - 1)[: start.size * w].reshape(start.size, w) + 1)
    table = table.astype(np.int32)
    q = rng.standard_normal((start.size, kvh * g, q_len, hd)).astype(np.float32)
    scales = {}
    if int8:
        k_pool, v_pool = (rng.integers(-127, 128, (nb, kvh, bs, hd)).astype(np.int8)
                          for _ in range(2))
        scales = {"k_scale": rng.uniform(0.01, 0.05, kvh).astype(np.float32),
                  "v_scale": rng.uniform(0.01, 0.05, kvh).astype(np.float32)}
    else:
        k_pool, v_pool = (rng.standard_normal((nb, kvh, bs, hd)).astype(np.float32)
                          for _ in range(2))
    want = np.asarray(jax_prefill(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(table),
        jnp.asarray(start), *(jnp.asarray(scales[n]) for n in ("k_scale", "v_scale")
                              if scales), softcap=softcap, interpret=True))
    for keys in KEY_TILES:
        got = _tiled_prefill(q, k_pool, v_pool, table, start, softcap, keys, **scales)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"{keys}-key tiles")
    # the plain version the CPU path and the card's checks use agrees too
    plain = paged_prefill_ref(*(torch.from_numpy(x) for x in (q, k_pool, v_pool, table, start)),
                              softcap=softcap,
                              **{n: torch.from_numpy(s) for n, s in scales.items()})
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=0)


def test_prefill_runs_on_its_own_library():
    """The causal mode has its own library: the bf16 kernel on ``wgmma``
    with ``cp.async`` gathers, and the decode library keeps no causal
    mode (no ``causal``/``q_len`` argument)."""
    assert _build.LIBRARIES["paged_prefill"] == ("paged_attention/csrc/paged_prefill.cu",)
    kdir = os.path.dirname(os.path.abspath(_build.__file__))
    with open(os.path.join(kdir, "paged_attention", "csrc", "paged_prefill.cu"),
              encoding="utf-8") as f:
        text = f.read()
    assert "Replaces: src/repro/kernels/paged_attention/kernel.py ::" in text
    assert "paged_attention_kernel, its causal mode" in text
    assert "wgmma_ss(" in text and "wgmma_rs(" in text and "cp_async16(" in text
    with open(os.path.join(kdir, "paged_attention", "csrc", "decode.cu"),
              encoding="utf-8") as f:
        decode = f.read()
    assert "int causal" not in decode and "q_len" not in decode
