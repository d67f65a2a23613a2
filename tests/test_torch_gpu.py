"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  They import no JAX; ``--noconftest`` keeps pytest from
loading ``tests/conftest.py``, which does, so they run on a GPU machine
without JAX:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: int8 accumulators bit-exact; paged attention float32 1e-5
(same math, keys streamed in chunks with rescaling), bf16 2e-2 (the
kernel rounds p to bf16 before the PV product, like the reference
kernel; the plain version keeps p in float32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.int8_matmul import ops as int8_ops  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_ref, paged_prefill_ref,
)


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
@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 5632, 2048), (37, 320, 200),
                                   (257, 2048, 5632), (5, 100, 33), (70, 1000, 129)])
def test_int8_kernel_bit_exact_on_card(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    w_t = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    assert torch.equal(int8_ops.int8_gemm(x, w_t), int8_matmul_acc_ref(x, w_t))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_kernels_match_plain_on_card(cuda, dtype, g):
    kvh, hd, bs, w, s = 4, 64, 16, 6, 5
    rng = np.random.default_rng(0)
    kv_len = np.asarray([0, 1, bs, bs + 1, w * bs], np.int32)
    q, kp, vp, table = _paged_inputs(rng, 5, kvh, g, hd, bs, w, 40)
    qs = rng.standard_normal((5, kvh * g, s, hd)).astype(np.float32)
    start = np.asarray([0, 3, bs, bs + 7, 2 * bs], np.int32)
    tq, tqs, tk, tv = (x.to(cuda, dtype) for x in _t(q, qs, kp, vp))
    tt, tl, ts = (x.to(cuda) for x in _t(table, kv_len, start))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    got = pa_ops.paged_attention_decode(tq, tk, tv, tt, tl).float()
    want = paged_decode_ref(tq, tk, tv, tt, tl)
    torch.testing.assert_close(got, want, atol=tol, rtol=0)
    got = pa_ops.paged_attention_prefill(tqs, tk, tv, tt, ts).float()
    want = paged_prefill_ref(tqs, tk, tv, tt, ts)
    torch.testing.assert_close(got, want, atol=tol, rtol=0)
