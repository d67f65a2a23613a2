"""Kernels on the training path: the scan's gradient, and the refusal of
every other kernel wrapper under autograd.

``rglru_scan`` runs as a ``torch.autograd.Function`` whose backward is
the same recurrence over the reversed sequence (on the CPU the plain
loop inside the Function, so these tests hold the backward formula
itself); it is held against ``jax.grad`` of the reference's
``rglru_scan_ref`` within 1e-5 of the largest gradient (float32; two
scans in other orders).  Every other wrapper,
and ``quantize``, raises when grad is enabled and an input requires
grad, on the CPU as on the card, so training under ``flash`` or a
quantized plan is refused, never detached.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.ossm import WeightCodes  # noqa: E402
from repro_torch.core.quant import QTensor, quantize  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.bts_encode.ops import bts_encode  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.int8_matmul.ops import (  # noqa: E402
    int8_gemm, int8_gemm_batched, int8_matmul_t,
)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    dense_attention_decode, paged_attention_decode, paged_attention_prefill,
)
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.stoch_matmul.ops import (  # noqa: E402
    stoch_gemm_codes, stoch_matmul, stoch_matmul_codes, stoch_matmul_codes_batched,
    stoch_matmul_packed,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402

TOL = 1e-5  # of the largest gradient magnitude


def _scan_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.999, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)
    return a, b, dh


@pytest.mark.parametrize("shape", [(2, 37, 5), (1, 1, 3), (3, 64, 8)])
def test_reverse_scan_backward_matches_jax_grad(shape):
    a, b, dh = _scan_inputs(shape, sum(shape))
    _, vjp = jax.vjp(jax_scan_ref, jnp.asarray(a), jnp.asarray(b))
    want_da, want_db = (np.asarray(g) for g in vjp(jnp.asarray(dh)))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    h = rg_ops.rglru_scan(ta, tb)
    assert type(h.grad_fn).__name__ == "RGLRUScanBackward"
    assert torch.equal(h.detach(), rglru_scan_ref(ta.detach(), tb.detach()))
    da, db = torch.autograd.grad(h, (ta, tb), torch.from_numpy(dh))
    for got, want in ((da, want_da), (db, want_db)):
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= TOL * scale


def test_scan_records_nothing_without_grad():
    a, b, _ = _scan_inputs((2, 5, 3), 0)
    ta = torch.from_numpy(a).requires_grad_(True)
    with torch.no_grad():
        assert rg_ops.rglru_scan(ta, torch.from_numpy(b)).grad_fn is None
    assert rg_ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).grad_fn is None
    reset_launches()
    h = rg_ops.rglru_scan(ta, torch.from_numpy(b))
    h.sum().backward()
    counts = launch_counts()  # the plain loop on the CPU: nothing launched either way
    assert counts["rglru_scan"] == 0 and counts["rglru_scan_backward"] == 0


def _req(*shape, dtype=torch.float32):
    return torch.randn(*shape).to(dtype).requires_grad_(True)


def _codes(*shape):
    return torch.randint(-127, 128, shape, dtype=torch.int8)


POOL = (torch.randn(4, 1, 4, 16), torch.randn(4, 1, 4, 16))
TABLE = torch.tensor([[1, 2]], dtype=torch.int32)
GUARDED = {
    "flash_attention": lambda: flash_attention(_req(1, 2, 4, 16), torch.randn(1, 1, 4, 16),
                                               torch.randn(1, 1, 4, 16)),
    "paged_attention_decode": lambda: paged_attention_decode(
        _req(1, 2, 16), *POOL, TABLE, torch.tensor([5], dtype=torch.int32)),
    "paged_attention_prefill": lambda: paged_attention_prefill(
        _req(1, 2, 3, 16), *POOL, TABLE, torch.tensor([2], dtype=torch.int32)),
    "dense_attention_decode": lambda: dense_attention_decode(
        _req(1, 2, 16), torch.randn(1, 1, 8, 16), torch.randn(1, 1, 8, 16),
        torch.tensor([5], dtype=torch.int32)),
    "int8_gemm": lambda: int8_gemm(_req(2, 16), _codes(3, 16)),
    "int8_gemm_batched": lambda: int8_gemm_batched(_req(2, 2, 16), _codes(2, 3, 16)),
    "int8_matmul_t": lambda: int8_matmul_t(QTensor(_codes(2, 16), _req(())),
                                           QTensor(_codes(3, 16), torch.ones(1, 3))),
    "stoch_matmul_packed": lambda: stoch_matmul_packed(
        _req(2, 16, 4), _codes(2, 16), torch.zeros(3, 16, 4, dtype=torch.int32),
        _codes(3, 16)),
    "stoch_matmul_codes": lambda: stoch_matmul_codes(
        _req(2, 16), torch.zeros(3, 16, 4, dtype=torch.int32), _codes(3, 16)),
    "stoch_gemm_codes": lambda: stoch_gemm_codes(_req(2, 16), _codes(3, 16)),
    "stoch_matmul_codes_batched": lambda: stoch_matmul_codes_batched(_req(2, 2, 16),
                                                                     _codes(2, 3, 16)),
    "stoch_matmul": lambda: stoch_matmul(QTensor(_codes(2, 16), _req(())),
                                         WeightCodes(_codes(3, 16), torch.ones(1, 3),
                                                     "bresenham")),
    "bts_encode": lambda: bts_encode(_req(2, 16)),
    "quantize": lambda: quantize(_req(2, 16)),
}


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_wrapper_refuses_an_input_that_requires_grad(name):
    with pytest.raises(RuntimeError, match="has no backward, and an input requires grad"):
        GUARDED[name]()


def test_attention_wrappers_run_under_no_grad():
    """The refusal is autograd's only: the same calls under no_grad run
    the plain versions."""
    with torch.no_grad():
        for name in ("flash_attention", "paged_attention_decode", "paged_attention_prefill",
                     "dense_attention_decode", "int8_matmul_t", "quantize"):
            out = GUARDED[name]()
            assert all(torch.isfinite(t.to(torch.float32)).all() for t in
                       (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("opts", [ModelOptions(attn_impl="flash"), ModelOptions(plan="int8"),
                                  ModelOptions(plan="sc"), ModelOptions(plan="mixed")],
                         ids=["flash", "int8", "sc", "mixed"])
def test_loss_refuses_kernel_and_quantized_paths(opts):
    cfg = get_arch("stablelm-1.6b").reduced(dtype="float32")
    model = Model(cfg, opts, device="cpu")
    params = tree_util.map_leaves(lambda t: t.requires_grad_(True), model.init(0))
    with pytest.raises(RuntimeError, match="has no backward"):
        model.loss(params, {"tokens": torch.randint(0, cfg.vocab, (2, 8))})
