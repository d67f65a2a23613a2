"""VDPE — homodyne Vector Dot-Product Engine (paper Fig. 3); port of
``repro.core.vdpe``.

A VDPE holds up to 1024 OSSMs on one wavelength; the photocurrents of all
lanes integrate on one photo-charge accumulator (PCA), so accumulation
over K is analog.  Longer dot products run as ``ceil(K / lanes)`` passes
into the same PCA (output-stationary), and one ADC digitizes the final
value.

This is the noise-aware functional model: exact integer popcount math
(``core.ossm``) plus, with ``noisy``, per-pass shot noise from
``core.photonics`` and the output ADC's resolution, for the Fig. 4
accuracy study.  Without noise the result equals the reference's bit for
bit.  The noise comes from a ``torch.Generator`` (the reference's
threefry draws cannot be replayed here), so a noisy result matches the
reference only in its statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import photonics
from repro_torch.core.ossm import W_GEN, X_GEN, ossm_multiply
from repro_torch.core.quant import STREAM_LEN, QTensor


@dataclasses.dataclass(frozen=True)
class VDPEConfig:
    lanes: int = 1024
    x_gen: str = X_GEN
    w_gen: str = W_GEN
    adc_bits: int = 8
    noisy: bool = False
    photonic: photonics.PhotonicParams = dataclasses.field(default_factory=photonics.PhotonicParams)


def _pad_to_lanes(q: torch.Tensor, lanes: int, dim: int) -> torch.Tensor:
    pad = (-q.shape[dim]) % lanes
    if pad == 0:
        return q
    shape = list(q.shape)
    shape[dim] = pad
    return torch.cat([q, q.new_zeros(shape)], dim=dim)


def sc_matmul(xq: QTensor, wq: QTensor, cfg: VDPEConfig = VDPEConfig(),
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic ``[M, K] @ [K, N]`` through pass-tiled VDPEs -> float32
    ``[M, N]``.  Bit-exact popcount math; with ``cfg.noisy``, Gaussian shot
    noise per pass (sigma ``sqrt(sum |counts| / electrons_per_bit)`` in
    popcount units, drawn from ``gen``, a generator seeded 0 if None) and
    the final value quantized through the ``adc_bits`` output ADC over the
    observed range."""
    qx, qw = xq.q, wq.q
    m_dim, k_dim = qx.shape
    k2, n_dim = qw.shape
    assert k_dim == k2, (qx.shape, qw.shape)
    lanes = cfg.lanes
    qx = _pad_to_lanes(qx, lanes, 1)
    qw = _pad_to_lanes(qw, lanes, 0)
    n_pass = qx.shape[1] // lanes
    if cfg.noisy and gen is None:
        gen = torch.Generator(device=qx.device)
        gen.manual_seed(0)
    n_e = photonics.electrons_per_bit(cfg.photonic)
    acc = torch.zeros((m_dim, n_dim), dtype=torch.float32, device=qx.device)
    for p in range(n_pass):
        x_t = qx[:, p * lanes:(p + 1) * lanes]
        w_t = qw[p * lanes:(p + 1) * lanes]
        prod = ossm_multiply(x_t[:, :, None], w_t[None], cfg.x_gen, cfg.w_gen)  # [M, lanes, N]
        pass_sum = prod.sum(1).to(torch.float32)  # analog PCA integration
        if cfg.noisy:
            abs_counts = prod.abs().sum(1).to(torch.float32)
            sigma = torch.sqrt(abs_counts / n_e)
            noise = torch.randn(pass_sum.shape, generator=gen, device=qx.device)
            pass_sum = pass_sum + sigma * noise
        acc = acc + pass_sum
    if cfg.noisy:
        rng = torch.clamp(acc.abs().max(), min=1.0)
        step = 2 * rng / (2 ** cfg.adc_bits)
        acc = torch.round(acc / step) * step
    return acc * STREAM_LEN * xq.scale * wq.scale


def sc_matmul_error(xq: QTensor, wq: QTensor, cfg: VDPEConfig, exact: torch.Tensor,
                    gen: Optional[torch.Generator] = None) -> float:
    """Relative L2 error of the SC result against the exact float matmul
    (Fig. 4)."""
    approx = sc_matmul(xq, wq, cfg, gen=gen)
    num = torch.linalg.norm(approx - exact)
    den = torch.clamp(torch.linalg.norm(exact), min=1e-9)
    return float(num / den)
