"""Photonic device-level model (paper §III "device-level analysis"); port
of ``repro.core.photonics``, pure Python.

Models the optical power budget and noise of a homodyne VDPE so we can
reproduce Fig. 4 (scalability of OAGs-per-wavelength) and justify the
paper's 0.5 uW/OAG + 1024 OAGs/lambda operating point.

Power budget: laser light is split 1:N across N lanes (OSSMs); each lane
passes two microring modulators (X and W — the cascade is the optical AND)
plus waveguide propagation, then lands on the photo-charge accumulator's
photodetector.  The received optical energy per '1' bit must exceed the
detection threshold set by shot + thermal noise at the chosen BER.

All constants carry their source; values marked `# assumed` are
representative literature numbers chosen to match the paper's stated
operating point (0.5 uW/OAG after losses, >30 Gbps, 1024 OAGs/lambda).
"""
from __future__ import annotations

import dataclasses
import math

# physical constants
Q_ELECTRON = 1.602e-19  # C
K_B = 1.381e-23  # J/K


@dataclasses.dataclass(frozen=True)
class PhotonicParams:
    bitrate_hz: float = 30e9          # paper: >30 Gbps streams
    responsivity_a_w: float = 1.1     # Ge-on-Si PD  # assumed
    mod_il_db: float = 0.5            # microring insertion loss  # assumed [5]
    oag_il_db: float = 1.0            # optical AND gate IL  # assumed [5]
    splitter_il_db: float = 0.2       # per 1:2 split stage [6]
    waveguide_db_cm: float = 0.5      # propagation loss, low-loss SiN-assisted platform  # assumed
    lane_pitch_cm: float = 20e-4      # 20 um lane pitch  # assumed
    coupler_il_db: float = 1.0        # fiber-chip coupling  # assumed
    temp_k: float = 300.0
    tia_noise_a_rthz: float = 2e-12   # input-referred TIA noise  # assumed
    target_ber: float = 1e-4          # raw stream BER target (SC tolerates bit flips)
    laser_wallplug: float = 0.20      # comb laser wall-plug w/ run-time power mgmt  # assumed [7]
    rx_power_w: float = 0.5e-6        # paper: ~0.5 uW optical power per OAG


def db_to_lin(db: float) -> float:
    return 10.0 ** (db / 10.0)


def lane_loss_db(p: PhotonicParams, n_lanes: int) -> float:
    """Total insertion loss from laser to one lane's photodetector."""
    split_stages = max(1, math.ceil(math.log2(max(n_lanes, 2))))
    wg_len_cm = n_lanes * p.lane_pitch_cm
    return (
        p.coupler_il_db
        + split_stages * p.splitter_il_db
        + 2 * p.mod_il_db  # X and W modulators
        + p.oag_il_db
        + wg_len_cm * p.waveguide_db_cm
    )


def laser_power_w(p: PhotonicParams, n_lanes: int) -> float:
    """Laser output needed so every lane receives p.rx_power_w.

    Splitting is power division (1/N) *plus* excess loss per stage.
    """
    loss = db_to_lin(lane_loss_db(p, n_lanes))
    return p.rx_power_w * n_lanes * loss


def laser_wall_power_w(p: PhotonicParams, n_lanes: int) -> float:
    return laser_power_w(p, n_lanes) / p.laser_wallplug


def shot_noise_sigma_bits(p: PhotonicParams, n_lanes: int) -> float:
    """Std-dev of the per-pass accumulated charge, in units of one bit-charge.

    The PCA is an *integrating* receiver: it accumulates photo-charge over
    the whole 128-bit window, so its equivalent noise bandwidth is
    1/(2*T_window) — NOT the line-rate bandwidth a per-bit receiver would
    need.  Integrated shot-noise charge variance = q * I_avg * T (equivalent
    to Poisson counting: sigma_electrons = sqrt(N_electrons)); the TIA's
    input-referred current noise integrates the same way.  Worst case: all
    ``n_lanes`` carrying '1' the full window.  Normalized by the single-bit
    charge q1 = R * P_rx / bitrate so the VDPE simulator can add Gaussian
    noise directly in popcount units.
    """
    i_photo = p.responsivity_a_w * p.rx_power_w  # per-lane current when '1'
    window_s = 128.0 / p.bitrate_hz
    q1 = i_photo / p.bitrate_hz  # charge per bit
    i_total = i_photo * n_lanes  # worst case: all lanes on
    var_shot = Q_ELECTRON * i_total * window_s  # Poisson: q*I*T
    nbw = 1.0 / (2.0 * window_s)  # integrator noise bandwidth
    var_tia = (p.tia_noise_a_rthz**2) * nbw * window_s**2
    sigma_q = math.sqrt(var_shot + var_tia)
    return sigma_q / q1


def electrons_per_bit(p: PhotonicParams) -> float:
    """Photo-electrons collected per received '1' bit-slot."""
    q1 = p.responsivity_a_w * p.rx_power_w / p.bitrate_hz
    return q1 / Q_ELECTRON


def snr_db(p: PhotonicParams, n_lanes: int) -> float:
    """Single-bit detection SNR (electrical) at the PCA input."""
    i_photo = p.responsivity_a_w * p.rx_power_w
    bandwidth = p.bitrate_hz / 2
    sigma_i = math.sqrt(2 * Q_ELECTRON * i_photo * n_lanes * bandwidth + (p.tia_noise_a_rthz**2) * bandwidth)
    return 10 * math.log10(i_photo / sigma_i) if sigma_i > 0 else float("inf")


def max_lanes_at_power(p: PhotonicParams, max_laser_w: float) -> int:
    """Largest power-of-two lane count within a per-wavelength laser budget."""
    n = 2
    while n <= 65536 and laser_power_w(p, 2 * n) <= max_laser_w:
        n *= 2
    return n


def vdpe_scalability_table(p: PhotonicParams, lane_sweep=(64, 128, 256, 512, 1024, 2048)):
    """Fig. 4 reproduction: per-wavelength laser power & noise vs #OAGs."""
    rows = []
    for n in lane_sweep:
        rows.append(
            dict(
                lanes=n,
                loss_db=lane_loss_db(p, n),
                laser_mw=laser_power_w(p, n) * 1e3,
                laser_wall_mw=laser_wall_power_w(p, n) * 1e3,
                sigma_popcount=shot_noise_sigma_bits(p, n),
                snr_db=snr_db(p, n),
            )
        )
    return rows
