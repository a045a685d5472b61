"""3GPP CDL channel generation on the host, the counterpart of the JAX
package's data/cdl.py (CDL_PROFILES:64, _generate_one:210,
generate_cdl_channels:294).

The clustered delay-line model of TR 38.901 §7.7.1 as the reference's
MATLAB path (matlab/generate_data.m, genChannels.m) configures it:
per-cluster powers, delays and zenith angles from the CDL-A..E tables, 20
rays per cluster at the Table 7.5-3 offsets scaled by the cluster's zenith
spreads, random per-ray phases and arrival-ray coupling, vertical ULAs of
Nt / Nr elements, and the narrowband response H(f_k) = sum_n H_n
exp(-j 2 pi f_k tau_n) at the kept subcarriers. The same documented
simplifications as the JAX package: one polarization, isotropic elements,
no Doppler, no path-filter timing offset.

Generation runs on the host in float32 / complex64 torch ops, as the JAX
package runs it on its CPU backend (cdl.py:314-317): the data set is a few
MB and is made once a run. `cdl_core` is the deterministic part, given the
per-ray phases and the zenith-ray permutation; `generate_cdl_channels`
draws those from a CPU `torch.Generator`. The two packages' random streams
differ by design, so the core matches the JAX package exactly and the
ensembles match in their statistics.
"""

from __future__ import annotations

import zlib
from typing import Dict, NamedTuple

import numpy as np
import torch

# TR 38.901 Table 7.5-3: ray offset angles (±, in degrees, unit spread)
RAY_OFFSETS = np.array(
    [0.0447, 0.1413, 0.2492, 0.3715, 0.5129, 0.6797, 0.8844, 1.1481, 1.5195, 2.1551],
    np.float64,
)
RAY_OFFSETS_PM = np.concatenate([RAY_OFFSETS, -RAY_OFFSETS])  # 20 rays


class CDLProfile(NamedTuple):
    # per-cluster rows: (normalized delay, power dB, AoD, AoA, ZoD, ZoA)
    rows: np.ndarray
    c_asd: float
    c_asa: float
    c_zsd: float
    c_zsa: float
    xpr_db: float
    los: bool  # first row is the specular LOS ray (not split into subrays)


def _rows(data) -> np.ndarray:
    return np.array(data, np.float64)


# Tables transcribed from 3GPP TR 38.901 §7.7.1 (Tables 7.7.1-1 … 7.7.1-5).
CDL_PROFILES: Dict[str, CDLProfile] = {
    "CDL-A": CDLProfile(
        _rows([
            [0.0000, -13.4, -178.1, 51.3, 50.2, 125.4],
            [0.3819, 0.0, -4.2, -152.7, 93.2, 91.3],
            [0.4025, -2.2, -4.2, -152.7, 93.2, 91.3],
            [0.5868, -4.0, -4.2, -152.7, 93.2, 91.3],
            [0.4610, -6.0, 90.2, 76.6, 122.0, 94.0],
            [0.5375, -8.2, 90.2, 76.6, 122.0, 94.0],
            [0.6708, -9.9, 90.2, 76.6, 122.0, 94.0],
            [0.5750, -10.5, 121.5, -1.8, 150.2, 47.1],
            [0.7618, -7.5, -81.7, -41.9, 55.2, 56.0],
            [1.5375, -15.9, 158.4, 94.2, 26.4, 30.1],
            [1.8978, -6.6, -83.0, 51.9, 126.4, 58.8],
            [2.2242, -16.7, 134.8, -115.9, 171.6, 26.0],
            [2.1718, -12.4, -153.0, 26.6, 151.4, 49.2],
            [2.4942, -15.2, -172.0, 76.6, 157.2, 143.1],
            [2.5119, -10.8, -129.9, -7.0, 47.2, 117.4],
            [3.0582, -11.3, -136.0, -23.0, 40.4, 122.7],
            [4.0810, -12.7, 165.4, -47.2, 43.3, 123.2],
            [4.4579, -16.2, 148.4, 110.4, 161.8, 32.6],
            [4.5695, -18.3, 132.7, 144.5, 10.8, 27.2],
            [4.7966, -18.9, -118.6, 155.3, 16.7, 15.2],
            [5.0066, -16.6, -154.1, 102.0, 171.7, 146.0],
            [5.3043, -19.9, 126.5, -151.8, 22.7, 150.7],
            [9.6586, -29.7, -56.2, 55.2, 144.9, 156.1],
        ]),
        c_asd=5.0, c_asa=11.0, c_zsd=3.0, c_zsa=3.0, xpr_db=10.0, los=False,
    ),
    "CDL-B": CDLProfile(
        _rows([
            [0.0000, 0.0, 9.3, -173.3, 105.8, 78.9],
            [0.1072, -2.2, 9.3, -173.3, 105.8, 78.9],
            [0.2155, -4.0, 9.3, -173.3, 105.8, 78.9],
            [0.2095, -3.2, -34.1, 125.5, 115.3, 63.3],
            [0.2870, -9.8, -65.4, -88.0, 119.3, 59.9],
            [0.2986, -1.2, -11.4, 155.1, 103.2, 67.5],
            [0.3752, -3.4, -11.4, 155.1, 103.2, 67.5],
            [0.5055, -5.2, -11.4, 155.1, 103.2, 67.5],
            [0.3681, -7.6, -67.2, -89.8, 118.2, 82.6],
            [0.3697, -3.0, 52.5, 132.1, 102.0, 66.3],
            [0.5700, -8.9, -72.0, -83.6, 100.4, 61.6],
            [0.5283, -9.0, 74.3, 95.3, 98.3, 58.0],
            [1.1021, -4.8, -52.2, 103.7, 103.4, 78.2],
            [1.2756, -5.7, -50.5, -87.8, 102.5, 82.0],
            [1.5474, -7.5, 61.4, -92.5, 101.4, 62.4],
            [1.7842, -1.9, 30.6, -139.1, 103.0, 78.0],
            [2.0169, -7.6, -72.5, -90.6, 100.0, 60.9],
            [2.8294, -12.2, -90.6, 58.6, 115.2, 82.9],
            [3.0219, -9.8, -77.6, -79.0, 100.5, 60.8],
            [3.6187, -11.4, -82.6, 65.8, 119.6, 57.3],
            [4.1067, -14.9, -103.6, 52.7, 118.7, 59.9],
            [4.2790, -9.2, 75.6, 88.7, 117.8, 60.1],
            [4.7834, -11.3, -77.6, -60.4, 115.7, 62.3],
        ]),
        c_asd=10.0, c_asa=22.0, c_zsd=3.0, c_zsa=7.0, xpr_db=8.0, los=False,
    ),
    "CDL-C": CDLProfile(
        _rows([
            [0.0000, -4.4, -46.6, -101.0, 97.2, 87.6],
            [0.2099, -1.2, -22.8, 120.0, 98.6, 72.1],
            [0.2219, -3.5, -22.8, 120.0, 98.6, 72.1],
            [0.2329, -5.2, -22.8, 120.0, 98.6, 72.1],
            [0.2176, -2.5, -40.7, -127.5, 100.6, 70.1],
            [0.6366, 0.0, 0.3, 170.4, 99.2, 75.3],
            [0.6448, -2.2, 0.3, 170.4, 99.2, 75.3],
            [0.6560, -3.9, 0.3, 170.4, 99.2, 75.3],
            [0.6584, -7.4, 73.1, 55.4, 105.2, 67.4],
            [0.7935, -7.1, -64.5, 66.5, 95.3, 63.8],
            [0.8213, -10.7, 80.2, -48.1, 106.1, 71.4],
            [0.9336, -11.1, -97.1, 46.9, 93.5, 60.5],
            [1.2285, -5.1, -55.3, 68.1, 103.7, 90.6],
            [1.3083, -6.8, -64.3, -68.7, 104.2, 60.1],
            [2.1704, -8.7, -78.5, 81.5, 93.0, 61.0],
            [2.7105, -13.2, 102.7, 30.7, 104.2, 100.7],
            [4.2589, -13.9, 99.2, -16.4, 94.9, 62.3],
            [4.6003, -13.9, 88.8, 3.8, 93.1, 66.7],
            [5.4902, -15.8, -101.9, -13.7, 92.2, 52.9],
            [5.6077, -17.1, 92.2, 9.7, 106.7, 61.8],
            [6.3065, -16.0, 93.3, 5.6, 93.0, 51.9],
            [6.6374, -15.7, 106.6, 0.7, 92.9, 61.7],
            [7.0427, -21.6, 119.5, -21.9, 105.2, 58.0],
            [8.6523, -22.8, -123.8, 33.6, 107.8, 57.0],
        ]),
        c_asd=2.0, c_asa=15.0, c_zsd=3.0, c_zsa=7.0, xpr_db=7.0, los=False,
    ),
    "CDL-D": CDLProfile(
        _rows([
            # row 0: LOS specular ray of cluster 1
            [0.0000, -0.2, 0.0, -180.0, 98.5, 81.5],
            [0.0000, -13.5, 0.0, -180.0, 98.5, 81.5],
            [0.035, -18.8, 89.2, 89.2, 85.5, 86.9],
            [0.612, -21.0, 89.2, 89.2, 85.5, 86.9],
            [1.363, -22.8, 89.2, 89.2, 85.5, 86.9],
            [1.405, -17.9, 13.0, 163.0, 97.5, 79.4],
            [1.804, -20.1, 13.0, 163.0, 97.5, 79.4],
            [2.596, -21.9, 13.0, 163.0, 97.5, 79.4],
            [1.775, -22.9, 34.6, -137.0, 98.5, 78.3],
            [4.042, -27.8, -64.5, 74.5, 88.4, 73.6],
            [7.937, -23.6, -32.9, 127.7, 91.3, 78.9],
            [9.424, -24.8, 52.6, -119.6, 103.8, 87.8],
            [9.708, -30.0, -132.1, -9.1, 80.3, 70.8],
            [12.525, -27.7, 77.2, -83.8, 86.5, 72.8],
        ]),
        c_asd=5.0, c_asa=8.0, c_zsd=3.0, c_zsa=3.0, xpr_db=11.0, los=True,
    ),
    "CDL-E": CDLProfile(
        _rows([
            [0.0000, -0.03, 0.0, -180.0, 99.6, 80.4],
            [0.0000, -22.03, 0.0, -180.0, 99.6, 80.4],
            [0.5133, -15.8, 57.5, 18.2, 104.2, 80.4],
            [0.5440, -18.1, 57.5, 18.2, 104.2, 80.4],
            [0.5630, -19.8, 57.5, 18.2, 104.2, 80.4],
            [0.5440, -22.9, -20.1, 101.8, 99.4, 80.8],
            [0.7112, -22.4, 16.2, 112.9, 100.8, 86.3],
            [1.9092, -18.6, 9.3, -155.5, 98.8, 82.7],
            [1.9293, -20.8, 9.3, -155.5, 98.8, 82.7],
            [1.9589, -22.6, 9.3, -155.5, 98.8, 82.7],
            [2.6426, -22.3, 19.0, -143.3, 100.8, 82.9],
            [3.7136, -25.6, 32.7, -94.7, 96.4, 88.0],
            [5.4524, -20.2, 0.5, 147.0, 98.9, 81.0],
            [12.0034, -29.8, 55.9, -36.2, 95.6, 88.6],
            [20.6419, -29.2, 57.6, -26.0, 104.6, 78.3],
        ]),
        c_asd=5.0, c_asa=11.0, c_zsd=3.0, c_zsa=7.0, xpr_db=8.0, los=True,
    ),
}



def _f32(v: float) -> float:
    """v rounded to float32, as a Python float."""
    return float(np.float32(v))


def _vertical_ula_response(zenith: torch.Tensor, n_elem: int,
                           spacing: float) -> torch.Tensor:
    """Response of an n-element vertical ULA at spacing wavelengths:
    exp(j 2 pi d k cos(zenith)), zenith (...,) f32 -> (..., n_elem)
    complex64 (genChannels.m:13-16 puts the elements along the zenith)."""
    k = torch.arange(n_elem, dtype=torch.float32)
    c = _f32(_f32(2.0 * np.pi) * _f32(spacing))  # f32(2 pi) * f32(d)
    phase = c * torch.cos(zenith)[..., None] * k
    return torch.polar(torch.ones_like(phase), phase)


def cdl_core(profile_name: str, phases: torch.Tensor, perm_z: torch.Tensor,
             num_rx: int = 16, num_tx: int = 64, spacing: float = 0.5,
             delay_spread_s: float = 30e-9, subcarrier_hz: float = 15e3,
             num_subcarriers: int = 10, subcarrier_gap: int = 24
             ) -> torch.Tensor:
    """CDL realizations from their draws: phases (..., C, 20) f32 in
    [0, 2 pi), perm_z (..., C, 20) int64, each row a permutation of the 20
    arrival rays of a cluster -> (..., S, Nr, Nt) complex64.

    The arithmetic of the JAX package's _generate_one (cdl.py:210-291) in
    the same float32 steps; for a LOS profile row 0 is the specular ray at
    the exact cluster angles with the full cluster power (cdl.py:268-277).
    """
    prof = CDL_PROFILES[profile_name]
    rows = prof.rows
    n_clusters, n_rays = rows.shape[0], RAY_OFFSETS_PM.shape[0]
    if phases.shape[-2:] != (n_clusters, n_rays) or perm_z.shape != phases.shape:
        raise ValueError(f"{profile_name} takes phases and perm_z of shape "
                         f"(..., {n_clusters}, {n_rays}), got "
                         f"{tuple(phases.shape)} and {tuple(perm_z.shape)}")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    delays = f32(rows[:, 0]) * _f32(delay_spread_s)               # (C,)
    powers = f32(10.0 ** (rows[:, 1] / 10.0))
    powers = powers / powers.sum()
    deg = np.pi / 180.0
    zod = f32(rows[:, 4]) * deg
    zoa = f32(rows[:, 5]) * deg
    offs = f32(RAY_OFFSETS_PM).expand(*phases.shape)               # (..., C, M)

    # departure rays keep table order; arrival rays are coupled by perm_z
    ray_zod = zod[:, None] + (prof.c_zsd * deg) * offs
    ray_zoa = zoa[:, None] + (prof.c_zsa * deg) * torch.take_along_dim(
        offs, perm_z, dim=-1)
    a_rx = _vertical_ula_response(ray_zoa, num_rx, spacing)       # (..., C, M, Nr)
    a_tx = _vertical_ula_response(ray_zod, num_tx, spacing)       # (..., C, M, Nt)
    amp = torch.sqrt(powers / n_rays)[:, None]                    # (C, 1)
    gain = amp * torch.polar(torch.ones_like(phases), phases)     # (..., C, M)
    if prof.los:
        los_rx = _vertical_ula_response(zoa[0], num_rx, spacing)
        los_tx = _vertical_ula_response(zod[0], num_tx, spacing)
        a_rx = a_rx.clone()
        a_tx = a_tx.clone()
        a_rx[..., 0, :, :] = los_rx
        a_tx[..., 0, :, :] = los_tx
        first = torch.zeros(n_rays, dtype=torch.float32)
        first[0] = 1.0
        gain = gain.clone()
        gain[..., 0, :] = (torch.sqrt(powers[0]) * torch.polar(
            torch.ones_like(phases[..., 0, :1]), phases[..., 0, :1])) * first

    # per-cluster channels H_c = sum_m g_cm a_rx (x) a_tx  -> (..., C, Nr, Nt)
    H_c = torch.einsum("...cmr,...cmt->...crt", gain[..., None] * a_rx, a_tx)
    sc = torch.arange(num_subcarriers, dtype=torch.float32) * subcarrier_gap
    freqs = sc * _f32(subcarrier_hz)                              # (S,)
    arg = (_f32(-2.0 * np.pi) * freqs)[:, None] * delays[None, :]  # (S, C)
    phase_f = torch.polar(torch.ones_like(arg), arg)
    return torch.einsum("sc,...crt->...srt", phase_f, H_c)


def cdl_draws(generator: torch.Generator, num_channels: int, profile: str,
              ray_coupling: str = "random"):
    """(phases, perm_z) of num_channels realizations, drawn on the CPU:
    phases uniform in [0, 2 pi), and for "random" coupling an independent
    uniform permutation of each cluster's arrival rays (the argsort of
    uniform draws); "fixed" keeps the table pairing (DataConfig.ray_coupling)."""
    shape = (num_channels, CDL_PROFILES[profile].rows.shape[0],
             RAY_OFFSETS_PM.shape[0])
    phases = torch.rand(shape, generator=generator) * _f32(2.0 * np.pi)
    if ray_coupling == "random":
        perm_z = torch.rand(shape, generator=generator).argsort(dim=-1)
    elif ray_coupling == "fixed":
        perm_z = torch.arange(shape[-1]).expand(shape)
    else:
        raise ValueError(ray_coupling)
    return phases, perm_z


def generate_cdl_channels(
    seed: int,
    profile: str = "CDL-C",
    num_channels: int = 200,
    num_rx: int = 16,
    num_tx: int = 64,
    spacing: float = 0.5,
    delay_spread_s: float = 30e-9,
    subcarrier_hz: float = 15e3,
    num_subcarriers: int = 10,
    subcarrier_gap: int = 24,
    ray_coupling: str = "random",
) -> np.ndarray:
    """num_channels CDL realizations -> (N, S, Nr, Nt) complex64 host array.

    Defaults mirror matlab/generate_data.m:8-21 (30 ns delay spread, 200
    channels, 10 subcarriers 24 apart at 15 kHz, lambda/2 ULAs). The draws
    come from a CPU generator seeded by (seed, crc32(profile)), so a
    (seed, profile) pair names one data set on every machine.
    """
    state = np.random.SeedSequence(
        [seed, zlib.crc32(profile.encode()) % (2**31)]).generate_state(
            1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(state >> np.uint64(1)))
    phases, perm_z = cdl_draws(g, num_channels, profile, ray_coupling)
    H = cdl_core(profile, phases, perm_z, num_rx, num_tx, spacing,
                 delay_spread_s, subcarrier_hz, num_subcarriers,
                 subcarrier_gap)
    return H.numpy()
