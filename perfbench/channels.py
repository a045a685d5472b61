"""The cells' channels, made by the benchmark from the seed and handed the
same to the program and to the reference.

A frozen copy of the 3GPP TR 38.901 clustered delay-line generator (CDL-C
only) as the reference's MATLAB path configures it (matlab/
generate_data.m, genChannels.m): per-cluster powers, delays and zenith
angles from Table 7.7.1-3, 20 rays a cluster at the Table 7.5-3 offsets
scaled by the cluster's zenith spreads, random per-ray phases and
arrival-ray coupling, vertical ULAs of Nt / Nr elements, and the
narrowband response at 10 subcarriers 24 apart at 15 kHz, of which the
data sets keep the first. One polarization, isotropic elements, no
Doppler. The draws come from a CPU generator seeded by (seed,
crc32(profile)); the arithmetic is float32 / complex64 torch ops in a
fixed order, so a seed names one data set.

The program reads the channels as its users' channel files
(`output_h`, (N, S, Nr, Nt) complex64 in an .npz) through its own loader
and normalises them itself; the reference normalises the same raw
channels by `global_norm`.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np
import torch

# TR 38.901 Table 7.5-3: ray offset angles (+-, degrees, unit spread)
RAY_OFFSETS = np.array(
    [0.0447, 0.1413, 0.2492, 0.3715, 0.5129, 0.6797, 0.8844, 1.1481,
     1.5195, 2.1551], np.float64)
RAY_OFFSETS_PM = np.concatenate([RAY_OFFSETS, -RAY_OFFSETS])  # 20 rays

# TR 38.901 Table 7.7.1-3 (CDL-C): normalized delay, power dB, AoD, AoA,
# ZoD, ZoA per cluster; the zenith spreads c_ZSD, c_ZSA in degrees
CDL_C = np.array([
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
], np.float64)
C_ZSD, C_ZSA = 3.0, 7.0
DELAY_SPREAD_S = 30e-9
SUBCARRIER_HZ = 15e3
SUBCARRIERS, SUBCARRIER_GAP = 10, 24


def _f32(v: float) -> float:
    return float(np.float32(v))


def _ula(zenith: torch.Tensor, n: int, spacing: float) -> torch.Tensor:
    """exp(j 2 pi d k cos(zenith)) of an n-element vertical ULA."""
    k = torch.arange(n, dtype=torch.float32)
    c = _f32(_f32(2.0 * np.pi) * _f32(spacing))
    phase = c * torch.cos(zenith)[..., None] * k
    return torch.polar(torch.ones_like(phase), phase)


def cdl_c(seed: int, num_channels: int, num_rx: int = 16, num_tx: int = 64,
          spacing: float = 0.5) -> np.ndarray:
    """num_channels CDL-C channels of subcarrier 0 -> (N, Nr, Nt) complex64."""
    state = np.random.SeedSequence(
        [seed, zlib.crc32(b"CDL-C") % (2**31)]).generate_state(1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(state >> np.uint64(1)))
    shape = (num_channels, CDL_C.shape[0], RAY_OFFSETS_PM.shape[0])
    phases = torch.rand(shape, generator=g) * _f32(2.0 * np.pi)
    perm_z = torch.rand(shape, generator=g).argsort(dim=-1)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    delays = f32(CDL_C[:, 0]) * _f32(DELAY_SPREAD_S)
    powers = f32(10.0 ** (CDL_C[:, 1] / 10.0))
    powers = powers / powers.sum()
    deg = np.pi / 180.0
    zod, zoa = f32(CDL_C[:, 4]) * deg, f32(CDL_C[:, 5]) * deg
    offs = f32(RAY_OFFSETS_PM).expand(*shape)
    ray_zod = zod[:, None] + (C_ZSD * deg) * offs
    ray_zoa = zoa[:, None] + (C_ZSA * deg) * torch.take_along_dim(
        offs, perm_z, dim=-1)
    a_rx = _ula(ray_zoa, num_rx, spacing)
    a_tx = _ula(ray_zod, num_tx, spacing)
    amp = torch.sqrt(powers / shape[-1])[:, None]
    gain = amp * torch.polar(torch.ones_like(phases), phases)
    H_c = torch.einsum("...cmr,...cmt->...crt", gain[..., None] * a_rx, a_tx)
    sc = torch.arange(SUBCARRIERS, dtype=torch.float32) * SUBCARRIER_GAP
    arg = (_f32(-2.0 * np.pi) * (sc * _f32(SUBCARRIER_HZ)))[:, None] \
        * delays[None, :]
    phase_f = torch.polar(torch.ones_like(arg), arg)
    H = torch.einsum("sc,...crt->...srt", phase_f, H_c)
    return np.ascontiguousarray(H[:, 0].numpy())


def global_norm(train: np.ndarray):
    """The 'global' normalisation of a training set: (mean 0, the std of
    the whole complex tensor)."""
    return 0.0, float(np.std(train))


def write_channel_file(directory: Path, name: str,
                       channels: np.ndarray) -> Path:
    """channels (N, Nr, Nt) as a channel file `output_h` (N, 1, Nr, Nt)."""
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / name
    np.savez(path, output_h=channels[:, None])
    return path
