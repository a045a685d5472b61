"""Channel dataset, the counterpart of the JAX package's
data/dataset.py:45-146: realizations read from files (`source="file"`) or
made by the built-in CDL generator (`source="cdl"`, data/cdl.py).

Semantics kept from the reference loader (loaders.py:8-107): only
subcarrier 0 of each file is used; 'global' norm is mean 0 and the std of
the whole complex train tensor, 'entrywise' is per-entry mean/std, and an
explicit [mean, std] passes the TRAIN stats to a val/test set; the network
sees the normalised Hermitian H^H.

`sample_draws` makes a batch's draws, pilots and measurement noise
included (loaders.py:52-106), and nothing else: LDAMP trains and
evaluates on them, assembled on the run's device
(train/ldamp.py::ldamp_inputs). Deliberate deviation there, kept from the
JAX package (data/dataset.py:21-24): `eig1` is the true largest
eigenvalue of P P^H, where the reference takes the first, unsorted
eigenvalue of np.linalg.eigvals.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config, DataConfig
from ..utils.spans import span
from .cdl import generate_cdl_channels
from .io import load_output_h

NormSpec = Union[None, str, Tuple[np.ndarray, np.ndarray], list]


def channel_filename(data_dir: str, profile: str, num_tx: int, num_rx: int,
                     spacing: float, seed: int, ext: str = "npz") -> str:
    """Reference artifact naming (loaders.py:23-24)."""
    return os.path.join(
        data_dir,
        f"{profile}_Nt{num_tx}_Nr{num_rx}_ULA{spacing:.2f}_seed{seed}.{ext}")


class ChannelDataset:
    """Channel realizations for one (profile, seed) across spacings."""

    def __init__(self, seed: int, config: Union[Config, DataConfig],
                 norm: NormSpec = None, num_pilots: Optional[int] = None):
        data = config.data if isinstance(config, Config) else config
        if data.source not in ("file", "cdl"):
            raise ValueError(f"unknown data source {data.source!r}")
        self.config = data
        self.num_pilots = int(num_pilots if num_pilots is not None
                              else data.num_pilots)
        chans = []
        for spacing in data.spacing_list:
            if data.source == "cdl":
                output_h = generate_cdl_channels(
                    seed=seed, profile=data.channel,
                    num_channels=data.num_channels, num_rx=data.num_rx,
                    num_tx=data.num_tx, spacing=spacing,
                    ray_coupling=data.ray_coupling)
            else:
                cands = [channel_filename(data.data_dir, data.channel,
                                          data.num_tx, data.num_rx, spacing,
                                          seed, ext)
                         for ext in ("npz", "mat", "h5")]
                path = next((c for c in cands if os.path.exists(c)), None)
                if path is None:
                    raise FileNotFoundError(
                        f"no channel file for {data.channel} spacing "
                        f"{spacing} seed {seed} under {data.data_dir}")
                output_h = load_output_h(path)
            # keep only the first subcarrier (loaders.py:33)
            chans.append(np.asarray(output_h[:, 0], np.complex64))
        self.channels = np.reshape(
            np.asarray(chans), (-1, chans[0].shape[-2], chans[0].shape[-1]))

        if isinstance(norm, (tuple, list)):
            self.mean, self.std = norm[0], norm[1]
        elif norm == "entrywise":
            self.mean = np.mean(self.channels, axis=0)
            self.std = np.std(self.channels, axis=0)
        elif norm == "global":
            self.mean = 0.0
            self.std = float(np.std(self.channels))
        elif norm is None:
            self.mean, self.std = 0.0, 1.0
        else:
            raise ValueError(f"unknown norm {norm!r}")
        self.noise_amp = data.noise_std / np.sqrt(2.0)  # loaders.py:58

    def __len__(self) -> int:
        return self.channels.shape[0]

    @property
    def norm_stats(self):
        return (self.mean, self.std)

    def normalized(self) -> np.ndarray:
        """(N, Nr, Nt) complex64, (H - mean)/std."""
        return ((self.channels - self.mean) / self.std).astype(np.complex64)

    def hermitian(self, normalized: bool = True) -> np.ndarray:
        """H^H -> (N, Nt, Nr) complex64."""
        h = self.normalized() if normalized else self.channels
        return np.conj(np.swapaxes(h, -1, -2))

    def hermitian_c2(self, normalized: bool = True) -> torch.Tensor:
        """H^H in c2 -> (N, Nt, Nr, 2) float32 CPU tensor."""
        from .. import cplx

        return cplx.from_complex(self.hermitian(normalized=normalized))

    def network_input(self) -> torch.Tensor:
        """(N, Nt, Nr, 2) float32 CPU tensor, the normalised H^H as the
        score network takes it (loaders.py:90-91), contiguous."""
        return self.hermitian_c2(normalized=True).contiguous()

    def sample_draws(self, generator: torch.Generator,
                     batch_size: Optional[int] = None,
                     with_measurements: bool = True) -> dict:
        """A batch's draws from `generator` (a CPU generator: the draws are
        the same whatever the run's device), in the reference loader's
        order (loaders.py:97-106; the JAX package's data/dataset.py:148-204),
        and nothing computed from them. CPU tensors:

          idx         (B,)              realization indices (randperm,
                                        without replacement)
          H           (B, Nr, Nt)       the raw (unnormalised) rows, complex
          pilot_bits  (B, Nt, Np, 2)    the QPSK pilots' 0/1 draws, uint8
          noise       (B, Nr, Np, 2)    the measurement noise's unit draws,
                                        float32; None without measurements
                                        or at noise amplitude 0
        """
        from .. import cplx

        with span("data.sample_batch"):
            n = len(self)
            idx = (torch.arange(n) if batch_size is None else
                   torch.randperm(n, generator=generator)[:batch_size])
            H_raw = torch.from_numpy(self.channels)[idx]
            bits = cplx.qpsk_bits(generator, H_raw.shape[0],
                                  self.config.num_tx, self.num_pilots,
                                  dtype=torch.uint8)
            noise = None
            if with_measurements and self.noise_amp > 0:
                noise = torch.randn(
                    (H_raw.shape[0], H_raw.shape[1], self.num_pilots, 2),
                    generator=generator)
            return {"idx": idx, "H": H_raw, "pilot_bits": bits,
                    "noise": noise}
