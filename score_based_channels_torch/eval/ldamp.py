"""LDAMP evaluation over SNR, the counterpart of the JAX package's
eval/ldamp.py (reference test_ldamp.py): the per-SNR checkpoints that
`train-ldamp` of either package wrote, each run on the validation
channels at its own SNR, on the card by default: the host draws each
SNR's batch, the device assembles it (`ldamp_inputs`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import cplx
from .._device import resolve_device
from ..config import Config
from ..data.dataset import ChannelDataset
from ..models.convert import jax_params_to_state_dict
from ..train.ldamp import (
    LDAMPTrainConfig, checkpoint_name, ldamp_batch, ldamp_inputs,
    make_ldamp_model,
)
from ..train.score import matmul_precision
from ..utils.checkpoint import load_checkpoint
from .estimate import derive_seed


@dataclasses.dataclass
class LDAMPResults:
    nmse: np.ndarray  # (n_snr, n_channels)
    snr_range: np.ndarray

    def avg_db(self) -> np.ndarray:
        return 10 * np.log10(self.nmse.mean(-1))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **dataclasses.asdict(self))


@torch.no_grad()
def run_ldamp_eval(
    config: Config,
    channel: str = "CDL-C",
    snr_range: Sequence[float] = tuple(np.arange(-10, 35, 5)),
    alpha: float = 0.6,
    model_dir: str = "models/ldamp-FlippedUNet",
    num_channels: int = 100,
    val_seed: int = 4321,
    seed: int = 17,
    device: Optional[Union[str, torch.device]] = None,
    _batches: Optional[Callable[[int], dict]] = None,
    _directions: Optional[Callable[[int], Sequence[torch.Tensor]]] = None,
) -> LDAMPResults:
    """NMSE of each SNR's model on `num_channels` validation channels.
    `_batches(i)` and `_directions(i)` replace SNR point i's own draws."""
    dev = resolve_device(device)
    num_pilots = int(config.data.num_tx * alpha)
    out = np.zeros((len(snr_range), num_channels), np.float32)
    with matmul_precision(config.training.matmul_precision):
        for i, snr in enumerate(snr_range):
            ck = load_checkpoint(
                checkpoint_name(model_dir, channel, snr, alpha))
            meta = ck["metadata"]
            tc = (LDAMPTrainConfig(**meta["tc"]) if "tc" in meta
                  else LDAMPTrainConfig())
            model = make_ldamp_model(tc, dev)
            model.load_state_dict(jax_params_to_state_dict(ck["params"]),
                                  strict=True)
            if _batches is not None:
                batch = {k: v.to(dev) for k, v in _batches(i).items()}
            else:
                noise_std = 10 ** (-snr / 20.0) * np.sqrt(config.data.num_tx)
                val_cfg = dataclasses.replace(
                    config.data, channel=channel, noise_std=float(noise_std),
                    num_pilots=num_pilots,
                    num_channels=max(num_channels, config.data.num_channels))
                ds = ChannelDataset(val_seed, val_cfg, norm="global")
                batch = ldamp_batch(ds, torch.Generator().manual_seed(
                    derive_seed(seed, i, 0)), min(num_channels, len(ds)), dev)
            batch = ldamp_inputs(batch)
            gen = torch.Generator(device=dev).manual_seed(
                derive_seed(seed, i, 1))
            h = model(batch["Y_herm"], batch["P_herm"], batch["eig1"], gen,
                      tc.max_unrolls,
                      _directions(i) if _directions is not None else None)
            out[i, :h.shape[0]] = cplx.nmse(
                h, batch["H_herm_cplx"]).cpu().numpy()
    return LDAMPResults(nmse=out, snr_range=np.asarray(snr_range, np.float64))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Evaluate LDAMP per-SNR models")
    p.add_argument("--train", type=str, default="CDL-C")
    p.add_argument("--alpha", type=float, default=0.6)
    p.add_argument("--snr_range", nargs="+", type=float,
                   default=list(np.arange(-10, 35, 5)))
    p.add_argument("--num_channels", type=int, default=100)
    p.add_argument("--model_dir", type=str,
                   default="models/ldamp-FlippedUNet")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--ray_coupling", type=str, default=None,
                   choices=["random", "fixed"],
                   help="dataset ensemble override (fixed = the "
                        "paper-matching per-drop coupling)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)

    from ..config import default_score_config

    cfg = default_score_config(args.train, ray_coupling=args.ray_coupling)
    res = run_ldamp_eval(cfg, channel=args.train, snr_range=args.snr_range,
                         alpha=args.alpha, model_dir=args.model_dir,
                         num_channels=args.num_channels, device=args.device)
    for s, snr in enumerate(res.snr_range):
        print(f"SNR {snr:6.1f} dB  NMSE {res.avg_db()[s]:7.2f} dB")
    out = args.output or f"results/ldamp/{args.train}_alpha{args.alpha:.2f}.npz"
    res.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
