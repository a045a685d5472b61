"""What the drivers share: the port's configuration built from a
configuration file, the data sets made from the seed, comparisons."""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..channels import cdl_c, global_norm, write_channel_file
from ..reference.common import derive_seed


def port_config(cfg: dict):
    """The port's `Config` of a score-model configuration file."""
    from score_based_channels_torch.config import default_score_config

    c = default_score_config(cfg["data"]["channel"])
    m = cfg.get("model", {})
    model = dataclasses.replace(
        c.model, **{k: m[k] for k in ("arch", "ngf", "nonlinearity",
                                      "normalization") if k in m},
        **cfg.get("sigmas", {}))
    sampling = dataclasses.replace(c.sampling, **cfg.get("sampling", {}))
    d = cfg["data"]
    data = dataclasses.replace(
        c.data, num_tx=d["num_tx"], num_rx=d["num_rx"],
        spacing_list=(d["spacing"],), num_channels=d["train_channels"],
        norm_channels=d["norm"])
    t = cfg.get("training", {})
    optim = dataclasses.replace(c.optim, **{k: t[k] for k in (
        "optimizer", "lr", "beta1", "beta2", "eps") if k in t})
    training = dataclasses.replace(c.training, **{k: t[k] for k in (
        "batch_size", "anneal_power", "log_every_steps") if k in t})
    if "ema_rate" in t:
        model = dataclasses.replace(model, ema_rate=t["ema_rate"])
    return c.replace(model=model, sampling=sampling, data=data, optim=optim,
                     training=training)


DATA_DIR = Path(__file__).resolve().parents[2] / "build" / "perfbench-data"


def program_dataset(channels: np.ndarray, data, tag: int, norm,
                    num_pilots: Optional[int] = None):
    """The port's `ChannelDataset` of raw channels (N, Nr, Nt), read by its
    own loader from a channel file (`source="file"`), as users hand it the
    published data. The file goes into a directory of its own under
    build/perfbench-data/, removed once read. `data` is the port's
    `DataConfig`; `tag` is the seed in the file's name."""
    from score_based_channels_torch.data.dataset import (
        ChannelDataset, channel_filename)

    DATA_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as d:
        data = dataclasses.replace(data, source="file", data_dir=d,
                                   spacing_list=(data.spacing_list[0],),
                                   num_channels=channels.shape[0])
        path = Path(channel_filename(d, data.channel, data.num_tx,
                                     data.num_rx, data.spacing_list[0], tag))
        write_channel_file(path.parent, path.name, channels)
        return ChannelDataset(tag, data, norm=norm, num_pilots=num_pilots)


def raw_channels(cfg: dict, seed: int, which: int) -> np.ndarray:
    """The raw channels of data set `which` (1 training, 2 validation) of a
    run, made from its seed by the benchmark's own generator."""
    d = cfg["data"]
    return cdl_c(derive_seed(seed, which) % 2**31, d["train_channels"],
                 d["num_rx"], d["num_tx"], d["spacing"])


def datasets(cfg: dict, config, seed: int, num_pilots: int):
    """(raw training channels, raw validation channels, the port's training
    set, the port's validation set): the validation set normalised by the
    training set's statistics, as `run_estimation` and `train` do."""
    tr_raw, val_raw = raw_channels(cfg, seed, 1), raw_channels(cfg, seed, 2)
    tag = derive_seed(seed, 8) % 2**31
    train = program_dataset(tr_raw, config.data, tag,
                            config.data.norm_channels)
    val = program_dataset(val_raw, config.data, tag + 1,
                          list(train.norm_stats), num_pilots)
    return tr_raw, val_raw, train, val


def hermitian_c2(channels: np.ndarray, train: np.ndarray) -> torch.Tensor:
    """The normalised H^H of raw (N, Nr, Nt) channels as (N, Nt, Nr, 2),
    normalised by the raw training set's global statistics (the
    reference's input, worked out from the raw data)."""
    mean, std = global_norm(train)
    h = ((channels - mean) / std).astype(np.complex64)
    h = np.conj(np.swapaxes(h, -1, -2))
    return torch.from_numpy(np.stack([h.real, h.imag], -1).astype(np.float32))


def worst(values) -> float:
    """The largest of the values, NaN if any is NaN."""
    vals = [float(v) for v in values]
    return float("nan") if any(v != v for v in vals) else max(vals)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> List[float]:
    """|norm(program leaf) - norm(reference leaf)| for each leaf in `keep`,
    measured against the larger of its reference norm and the median
    leaf's."""
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(rn.values())))
    return [abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
            for k in keep]


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor], keep: List[str]) -> float:
    """The largest of the `leaf_gaps` (NaN if any is NaN)."""
    return worst(leaf_gaps(prog, ref, keep))


def quartile_leaf_gap(prog: Dict[str, torch.Tensor],
                      ref: Dict[str, torch.Tensor], keep: List[str]) -> float:
    """The lower quartile of the `leaf_gaps` (NaN if any is NaN): a gap
    that a quarter of the leaves reach. A precision lost everywhere moves
    it; a gap confined to fewer than three quarters of the leaves, such as
    a max pool's gradient sent to another of two all but equal inputs,
    does not."""
    gaps = leaf_gaps(prog, ref, keep)
    return (float("nan") if any(g != g for g in gaps)
            else float(np.quantile(gaps, 0.25)))


def moving_leaves(grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: a
    norm at least a thousandth of the median leaf's."""
    n = {k: float(v.double().norm()) for k, v in grad.items()}
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= 1e-3 * med]
