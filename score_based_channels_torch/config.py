"""Typed configuration, a copy of the JAX package's config.py.

The port keeps its own copy so that it imports nothing of the JAX package;
the dataclasses and their dict/JSON forms are the same, so the `__meta__`
config inside a checkpoint written by the JAX package parses here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Score-network architecture + σ-schedule.

    Mirrors reference train_score.py:37-43 and 98-101.
    """

    # Architecture
    arch: str = "ncsnv2_deepest"  # {ncsnv2, ncsnv2_deeper, ncsnv2_deepest}
    ngf: int = 32
    nonlinearity: str = "elu"
    normalization: str = "InstanceNorm++"
    # Explicit encodings of DotMap-falsiness behaviors in the reference:
    input_transform: str = "affine_2x_minus_1"  # ncsnv2.py:270-273 (always hit)
    conditional_norm: bool = False  # ncsnv2.py:203 get_normalization(conditional=False)

    # σ-schedule (geometric: train_score.py:98-101)
    sigma_dist: str = "geometric"
    num_classes: int = 2311  # number of noise levels N
    sigma_begin: float = 39.15
    sigma_rate: float = 0.995

    # EMA (train_score.py:37-38)
    ema: bool = True
    ema_rate: float = 0.999

    @property
    def sigma_end(self) -> float:
        # train_score.py:100-101
        return self.sigma_begin * self.sigma_rate ** (self.num_classes - 1)


@dataclass(frozen=True)
class OptimConfig:
    """Adam settings (reference train_score.py:46-51; note eps=1e-3)."""

    optimizer: str = "Adam"
    lr: float = 1e-4
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    amsgrad: bool = False
    eps: float = 1e-3  # train_score.py:51 — deliberately large


@dataclass(frozen=True)
class TrainingConfig:
    """Reference train_score.py:54-58."""

    batch_size: int = 32
    n_epochs: int = 400
    anneal_power: float = 2.0
    log_every_steps: int = 100
    seed: int = 0
    # TPU additions
    data_parallel: bool = True  # pjit over a ('data',) mesh
    matmul_precision: str = "highest"  # parity-first; relax after validation


@dataclass(frozen=True)
class DataConfig:
    """Reference train_score.py:61-67 and loaders.py semantics.

    image_size is [Nr, Nt] of the physical channel H ∈ C^{Nr×Nt}; the score
    network consumes the Hermitian view H^H ∈ C^{Nt×Nr} as (B, Nt, Nr, 2)
    NHWC real arrays (reference uses (B, 2, 64, 16) NCHW; loaders.py:87-99).
    """

    channel: str = "CDL-C"
    channels: int = 2  # {Re, Im}
    num_rx: int = 16  # Nr
    num_tx: int = 64  # Nt
    num_pilots: int = 64
    noise_std: float = 0.0
    norm_channels: str = "global"
    spacing_list: Tuple[float, ...] = (0.5,)
    num_channels: int = 200  # realizations per (profile, spacing, seed) file
    data_dir: str = "./data"
    # Generation backend: "cdl" = built-in 3GPP-style CDL generator (replaces
    # the reference's MATLAB generate_data.m path); "file" = load .mat/.h5.
    source: str = "cdl"
    # TR 38.901 §7.5 step-8 ray coupling: "random" redraws the per-cluster
    # departure/arrival pairing each realization (the standard's ensemble,
    # erank≈36 at 64×16); "fixed" keeps the table pairing per realization —
    # the more concentrated (erank≈16.5) per-drop ensemble, the best
    # available hypothesis for the reference's MATLAB data (RESULTS.md r3).
    ray_coupling: str = "random"

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.num_rx, self.num_tx)


@dataclass(frozen=True)
class SamplingConfig:
    """Annealed-Langevin posterior-sampling hyper-parameters.

    Defaults follow reference test_score.py:39-56 (all CDL profiles use
    α=3e-11, β=0.01, 3 inner steps per σ-level).
    """

    steps_each: int = 3
    alpha_step: float = 3e-11
    beta_noise: float = 0.01
    final_denoise: bool = False  # the channel scripts never denoise at the end


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    data: DataConfig = field(default_factory=DataConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)

    # ---- (de)serialization: configs travel inside checkpoints, like the
    # reference's `torch.save({'config': config, ...})` contract
    # (train_score.py:211-216, re-used at load in test_score.py:35-36). ----
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def _sub(klass, key):
            sub = dict(d.get(key, {}))
            fields = {f.name for f in dataclasses.fields(klass)}
            sub = {k: v for k, v in sub.items() if k in fields}
            for f in dataclasses.fields(klass):
                if f.name in sub and isinstance(sub[f.name], list):
                    sub[f.name] = tuple(sub[f.name])
            return klass(**sub)

        return cls(
            model=_sub(ModelConfig, "model"),
            optim=_sub(OptimConfig, "optim"),
            training=_sub(TrainingConfig, "training"),
            data=_sub(DataConfig, "data"),
            sampling=_sub(SamplingConfig, "sampling"),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))


def default_score_config(channel: str = "CDL-C",
                         ray_coupling: str | None = None) -> Config:
    """The exact recipe of reference train_score.py for a given CDL profile.

    ray_coupling optionally overrides DataConfig.ray_coupling ("random" =
    the generator's default ensemble, "fixed" = the per-drop coupling that
    reproduces the paper's Fig. 5c absolutes — RESULTS.md round 3)."""
    cfg = Config()
    data = dataclasses.replace(cfg.data, channel=channel)
    if ray_coupling is not None:
        data = dataclasses.replace(data, ray_coupling=ray_coupling)
    return cfg.replace(data=data)
