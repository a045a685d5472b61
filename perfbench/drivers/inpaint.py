"""Image inpainting: `diffusion/sampling.py::annealed_langevin_inpainting`
with the port's NCSNv2-Deepest, one whole inpainting run a unit, as a user
completes a batch of faces from the FFHQ checkpoint.

Traffic (the cell's "traffic"): dtype (the network's; the state is f32),
rows (images a run: rows / completions reference images, each completed
`completions` times, consecutively, as the published sampler repeats
them), known_columns (the left columns known; the rest is estimated),
check_rows (rows of one unit compared with the reference), check_steps
(steps whose forward is compared), warm_levels (the set-up's short
schedule). The schedule is the configuration's: every `level_stride`-th
level and the last, step_lr scaled by the stride. The reference images
are made in set-up from the seed; each unit draws its initial states and
its sampler's draws (n1, z) from (seed, unit), on the card.

The comparison, on one unit of the window drawn from the seed and
`check_rows` of its rows drawn from (seed, unit):
  inpaint_gap  the worst row's relative error of the final image against
               the reference's run (`reference/inpaint.py` with
               `reference/ncsnv2.py`, float32, TF32 off) from the same
               initial state with the same draws;
  score_gap    the worst relative error of the program's forward against
               the reference's forward of the same visited state, at
               `check_steps` steps drawn from the seed (recorded while the
               timed unit ran), so every forward is tied to the reference
               even where the trajectories drift apart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..reference import common as rc
from ..reference import inpaint, ncsnv2
from ..trace import span
from ..weights import make_weights

ROUTES = ("conv2d_taps", "conv2d_taps.wide", "instance_norm_plus",
          "instance_norm_plus.two_pass")


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed = config, cell, seed
        self.t = cell["traffic"]
        self.dev = torch.device(device)
        self.dtype = getattr(torch, self.t["dtype"])
        m, d = config["model"], config["data"]
        self.ngf, self.C = m["ngf"], d["channels"]
        self.shape = (self.t["rows"], d["image_size"], d["image_size"],
                      self.C)
        s = config["sampling"]
        self.levels, scale = inpaint.sigmas(m["sigma_begin"], m["sigma_end"],
                                            m["num_classes"],
                                            s["level_stride"])
        self.step_lr = s["step_lr"] * scale
        self.steps = self.levels.shape[0] * s["n_steps_each"]
        rng = np.random.default_rng(rc.derive_seed(seed, 4))
        self.check_steps = sorted(int(k) for k in rng.choice(
            self.steps, size=min(self.t["check_steps"], self.steps),
            replace=False))
        self.units = []  # per unit: seed, rows, final images, recorded
        self.attempted = self.failed = 0

    # ---- set-up -------------------------------------------------------
    def setup(self) -> None:
        from score_based_channels_torch.config import ModelConfig
        from score_based_channels_torch.eval.estimate import (
            score_fn_from_params)
        from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest

        m, dev = self.config["model"], self.dev
        served = None if self.dtype == torch.float32 else self.dtype
        with span("weights"):
            self.weights = make_weights(ncsnv2.param_specs(self.ngf, self.C),
                                        self.seed, dev, served=served)
            mcfg = dataclasses.replace(
                ModelConfig(), ngf=self.ngf, nonlinearity=m["nonlinearity"],
                normalization=m["normalization"])
            model = NCSNv2Deepest(mcfg, self.C).to(dev)
            model.load_state_dict(self.weights)
            self.score_fn = self._recording(score_fn_from_params(model,
                                                                 served))
        with span("data"):
            g = rc.generator(self.seed, 1, device=dev)
            n_ref = self.t["rows"] // self.t["completions"]
            self.refer = torch.rand((n_ref,) + self.shape[1:], generator=g,
                                    device=dev).repeat_interleave(
                                        self.t["completions"], dim=0)
            self.mask = torch.zeros((1, 1, self.shape[2], 1), device=dev)
            self.mask[:, :, :self.t["known_columns"]] = 1.0
            k = len(self.check_steps)
            n = self.t["check_rows"]
            self.slot = torch.full((self.steps,), k, dtype=torch.int64,
                                   device=dev)
            self.slot[self.check_steps] = torch.arange(k, device=dev)
            self.rec_x = torch.zeros((k + 1, n) + self.shape[1:], device=dev)
            self.rec_s = torch.zeros_like(self.rec_x)
            self.rows_t = torch.zeros(n, dtype=torch.int64, device=dev)
            self.step_k = torch.zeros(1, dtype=torch.int64, device=dev)
        with span("warm-up"):  # the cell's shapes, a short schedule
            idx = torch.linspace(0, self.levels.shape[0] - 1,
                                 self.t["warm_levels"]).round().long()
            self._run(rc.derive_seed(self.seed, 5), self.levels[idx])
        self.units.clear()

    def _recording(self, fn):
        """fn, which also copies the check rows' visited state and score
        into slot `slot[step]` of rec_x and rec_s (the last slot takes the
        steps not compared): device operations on static buffers, so a
        captured step records them at every replay."""
        def score(x, sigma):
            out = fn(x, sigma)
            k = self.slot.index_select(0, self.step_k)
            self.rec_x.index_copy_(
                0, k, x.index_select(0, self.rows_t).unsqueeze(0))
            self.rec_s.index_copy_(
                0, k, out.index_select(0, self.rows_t).unsqueeze(0))
            self.step_k.add_(1)
            return out
        return score

    def initial(self, useed: int) -> torch.Tensor:
        """A unit's initial states, uniform in [0, 1), made on the card."""
        g = rc.generator(useed, 0, device=self.dev)
        return torch.rand(self.shape, generator=g, device=self.dev)

    def check_rows(self, useed: int) -> list:
        rng = np.random.default_rng(rc.derive_seed(useed, 2))
        return sorted(int(r) for r in rng.choice(
            self.t["rows"], size=self.t["check_rows"], replace=False))

    def _run(self, useed: int, levels: torch.Tensor) -> torch.Tensor:
        from score_based_channels_torch.diffusion.sampling import (
            annealed_langevin_inpainting)

        self.step_k.zero_()
        self.rows_t.copy_(torch.tensor(self.check_rows(useed)))
        return annealed_langevin_inpainting(
            self.score_fn, self.initial(useed), self.refer, self.mask,
            levels, generator=rc.generator(useed, 1, device=self.dev),
            n_steps_each=self.config["sampling"]["n_steps_each"],
            step_lr=self.step_lr)

    # ---- the window ---------------------------------------------------
    def unit(self) -> dict:
        from score_based_channels_torch import kernels

        useed = rc.derive_seed(self.seed, 3, len(self.units))
        before = kernels.counts()
        with span("inpaint"):
            x = self._run(useed, self.levels)
            rows = self.check_rows(useed)
            bad = int((~torch.isfinite(x.flatten(1))).any(1).sum())
            self.units.append(dict(
                seed=useed, rows=rows, x=x[rows].cpu(),
                rec_x=self.rec_x[:-1].cpu(), rec_s=self.rec_s[:-1].cpu()))
        after = kernels.counts()
        self.attempted += x.shape[0]
        self.failed += bad
        return {"done": x.shape[0], "model": "ncsnv2_deepest_ffhq256",
                "dtype": self.t["dtype"], "forward": {x.shape[0]: self.steps},
                "launches": {k: after[k]["launches"] - before[k]["launches"]
                             for k in ROUTES if k in after}}

    def release(self) -> None:
        self.score_fn = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the comparison -----------------------------------------------
    def picked(self) -> dict:
        """The unit compared, drawn from the seed."""
        rng = np.random.default_rng(rc.derive_seed(self.seed, 6))
        return self.units[int(rng.integers(len(self.units)))]

    def program(self) -> dict:
        u = self.picked()
        return {"x": u["x"], "s": u["rec_s"]}

    def reference(self, control: str = None, fault: str = None) -> dict:
        """The reference's final images of the compared rows, and its
        forwards of the program's recorded states; `control` "fp8" or
        "tf32" computes them in that lower precision; `fault` breaks it:
        "no_mask" (the known region not re-imposed), "no_plus" (the norm's
        alpha m_hat term dropped)."""
        u, dev = self.picked(), self.dev
        W = {k: v.to(dev) for k, v in self.weights.items()}
        net = (_NoPlus if fault == "no_plus" else ncsnv2.NCSNv2Deepest)(
            W, self.ngf, quant=rc.fp8 if control == "fp8" else rc.identity)
        rows = torch.tensor(u["rows"], device=dev)
        mask = torch.zeros_like(self.mask) if fault == "no_mask" else \
            self.mask
        with rc.precision(control == "tf32"), torch.no_grad():
            x = inpaint.inpaint(
                net, self.initial(u["seed"]), self.refer, mask, self.levels,
                self.step_lr, self.config["sampling"]["n_steps_each"],
                rc.generator(u["seed"], 1, device=dev), rows=rows)
            sig = self.levels.to(dev).repeat_interleave(
                self.config["sampling"]["n_steps_each"])
            s = torch.stack([net(u["rec_x"][i].to(dev), sig[k])
                             for i, k in enumerate(self.check_steps)])
        return {"x": x.cpu(), "s": s.cpu()}

    def faults(self) -> dict:
        return {"no_mask": {"fault": "no_mask"},
                "no_plus": {"fault": "no_plus"}}

    @staticmethod
    def readings(got: dict, ref: dict) -> dict:
        """The numbers compared: the worst row's relative error of the
        final image, and the worst relative error of a recorded forward
        (over each step's and row's score)."""
        def rel(a, b):
            a, b = a.double().flatten(1), b.double().flatten(1)
            return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())
        return {"inpaint_gap": rel(got["x"], ref["x"]),
                "score_gap": rel(got["s"].flatten(0, 1),
                                 ref["s"].flatten(0, 1))}

    def check(self) -> list:
        r = self.readings(self.program(), self.reference())
        lim = self.cell["limits"]
        return [(k, r[k], lim[k]) for k in lim]


class _NoPlus(ncsnv2.NCSNv2Deepest):
    """The reference with InstanceNorm++'s alpha m_hat term dropped (plain
    instance norm): a fault the comparison must catch."""

    def norm(self, name, x):
        g, b = (self.P[f"{name}.{k}"].view(1, -1, 1, 1)
                for k in ("gamma", "beta"))
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return torch.nn.functional.elu(
            g * (x - mu) / torch.sqrt(var + 1e-5) + b)
