"""Multi-process smoke: a data-parallel train step, a checkpoint round trip
and a sweep chunk, the counterpart of the JAX package's
parallel/mp_smoke.py.

Each process joins one torch.distributed group (parallel/multihost.py)
and runs, over the ('data',) mesh of all ranks:

  1. data-parallel DSM train steps (every rank draws the whole batch and
     keeps its rows; the gradients are all-reduced to their mean),
  2. a checkpoint round trip: rank 0 saves the state with
     utils/checkpoint.py, then a barrier; every rank restores it and
     asserts bitwise equality with its live parameters and EMA,
  3. an annealed-Langevin sweep chunk from the RESTORED EMA network, each
     rank on its rows, the traces all-gathered,

then prints one line whose values agree on every rank.

    python -m score_based_channels_torch.parallel.mp_smoke \\
        --coordinator 127.0.0.1:29500 --num_processes 2 --process_id 0 \\
        --device cpu &
    python -m score_based_channels_torch.parallel.mp_smoke \\
        --coordinator 127.0.0.1:29500 --num_processes 2 --process_id 1 \\
        --device cpu

On the CPU the group runs on Gloo; on the card on NCCL, one card a rank.
Under torchrun, omit the first three options (env://).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import numpy as np
import torch


def run_smoke(device=None, ngf: int = 8, num_classes: int = 16,
              batch: int = 4, steps: int = 1, sigmas=None,
              alpha_step: float = 1e-6, chunk_size=None,
              ckpt_path: Optional[str] = None, seed: int = 0,
              _draws: Optional[dict] = None) -> dict:
    """Train steps, checkpoint round trip and a sweep chunk on the mesh of
    the initialised group (one rank without one).

    The batch is fixed (not scaled by the ranks), so the result does not
    depend on the world size. sigmas: the sweep's schedule (default the
    JAX smoke's 20 levels from 5 to 0.01) and alpha_step its step size at
    sigma_end; chunk_size: its chunk (default the batch). _draws: {"x", "labels", "noise"}, each (steps, batch, ...),
    in place of the seeded draws (a test passes the JAX package's).

    Returns loss (of the last step), losses, nmse_db, ckpt, rank, world,
    params and ema (the JAX package's trees, numpy), trace (L*S, batch)."""
    from .. import cplx
    from .._device import resolve_device
    from ..config import Config, DataConfig, ModelConfig, TrainingConfig
    from ..diffusion.sigmas import get_sigmas
    from ..eval.estimate import derive_seed, langevin_chunked, load_score_fn
    from ..models import state_dict_to_jax_params
    from ..train.score import ScoreTrainer
    from ..utils.checkpoint import load_checkpoint
    from .mesh import make_mesh
    from .multihost import is_primary

    dev = resolve_device(device)
    mesh = make_mesh()
    cfg = Config(model=ModelConfig(ngf=ngf, num_classes=num_classes),
                 training=TrainingConfig(batch_size=batch),
                 data=DataConfig(num_channels=batch))
    trainer = ScoreTrainer(cfg, device=dev)
    assert trainer.mesh is not None or not mesh.distributed

    # -- 1. data-parallel train steps -----------------------------------------
    state = trainer.init_state(seed)
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev)
    losses = []
    for s in range(steps):
        if _draws is None:
            x = torch.from_numpy(rng.standard_normal(
                (batch, cfg.data.num_tx, cfg.data.num_rx, 2)).astype(np.float32))
            labels = noise = None
            gen.manual_seed(derive_seed(seed, 2, s))
        else:
            x, labels, noise = (torch.as_tensor(np.asarray(_draws[k][s])).to(dev)
                                for k in ("x", "labels", "noise"))
        losses.append(float(trainer.train_step(state, x.to(dev), gen, labels,
                                               noise)))

    # -- 2. checkpoint round trip ---------------------------------------------
    ckpt_path = ckpt_path or os.path.join(tempfile.gettempdir(),
                                          "mp_smoke_ckpt.npz")
    if is_primary():
        trainer.save(ckpt_path, state)
    mesh.barrier()
    restored = load_checkpoint(ckpt_path)
    live = {"params": state_dict_to_jax_params(state.model.state_dict()),
            "ema": state_dict_to_jax_params(state.ema.state_dict())}
    for name in ("params", "ema"):
        _assert_trees_equal(live[name], restored[name], name)

    # -- 3. sweep chunk from the restored EMA network -------------------------
    Nt, Nr, Np_ = cfg.data.num_tx, cfg.data.num_rx, 10
    sig = get_sigmas(5.0, 0.01, 20) if sigmas is None else torch.as_tensor(
        sigmas, dtype=torch.float32)
    _, score_fn = load_score_fn(ckpt_path, dev)
    crandn = lambda *s: ((rng.standard_normal(s) + 1j * rng.standard_normal(s))
                         / np.sqrt(2)).astype(np.complex64)
    H = crandn(batch, Nt, Nr)
    A = crandn(batch, Np_, Nt)
    A2, Y2, X2 = (cplx.from_complex(torch.from_numpy(v)) for v in (A, A @ H, H))
    x0 = cplx.randn(torch.Generator().manual_seed(2), (batch, Nt, Nr))
    _, trace = langevin_chunked(
        score_fn, A2, Y2, sig, 0.01, x0, seed=3, alpha_step=alpha_step,
        beta_noise=0.001, steps_each=2, oracle2=X2,
        chunk_size=chunk_size or batch, device=dev, mesh=mesh)
    nmse = float(trace[-1].mean())
    return dict(loss=losses[-1], losses=losses, nmse_db=10 * np.log10(nmse),
                ckpt="ok", rank=mesh.rank, world=mesh.world_size,
                params=live["params"], ema=live["ema"], trace=trace)


def _assert_trees_equal(a, b, what: str) -> None:
    from ..models.convert import tree_leaves, tree_paths

    if tree_paths(a) != tree_paths(b):
        raise AssertionError(f"{what}: restored tree differs")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} round trip")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0 (omit under torchrun)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, NCCL; cpu: Gloo)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint path shared by the ranks (default: "
                        "mp_smoke_ckpt.npz in the temporary directory)")
    p.add_argument("--draws", type=str, default=None,
                   help="npz of x, labels, noise (steps, batch, ...) to train "
                        "on instead of the seeded draws")
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--chunk", type=int, default=None,
                   help="rows of a sweep chunk (default: the batch)")
    p.add_argument("--out", type=str, default=None,
                   help="write this rank's losses, parameters and trace to "
                        "<out>.rank<r>.npz")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from ..models.convert import tree_leaves, tree_paths
    from .multihost import initialize

    initialize(args.coordinator, args.num_processes, args.process_id,
               device=args.device)
    try:
        draws = None
        if args.draws:
            with np.load(args.draws) as f:
                draws = {k: f[k] for k in ("x", "labels", "noise")}
        out = run_smoke(args.device, steps=args.steps, chunk_size=args.chunk,
                        ckpt_path=args.ckpt, _draws=draws)
        if args.out:
            flat = {}
            for name in ("params", "ema"):
                for path, leaf in zip(tree_paths(out[name]),
                                      tree_leaves(out[name])):
                    flat[f"{name}/" + "/".join(path)] = leaf
            np.savez(f"{args.out}.rank{out['rank']}.npz",
                     losses=np.asarray(out["losses"]), trace=out["trace"],
                     **flat)
        # one parseable line a rank; the values agree on every rank
        print(f"MP_SMOKE_OK rank={out['rank']} world={out['world']} "
              f"loss={out['loss']:.6f} nmse_db={out['nmse_db']:.4f} "
              f"ckpt={out['ckpt']}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
