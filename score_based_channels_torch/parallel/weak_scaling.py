"""Weak scaling of the data-parallel Langevin sweep on the CPU, the
counterpart of the JAX package's parallel/weak_scaling.py.

Runs `langevin_chunked` over a mesh of 1, 2 and 4 Gloo processes on the
CPU with a FIXED batch per rank, and prints one JSON line per world size
(wall time per sweep, NFE/s). Every number is a CPU number (`"platform":
"cpu"`): the processes share the host's cores, so once the ranks, times
their threads, outnumber the cores the slowdown measures oversubscription,
not the collectives. What it isolates is the cost of the split, the
per-rank noise draws and the trace gather, which must stay near flat.

Usage:  python -m score_based_channels_torch.parallel.weak_scaling \\
            [--world 1 2 4] [--per_rank 8] [--stride 100] [--ngf 32]
Child:  ... weak_scaling --child RANK --world_size N --port P (internal)
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _child(rank: int, world: int, port: int, per_rank: int, stride: int,
           reps: int, ngf: int, threads: int) -> None:
    import torch

    torch.set_num_threads(threads)
    import torch.distributed as dist

    from .. import cplx, physics
    from ..config import Config, ModelConfig
    from ..diffusion.sigmas import sigmas_from_config, subsample_schedule
    from ..eval.estimate import langevin_chunked, score_fn_from_params
    from ..models import make_score_model
    from .mesh import make_mesh
    from .multihost import initialize

    initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh()
        cfg = Config(model=ModelConfig(ngf=ngf))
        model = make_score_model(cfg.model, cfg.data.channels, device="cpu")
        score_fn = score_fn_from_params(model)
        B = per_rank * world
        g = torch.Generator().manual_seed(0)
        sigmas, alpha_scale = subsample_schedule(
            sigmas_from_config(cfg.model), stride)
        X2 = cplx.randn(g, (B, 64, 16))
        A2 = cplx.conj_transpose(cplx.qpsk_pilots(g, B, 64, 38))
        npow = float(physics.snr_to_noise_power(10.0, 64))
        Y2 = physics.measure_c2(g, A2, X2, npow)
        x0 = cplx.randn(g, (B, 64, 16))

        def run():
            return langevin_chunked(
                score_fn, A2, Y2, sigmas, npow, x0, seed=1,
                alpha_step=3e-11 * alpha_scale, beta_noise=0.01,
                steps_each=3, oracle2=X2, device="cpu", mesh=mesh)

        run()  # warm-up
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        mesh.barrier()
        dt = (time.perf_counter() - t0) / reps
        nfes = B * sigmas.shape[0] * 3
        if rank == 0:
            print(json.dumps({"platform": "cpu", "world_size": world,
                              "batch": B, "per_rank": per_rank,
                              "threads_per_rank": threads, "ngf": ngf,
                              "levels": int(sigmas.shape[0]),
                              "wall_s": round(dt, 4),
                              "nfe_per_s": round(nfes / dt, 2)}), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", nargs="+", type=int, default=[1, 2, 4])
    p.add_argument("--per_rank", type=int, default=8)
    p.add_argument("--stride", type=int, default=100)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--threads", type=int, default=1,
                   help="torch threads of each rank")
    p.add_argument("--timeout", type=float, default=1800.0,
                   help="seconds a world size may take")
    p.add_argument("--child", type=int, default=None)
    p.add_argument("--world_size", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    args = p.parse_args(argv)

    if args.child is not None:
        _child(args.child, args.world_size, args.port, args.per_rank,
               args.stride, args.reps, args.ngf, args.threads)
        return

    print(f"# weak scaling on the CPU (Gloo): fixed batch {args.per_rank} a "
          f"rank, level stride {args.stride}, ngf {args.ngf}, "
          f"{args.threads} thread(s) a rank, {os.cpu_count()} cores",
          flush=True)
    env = dict(os.environ, OMP_NUM_THREADS=str(args.threads))
    failed = False
    for n in args.world:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "score_based_channels_torch.parallel.weak_scaling",
             "--child", str(r), "--world_size", str(n), "--port", str(port),
             "--per_rank", str(args.per_rank), "--stride", str(args.stride),
             "--reps", str(args.reps), "--ngf", str(args.ngf),
             "--threads", str(args.threads)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(n)]
        outs = []
        try:
            outs = [pr.communicate(timeout=args.timeout) for pr in procs]
        except subprocess.TimeoutExpired:
            for pr in procs:
                pr.kill()
                pr.wait()
            print(f"# world_size={n} timed out", file=sys.stderr)
            failed = True
            continue
        for line in outs[0][0].splitlines():
            if line.startswith("{"):
                print(line, flush=True)
        for r, (pr, (_, err)) in enumerate(zip(procs, outs)):
            if pr.returncode != 0:
                print(f"# world_size={n} rank {r} FAILED:\n{err[-2000:]}",
                      file=sys.stderr)
                failed = True
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
