"""Device time of the pool kernels beside the library's pools, on the card.

A pool module (`max_pool`, `mean_pool`) gives its `launch_plan`, its
`_launch`, its `library` pool, its `bytes_moved` and `POOLS`, each model's
pools of one forward. `measure` times the kernel and the library at one
shape (device time, launches captured in a CUDA graph) beside the bytes
bound; `per_forward` sums it over a forward's pools. chip_smoke.py prints
both pools' per-forward lines at ngf 32, batch 256 (bf16, f32) and ngf 128,
batch 8 (bf16).
"""

from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

HBM_BYTES_PER_S = 3.35e12  # an H100 SXM's memory bandwidth


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms a call of fn: `reps` calls captured in one CUDA graph,
    timed by CUDA events around a replay. A launch's host work (tens of us
    through ctypes) is left out, as in the samplers' captured levels."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(pool: ModuleType, B: int, H: int, W: int, C: int,
            dtype: torch.dtype, reps: int = 20) -> dict:
    """The pool's kernel and its library pool on one random card input:
    device ms a call each (`graph_ms`), whether they agree (torch.equal),
    and the bytes bound in ms."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(B, C, H, W, device="cuda", generator=g).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    p = pool.launch_plan(B, H, W, C, dtype)
    fns = {"kernel": lambda: pool._launch(x, p),
           "library": lambda: pool.library(x)}
    out = {"plan": dataclasses.asdict(p),
           "equal": bool(torch.equal(fns["kernel"](), fns["library"]())),
           "bound_ms": pool.bytes_moved(B, H, W, C, dtype)
           / HBM_BYTES_PER_S * 1e3}
    for name, fn in fns.items():
        out[f"{name}_ms"] = graph_ms(fn, reps)
    return out


def per_forward(pool: ModuleType, model: str, B: int, dtype: torch.dtype,
                reps: int = 20) -> dict:
    """`measure` at each shape of `pool.POOLS[model]`, one forward's pools,
    and the sums over them."""
    rows = []
    for (H, W, C), n in pool.POOLS[model]:
        m = measure(pool, B, H, W, C, dtype, reps)
        rows.append(dict(shape=[H, W, C], per_forward=n, **m))
    tot = {k: sum(r[k] * r["per_forward"] for r in rows)
           for k in ("kernel_ms", "library_ms", "bound_ms")}
    return dict(model=model, batch=B, dtype=str(dtype).split(".")[-1],
                rows=rows, equal=all(r["equal"] for r in rows), **tot)
