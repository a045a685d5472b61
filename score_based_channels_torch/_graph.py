"""The two steps that the port's CUDA-graph runners share (the sampler's
`PosteriorRunner`, the trainers' `TrainChunkRunner` and
`LDAMPStepRunner`, the baselines' iterations): a warm-up run on a side
stream, and the capture of one step with its kernel counts taken back (a
capture records launches and runs none). `run_steps` runs a loop whose
steps need nothing from the host through both, then the replays."""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from . import kernels


class Capture(NamedTuple):
    graph: torch.cuda.CUDAGraph
    launches: dict      # kernel name -> launches a replay makes
    grad: dict          # kernel name -> gradient work a replay does
    seconds: float      # the capture's host time
    pool_bytes: int     # memory the capture reserved for its pool


def on_side_stream(fn: Callable[[], None], device: torch.device) -> None:
    """fn() on a side stream ordered after and before the current one (the
    eager run before a capture: first launches, with their builds,
    `cudaFuncSetAttribute`, occupancy queries and algorithm choices,
    happen outside the capture)."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    main.wait_stream(side)


def capture(fn: Callable[[], None], generator: Optional[torch.Generator],
            device: torch.device) -> Capture:
    """Capture fn() in a CUDA graph (its own stream and memory pool), the
    generator (when fn draws) registered with it and left where it was.
    The kernel launches and gradient work that the wrappers counted while the
    capture recorded are taken back from `kernels.counts()` and
    `kernels.grad_counts()` and returned, for the runner to add once a
    replay. A capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
        rng = generator.get_state()
    before, before_grad = kernels.counts(), kernels.grad_counts()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    # thread_local: another thread's CUDA calls (NCCL's watchdog under
    # torch.distributed) may not invalidate the capture; autograd's device
    # thread records its backward into the capturing stream all the same
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                          capture_error_mode="thread_local"):
        fn()
    seconds = time.perf_counter() - t0
    after, after_grad = kernels.counts(), kernels.grad_counts()
    launches = {k: after[k]["launches"] - before[k]["launches"]
                for k in after}
    grad = {k: {w: n - before_grad[k][w] for w, n in after_grad[k].items()}
            for k in after_grad}
    kernels.add_launches(launches, -1)  # recorded, none launched
    kernels.add_grad_counts(grad, -1)
    pool = torch.cuda.memory_reserved(device) - reserved
    if generator is not None:
        generator.set_state(rng)
    return Capture(graph, launches, grad, seconds, pool)


def run_steps(steps: Sequence[Callable[[], None]], n: int,
              device: torch.device) -> List[Capture]:
    """n iterations, iteration i calling steps[i % len(steps)] (steps that
    take turns, say with the roles of two buffers swapped); each updates
    its buffers in place and reads no host value that changes between
    iterations. On the CPU n calls; on the card the first len(steps)
    iterations on a side stream, then one capture (`capture`) of each
    step, replayed in turn for the other iterations, its counts added
    once a replay. Returns the captures (none when n <= len(steps))."""
    k = len(steps)
    if device.type != "cuda":
        for i in range(n):
            steps[i % k]()
        return []
    for i in range(min(n, k)):
        on_side_stream(steps[i], device)
    if n <= k:
        return []
    caps = [capture(step, None, device) for step in steps]
    for i in range(k, n):
        cap = caps[i % k]
        cap.graph.replay()
        kernels.add_launches(cap.launches)
        kernels.add_grad_counts(cap.grad)
    return caps
