"""The two steps that the port's CUDA-graph runners share (the sampler's
`PosteriorRunner`, the trainers' `TrainChunkRunner` and
`LDAMPStepRunner`, the baselines' iterations, the other samplers' steps,
the link's receiver and decoder): a warm-up run on a side stream, and the
capture of one step with its kernel counts taken back (a capture records
launches and runs none). `Replayer` runs one step a call through both,
then its replays; `run_steps` runs a loop of such steps."""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from . import kernels
from .utils.spans import span


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
    with span("graph.warm_up"):
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
    with span("graph.capture"):
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
        # torch.distributed) may not invalidate the capture; autograd's
        # device thread records its backward into the capturing stream all
        # the same
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                              capture_error_mode="thread_local"):
            fn()
        seconds = time.perf_counter() - t0
        after, after_grad = kernels.counts(), kernels.grad_counts()
        launches = {k: after[k]["launches"] - before[k]["launches"]
                    for k in after}
        grad = {k: {w: n - before_grad[k][w]
                    for w, n in after_grad[k].items()} for k in after_grad}
        kernels.add_launches(launches, -1)  # recorded, none launched
        kernels.add_grad_counts(grad, -1)
        pool = torch.cuda.memory_reserved(device) - reserved
        if generator is not None:
            generator.set_state(rng)
        return Capture(graph, launches, grad, seconds, pool)


class Replayer:
    """fn() once a call, where fn is a step on static buffers that reads no
    host value that changes between calls. On the CPU, fn(). On the card,
    the first call runs fn on a side stream (`on_side_stream`), the
    second captures it (`capture`, the generator registered when fn
    draws) and replays the graph, every later call replays it, and each
    replay adds the captured counts to `kernels.counts()` and
    `kernels.grad_counts()`. A capture that fails raises. `_capture =
    False` runs every call eagerly on the current stream: the yardstick
    beside the graph, not a user option."""

    def __init__(self, fn: Callable[[], None], device,
                 generator: Optional[torch.Generator] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.generator = generator
        self.cap: Optional[Capture] = None
        self.warm = False
        self.replays = 0
        self._capture = True

    def __call__(self) -> None:
        if self.device.type != "cuda" or not self._capture:
            self.fn()
        elif not self.warm:
            on_side_stream(self.fn, self.device)
            self.warm = True
        else:
            if self.cap is None:
                self.cap = capture(self.fn, self.generator, self.device)
            with span("graph.replay"):
                self.cap.graph.replay()
            self.replays += 1
            kernels.add_launches(self.cap.launches)
            kernels.add_grad_counts(self.cap.grad)


def run_steps(steps: Sequence[Callable[[], None]], n: int, device,
              generator: Optional[torch.Generator] = None) -> List[Capture]:
    """n iterations, iteration i calling steps[i % len(steps)] (steps that
    take turns, say with the roles of two buffers swapped), each through
    its own `Replayer`: on the card the first len(steps) iterations on a
    side stream, then each step captured at its second iteration and
    replayed. Returns the captures made."""
    runs = [Replayer(step, device, generator) for step in steps]
    for i in range(n):
        runs[i % len(runs)]()
    return [r.cap for r in runs if r.cap is not None]
