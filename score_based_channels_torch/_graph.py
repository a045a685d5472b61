"""The port's one capture-and-replay path for its CUDA graphs (the
sampler's `PosteriorRunner`, the trainers' `TrainChunkRunner` and
`LDAMPStepRunner`, the baselines' iterations, the other samplers' steps,
the link's receiver and decoder): a warm-up run on a side stream, and the
capture of one step with its kernel counts taken back (a capture records
launches and runs none). `Replayer` runs one step a call through both,
then its replays; `run_steps` runs a loop of such steps. Under `eager()`
every `Replayer` calls its step on the current stream: the yardstick a
graph is held against. STATS counts the captures and replays of every
graph the port makes."""

from __future__ import annotations

import contextlib
import gc
import inspect
import time
import weakref
from typing import Callable, Iterator, List, NamedTuple, Optional, Sequence

import torch

from . import kernels
from .utils.spans import span

# Counts since `reset_stats`: graph captures and replays, seconds spent
# capturing and the largest graph memory pool (bytes a capture reserved
# for one step's intermediates).
STATS = dict(captures=0, replays=0, capture_seconds=0.0, pool_bytes=0)
_eager = False  # set by `eager()`


def reset_stats() -> None:
    """Set the counts in STATS to 0."""
    for k in STATS:
        STATS[k] = type(STATS[k])(0)


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """While the block runs, every `Replayer` call runs its step eagerly on
    the current stream (no warm-up, capture or replay): the same steps the
    graph runs, the yardstick it is held against. Nests; the state before
    the block comes back when it ends, by an exception too."""
    global _eager
    saved, _eager = _eager, True
    try:
        yield
    finally:
        _eager = saved


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
        # the same. The garbage collector waits: a dead graph it frees
        # during the capture (cudaGraphExecDestroy) invalidates it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                                  capture_error_mode="thread_local"):
                fn()
        finally:
            if collecting:
                gc.enable()
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
        STATS["captures"] += 1
        STATS["capture_seconds"] += seconds
        STATS["pool_bytes"] = max(STATS["pool_bytes"], pool)
        return Capture(graph, launches, grad, seconds, pool)


class Replayer:
    """fn() once a call, where fn is a step on static buffers that reads no
    host value that changes between calls. On the CPU, fn(). On the card,
    the first call runs fn on a side stream (`on_side_stream`), the
    second captures it (`capture`, the generator registered when fn
    draws) and replays the graph, every later call replays it, and each
    replay adds the captured counts to `kernels.counts()` and
    `kernels.grad_counts()`. A capture that fails raises; nothing falls
    back to the eager step. Under `eager()`, fn() on the current stream.

    A bound method is held weakly: its object owns the replayer, and a
    reference cycle would keep a dead runner's graph and pool until the
    garbage collector ran."""

    def __init__(self, fn: Callable[[], None], device,
                 generator: Optional[torch.Generator] = None):
        self._fn = (weakref.WeakMethod(fn) if inspect.ismethod(fn)
                    else lambda: fn)
        self.device = torch.device(device)
        self.generator = generator
        self.cap: Optional[Capture] = None
        self.warm = False

    def __call__(self) -> None:
        fn = self._fn()
        if self.device.type != "cuda" or _eager:
            fn()
        elif not self.warm:
            on_side_stream(fn, self.device)
            self.warm = True
        else:
            if self.cap is None:
                self.cap = capture(fn, self.generator, self.device)
            with span("graph.replay"):
                self.cap.graph.replay()
            STATS["replays"] += 1
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
