"""The port's one capture-and-replay path (`_graph`): the eager switch, the
graph counts, and guards that keep every CUDA graph on that path (no
runner takes a capture argument of its own, and no module outside
`_graph.py` and `kernels/` builds a graph). CPU only: on the CPU a
`Replayer` calls its step, so what the switch does on the card is the
card tests' (tests/test_torch_cuda.py)."""

import ast
import inspect
from pathlib import Path

import pytest

import score_based_channels_torch
from score_based_channels_torch import _graph
from score_based_channels_torch.config import default_score_config
from score_based_channels_torch.diffusion.sampling import (
    PosteriorRunner, annealed_langevin_posterior_c2,
)
from score_based_channels_torch.train.ldamp import (
    LDAMPStepRunner, train_ldamp_snr,
)
from score_based_channels_torch.train.score import (
    ScoreTrainer, TrainChunkRunner,
)

PACKAGE = Path(score_based_channels_torch.__file__).parent


def test_eager_nests_and_restores_its_state_after_an_exception():
    assert not _graph._eager
    with _graph.eager():
        assert _graph._eager
        with _graph.eager():
            assert _graph._eager
        assert _graph._eager  # the inner block left the outer's state
    assert not _graph._eager
    with pytest.raises(KeyError):
        with _graph.eager():
            with _graph.eager():
                raise KeyError("inside")
    assert not _graph._eager


def test_eager_replayer_calls_its_step_each_call():
    calls = []
    rep = _graph.Replayer(lambda: calls.append(1), "cpu")
    _graph.reset_stats()
    with _graph.eager():
        for _ in range(3):
            rep()
    rep()
    assert len(calls) == 4 and rep.cap is None and not rep.warm
    assert _graph.STATS["replays"] == 0


def test_a_runner_is_freed_when_its_last_reference_goes():
    """A runner's replayer holds its step weakly, so no reference cycle
    keeps a dead runner (on the card, its graph and pool) until the
    garbage collector runs, which may be during another capture."""
    import gc
    import weakref

    import torch

    class Owner:
        def __init__(self):
            self.calls = 0
            self.replayer = _graph.Replayer(self.step, "cpu")

        def step(self):
            self.calls += 1

    runner = PosteriorRunner(lambda x, s: torch.zeros_like(x), torch.ones(2),
                             torch.Generator(), steps_each=1)
    runner.run(torch.zeros(2, 38, 64, 2), torch.zeros(2, 38, 16, 2), 1.0,
               torch.zeros(2, 64, 16, 2))
    owner = Owner()
    owner.replayer()
    assert owner.calls == 1
    refs = [weakref.ref(runner), weakref.ref(owner)]
    gc.disable()
    try:
        del runner, owner
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_reset_stats_zeroes_the_counts():
    _graph.STATS.update(captures=3, replays=17, capture_seconds=0.25,
                        pool_bytes=1 << 20)
    _graph.reset_stats()
    assert _graph.STATS == dict(captures=0, replays=0, capture_seconds=0.0,
                                pool_bytes=0)
    assert type(_graph.STATS["capture_seconds"]) is float


@pytest.mark.parametrize("fn", [
    TrainChunkRunner, LDAMPStepRunner, PosteriorRunner, ScoreTrainer,
    train_ldamp_snr, annealed_langevin_posterior_c2, _graph.Replayer],
    ids=lambda f: f.__name__)
def test_no_runner_takes_a_capture_argument(fn):
    """The eager switch is `_graph.eager()` alone: no runner, trainer or
    entry point has a parameter of its own for it."""
    params = inspect.signature(fn).parameters
    assert not {"capture", "_capture"} & set(params), list(params)


def test_no_runner_keeps_a_capture_attribute():
    rep = _graph.Replayer(lambda: None, "cpu")
    assert not hasattr(rep, "_capture") and not hasattr(rep, "replays")
    trainer = ScoreTrainer(default_score_config("CDL-C"), device="cpu")
    assert not hasattr(trainer, "_capture")


def _graph_builders(tree):
    """(line, text) of each use of torch.cuda.CUDAGraph or
    torch.cuda.graph in a module's AST, however it was imported."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and (
                node.attr == "CUDAGraph"
                or (node.attr == "graph" and isinstance(node.value,
                                                        ast.Attribute)
                    and node.value.attr == "cuda")):
            found.append((node.lineno, ast.unparse(node)))
        elif isinstance(node, ast.ImportFrom) and (node.module or "").endswith(
                "cuda"):
            found += [(node.lineno, a.name) for a in node.names
                      if a.name in ("CUDAGraph", "graph")]
    return found


def test_only_the_graph_module_builds_cuda_graphs():
    """Every CUDA graph of the port goes through `_graph` (its capture and
    Replayer); `kernels/` may build its own for micro-benchmarks
    (`pool_bench.graph_ms`)."""
    outside = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(PACKAGE)
        if rel.parts[0] == "kernels" or rel == Path("_graph.py"):
            continue
        found = _graph_builders(ast.parse(path.read_text()))
        if found:
            outside[str(rel)] = found
    assert outside == {}
    # the guard sees the spellings it forbids
    assert len(_graph_builders(ast.parse(
        "import torch\ng = torch.cuda.CUDAGraph()\n"
        "with torch.cuda.graph(g):\n    pass\n"
        "from torch.cuda import CUDAGraph\n"))) == 3
    assert _graph_builders(ast.parse(
        (PACKAGE / "_graph.py").read_text()))
