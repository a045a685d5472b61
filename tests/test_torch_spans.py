"""The port's program spans (`utils/spans.py`) on the CPU: nothing is
recorded without a profiler; under `torch.profiler.profile` the runners
record their runs, loads, levels and steps with their parents, each span
starting inside its "sbc:" profiler event and ending just after it, and
the ring keeps its bound.
Tiny shapes: a 2-row sampler with an analytic score, an ngf-8 DSM step at
batch 4, a 2-unroll LDAMP at batch 2.
"""

import collections
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from score_based_channels_torch.config import Config, DataConfig, ModelConfig
from score_based_channels_torch.data import ChannelDataset
from score_based_channels_torch.diffusion.sampling import PosteriorRunner
from score_based_channels_torch.eval.estimate import (
    langevin_chunked, run_snr_sweep,
)
from score_based_channels_torch.train import ScoreTrainer
from score_based_channels_torch.train.ldamp import (
    LDAMPStepRunner, LDAMPTrainConfig, ldamp_batch, make_ldamp_model,
    make_ldamp_optimizer,
)
from score_based_channels_torch.train.score import TrainChunkRunner
from score_based_channels_torch.utils import spans

torch.set_num_threads(1)

LEVELS = 5


def _sampler_inputs(B=2, Np=5, Nt=4, Nr=3):
    g = torch.Generator().manual_seed(0)
    A = torch.randn(B, Np, Nt, 2, generator=g)
    Y = torch.randn(B, Np, Nr, 2, generator=g)
    x0 = torch.randn(B, Nt, Nr, 2, generator=g)
    return A, Y, torch.full((B,), 0.1), x0


def _runner(levels=LEVELS):
    return PosteriorRunner(lambda x, sigma: -x / (1.0 + sigma ** 2),
                           torch.linspace(1.0, 0.1, levels),
                           torch.Generator().manual_seed(1), steps_each=2)


def _traced(fn):
    """fn() under a CPU profiler -> (the spans recorded meanwhile, the
    profiler's "sbc:" events as (name, start ns, end ns))."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    got = spans.recorded(t0, time.time_ns())
    events = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(spans.PREFIX):
            events.append((ev.name()[len(spans.PREFIX):], ev.start_ns(),
                           ev.start_ns() + ev.duration_ns()))
    return got, events


def _children(recs, parent):
    return [s.name for s in recs if s.parent == parent.index]


def _within_their_events(recs, events):
    """Each record starts inside its own profiler event and ends just after
    it closes (the k-th span of a name against the k-th event of that
    name)."""
    by = collections.defaultdict(list)
    for name, s, e in sorted(events, key=lambda t: t[1]):
        by[name].append((s, e))
    seen = collections.Counter()
    for r in sorted(recs, key=lambda r: r.start_ns):
        s, e = by[r.name][seen[r.name]]
        seen[r.name] += 1
        assert s <= r.start_ns <= e <= r.end_ns, r
    assert sum(seen.values()) == len(events)


def test_without_a_profiler_nothing_is_recorded(monkeypatch):
    def refused(name):
        raise AssertionError("record_function ran without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    before = list(spans._ring)
    assert spans.span("sampler.run") is spans.span("other")
    t0 = time.time_ns()
    _runner().run(*_sampler_inputs())
    A, Y, npow, x0 = _sampler_inputs(B=3)
    langevin_chunked(lambda x, s: -x, A, Y, torch.linspace(1.0, 0.1, 3),
                     npow, x0, 5, 1e-3, 0.0, steps_each=1, chunk_size=2,
                     device="cpu")
    assert spans.recorded(t0, time.time_ns()) == []
    assert list(spans._ring) == before


def test_no_span_event_in_a_trace_of_unmarked_work():
    got, events = _traced(lambda: torch.ones(4, 4) @ torch.ones(4, 4))
    assert got == [] and events == []


def test_posterior_runner_records_a_run_its_load_and_each_level():
    runner = _runner()
    got, events = _traced(lambda: runner.run(*_sampler_inputs()))
    (run,) = [s for s in got if s.name == "sampler.run"]
    assert run.parent is None
    each = ["sampler.level"] * LEVELS
    assert _children(got, run) == ["sampler.load"] + each
    assert [s.name for s in got] == ["sampler.run", "sampler.load"] + each
    for s in got[1:]:
        assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns
    levels = [s for s in got if s.name == "sampler.level"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(levels, levels[1:]))
    _within_their_events(got, events)


def test_chunked_sweep_records_its_draws_pads_runs_and_readbacks():
    """run_snr_sweep: the draws once, then per chunk the padding and
    copies, the runner's run and the read-back, in that order."""
    cfg = Config(data=DataConfig(num_channels=4),
                 model=ModelConfig(num_classes=6))
    ds = ChannelDataset(4321, dataclasses.replace(cfg.data, num_pilots=38),
                        norm="global")
    score = lambda x, sigma: -x  # noqa: E731
    got, events = _traced(lambda: run_snr_sweep(
        score, cfg, ds, np.array([0.0, 10.0]), 7, num_channels=3,
        chunk_size=4, device="cpu"))
    top = [s.name for s in got if s.parent is None]
    assert top == ["sweep.draws"] + ["sweep.pad", "sampler.run",
                                     "sweep.readback"] * 2
    assert [s.name for s in got].count("sampler.level") == 2 * 6
    _within_their_events(got, events)


def test_dsm_runner_records_a_run_its_load_and_each_step():
    cfg = Config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, num_classes=12),
        training=dataclasses.replace(cfg.training, batch_size=4,
                                     log_every_steps=3),
        data=dataclasses.replace(cfg.data, num_channels=16))
    trainer = ScoreTrainer(cfg, device="cpu")
    state = trainer.init_state(0)
    x_all = torch.randn(8, 64, 16, 2)
    runner = TrainChunkRunner(trainer.update, state, x_all, 4, 3,
                              torch.Generator(), 3)
    n = 2

    def work():
        runner.run(torch.arange(8).view(n, 4), list(range(n)))
        trainer.eval_loss(state.ema, x_all[:4], torch.Generator())

    got, events = _traced(work)
    (run,) = [s for s in got if s.name == "dsm.run"]
    assert run.parent is None
    assert _children(got, run) == ["dsm.load"] + ["dsm.step"] * n
    (ev,) = [s for s in got if s.name == "dsm.eval_loss"]
    assert ev.parent is None and ev.start_ns >= run.end_ns
    _within_their_events(got, events)


def test_ldamp_runner_records_the_batch_load_and_step_of_each_step():
    cfg = Config(data=DataConfig(num_channels=4))
    tc = LDAMPTrainConfig(max_unrolls=2, chans=4, num_pools=1, batch_size=2,
                          n_epochs=2, decay_epochs=1)
    ds = ChannelDataset(1234, dataclasses.replace(
        cfg.data, noise_std=float(10 ** (-0.5) * 8), num_pilots=38),
        norm="global")
    model = make_ldamp_model(tc, "cpu")
    runner = LDAMPStepRunner(model, make_ldamp_optimizer(model, tc, 2),
                             torch.Generator(), 2, 4)
    gen = torch.Generator().manual_seed(0)
    got, events = _traced(lambda: runner.run(
        (ldamp_batch(ds, gen, 2, "cpu") for _ in range(2)), [3, 4]))
    (run,) = [s for s in got if s.name == "ldamp.run"]
    assert run.parent is None
    assert _children(got, run) == ["data.sample_batch", "ldamp.load",
                                   "ldamp.step"] * 2
    _within_their_events(got, events)


def test_parents_nest_and_the_ring_keeps_its_bound(monkeypatch):
    assert spans._ring.maxlen == spans.CAPACITY
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=8))

    def work():
        with spans.span("outer"):
            for _ in range(3):
                with spans.span("inner"):
                    with spans.span("leaf"):
                        pass
        for _ in range(12):
            with spans.span("tail"):
                pass

    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("first"):
            pass
        work()
    got = spans.recorded(t0, time.time_ns())
    assert len(spans._ring) == 8 and [s.name for s in got] == ["tail"] * 8
    assert [s.index for s in got] == sorted(s.index for s in got)

    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=64))
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        work()
    got = spans.recorded(t0, time.time_ns())
    outer = got[0]
    inner = [s for s in got if s.name == "inner"]
    assert outer.name == "outer" and outer.parent is None
    assert all(s.parent == outer.index for s in inner)
    leaves = [s for s in got if s.name == "leaf"]
    assert [s.parent for s in leaves] == [s.index for s in inner]
    assert all(s.parent is None for s in got if s.name == "tail")


def test_recorded_keeps_the_spans_that_overlap_the_window(monkeypatch):
    S = spans.Span
    ring = collections.deque([S("b", 20, 30, None, 1), S("a", 0, 10, None, 0),
                              S("c", 40, 50, None, 2)], maxlen=8)
    monkeypatch.setattr(spans, "_ring", ring)
    assert [s.name for s in spans.recorded(5, 45)] == ["a", "b", "c"]
    assert [s.name for s in spans.recorded(10, 40)] == ["b"]
    assert spans.recorded(31, 39) == []
