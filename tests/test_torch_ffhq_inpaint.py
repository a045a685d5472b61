"""NCSNv2-Deepest at its published FFHQ widths (ngf 128, 256x256x3) and the
benchmark's inpainting cell, on the CPU: the shape table against the
model, the wide conv and two-pass norm routes' plans at every shape of it,
every shape of today's tables keeping its plan, the route counters, the
image samplers' spans, and the port's forward and inpainting sampler
against the benchmark's plain references at a small size, with the cell's
driver driven whole at a tiny traffic (and caught with planted faults).
"""

import collections
import copy
import dataclasses
import json
import math
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import attribution, harness, work
from perfbench.reference import inpaint as ref_inpaint
from perfbench.reference import ncsnv2 as ref_ncsnv2
from perfbench.weights import make_weights
from score_based_channels_torch import kernels
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion import sampling
from score_based_channels_torch.kernels import conv, instance_norm
from score_based_channels_torch.models import layers
from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest
from score_based_channels_torch.utils import spans

torch.set_num_threads(1)

PLANS = json.loads((Path(__file__).parent /
                    "kernel_plans.json").read_text())
FFHQ = work.table("ncsnv2_deepest_ffhq256")
CELL = "ffhq256.inpaint.bf16"


def _model(ngf, channels=3):
    return NCSNv2Deepest(dataclasses.replace(ModelConfig(), ngf=ngf),
                         channels)


def test_ffhq_table_is_the_models_census():
    """The port's NCSNv2-Deepest at ngf 128 on one 256x256x3 image calls
    exactly the table's convs and norms (the shapes counted with the
    convs and norms stubbed out, so the census costs no arithmetic); its
    parameters are the published 94,132,611."""
    m = _model(128)
    convs, norms, first = collections.Counter(), collections.Counter(), []

    def c(x, w, b=None, d=1, elu=False):
        key = (x.shape[2], x.shape[3], x.shape[1], w.shape[0], w.shape[-1],
               d, int(b is not None))
        first.append(key)
        convs[key] += 1
        return x.new_zeros(x.shape[0], w.shape[0], *x.shape[2:])

    def n(x, a, g, b, elu=False):
        norms[tuple(x.shape[2:]) + (x.shape[1],)] += 1
        return x

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(layers.conv_kernel, "conv2d", c)
        mp.setattr(layers.norm_kernel, "instance_norm_plus", n)
        m(torch.rand(1, 256, 256, 3), torch.tensor(1.0))
    assert {tuple(r[:7]): r[7] for r in FFHQ["convs"]} == dict(convs)
    assert {tuple(r[:3]): r[3] for r in FFHQ["norms"]} == dict(norms)
    assert tuple(FFHQ["convs_first"]) == first[0]
    assert sum(convs.values()) == 113 and sum(norms.values()) == 25
    assert sum(p.numel() for p in m.parameters()) == 94_132_611
    assert [(k, tuple(v.shape)) for k, v in m.state_dict().items()] == [
        (name, s) for name, s, _ in ref_ncsnv2.param_specs(128, 3)]
    flops = work.model_flops({"model": "ncsnv2_deepest_ffhq256",
                              "forward": {1: 1}})
    assert flops == 838_961_463_296


def _taps(k, d, H, W):
    t = conv.live_taps(k, d, H, W)
    return [a[2] for a in t], [a[3] for a in t]


@pytest.mark.parametrize("row", FFHQ["convs"], ids=lambda r: "x".join(
    map(str, r[:6])))
def test_wide_plan_at_every_ffhq_conv(row):
    """Batch 8: every conv of the FFHQ model takes the wide route (a
    channel count past 128, a row past 128 pixels, or resident weights
    that do not fit), whose plan fits the card (shared memory, TMA boxes,
    128-pixel tiles covering the image, output channels tiled by a wgmma
    N)."""
    H, W, Cin, Cout, k, d = row[:6]
    dy, dx = _taps(k, d, H, W)
    B = 8
    if not conv.takes_wide(W, Cin, Cout):
        # 128 -> 128 at 128x128: the resident route would hold its weight
        # slices at BN 32 only, so the wide route takes it
        assert (W, Cin, Cout) == (128, 128, 128)
        assert conv.resident_is_cut(
            conv.wgmma_plan(B, H, W, Cin, Cout, dy, dx), Cout)
    p = conv._launch_args(B, H, W, Cin, Cout, k, d, True)[0]
    assert isinstance(p, conv.WidePlan)
    assert p.nwg in (2, 4) and p.threads == 128 * p.nwg + 32
    assert p.smem <= conv.MAX_SMEM_OPTIN
    assert p.SB * p.TH * p.WS <= 64 * p.nwg and W % p.WS == 0
    assert p.WS <= conv.WIDE_SEGMENT and (p.WS == W or p.SB == 1)
    assert p.TH + 2 * p.py <= 256 and p.WS + 2 * p.px <= 256
    assert p.BN in conv.WGMMA_N and p.BN >= min(Cout, 128)
    assert p.KS * 16 * p.nchunks >= Cin and 4 <= p.stages <= 8
    rows, groups, ntiles = p.tiles
    assert rows * p.TH * p.WS >= H * W and groups * p.SB >= B
    assert ntiles * p.BN >= Cout
    assert p.nwg == 2 or rows * groups * ntiles >= conv.MIN_BLOCKS
    assert p.smem == conv.wide_smem(p.SB, p.TH + 2 * p.py, p.WS + 2 * p.px,
                                    p.KS, p.BN, p.stages)
    # the f32 route takes it too, on its wide route: tiles of whole rows
    # or of segments of a wide row, as many channel tiles as Cout needs
    if conv.takes_wide(W, Cin, Cout):
        q = conv._launch_args(B, H, W, Cin, Cout, k, d, False)[0]
        assert type(q) is conv.Plan and W % q.WS == 0


def test_wide_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="channels"):
        conv.wide_plan(1, 8, 8, 513, 8, [0], [0])
    with pytest.raises(ValueError, match="wider"):
        conv.wide_plan(1, 8, 512, 8, 8, [0], [0])
    with pytest.raises(ValueError, match="segments"):
        conv.wide_plan(1, 8, 255, 8, 8, [0], [0])
    assert conv.wide_tile(1, 8, 250, 128) == (1, 1, 125)
    assert conv.wide_tile(1, 8, 256, 256) == (1, 2, 128)
    assert conv.wide_tile(3, 8, 8, 128) == (2, 8, 8)


@pytest.mark.parametrize("row", FFHQ["norms"], ids=lambda r: "x".join(
    map(str, r[:3])))
def test_two_pass_plan_at_every_ffhq_norm(row):
    """Batch 8, bf16: every norm of the FFHQ model takes the two-pass route
    (256x256x128 is 16.8 MB a sample; the others carry 256-512 channels),
    statistics blocks of at most 256 threads covering each sample."""
    H, W, C, _ = row
    p = instance_norm.launch_plan(8, H, W, C, torch.bfloat16)
    assert isinstance(p, instance_norm.TwoPassPlan)
    assert p.threads == p.rows * C // 8 <= instance_norm.STATS_THREADS
    assert p.tile_pixels == p.rows * instance_norm.STATS_VECS
    assert (p.tiles - 1) * p.tile_pixels < H * W <= p.tiles * p.tile_pixels
    assert p.part_floats == 8 * p.tiles * 2 * C and p.stat_floats == 8 * 3 * C
    with pytest.raises(ValueError):  # the one-pass route refuses it
        instance_norm.plan(8, H, W, C, torch.bfloat16)


def test_two_pass_plan_refuses_what_the_kernel_does_not_take():
    for C in (4, 12, 520):
        with pytest.raises(ValueError, match="two-pass"):
            instance_norm.launch_plan(2, 8, 8, C + 128, torch.float32)
    with pytest.raises(TypeError):
        instance_norm.launch_plan(2, 8, 2, 256, torch.float16)


@pytest.mark.parametrize("model", ["ncsnv2_deepest", "ldamp_unet"])
def test_todays_shapes_keep_their_conv_plans(model):
    """Every conv (and input-gradient conv) shape of today's tables at
    batches 1-256, both dtypes: the route and plan recorded before the
    wide route was added (tests/kernel_plans.json)."""
    rows = [r for r in PLANS["convs"] if r["model"] == model]
    assert rows
    for r in rows:
        B, H, W, Ci, Co, k, d = r["shape"]
        for bf16, key in ((True, "bf16"), (False, "f32")):
            want = r[key]
            if isinstance(want, str):
                with pytest.raises(ValueError):
                    conv._launch_args(B, H, W, Ci, Co, k, d, bf16)
                continue
            p = conv._launch_args(B, H, W, Ci, Co, k, d, bf16)[0]
            assert not isinstance(p, conv.WidePlan), r
            if bf16:
                got = list(p)
            else:  # recorded before the f32 plan had tile columns WS
                got = dataclasses.asdict(p)
                assert got.pop("WS") == W, r
                got = list(got.values())
            assert json.loads(json.dumps(got)) == want, (r["shape"], key)


def test_todays_shapes_keep_their_norm_plans():
    """Every norm shape of today's tables at batches 1-256, both dtypes:
    the one-pass plan recorded before the two-pass route was added."""
    assert PLANS["norms"]
    for r in PLANS["norms"]:
        B, H, W, C = r["shape"]
        p = instance_norm.launch_plan(B, H, W, C, getattr(torch, r["dtype"]))
        assert isinstance(p, instance_norm.Plan)
        assert json.loads(json.dumps(dataclasses.astuple(p))) == r["plan"]


def test_route_counters_count_replays():
    """The routes' launch counters are in `kernels.counts()`, reset with
    the others, and a graph replay's `add_launches` counts them as it
    counts the kernels' own (a capture takes back what it recorded)."""
    kernels.reset_counts()
    n = kernels.counts()
    assert n["conv2d_taps.wide"] == {"launches": 0}
    assert n["instance_norm_plus.two_pass"] == {"launches": 0}
    rec = {"conv2d_taps": 113, "conv2d_taps.wide": 104,
           "instance_norm_plus": 25, "instance_norm_plus.two_pass": 25}
    kernels.add_launches(rec)
    kernels.add_launches(rec, -1)
    for _ in range(3):
        kernels.add_launches(rec)
    n = kernels.counts()
    assert n["conv2d_taps"] == {"launches": 339, "plain": 0}
    assert n["conv2d_taps.wide"] == {"launches": 312}
    assert n["instance_norm_plus.two_pass"] == {"launches": 75}
    kernels.reset_counts()
    assert kernels.counts()["conv2d_taps.wide"] == {"launches": 0}


def _score(x, sigma):
    return -x / (1.0 + sigma ** 2)


@pytest.mark.parametrize("sampler", ["unconditional", "inpainting",
                                     "interpolation"])
def test_image_samplers_record_only_grouped_spans(sampler):
    """A run of each image sampler, with the profiler on, records only
    spans that the benchmark's idle attribution groups (`GROUPS`), and
    with it off records nothing."""
    x0 = torch.rand(2, 4, 4, 3)
    sig = torch.linspace(1.0, 0.1, 3)
    gen = torch.Generator().manual_seed(0)
    run = {
        "unconditional": lambda: sampling.annealed_langevin_unconditional(
            _score, x0, sig, gen, n_steps_each=2),
        "inpainting": lambda: sampling.annealed_langevin_inpainting(
            _score, x0, torch.rand(2, 4, 4, 3), torch.ones(1, 1, 4, 1), sig,
            gen, n_steps_each=2),
        "interpolation": lambda: sampling.annealed_langevin_interpolation(
            _score, x0, sig, gen, n_interpolations=3, n_steps_each=2),
    }[sampler]
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    names = [s.name for s in spans.recorded(t0, time.time_ns())]
    assert all(n in attribution.GROUPS for n in names), names
    t0 = time.time_ns()
    run()  # no profiler: nothing recorded
    assert not spans.recorded(t0, time.time_ns())


def test_port_forward_matches_the_reference_at_ngf_8():
    """The port's NCSNv2-Deepest at ngf 8 on 32x32x3 images (plain
    versions on the CPU) against `reference/ncsnv2.py` on the same seeded
    weights: the same function to float32 rounding."""
    specs = ref_ncsnv2.param_specs(8, 3)
    W = make_weights(specs, 11, "cpu")
    m = _model(8)
    m.load_state_dict(W)
    g = torch.Generator().manual_seed(2)
    x, s = torch.rand(2, 32, 32, 3, generator=g), torch.tensor([0.3, 40.0])
    with torch.no_grad():
        got, want = m(x, s), ref_ncsnv2.NCSNv2Deepest(W, 8)(x, s)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_port_inpainting_matches_the_reference():
    """`annealed_langevin_inpainting` (the port's sampler, the ngf-8 model
    on the CPU) against `reference/inpaint.py` with the reference's
    network, from the same initial state with the same draws."""
    specs = ref_ncsnv2.param_specs(8, 3)
    W = make_weights(specs, 12, "cpu")
    m = _model(8)
    m.load_state_dict(W)
    m.eval()
    g = torch.Generator().manual_seed(3)
    x0, refer = torch.rand(2, 32, 32, 3, generator=g), torch.rand(
        2, 32, 32, 3, generator=g)
    mask = torch.zeros(1, 1, 32, 1)
    mask[:, :, :16] = 1.0
    levels, scale = ref_inpaint.sigmas(348.0, 0.01, 40, 10)
    assert levels.shape[0] == 5 and scale == 10.0
    with torch.no_grad():
        got = sampling.annealed_langevin_inpainting(
            lambda x, s: m(x, s), x0, refer, mask, levels,
            torch.Generator().manual_seed(4), n_steps_each=2,
            step_lr=9e-7 * scale)
    want = ref_inpaint.inpaint(ref_ncsnv2.NCSNv2Deepest(W, 8), x0, refer,
                               mask, levels, 9e-7 * scale, 2,
                               torch.Generator().manual_seed(4))
    rows = ref_inpaint.inpaint(ref_ncsnv2.NCSNv2Deepest(W, 8), x0, refer,
                               mask, levels, 9e-7 * scale, 2,
                               torch.Generator().manual_seed(4),
                               rows=torch.tensor([1]))
    assert float((got - want).norm() / want.norm()) < 1e-5
    assert torch.allclose(rows[0], want[1], rtol=1e-5, atol=1e-4)
    # the known columns hold the reference plus the last level's noise
    assert float((got[..., :16, :] - refer[..., :16, :]).abs().max()) < 0.2


def tiny():
    cell = copy.deepcopy(harness.load_json("workloads", CELL))
    config = copy.deepcopy(harness.load_json("configs", cell["config"]))
    config["model"].update(ngf=8, num_classes=40)
    config["data"]["image_size"] = 32
    config["sampling"]["level_stride"] = 10
    cell["traffic"].update(rows=4, known_columns=16, check_steps=3)
    return config, cell


def correct(config, cell, seed=2**35 + 3, units=2):
    drv = harness.driver_module(cell["driver"]).Driver(config, cell, seed,
                                                       "cpu")
    drv.setup()
    works = [drv.unit() for _ in range(units)]
    drv.release()
    checks = drv.check()
    return drv, works, checks, all(math.isfinite(v) and v <= lim
                                   for _, v, lim in checks)


def test_inpaint_driver_is_correct_at_a_tiny_traffic():
    """Set-up, two units and the check at ngf 8 on 32x32x3 rows (the
    cell's own driver and limits): correct, the units' work as the shape
    table counts it, the check rows' states recorded at the seeded
    steps."""
    config, cell = tiny()
    drv, works, checks, ok = correct(config, cell)
    assert ok, checks
    assert [k for k, _, _ in checks] == ["inpaint_gap", "score_gap"]
    w = works[0]
    assert w["done"] == 4 and w["forward"] == {4: 5 * 3}
    assert w["model"] == "ncsnv2_deepest_ffhq256"
    assert w["launches"]["conv2d_taps"] == 0  # plain versions on the CPU
    assert drv.attempted == 8 and drv.failed == 0
    u = drv.units[0]
    assert u["rec_x"].shape == (3, 2, 32, 32, 3) and u["rec_x"].abs().sum()
    assert len(drv.units) == 2 and drv.units[0]["seed"] != drv.units[1][
        "seed"]


@pytest.mark.parametrize("fault", ["no_mask", "no_plus"])
def test_inpaint_driver_catches_a_planted_fault(fault):
    """The port broken underneath: the known region not re-imposed, or
    InstanceNorm++'s alpha m_hat term dropped. `correct` is false."""
    config, cell = tiny()
    with pytest.MonkeyPatch.context() as mp:
        if fault == "no_mask":
            orig = sampling.annealed_langevin_inpainting

            def unmasked(score, x, refer, mask, *a, **k):
                return orig(score, x, refer, torch.zeros_like(mask), *a,
                            **k)
            mp.setattr(sampling, "annealed_langevin_inpainting", unmasked)
        else:
            plain = instance_norm.instance_norm_plus_plain

            def no_plus(x, alpha, gamma, beta, elu=False):
                return plain(x, torch.zeros_like(alpha), gamma, beta, elu)
            mp.setattr(layers.norm_kernel, "instance_norm_plus", no_plus)
        assert not correct(config, cell, units=1)[3]
