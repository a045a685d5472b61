"""Each plain reference against the port's CPU path at a tiny size, with
the weights and draws the benchmark makes."""

import math

import pytest
import torch

from perfbench import harness
from perfbench.reference import ldamp as ref_ldamp
from perfbench.reference import ncsnv2
from perfbench.weights import make_weights


def drive(config, cell, seed=2**40 + 7):
    drv = harness.driver_module(cell["driver"]).Driver(config, cell, seed,
                                                       "cpu")
    drv.setup()
    drv.unit()
    drv.release()
    return drv, drv.readings(drv.program(), drv.reference())


def test_ncsnv2_specs_and_forward():
    from score_based_channels_torch.config import default_score_config
    from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest

    specs = ncsnv2.param_specs()
    m = NCSNv2Deepest(default_score_config().model, 2)
    sd = m.state_dict()
    assert [(k, tuple(v.shape)) for k, v in sd.items()] == [
        (n, s) for n, s, _ in specs]
    W = make_weights(specs, 3, "cpu")
    m.load_state_dict(W)
    x, s = torch.randn(2, 64, 16, 2), torch.tensor([0.7, 3.0])
    with torch.no_grad():
        assert torch.equal(m(x, s), ncsnv2.NCSNv2Deepest(W)(x, s))


def test_ldamp_forward_in_float64():
    """The same function: in float64 the two agree to rounding (in float32
    the divergence probe's finite difference magnifies rounding)."""
    from score_based_channels_torch.models.ldamp import LDAMP

    W = make_weights(ref_ldamp.param_specs(2), 5, "cpu")
    m = LDAMP(max_unrolls=2)
    assert [(k, tuple(v.shape)) for k, v in m.state_dict().items()] == [
        (n, s) for n, s, _ in ref_ldamp.param_specs(2)]
    m.load_state_dict(W)
    m = m.double()
    g = torch.Generator().manual_seed(0)
    b = {"Y_herm": torch.randn(3, 38, 16, 2, generator=g).double(),
         "P_herm": torch.randn(3, 38, 64, 2, generator=g).double(),
         "eig1": torch.rand(3, generator=g).double() + 60}
    d = [torch.randn(3, 64, 16, 2, generator=g).double() for _ in range(2)]
    with torch.no_grad():
        want = m(b["Y_herm"], b["P_herm"], b["eig1"], directions=d)
        it = iter(d)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "randn", lambda *a, **k: next(it))
            got = ref_ldamp.ldamp({k: v.double() for k, v in W.items()}, b,
                                  None, 2)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-12


@pytest.mark.parametrize("cell,bounds", [
    ("deepest.estimate.f32", {"estimate_gap": 1e-6,
                              "nmse_trace_gap_db": 1e-5}),
    ("deepest.train.b32", {"loss_gap": 1e-5, "grad_gap": 1e-4,
                           "change_gap": 1e-3, "ema_change_gap": 1e-3}),
    ("ldamp.train.b128", {"loss_gap": 1e-2, "grad_gap": 1e-3,
                          "change_gap": 1e-2}),
])
def test_reference_follows_the_cpu_path(tiny_cell, cell, bounds):
    _, r = drive(*tiny_cell(cell))
    for k, b in bounds.items():
        assert math.isfinite(r[k]) and r[k] <= b, (k, r[k])
