"""The conv-probe slice of the port against the JAX package: `conv_im2col`,
`conv_chain`, the probe harness and `fused_forward`.

On the CPU the wrappers run their plain versions; the same inputs, made
with numpy from a seed, go through the JAX Pallas kernels in interpret mode
(as tests/test_kernels.py runs them) and the lax oracles. Bars are the JAX
package's own: conv rtol 1e-5 / atol 1e-5 (test_kernels.py:87-90), chain
rtol 1e-4 / atol 1e-5 (:111), fused forward rtol 2e-4 / atol 2e-5
(:130-131). The CUDA kernels are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.kernels import conv_probe as jcp
from score_based_channels_tpu.kernels.fused_forward import (
    fused_forward as jax_fused_forward,
)
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.kernels import (
    conv, conv_chain, conv_im2col, conv_probe, counts, reset_counts,
)
from score_based_channels_torch.kernels import fused_forward as ff
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model,
)

torch.set_num_threads(1)

# tests/test_kernels.py:72-77
IM2COL_CASES = [(8, 2, 16, 16, 1), (8, 2, 16, 16, 4), (16, 4, 8, 16, 2),
                (4, 4, 8, 8, 1)]


def _probe_inputs(H, W, Cin, Cout, seed, B=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(H * W, B, Cin).astype(np.float32)
    w = (rng.randn(3, 3, Cin, Cout) / (3 * Cin)).astype(np.float32)
    b = np.linspace(-1, 1, Cout, dtype=np.float32)
    return x, w, b


@pytest.mark.parametrize("bias,act", [(False, False), (True, False),
                                      (False, True), (True, True)])
@pytest.mark.parametrize("H,W,Cin,Cout,d", IM2COL_CASES)
def test_im2col_matches_pallas_and_oracle(H, W, Cin, Cout, d, bias, act):
    x, w, b = _probe_inputs(H, W, Cin, Cout, H * W * Cin + d)
    bj = jnp.asarray(b) if bias else None
    args = (jnp.asarray(x), jnp.asarray(w), bj, H, W, d)
    want_p = np.asarray(jcp.conv_im2col(*args, act=act, interpret=True))
    want_o = np.asarray(jcp.conv_oracle(*args, act=act))
    bt = torch.from_numpy(b) if bias else None
    got = conv_im2col.conv_im2col(torch.from_numpy(x), torch.from_numpy(w),
                                  bt, H, W, d, act)
    assert got.shape == (H * W, 8, Cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_p, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_o, rtol=1e-5, atol=1e-5)
    oracle = conv_probe.conv_oracle(torch.from_numpy(x), torch.from_numpy(w),
                                    bt, H, W, d, act)
    np.testing.assert_allclose(oracle.numpy(), want_o, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,W,Cin,Cout,k,d", [
    (64, 16, 2, 32, 3, 1), (64, 16, 32, 2, 3, 1), (16, 4, 64, 64, 1, 1),
    (8, 2, 64, 128, 3, 2), (8, 2, 128, 128, 3, 4)])
def test_channels_last_entry_point_equals_the_per_tap_conv(H, W, Cin, Cout, k,
                                                            d):
    """conv2d_im2col takes conv.conv2d's contract (NCHW channels_last, the
    weight in kernel_layout) and computes the same function."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, Cin, H, W, generator=g).contiguous(
        memory_format=torch.channels_last)
    w = conv.kernel_layout(torch.randn(Cout, Cin, k, k, generator=g) / 9)
    b = torch.randn(Cout, generator=g)
    got = conv_im2col.conv2d_im2col(x, w, b, d, elu=True)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, conv.conv2d(x, w, b, d, elu=True))


@pytest.mark.parametrize("d", [1, 2])
def test_chain_matches_pallas_and_unrolled_oracle(d):
    H, W, C, B, n = 8, 2, 16, 8, 3
    rng = np.random.RandomState(11 + d)
    x = rng.randn(H * W, B, C).astype(np.float32)
    ws = (rng.randn(n, 3, 3, C, C) / (3 * C)).astype(np.float32)
    bs = (0.1 * rng.randn(n, C)).astype(np.float32)
    want_p = np.asarray(jcp.conv_chain(jnp.asarray(x), jnp.asarray(ws),
                                       jnp.asarray(bs), H, W, d,
                                       interpret=True))
    want_o = jnp.asarray(x)
    for i in range(n):
        want_o = jcp.conv_oracle(want_o, jnp.asarray(ws[i]), jnp.asarray(bs[i]),
                                 H, W, d, act=True)
    got = conv_chain.conv_chain(torch.from_numpy(x), torch.from_numpy(ws),
                                torch.from_numpy(bs), H, W, d).numpy()
    np.testing.assert_allclose(got, want_p, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want_o), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k,d,H,W", [(3, 1, 8, 2), (3, 4, 8, 2), (3, 2, 8, 2),
                                     (3, 2, 16, 4), (1, 1, 8, 2),
                                     (3, 4, 4, 4)])
def test_live_taps_equal_the_jax_ones(k, d, H, W):
    assert conv_probe.live_taps(k, d, H, W) == [
        tuple(t) for t in jcp.live_taps(k, d, H, W)]


def test_bf16_inputs_keep_their_dtype():
    x, w, b = _probe_inputs(8, 2, 16, 16, 3)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    got = conv_im2col.conv_im2col(xt.bfloat16(), wt.bfloat16(), bt, 8, 2, 1,
                                  True)
    want = conv_im2col.conv_im2col(xt.bfloat16().float(), wt.bfloat16().float(),
                                   bt, 8, 2, 1, True)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max() <= 2e-2 * want.abs().max()
    ws = wt[None].repeat(2, 1, 1, 1, 1) / 2
    bs = torch.zeros(2, 16)  # float32, as the JAX harness passes it
    chain = conv_chain.conv_chain(xt.bfloat16(), ws.bfloat16(), bs, 8, 2)
    assert chain.dtype == torch.bfloat16 and chain.shape == xt.shape


@pytest.mark.parametrize("B", [1, 8, 100, 256, 1024])
def test_chain_plan_fits_the_card(B):
    p = conv_chain.plan(B, 8, 2, 128)  # float32: the FMA route
    assert p.route == conv_chain.FMA
    assert p.threads % 32 == 0 and p.threads <= conv_chain.MAX_THREADS
    assert p.smem <= conv_chain.MAX_SMEM
    assert 1 <= p.CK <= 128 and p.CK * 128 <= conv_chain.PF * p.threads
    assert p.threads >= -(-(p.SB * 16) // 4) * 32  # every 4x4 tile
    q = conv_chain.plan(B, 8, 2, 128, torch.bfloat16)  # the tensor cores
    assert q.route == conv_chain.MMA and q.SB == p.SB
    assert q.threads == -(-(q.SB * 16) // 16) * 4 * 32  # 16 x 32 per warp
    assert q.smem <= conv_chain.MAX_SMEM


@pytest.mark.parametrize("B", [1, 5, 8, 40, 256, 300, 1024])
def test_chain_plan_clusters(B):
    """The MMA route's clusters: CL in {1, 2, 4, 8}, no larger than the
    blocks the batch needs, a grid padded to a multiple of CL by fewer
    than CL blocks, and shared memory, mbarriers included, that fits."""
    H, W, C = 8, 2, 128
    p = conv_chain.plan(B, H, W, C, torch.bfloat16)
    blocks = -(-B // p.SB)
    assert p.cluster in conv_chain.CLUSTERS
    assert p.cluster == min(conv_chain.CLUSTER,
                            max(c for c in conv_chain.CLUSTERS if c <= blocks))
    g = conv_chain.grid(B, p)
    assert g % p.cluster == 0 and blocks <= g < blocks + p.cluster
    assert C % p.cluster == 0  # each rank fetches C / CL rows of a tap
    mpad = -(-(p.SB * H * W) // 16) * 16
    assert p.smem == (2 * (2 * (mpad + 1) + conv_chain.STAGES * C) * (C + 8)
                      + 2 * 8 * conv_chain.STAGES)  # full + empty barriers
    assert p.smem <= conv_chain.MAX_SMEM
    assert conv_chain.plan(B, H, W, C).cluster == 1  # the FMA route


def test_chain_plan_keeps_two_samples_a_block_at_batch_256():
    p = conv_chain.plan(256, 8, 2, 128, torch.bfloat16)
    assert (p.SB, p.cluster) == (2, conv_chain.CLUSTER)
    assert conv_chain.grid(256, p) == 128
    assert conv_chain.grid(5, dataclasses.replace(
        conv_chain.plan(5, 8, 2, 128, torch.bfloat16), cluster=8)) == 8


def test_chain_plan_routes_and_limits():
    assert conv_chain.plan(256, 8, 2, 128).SB == 2  # 128 blocks at batch 256
    assert conv_chain.plan(8, 8, 2, 16).SB == 1
    assert conv_chain.plan(8, 8, 2, 16, torch.bfloat16).route == conv_chain.MMA
    # bf16 with C not a multiple of 16 stays on the FMA units
    assert conv_chain.plan(8, 4, 4, 24, torch.bfloat16).route == conv_chain.FMA
    with pytest.raises(ValueError, match="channels"):
        conv_chain.plan(256, 8, 2, 256)


def test_im2col_tiles_and_routes():
    bf, f32 = torch.bfloat16, torch.float32
    assert conv_im2col.route(bf) == conv_im2col.WGMMA
    assert conv_im2col.route(f32) == conv_im2col.FMA
    # wgmma: tiles of whole rows, 128 pixels at 64x16 batch 256; the begin
    # and end convs (2 channels) too, the end conv on an N = 8 tile
    p = conv_im2col.plan(256, 64, 16, 32, 32, 9, bf)
    assert (p.BM, p.SB, p.TH, p.BN, p.grid) == (128, 1, 8, 32, (2048, 1))
    assert conv_im2col.plan(256, 64, 16, 32, 2, 9, bf).BN == 8
    assert conv_im2col.plan(256, 64, 16, 2, 32, 9, bf).KS == 1
    # the 8x2 layers: 4 samples a 64-pixel tile, Cout split until 128 jobs
    p = conv_im2col.plan(256, 8, 2, 128, 128, 9, bf)
    assert (p.BM, p.SB, p.BN, p.grid) == (64, 4, 64, (64, 2))
    assert conv_im2col.plan(256, 8, 2, 64, 64, 9, bf).grid == (64, 2)
    assert conv_im2col.plan(2, 8, 2, 128, 128, 9, bf).BN == 32
    # float32: the FMA tiles, 128 x 32 or 64 x 64
    assert conv_im2col.plan(256, 64, 16, 32, 32, 9, f32).grid == (2048, 1)
    assert conv_im2col.plan(256, 8, 2, 128, 128, 9, f32).grid == (64, 2)
    assert conv_im2col.plan(256, 8, 2, 2, 2, 9, f32).BN == 32


def test_new_wrappers_count_and_refuse_other_devices():
    x, w, b = map(torch.from_numpy, _probe_inputs(8, 2, 16, 16, 4))
    reset_counts()
    conv_im2col.conv_im2col(x, w, None, 8, 2)
    conv_chain.conv_chain(x, w[None], b[None], 8, 2)
    c = counts()
    assert c["conv_im2col"] == {"launches": 0, "plain": 1}
    assert c["conv_chain"] == {"launches": 0, "plain": 1}
    with pytest.raises(RuntimeError, match="no kernel"):
        conv_im2col.conv_im2col(x.to("meta"), w.to("meta"), None, 8, 2)
    with pytest.raises(RuntimeError, match="no kernel"):
        conv_chain.conv_chain(x.to("meta"), w[None].to("meta"),
                              b[None].to("meta"), 8, 2)


def test_harness_runs_every_case_on_the_cpu(capsys):
    reset_counts()
    rows = conv_probe.main(["--batch", "2", "--reps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "host times" in out
    for name, *_ in conv_probe.CASES:
        assert name in out
    for n in conv_probe.CHAIN_NS:
        assert f"chain n={n}" in out
    assert len(rows) == len(conv_probe.CASES) + len(conv_probe.CHAIN_NS)
    c = counts()
    assert all(v["launches"] == 0 for v in c.values()), c
    for name in ("conv2d_taps", "conv_im2col", "conv_chain"):
        assert c[name]["plain"] > 0, c


# -----------------------------------------------------------------------------
# fused_forward
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def production():
    """The production ngf=32 wiring, random flax parameters carried across."""
    jm = jax_model(JModelConfig())
    x = np.random.RandomState(0).randn(2, 64, 16, 2).astype(np.float32)
    sig = np.array([0.7, 2.3], np.float32)
    params = jm.init(jax.random.key(1), jnp.asarray(x),
                     jnp.asarray(sig))["params"]
    return params, jax_params_to_state_dict(params), x, sig


def test_fused_forward_matches_the_jax_one(production):
    params, state, x, sig = production
    want = np.asarray(jax_fused_forward(params, jnp.asarray(x),
                                        jnp.asarray(sig)))
    with torch.no_grad():
        got = ff.fused_forward(state, torch.from_numpy(x),
                               torch.from_numpy(sig)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_fused_forward_equals_the_module_forward(production):
    _, state, x, sig = production
    model = make_score_model(ModelConfig(), device="cpu")
    model.load_state_dict(state, strict=True)
    xt, st = torch.from_numpy(x), torch.from_numpy(sig)
    with torch.no_grad():
        reset_counts()
        got = ff.fused_forward(model.state_dict(), xt, st)
        c = counts()
        assert torch.equal(got, model(xt, st))
        # the converter's contiguous (O, I, k, k) weights give the same
        assert torch.equal(ff.fused_forward(state, xt, st), got)
    assert c["conv2d_taps"]["plain"] == 113
    assert c["instance_norm_plus"]["plain"] == 25


def test_a_segment_passed_in_is_the_one_called():
    model = make_score_model(ModelConfig(ngf=8), device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 64, 16, 2)
                         .astype(np.float32))
    seen = []

    def segment(params, h):
        seen.append(tuple(h.shape))
        return ff.deep_segment_plain(params, h)

    with torch.no_grad():
        state = model.state_dict()
        assert torch.equal(ff.fused_forward(state, x, 1.0, segment=segment),
                           ff.fused_forward(state, x, 1.0))
        other = ff.fused_forward(state, x, 1.0,
                                 segment=lambda p, h: torch.zeros_like(h))
    assert seen == [(2, 16, 8, 2)]
    assert not torch.equal(other, ff.fused_forward(state, x, 1.0))


def test_prepare_params_lays_out_once_and_keeps_what_is_right():
    model = make_score_model(ModelConfig(ngf=8), device="cpu")
    sd = model.state_dict()
    params = ff.prepare_params(sd)
    w = params["res1"]["0"]["conv1"]["weight"]
    assert w.data_ptr() == sd["res1.0.conv1.weight"].data_ptr()  # no copy
    assert ff.prepare_params(params) is params
    flat = ff.prepare_params({k: v.contiguous() for k, v in sd.items()},
                             dtype=torch.bfloat16)
    for key in ("begin_conv", "end_conv"):
        t = flat[key]["weight"]
        assert conv.has_kernel_layout(t) and t.dtype == torch.bfloat16
    assert conv.has_kernel_layout(flat["res2"]["0"]["shortcut"]["conv"]
                                  ["weight"])
