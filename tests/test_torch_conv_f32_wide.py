"""The wide f32 route of conv2d_taps (csrc/conv2d_taps.cu, the f32
kernel's segment instance; tile plan `conv.plan` with WS < W) on the CPU:
a launchable plan for every forward and input-gradient conv of
NCSNv2-Deepest at its published FFHQ widths (ngf 128, 256x256x3) at the
training batches, tiles that cover every output once, the kernel's walk
in numpy against `pruned_conv`, every shape of today's tables kept off
the route, and the route's counters.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import work
from score_based_channels_torch import kernels
from score_based_channels_torch.kernels import conv

FFHQ = work.table("ncsnv2_deepest_ffhq256")
PLANS = json.loads((Path(__file__).parent / "kernel_plans.json").read_text())


def _taps(k, d, H, W):
    t = conv.live_taps(k, d, H, W)
    return [a[2] for a in t], [a[3] for a in t]


def _ffhq_launches():
    """(H, W, Cin, Cout, k, d) of every forward conv of the FFHQ table and
    of every input gradient a training step takes (Cin and Cout swapped;
    none for the conv that reads the data)."""
    fwd = {tuple(r[:6]) for r in FFHQ["convs"]}
    first = tuple(FFHQ["convs_first"][:6])
    dgrad = {(H, W, co, ci, k, d) for H, W, ci, co, k, d in fwd
             if (H, W, ci, co, k, d) != first}
    return sorted(fwd | dgrad)


def _block(p, H, W, B, Cout, blk):
    """(rank, b0, h0, w0, n0) of block blk as the wide kernel numbers them:
    rank blk % CL of tile blk // CL; the channel tile fastest, then the
    segment of the row, the row tile, the sample group."""
    tile, ntn = blk // p.CL, -(-Cout // p.BN)
    nseg, nrt = W // p.WS, -(-H // p.TH)
    mt = tile // ntn
    seg, rt = mt % nseg, mt // nseg
    return (blk % p.CL, (rt // nrt) * p.SB, (rt % nrt) * p.TH, seg * p.WS,
            (tile % ntn) * p.BN)


def _chunks(p, rank):
    return range(rank * p.nchunks // p.CL, (rank + 1) * p.nchunks // p.CL)


def _threads(p):
    WN = p.BN // 4
    WM = 32 // WN
    out = []
    for tid in range(p.threads):
        warp, lane = divmod(tid, 32)
        nb, qb = 4 * (lane % WN), warp * 8 * WM + lane // WN
        out.append(([qb + WM * m for m in range(8)], [nb + j for j in range(4)]))
    return out


@pytest.mark.parametrize("B", [2, 8, 16])
@pytest.mark.parametrize("shape", _ffhq_launches(),
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_wide_plan_at_every_ffhq_launch(shape, B):
    """Every forward and input-gradient conv of an FFHQ training step takes
    the wide f32 route with a plan the card launches: shared memory within
    the opt-in limit, 32-bit offsets, whole segments of the row, tiles that
    cover every (pixel, output channel) once, threads every entry of a
    tile once, a cluster's ranks every (tap, chunk) once; at batch 16 the
    grid fills the card."""
    H, W, Cin, Cout, k, d = shape
    p = conv._launch_args(B, H, W, Cin, Cout, k, d, False)[0]
    if not conv.takes_wide(W, Cin, Cout):
        # 128 -> 128 at 128x128: the resident route's whole-row tiles
        assert (H, W, Cin, Cout) == (128, 128, 128, 128)
        assert type(p) is conv.Plan and p.smem <= conv.MAX_SMEM_OPTIN
        assert p.blocks >= conv.SMS
        return
    assert type(p) is conv.Plan and p.WS == min(W, conv.F32_SEGMENT)
    dy, dx = _taps(k, d, H, W)
    assert p == conv.plan(B, H, W, Cin, Cout, dy, dx)
    assert p.smem <= conv.MAX_SMEM_OPTIN
    assert B * H * W * max(Cin, Cout) < 2 ** 31
    assert p.threads <= conv.F32_MAX_THREADS and p.threads % 32 == 0
    assert p.threads == p.BM * p.BN // 32 and p.BN in conv.F32_BN
    assert W % p.WS == 0 and p.SB * p.TH * p.WS <= p.BM
    assert p.WS == W or p.SB == 1
    assert p.smem == conv.f32_smem(p.SB, p.TH + 2 * p.py, p.WS + 2 * p.px,
                                   len(dy), p.BM, p.BN, p.BK, p.stages)
    cover = np.zeros((B, H, W // p.WS, Cout), np.int32)
    for blk in range(0, p.blocks, p.CL):
        _, b0, h0, w0, n0 = _block(p, H, W, B, Cout, blk)
        cover[b0:b0 + p.SB, h0:h0 + p.TH, w0 // p.WS, n0:n0 + p.BN] += 1
    assert (cover == 1).all()
    entries = np.zeros((p.BM, p.BN), np.int32)
    for pixels, channels in _threads(p):
        entries[np.ix_(pixels, channels)] += 1
    assert (entries == 1).all()
    taps = len(dy)
    got = sorted((t, c) for r in range(p.CL) for c in _chunks(p, r)
                 for t in range(taps))
    assert got == [(t, c) for t in range(taps) for c in range(p.nchunks)]
    assert p.BK * p.nchunks >= Cin > p.BK * (p.nchunks - 1)
    if B == 16:
        assert p.blocks >= conv.SMS, p


def _wide_kernel_in_numpy(x, weight, bias, d, elu, p):
    """The f32 kernel's segment instance's arithmetic in float64, block by block
    as plan `p` launches it: the segment's halo staged through its source
    offsets (zero outside the image and past Cin), the live taps' weight
    rows read in place, each thread's entries, the cluster's partials in
    rank order, + bias, ELU, stored to the tile's pixels."""
    B, Cin, H, W = x.shape
    Cout, k = weight.shape[0], weight.shape[-1]
    taps = conv.live_taps(k, d, H, W)
    xm = x.permute(0, 2, 3, 1).reshape(-1).numpy()
    wm = weight.permute(2, 3, 1, 0).reshape(-1).numpy()
    WS = p.WS
    TR, TW = p.TH + 2 * p.py, WS + 2 * p.px
    HP, P = p.SB * TR * TW, p.SB * p.TH * WS
    threads = _threads(p)
    out = np.full(B * H * W * Cout, np.nan)
    for blk0 in range(0, p.blocks, p.CL):
        parts = []
        for blk in range(blk0, blk0 + p.CL):
            rank, b0, h0, w0, n0 = _block(p, H, W, B, Cout, blk)
            hp = np.arange(HP)
            sb, r, c = hp // (TR * TW), hp % (TR * TW) // TW, hp % TW
            b, h, wc = b0 + sb, h0 - p.py + r, w0 + c - p.px
            ok = (b < B) & (h >= 0) & (h < H) & (wc >= 0) & (wc < W)
            gofs = np.where(ok, ((b * H + h) * W + wc) * Cin, -1)
            q = np.minimum(np.arange(p.BM), P - 1)
            sq, rq = q // (p.TH * WS), q % (p.TH * WS)
            hoff = (sq * TR + rq // WS + p.py) * TW + rq % WS + p.px
            acc = np.zeros((p.BM, p.BN))
            for ch in _chunks(p, rank):
                cc = ch * p.BK + np.arange(p.BK)
                halo = np.zeros((HP, p.BK))
                src = gofs[:, None] + cc[None, :]
                live = (gofs[:, None] >= 0) & (cc[None, :] < Cin)
                halo[live] = xm[src[live]]
                n = n0 + np.arange(p.BN)
                for iy, ix, ty, tx in taps:
                    ws = np.zeros((p.BK, p.BN))
                    row = (iy * k + ix) * Cin + cc
                    wl = (cc[:, None] < Cin) & (n[None, :] < Cout)
                    ws[wl] = wm[(row[:, None] * Cout + n[None, :])[wl]]
                    acc += halo[hoff + ty * TW + tx] @ ws
            part = np.full((p.BM, p.BN), np.nan)
            for pixels, channels in threads:
                part[np.ix_(pixels, channels)] = acc[np.ix_(pixels, channels)]
            parts.append(part)
        tile = 0.0
        for part in parts:  # rank order
            tile = tile + part
        if bias is not None:
            tile = tile + np.pad(bias.numpy(), (0, p.BN))[n0:n0 + p.BN]
        if elu:
            tile = np.where(tile > 0, tile, np.expm1(tile))
        for q in range(P):
            b = b0 + q // (p.TH * WS)
            rem = q % (p.TH * WS)
            h = h0 + rem // WS
            if b < B and h < H:
                o = ((b * H + h) * W + w0 + rem % WS) * Cout
                nn = min(p.BN, Cout - n0)
                out[o + n0:o + n0 + nn] = tile[q, :nn]
    return torch.from_numpy(out.reshape(B, H, W, Cout)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,d,bias,elu,forced", [
    (1, 4, 256, 8, 8, 3, 1, True, True, {}),           # 16 segments of 16
    (2, 6, 64, 136, 12, 3, 1, False, False, {}),        # Cin past 128
    (1, 5, 64, 4, 140, 3, 2, True, False, dict(BM=64)),  # ragged rows
    (2, 8, 8, 130, 20, 3, 4, True, True, {}),           # whole images
    (1, 3, 96, 132, 8, 1, 1, False, False, dict(CL=2)),  # k = 1, a K split
    (1, 4, 160, 3, 132, 3, 1, True, False, {}),         # Cin 3: 4-byte copies
])
def test_f32_wide_plan_walked_in_numpy_reproduces_pruned_conv(
        B, H, W, Cin, Cout, k, d, bias, elu, forced):
    """The wide plan's segments, halos, thread tiles and K splits, walked in
    numpy (float64) as the kernel walks them, give `pruned_conv`."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(B, Cin, H, W, generator=g, dtype=torch.float64)
    w = conv.kernel_layout(torch.randn(Cout, Cin, k, k, generator=g,
                                       dtype=torch.float64))
    b = torch.randn(Cout, generator=g, dtype=torch.float64) if bias else None
    dy, dx = _taps(k, d, H, W)
    p = conv.plan(B, H, W, Cin, Cout, dy, dx)
    if forced:
        q = conv.f32_config(B, H, W, Cin, Cout, dy, dx, p.BN,
                            forced.get("BM", p.BM), p.BK,
                            forced.get("CL", p.CL), WS=p.WS)
        assert q is not None
        p = q
    got = _wide_kernel_in_numpy(x, w, b, d, elu, p)
    want = conv.pruned_conv(x, w, b, d, elu)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_f32_wide_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="channels"):
        conv.plan(1, 8, 8, 513, 8, [0], [0])
    with pytest.raises(ValueError, match="wider"):
        conv.plan(1, 8, 512, 8, 8, [0], [0])
    with pytest.raises(ValueError, match="segments"):
        conv.plan(1, 8, 200, 8, 8, [0], [0])
    with pytest.raises(ValueError, match="32-bit"):
        conv.plan(64, 256, 256, 512, 512, [0], [0])
    assert conv.f32_config(1, 8, 64, 8, 8, [0], [0], 8, 256, 8,
                           WS=24) is None  # 24 does not divide 64


def test_todays_f32_shapes_stay_off_the_wide_route():
    """Every f32 conv (and input-gradient conv) shape of the 64x16 tables
    and the LDAMP U-Net at batches 1-256 keeps the resident route's
    `Plan`, as recorded before the wide routes (tests/kernel_plans.json)."""
    rows = [r for r in PLANS["convs"] if not isinstance(r["f32"], str)]
    assert len(rows) > 200
    for r in rows:
        B, H, W, Ci, Co, k, d = r["shape"]
        assert not conv.takes_wide(W, Ci, Co)
        p = conv._launch_args(B, H, W, Ci, Co, k, d, False)[0]
        assert type(p) is conv.Plan and p.WS == W


def test_f32_wide_counters_count_forwards_and_dgrads_apart():
    """The route's forward and input-gradient launches are counters of
    `kernels.counts()`, reset with the others, counted by a replay's
    `add_launches` like the kernel's own."""
    kernels.reset_counts()
    n = kernels.counts()
    assert n["conv2d_taps.f32_wide"] == {"launches": 0}
    assert n["conv2d_taps.f32_wide.dgrad"] == {"launches": 0}
    rec = {"conv2d_taps": 225, "conv2d_taps.f32_wide": 104,
           "conv2d_taps.f32_wide.dgrad": 100}
    kernels.add_launches(rec)
    kernels.add_launches(rec, -1)
    kernels.add_launches(rec, 4)
    n = kernels.counts()
    assert n["conv2d_taps"]["launches"] == 900
    assert n["conv2d_taps.f32_wide"] == {"launches": 416}
    assert n["conv2d_taps.f32_wide.dgrad"] == {"launches": 400}
    kernels.reset_counts()
    assert kernels.counts()["conv2d_taps.f32_wide.dgrad"] == {"launches": 0}


@pytest.mark.parametrize("model", ["deepest", "ffhq"])
def test_bench_step_launches_are_the_models_census(model):
    """`conv_f32_bench.step_launches` (the census by hooks that the f32
    micro-benchmark and the card's smoke phase time) gives, for the FFHQ
    model, each forward conv of the shape table at its count and its
    input gradient but for the conv that reads the data; for the 64x16
    model, 113 forwards and 112 dgrads. The convs and norms are stubbed
    out, so the forward costs no arithmetic."""
    from score_based_channels_torch.kernels import conv_f32_bench
    from score_based_channels_torch.models import layers

    def c(x, w, b=None, d=1, elu=False):
        return x.new_zeros(x.shape[0], w.shape[0], *x.shape[2:])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.conv_kernel, "conv2d", c)
        mp.setattr(layers.norm_kernel, "instance_norm_plus",
                   lambda x, *a, **k: x)
        got = conv_f32_bench.step_launches(model, "cpu")
    fwd, dgrad = {}, {}
    for r in got:
        key = tuple(r[:7]) if r[8] == "fwd" else tuple(r[:6])
        into = fwd if r[8] == "fwd" else dgrad
        into[key] = into.get(key, 0) + r[7]
    assert sum(fwd.values()) == 113 and sum(dgrad.values()) == 112
    assert all(not r[6] for r in got if r[8] == "dgrad")
    if model == "ffhq":
        assert fwd == {tuple(r[:6]) + (bool(r[6]),): r[7]
                       for r in FFHQ["convs"]}
        first = tuple(FFHQ["convs_first"][:6])
        want = {}
        for H, W, ci, co, k, d, _, n in FFHQ["convs"]:
            if (H, W, ci, co, k, d) != first:
                want[(H, W, co, ci, k, d)] = (
                    want.get((H, W, co, ci, k, d), 0) + n)
        assert dgrad == want
