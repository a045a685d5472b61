"""The port's coded link (comms/, kernels/ldpc_minsum.py) against the JAX
package's.

The same inputs, made with numpy or the JAX package's own draws, go
through both packages on the CPU; the port's min-sum iteration runs its
plain version there. Bars:
  - code construction, QPSK modulation, interleaving: exact;
  - one BP iteration: every operation but the column sum is exact, and
    the port adds each column in ascending row order where XLA picks its
    own order, so messages agree to a few f32 ulps (measured 7.2e-7 at
    |c2v| <= 8; bar 2e-6) and decoded bits are identical;
  - 8 iterations on the JAX package's own fixture (tests/test_comms.py
    test_pallas_bp_iteration_matches_jnp_bitexact): identical hard bits,
    post LLRs within rtol 1e-5 / atol 1e-4 (measured 1.5e-5 at |post| <=
    108, 172 of 3,888 entries differ);
  - detectors: ML exact and max-log 1e-4, QR 1e-5, K-best 1e-3 (the JAX
    package's bar, tests/test_comms.py:192), ZF-SIC 1e-4;
  - the link with the JAX package's draws of V and w injected: BER and
    BLER equal for both CSI modes.
Signed zeros: masked entries may be -0.0 on one side and +0.0 on the other;
every comparison here treats them as equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu import cplx as jcplx
from score_based_channels_tpu.comms import ldpc as jldpc
from score_based_channels_tpu.comms import link as jlink
from score_based_channels_tpu.comms import mimo as jmimo
from score_based_channels_tpu.comms import modulation as jmod
from score_based_channels_tpu.kernels.ldpc_minsum import bp_iteration_pallas
from score_based_channels_torch import cplx
from score_based_channels_torch.comms import ldpc, link, mimo, modulation
from score_based_channels_torch.kernels import counts, ldpc_minsum, reset_counts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def code():
    return ldpc.make_wifi_ldpc()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _noisy_llr(code, B, seed, key):
    """The JAX fixture's LLRs: +-3 codeword symbols plus JAX normals."""
    rng = np.random.default_rng(seed)
    cw = code.encode(rng.integers(0, 2, (B, code.k), dtype=np.uint8))
    return np.asarray(jnp.asarray(1 - 2 * cw.astype(np.float32)) * 3.0
                      + jax.random.normal(jax.random.key(key), (B, code.n)))


@pytest.mark.parametrize("make", ["make_wifi_ldpc", "make_wifi_like_ldpc"])
def test_code_construction_matches_jax(make):
    got, want = getattr(ldpc, make)(), getattr(jldpc, make)()
    np.testing.assert_array_equal(got.H, want.H)
    np.testing.assert_array_equal(got.G_info_to_parity, want.G_info_to_parity)
    np.testing.assert_array_equal(got.perm, want.perm)
    assert (got.n, got.k, got.m) == (want.n, want.k, want.m) == (648, 324, 324)
    bits = np.random.default_rng(0).integers(0, 2, (16, got.k), np.uint8)
    cw = got.encode(bits)
    np.testing.assert_array_equal(cw, want.encode(bits))
    assert got.check(cw).all()
    bad = cw.copy()
    bad[:, 5] ^= 1
    assert not got.check(bad).any()
    np.testing.assert_array_equal(ldpc.WIFI_N648_R12_Z27,
                                  jldpc.WIFI_N648_R12_Z27)
    np.testing.assert_array_equal(link._interleaver(648),
                                  jlink._interleaver(648))


def test_qpsk_matches_jax():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (4, 64), dtype=np.uint8)
    syms = modulation.qpsk_modulate(torch.from_numpy(bits))
    np.testing.assert_array_equal(syms.numpy(),
                                  np.asarray(jmod.qpsk_modulate(bits)))
    y = rng.standard_normal((4, 32, 2)).astype(np.float32)
    for nv in (0.1, 0.7):
        got = modulation.qpsk_demap_llr(torch.from_numpy(y), nv)
        want = jmod.qpsk_demap_llr(jnp.asarray(y), nv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    hard = (modulation.qpsk_demap_llr(syms, 0.1) < 0).to(torch.uint8)
    np.testing.assert_array_equal(hard.numpy(), bits)


def test_edge_tables_describe_the_mask(code):
    t = ldpc_minsum.edge_tables(torch.from_numpy(code.H))
    H = code.H.astype(bool)
    assert t.num_edges == H.sum() == 2376 and (t.m, t.n) == H.shape
    rp, rc = t.row_ptr.numpy(), t.row_cols.numpy()
    cp, cr = t.col_ptr.numpy(), t.col_rows.numpy()
    for i in range(t.m):
        np.testing.assert_array_equal(rc[rp[i]:rp[i + 1]], np.flatnonzero(H[i]))
    for j in range(t.n):
        np.testing.assert_array_equal(cr[cp[j]:cp[j + 1]],
                                      np.flatnonzero(H[:, j]))
    assert t.row_edges.shape == (324, 8) and t.col_edges.shape == (648, 12)


def test_edge_tables_pack_the_kernel_tables(code):
    """The kernel's one bulk copy: row_ptr, row_cols, col_ptr and col_edge
    (the edge ids column by column, rows ascending) back to back in one
    int32 array padded to 16 bytes; the four fields are views of it."""
    t = ldpc_minsum.edge_tables(torch.from_numpy(code.H))
    parts = [t.row_ptr, t.row_cols, t.col_ptr, t.col_edge]
    n = sum(p.numel() for p in parts)
    assert t.packed.dtype == torch.int32 and t.packed.numel() % 4 == 0
    assert n <= t.packed.numel() < n + 4 and t.nbytes() == 4 * t.packed.numel()
    assert torch.equal(t.packed[:n], torch.cat(parts))
    assert (t.packed[n:] == 0).all()
    for p in parts:
        assert p.untyped_storage().data_ptr() == \
            t.packed.untyped_storage().data_ptr()
    ce = t.col_edge.long()
    assert torch.equal(t.edge_row[ce], t.col_rows.long())
    assert torch.equal(t.edge_col[ce], torch.repeat_interleave(
        torch.arange(t.n), torch.diff(t.col_ptr.long())))
    assert t.max_row_degree == code.H.sum(1).max() == 8


@pytest.mark.parametrize("make", ["make_wifi_ldpc", "make_wifi_like_ldpc"])
@pytest.mark.parametrize("B", [1, 3, 100, 256, 257])
def test_ldpc_plan_fits_the_card(make, B):
    c = getattr(ldpc, make)()
    t = ldpc_minsum.edge_tables(c.H)
    p = ldpc_minsum.plan(B, t.m, t.n, t.num_edges, t.max_row_degree)
    R = p.rows_per_band
    assert (p.threads, p.copy, p.blocks) == (128, "bulk", B)
    assert p.smem == ldpc_minsum.smem_bytes(t.m, t.n, t.num_edges, R)
    # the band buffers, the packed tables, the messages and the totals
    assert p.smem >= 2 * R * t.n * 4 + t.nbytes() + 4 * t.num_edges + 4 * t.n
    # a band is at most one step of the 4 warps; every packet's block is
    # on the card at once, and with a longer band they would not be
    per_sm = -(-B // ldpc_minsum.NUM_SMS)
    budget = ldpc_minsum.SM_SMEM // per_sm - 1024
    assert p.smem <= budget and R <= 128 // p.lanes_per_row
    assert R == 128 // p.lanes_per_row or ldpc_minsum.smem_bytes(
        t.m, t.n, t.num_edges, R + 1) > budget
    assert p.lanes_per_row >= t.max_row_degree
    if make == "make_wifi_ldpc" and B in (100, 256):  # 16 and 15 rows
        assert (R, p.lanes_per_row) == ((16, 8) if B == 100 else (15, 8))


def test_ldpc_plan_limits():
    with pytest.raises(ValueError, match="n ="):
        ldpc_minsum.plan(2, 4, ldpc_minsum.MAX_N + 1, 8, 2)
    with pytest.raises(ValueError, match="exceed shared memory"):
        ldpc_minsum.plan(2, 4000, 8000, 30000, 8)  # tables of 256 KB
    p = ldpc_minsum.plan(2, 6, 10, 20, 5)  # rows of 40 bytes: no bulk
    assert (p.copy, p.lanes_per_row, p.rows_per_band) == ("element", 16, 6)
    assert ldpc_minsum.plan(2, 6, 12, 20, 5).copy == "bulk"
    p = ldpc_minsum.plan(2, 40, 64, 1600, 40)  # rows of degree 40
    assert p.lanes_per_row == 32 and p.rows_per_band == 4
    big = ldpc_minsum.plan(264, 500, 2000, 4000, 8)  # bands shrink to fit
    assert big.smem <= ldpc_minsum.SM_SMEM // 2 - 1024
    assert big.rows_per_band < 16


@pytest.mark.parametrize("R,lanes", [(16, 8), (15, 8), (8, 16), (7, 16),
                                     (4, 32), (2, 32), (1, 32)])
def test_ldpc_lanes_a_row_fill_the_band(R, lanes):
    """Rows of degree <= 8: 8 lanes a row, widened while the 4 warps
    would take twice the band's rows in one step."""
    assert ldpc_minsum._lanes(8, R) == lanes
    assert ldpc_minsum._lanes(40, R) == 32


def _segment_min_sum(a, seg):
    """The kernel's reduction of one row: lane q takes positions q, q +
    seg, ... in order, then a butterfly over the segment's lanes; each step
    keeps the least (value, position) and the least of the rest."""
    inf = float("inf")
    lanes = []
    for q in range(seg):
        m1, i, m2 = inf, 1 << 30, inf
        for p in range(q, len(a), seg):
            if a[p] < m1 or (a[p] == m1 and p < i):
                m1, i, m2 = a[p], p, min(m1, inf)
            else:
                m2 = min(m2, a[p])
        lanes.append((m1, i, m2))
    off = seg // 2
    while off:
        new = []
        for q in range(seg):
            (m1, i, m2), (n1, j, n2) = lanes[q], lanes[q ^ off]
            if n1 < m1 or (n1 == m1 and j < i):
                new.append((n1, j, min(m1, n2)))
            else:
                new.append((m1, i, min(m2, n1)))
        lanes = new
        off //= 2
    assert len(set(lanes)) == 1  # every lane ends with the row's result
    m1, i, m2 = lanes[0]
    return m1, i, min(m2, ldpc_minsum.BIG)


@pytest.mark.parametrize("seg", [1, 2, 8, 32])
def test_segment_reduction_matches_the_plain_min_sum(seg):
    """min1, first-occurrence argmin and min2 of the plain version
    (strict <, BIG padding) from the kernel's lane order, ties included."""
    rng = np.random.default_rng(seg)
    for dr in (1, 2, 7, 8, 40):
        for _ in range(20):
            a = rng.integers(0, 4, dr).astype(np.float32)  # many ties
            t = torch.from_numpy(a)[None]
            min1 = t.min(-1, keepdim=True).values
            pos = torch.arange(dr)
            first = torch.where(t <= min1, pos, dr).min(-1).values
            min2 = torch.where(pos == first, ldpc_minsum.BIG, t).min().item()
            assert _segment_min_sum(list(a), seg) == (min1.item(),
                                                      first.item(), min2)


@pytest.mark.parametrize("start", ["zeros", "random"])
def test_one_plain_iteration_matches_jax(code, start):
    """One iteration against the Pallas kernel in interpret mode and, from
    zero messages, minsum_decode's jnp body (use_pallas=False)."""
    B = 3
    llr = _noisy_llr(code, B, 7, 3)
    H = jnp.asarray(code.H, jnp.float32)
    if start == "zeros":
        c2v = np.zeros((B, code.m, code.n), np.float32)
    else:
        c2v = np.asarray(jax.random.normal(jax.random.key(6),
                                           (B, code.m, code.n)))
        c2v = c2v * 2.0 * code.H[None]
    reset_counts()
    got = ldpc_minsum.bp_iteration(_t(c2v), _t(llr), _t(code.H))
    assert counts()["ldpc_minsum"] == {"launches": 0, "plain": 1}
    want = bp_iteration_pallas(jnp.asarray(c2v), jnp.asarray(llr), H,
                               interpret=True)
    # no column sum to order from zeros: exact; else a few ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=0 if start == "zeros" else 2e-6)
    assert (got.numpy()[:, code.H == 0] == 0).all()
    if start == "zeros":
        jb, jp = jldpc.minsum_decode(jnp.asarray(llr), H, num_iters=1,
                                     use_pallas=False)
        tb, tp = ldpc.minsum_decode(_t(llr), code.H, num_iters=1)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-5)


def test_eight_iterations_match_jax(code):
    """The JAX package's bit-exactness fixture (B=6, 8 iterations)."""
    llr = _noisy_llr(code, 6, 7, 3)
    jb, jp = jldpc.minsum_decode(jnp.asarray(llr),
                                 jnp.asarray(code.H, jnp.float32),
                                 num_iters=8, use_pallas=False)
    reset_counts()
    tb, tp = ldpc.minsum_decode(_t(llr), code.H, num_iters=8)
    assert counts()["ldpc_minsum"] == {"launches": 0, "plain": 8}
    assert tb.dtype == torch.uint8 and tp.dtype == torch.float32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-4)


def test_batch_independence(code):
    """A packet decodes the same alone and in a batch of 5 (the port's
    counterpart of the JAX batch-padding test)."""
    B = 5
    rng = np.random.default_rng(5)
    llr = _t(rng.standard_normal((B, code.n)) * 2.0)
    c2v = _t(rng.standard_normal((B, code.m, code.n)) * code.H[None])
    mask = _t(code.H)
    full = ldpc_minsum.bp_iteration(c2v, llr, mask)
    one = ldpc_minsum.bp_iteration(c2v[:1], llr[:1], mask)
    assert full.shape == (B, code.m, code.n)
    assert torch.equal(full[:1], one)
    bits5, post5 = ldpc.minsum_decode(llr, code.H, num_iters=6)
    bits1, post1 = ldpc.minsum_decode(llr[:1], code.H, num_iters=6)
    assert torch.equal(bits5[:1], bits1) and torch.equal(post5[:1], post1)


def test_plain_iteration_ignores_masked_entries(code):
    """Finite values off the mask do not change the result (the JAX
    kernel re-masks them)."""
    rng = np.random.default_rng(9)
    llr = _t(rng.standard_normal((2, code.n)))
    c2v = _t(rng.standard_normal((2, code.m, code.n)) * code.H[None])
    junk = c2v + _t(rng.standard_normal(c2v.shape) * (1 - code.H[None]))
    mask = _t(code.H)
    assert torch.equal(ldpc_minsum.bp_iteration(c2v, llr, mask),
                       ldpc_minsum.bp_iteration(junk, llr, mask))


@pytest.mark.parametrize("make", ["make_wifi_ldpc", "make_wifi_like_ldpc"])
def test_decoding_corrects_errors(make):
    code = getattr(ldpc, make)()
    rng = np.random.default_rng(80211)
    cw = code.encode(rng.integers(0, 2, (12, code.k), dtype=np.uint8))
    sigma = 0.6  # BPSK over AWGN, ~4.4 dB Eb/N0 at rate 1/2
    y = 1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape)
    llr = _t(2.0 * y / sigma**2)
    hard_in_errs = ((llr < 0).numpy().astype(np.uint8) != cw).sum()
    bits, _ = ldpc.minsum_decode(llr, code.H, num_iters=30)
    errs = (bits.numpy() != cw).sum()
    assert hard_in_errs > 0
    assert errs < hard_in_errs * 0.05, (hard_in_errs, errs)


def _detector_inputs(seed, B=2, L=6):
    kh, ky = jax.random.split(jax.random.key(seed))
    return (np.asarray(jcplx.randn(kh, (B, 16, 4))),
            np.asarray(jcplx.randn(ky, (B, L, 16))))


@pytest.mark.parametrize("max_log", [False, True])
def test_ml_llr_matches_jax(max_log):
    H, Y = _detector_inputs(5)
    for nv in (1.0, 0.2):
        want = jmimo.mimo_ml_llr(jnp.asarray(Y), jnp.asarray(H), nv,
                                 max_log=max_log, clip=50.0)
        got = mimo.mimo_ml_llr(_t(Y), _t(H), nv, max_log=max_log, clip=50.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(mimo._candidate_table(4)[0],
                                  jmimo._candidate_table(4)[0])


def test_c2_qr_matches_jax():
    H = np.asarray(jcplx.randn(jax.random.key(17), (3, 16, 4)))
    Q, R = mimo._c2_qr(_t(H))
    jQ, jR = jmimo._c2_qr(jnp.asarray(H))
    np.testing.assert_allclose(Q.numpy(), np.asarray(jQ), rtol=0, atol=1e-5)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k_best", [16, 256])
def test_kbest_llr_matches_jax(k_best):
    H, Y = _detector_inputs(11)
    want = jmimo.mimo_kbest_llr(jnp.asarray(Y), jnp.asarray(H), 1.0,
                                k_best=k_best, clip=50.0)
    got = mimo.mimo_kbest_llr(_t(Y), _t(H), 1.0, k_best=k_best, clip=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    if k_best == 256:  # exhaustive: max-log ML
        ml = mimo.mimo_ml_llr(_t(Y), _t(H), 1.0, max_log=True, clip=50.0)
        np.testing.assert_allclose(got.numpy(), ml.numpy(), rtol=1e-3,
                                   atol=1e-3)


def test_zf_sic_llr_matches_jax():
    H, Y = _detector_inputs(7, L=12)
    want = jmimo.mimo_zf_sic_llr(jnp.asarray(Y), jnp.asarray(H), 1.0)
    got = mimo.mimo_zf_sic_llr(_t(Y), _t(H), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("detector", ["ml", "kbest", "zf-sic"])
def test_detectors_recover_noiseless_bits(detector):
    B, L, Ns = 2, 10, 4
    H = _t(jcplx.randn(jax.random.key(3), (B, 16, Ns)))
    bits = np.random.default_rng(4).integers(0, 2, (B, L, 2 * Ns),
                                             dtype=np.uint8)
    s = modulation.qpsk_modulate(torch.from_numpy(bits.reshape(B, -1)))
    Y = cplx.matmul(s.reshape(B, L, Ns, 2), cplx.transpose(H))
    fn = {"ml": mimo.mimo_ml_llr, "kbest": mimo.mimo_kbest_llr,
          "zf-sic": mimo.mimo_zf_sic_llr}[detector]
    llr = fn(Y, H, 0.01, n_streams=Ns)
    assert llr.shape == (B, L, 2 * Ns)
    np.testing.assert_array_equal((llr < 0).numpy().astype(np.uint8), bits)


def _jax_draws(seed, i, B, Nt, Ns, L, Nr):
    """V and w as the JAX package's run_link_simulation draws them for SNR
    point i (comms/link.py:150 fold_in, :86 split, unscaled)."""
    kv, kn = jax.random.split(jax.random.fold_in(jax.random.key(seed), i))
    return (_t(jcplx.randn(kv, (B, Nt, Ns))), _t(jcplx.randn(kn, (B, L, Nr))))


def test_link_with_injected_draws_matches_jax(code):
    B, Nr, Nt, snrs = 12, 16, 64, np.array([0.0, 10.0])
    kh, ke = jax.random.split(jax.random.key(6))
    H = np.asarray(jcplx.to_complex(jcplx.randn(kh, (B, Nr, Nt))))
    H_noisy = H + 0.3 * np.asarray(
        jcplx.to_complex(jcplx.randn(ke, (B, Nr, Nt))))
    want = jlink.run_link_simulation(H, H_noisy, snr_range=snrs,
                                     num_bp_iters=8)
    Ht, He = link._c2(H, "cpu"), link._c2(H_noisy, "cpu")
    reset_counts()
    for i, snr in enumerate(snrs):
        ideal, est = link.simulate_packets(
            None, Ht, He, float(snr), code, num_bp_iters=8,
            draws=_jax_draws(0, i, B, Nt, 4, 81, Nr))
        assert ideal == {"ber": want.ber_ideal[i], "bler": want.bler_ideal[i]}
        assert est == {"ber": want.ber_est[i], "bler": want.bler_est[i]}
    assert counts()["ldpc_minsum"] == {"launches": 0, "plain": 2 * 2 * 8}
    assert want.ber_ideal[1] <= 0.05  # the JAX package's bar at 10 dB
    assert want.ber_est[1] >= want.ber_ideal[1]


def test_run_link_simulation_on_the_cpu():
    B = 8
    g = np.random.default_rng(1)
    H = (g.standard_normal((B, 16, 64)) + 1j * g.standard_normal(
        (B, 16, 64))) / np.sqrt(2)
    H_est = np.stack([H + 0.3 * (g.standard_normal(H.shape) + 1j *
                                 g.standard_normal(H.shape)) / np.sqrt(2)
                      for _ in range(2)])  # one estimate per SNR
    res = link.run_link_simulation(H, H_est, snr_range=np.array([0., 10.]),
                                   num_bp_iters=8, device="cpu")
    assert res.ber_ideal.shape == res.bler_est.shape == (2,)
    assert res.ber_ideal[1] <= 0.05 and res.ber_est[1] >= res.ber_ideal[1]
    again = link.run_link_simulation(H, H_est, snr_range=np.array([0., 10.]),
                                     num_bp_iters=8, device="cpu")
    np.testing.assert_array_equal(again.ber_est, res.ber_est)  # seeded


def _write_channels(data_dir, seed, n, rng):
    h = (rng.randn(n, 1, 16, 64) + 1j * rng.randn(n, 1, 16, 64)) * 0.3
    np.savez(data_dir / f"CDL-C_Nt64_Nr16_ULA0.50_seed{seed}.npz",
             output_h=h.astype(np.complex64))


@pytest.fixture(scope="module")
def channels_file(tmp_path_factory):
    """`estimate --save_channels` output of the port, on the CPU (the
    counterpart of tests/test_link_integration.py)."""
    from score_based_channels_torch.config import Config, DataConfig, ModelConfig
    from score_based_channels_torch.eval.estimate import run_estimation

    tmp = tmp_path_factory.mktemp("link")
    rng = np.random.RandomState(4)
    _write_channels(tmp, 1234, 16, rng)
    _write_channels(tmp, 4321, 8, rng)
    cfg = Config(model=ModelConfig(ngf=8, num_classes=5),
                 data=DataConfig(source="file", data_dir=str(tmp)))
    path = str(tmp / "channels.npz")
    res = run_estimation(lambda x, s: torch.zeros_like(x), cfg,
                         snr_range=np.array([0.0, 10.0]), num_channels=6,
                         stop_steps=np.array([3, 9]), save_channels_to=path,
                         device="cpu")
    return path, res


def test_save_channels_then_link(channels_file):
    path, res = channels_file
    with np.load(path) as f:
        est, oracle = f["est_sp0_al0"], f["oracle_sp0_al0"]
    assert est.shape == (2, 6, 64, 16) and oracle.shape == (6, 64, 16)
    assert np.iscomplexobj(est) and np.iscomplexobj(oracle)
    for s, stop in enumerate([3, 9]):
        nm = (np.abs(est[s] - oracle) ** 2).sum((-1, -2)) / \
             (np.abs(oracle) ** 2).sum((-1, -2))
        np.testing.assert_allclose(nm, res.nmse_log[0, 0, s, stop], rtol=1e-4)
    H_true = np.conj(np.swapaxes(oracle, -1, -2))
    H_est = np.conj(np.swapaxes(est, -1, -2))
    out = link.run_link_simulation(H_true, cplx.from_complex(H_est),
                                   snr_range=np.array([0.0, 10.0]),
                                   num_bp_iters=8, device="cpu")
    assert out.ber_est.shape == (2,) and np.all(np.isfinite(out.ber_est))


def test_link_cli_on_the_cpu(channels_file, tmp_path, capsys):
    path, _ = channels_file
    out = tmp_path / "link" / "results.npz"
    link.main(["--channels", path, "--device", "cpu", "--bp_iters", "4",
               "--snr", "10", "--output", str(out)])
    text = capsys.readouterr().out
    assert "SNR   10.0 dB" in text and f"saved {out}" in text
    with np.load(out) as f:
        assert set(f.files) == {"snr_range", "ber_ideal", "ber_est",
                                "bler_ideal", "bler_est"}
        np.testing.assert_array_equal(f["snr_range"], [10.0])
        assert np.isfinite(f["ber_est"]).all()


def test_link_cli_defaults_to_the_card(channels_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        link.main(["--channels", channels_file[0]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        link.run_link_simulation(np.zeros((1, 16, 64), np.complex64),
                                 np.zeros((1, 16, 64), np.complex64))
