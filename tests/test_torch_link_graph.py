"""The link's receiver on static buffers (comms/link.py::LinkReceiver,
comms/ldpc.py::MinsumDecoder, the detectors' `tables`) on the CPU,
against the eager calls they replace.

On the CPU each runs its step once a call (on the card the step is one
captured CUDA graph, replayed: tests/test_torch_cuda.py). The step runs
the eager path's operations on static buffers, so every comparison here
is bit for bit: the decoder against `minsum_decode`, each detector with
its tables against itself without, `solve_ex` without its check against
`solve`, the gather by the inverse permutation against the index-put
de-interleave, and `simulate_packets` through a kept receiver against a
receiver built for the call. The JAX parity of the link through the
receiver is tests/test_torch_comms.py's.
"""

import numpy as np
import pytest
import torch

from score_based_channels_torch import cplx
from score_based_channels_torch.comms import ldpc, link, mimo
from score_based_channels_torch.kernels import counts, ldpc_minsum, reset_counts

torch.set_num_threads(1)

B, NR, NT = 6, 16, 64


@pytest.fixture(scope="module")
def code():
    return ldpc.make_wifi_ldpc()


def _llr(code, seed, B=B):
    rng = np.random.default_rng(seed)
    cw = code.encode(rng.integers(0, 2, (B, code.k), dtype=np.uint8))
    return torch.from_numpy((1.0 - 2.0 * cw) * 2.5 + 1.5 * rng.standard_normal(
        cw.shape)).float()


def test_decoder_equals_minsum_decode_over_three_calls(code):
    dec = ldpc.MinsumDecoder(code.H, B, num_iters=7, device="cpu")
    reset_counts()
    for seed in (1, 2, 3):
        llr = _llr(code, seed)
        want_bits, want_post = ldpc.minsum_decode(llr, code.H, num_iters=7)
        bits, post = dec(llr)
        assert bits.dtype == torch.uint8 and torch.equal(bits, want_bits)
        assert torch.equal(post, want_post)
    assert counts()["ldpc_minsum"] == {"launches": 0, "plain": 2 * 3 * 7}
    with pytest.raises(ValueError, match="llr"):
        dec(llr[:2])


def test_iteration_into_a_given_buffer_equals_a_new_one(code):
    t = ldpc_minsum.edge_tables(code.H)
    c2v = ldpc_minsum.bp_iteration(torch.zeros(B, code.m, code.n),
                                   _llr(code, 4), code.H, tables=t)
    out = torch.full_like(c2v, 7.0)  # stale values are overwritten
    got = ldpc_minsum.bp_iteration(c2v, _llr(code, 5), code.H, tables=t,
                                   out=out)
    assert got is out
    assert torch.equal(out, ldpc_minsum.bp_iteration(c2v, _llr(code, 5),
                                                     code.H, tables=t))
    with pytest.raises(ValueError, match="out may not be"):
        ldpc_minsum.bp_iteration(c2v, _llr(code, 5), code.H, tables=t,
                                 out=c2v)


def _detector_case(seed, L=81, Ns=4):
    g = torch.Generator().manual_seed(seed)
    H = cplx.randn(g, (B, NR, Ns))
    Y = cplx.matmul(cplx.randn(g, (B, L, Ns)), cplx.transpose(H)) \
        + 0.3 * cplx.randn(g, (B, L, NR))
    return Y, H, torch.tensor(0.045)


@pytest.mark.parametrize("detector,kw", [
    ("ml", {}), ("ml", {"max_log": True}), ("kbest", {}),
    ("kbest", {"k_best": 256})])
def test_detector_with_tables_equals_itself_without(detector, kw):
    fn = {"ml": mimo.mimo_ml_llr, "kbest": mimo.mimo_kbest_llr}[detector]
    Y, H, nv = _detector_case(6)
    tables = mimo.detector_tables(4, "cpu")
    got = fn(Y, H, nv, tables=tables, **kw)
    assert got.shape == (B, 81, 8)
    assert torch.equal(got, fn(Y, H, nv, **kw))
    assert torch.equal(got, fn(Y, H, float(nv), **kw))  # a host variance


def test_solve_ex_unchecked_equals_solve_at_the_link_shapes():
    """The ZF-SIC system of every stage (k = 4, 3, 2, 1 streams left):
    the regularised real (2k, 2k) Gram matrix against (2k, 81) columns."""
    Y, H, _ = _detector_case(8)
    for k in (4, 3, 2, 1):
        Hk = H[:, :, :k]
        Hh = cplx.conj_transpose(Hk)
        G = cplx.matmul(Hh, Hk)
        Gr = torch.cat([torch.cat([G[..., 0], -G[..., 1]], -1),
                        torch.cat([G[..., 1], G[..., 0]], -1)], -2)
        Gr = Gr + 1e-5 * torch.eye(2 * k)
        rhs = cplx.matmul(Hh, Y.transpose(1, 2))
        rhs_r = torch.cat([rhs[..., 0], rhs[..., 1]], -2)
        sol, info = torch.linalg.solve_ex(Gr, rhs_r, check_errors=False)
        assert torch.equal(sol, torch.linalg.solve(Gr, rhs_r))
        assert not info.any()


def test_inverse_permutation_gather_equals_the_index_put(code):
    perm = link._interleaver(code.n)
    llr = torch.randn(B, code.n, generator=torch.Generator().manual_seed(2))
    want = torch.empty_like(llr)
    want[:, torch.from_numpy(perm)] = llr
    got = torch.index_select(llr, 1, torch.from_numpy(np.argsort(perm)))
    assert torch.equal(got, want)


def _channels(seed):
    g = torch.Generator().manual_seed(seed)
    H = cplx.randn(g, (B, NR, NT))
    return H, H + 0.3 * cplx.randn(g, (B, NR, NT))


@pytest.mark.parametrize("detector", ["ml", "kbest", "zf-sic"])
def test_simulate_packets_through_a_kept_receiver(code, detector):
    """Two SNR points through one kept receiver equal the same points
    without a receiver (one built for the call) in BER and BLER, and a
    receiver built for the point in its decoded bits."""
    Ht, He = _channels(3)
    kw = dict(num_bp_iters=6, detector=detector)
    kept = link.LinkReceiver(code, B, NR, num_bp_iters=6, detector=detector,
                             device="cpu")
    for snr in (0.0, 10.0):
        gen = lambda: torch.Generator().manual_seed(9)
        fresh = link.LinkReceiver(code, B, NR, num_bp_iters=6,
                                  detector=detector, device="cpu")
        want = link.simulate_packets(gen(), Ht, He, snr, code, **kw)
        got = link.simulate_packets(gen(), Ht, He, snr, code, receiver=kept,
                                    **kw)
        link.simulate_packets(gen(), Ht, He, snr, code, receiver=fresh, **kw)
        assert got == want
        assert torch.equal(kept.decoder.bits, fresh.decoder.bits)
    with pytest.raises(ValueError, match="built for"):
        link.simulate_packets(gen(), Ht, He, 0.0, code, num_bp_iters=5,
                              detector=detector, receiver=kept)


def test_receiver_equals_the_eager_chain(code):
    """The receiver's bits against the chain it replaces: the detector
    without tables, the index-put de-interleave, `minsum_decode`."""
    Y, H, nv = _detector_case(12)
    rx = link.LinkReceiver(code, B, NR, num_bp_iters=5, device="cpu")
    llr = mimo.mimo_ml_llr(Y, H, nv).reshape(B, code.n)
    llr_d = torch.empty_like(llr)
    llr_d[:, torch.from_numpy(link._interleaver(code.n))] = llr
    want, _ = ldpc.minsum_decode(llr_d, code.H, num_iters=5)
    for _ in range(2):
        assert torch.equal(rx(Y, H, nv), want)
    with pytest.raises(ValueError, match="LinkReceiver takes"):
        rx(Y[:1], H[:1], nv)
    with pytest.raises(ValueError, match="unknown detector"):
        link.LinkReceiver(code, B, NR, detector="mmse", device="cpu")


def test_sweep_builds_its_constants_once(code, monkeypatch):
    """A 9-SNR `run_link_simulation` builds the edge tables and the
    detector tables once, and decodes 2 x 9 times through them."""
    built = {"edge": 0, "detector": 0}
    edge, det = ldpc.edge_tables, link.detector_tables

    def count(key, fn):
        def wrapped(*a, **k):
            built[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ldpc, "edge_tables", count("edge", edge))
    monkeypatch.setattr(link, "detector_tables", count("detector", det))
    Ht, He = _channels(5)
    reset_counts()
    res = link.run_link_simulation(Ht, He, snr_range=np.arange(-10, 12.5, 2.5),
                                   num_bp_iters=2, device="cpu")
    assert built == {"edge": 1, "detector": 1}
    assert counts()["ldpc_minsum"] == {"launches": 0, "plain": 2 * 9 * 2}
    assert res.ber_ideal.shape == (9,) and np.isfinite(res.ber_est).all()


def test_eager_receivers_give_the_graph_sweeps_bits(code):
    """Under `_graph.eager()` (the graph's yardstick) the receivers run
    eagerly; on the CPU both ways run the same step, so the sweeps agree,
    and the switch is off again on leaving."""
    from score_based_channels_torch import _graph
    from score_based_channels_torch.comms import link_bench

    H, H_est = link_bench.channels(B)
    kw = dict(snr_range=np.array([-5.0, 5.0]), num_bp_iters=3, device="cpu")
    want = link.run_link_simulation(H, H_est, **kw)
    with _graph.eager():
        assert _graph._eager
        got = link.run_link_simulation(H, H_est, **kw)
    assert not _graph._eager
    for key in ("ber_ideal", "ber_est", "bler_ideal", "bler_est"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


def test_link_bench_needs_a_card():
    from score_based_channels_torch.comms import link_bench

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        link_bench.main(["--pairs", "1"])
