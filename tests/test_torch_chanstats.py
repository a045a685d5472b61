"""The port's generator statistics (eval/chanstats.py, the `chanstats`
command) against the JAX package on the CPU.

The analytic functions are float64 numpy in both packages: equal at rtol
1e-10. The port's own generator (data/cdl.py) must converge to the
analytic covariances at the JAX package's bar (tests/test_chanstats.py:
37-47: relative Frobenius error < 0.10 on both sides at 400 channels,
effective rank within 5%).
"""

import numpy as np
import pytest

from score_based_channels_tpu.eval import chanstats as jcs
from score_based_channels_torch.data.cdl import generate_cdl_channels
from score_based_channels_torch.eval import chanstats as cs

PROFILES = ["CDL-A", "CDL-B", "CDL-C", "CDL-D", "CDL-E"]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("profile", PROFILES)
def test_analytic_side_covariances_and_spreads_match_jax(profile):
    got = cs.analytic_covariances(profile, num_rx=16, num_tx=64, spacing=0.5)
    want = jcs.analytic_covariances(profile, num_rx=16, num_tx=64,
                                    spacing=0.5)
    for g, w in zip(got, want):
        _close(g, w)
        gs, ws = cs.eig_stats(g), jcs.eig_stats(w)
        assert gs.keys() == ws.keys()
        for k in ws:
            _close(gs[k], ws[k])
    for side in ("tx", "rx"):
        _close(cs.rms_zenith_spread_deg(profile, side),
               jcs.rms_zenith_spread_deg(profile, side))


@pytest.mark.parametrize("coupling", ["random", "fixed"])
@pytest.mark.parametrize("layout", [True, False])
def test_analytic_full_covariance_matches_jax(coupling, layout):
    for profile in ("CDL-C", "CDL-D"):
        got = cs.analytic_full_covariance(profile, 4, 8, 0.5, coupling,
                                          layout)
        want = jcs.analytic_full_covariance(profile, 4, 8, 0.5, coupling,
                                            layout)
        _close(got, want)


def test_lmmse_bound_matches_jax():
    snr = np.array([-10.0, 10.0, 30.0])
    got = cs.lmmse_bound_db("CDL-C", snr, num_pilots=6, num_rx=4, num_tx=8,
                            num_pilot_draws=2, seed=3)
    want = jcs.lmmse_bound_db("CDL-C", snr, num_pilots=6, num_rx=4,
                              num_tx=8, num_pilot_draws=2, seed=3)
    _close(got, want)
    assert np.all(np.diff(got) < 0)  # more SNR, less error


def test_empirical_stats_match_jax_on_one_batch():
    H = generate_cdl_channels(11, "CDL-B", num_channels=40)[:, 0]
    got, want = cs.empirical_stats(H), jcs.empirical_stats(H)
    for k in ("R_tx", "R_rx"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9)
    for k in ("beam_k90", "beam_k99", "beam_total"):
        assert got[k] == want[k]


def test_port_generator_converges_to_the_analytic_covariance():
    H = generate_cdl_channels(7, "CDL-C", num_channels=400)[:, 0]
    emp = cs.empirical_stats(H)
    R_tx_a, R_rx_a = cs.analytic_covariances("CDL-C")
    assert cs.cov_rel_error(emp["R_tx"], R_tx_a) < 0.10
    assert cs.cov_rel_error(emp["R_rx"], R_rx_a) < 0.10
    ana_tx = cs.eig_stats(R_tx_a)
    assert abs(emp["tx"]["erank"] - ana_tx["erank"]) / ana_tx["erank"] < 0.05


def test_chanstats_cli(tmp_path, capsys):
    cs.main(["--profiles", "CDL-D", "--num_channels", "20", "--lmmse",
             "--snr", "0", "20", "--output", str(tmp_path)])
    out = capsys.readouterr().out
    assert "LMMSE bound" in out and "saved" in out
    with np.load(tmp_path / "summary.npz") as f:
        assert f["CDL-D/lmmse_nmse_db"].shape == (2,)
        assert f["CDL-D/R_tx_emp"].shape == (64, 64)
