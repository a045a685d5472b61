"""The PyTorch port's `plots` command and eval/plots.py against the JAX
package: tests/test_plots.py's three cases on the port, the selection
arithmetic (nmse_at_step, nmse_at_per_snr_steps) against the JAX
functions, the figures from results the JAX package saved, and the
command lines (`plots` offered, `--cache` refused).
"""

import os
import sys

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from score_based_channels_tpu.eval import plots as jplots  # noqa: E402
from score_based_channels_tpu.eval.estimate import (  # noqa: E402
    EstimationResults as JaxResults,
)
from score_based_channels_torch.eval import chanstats  # noqa: E402
from score_based_channels_torch.eval import plots  # noqa: E402
from score_based_channels_torch.eval.estimate import (  # noqa: E402
    EstimationResults,
)

FAKE_BOUND = staticmethod(lambda ch, snr, **kw: -np.asarray(snr, float) - 5.0)


def _synthetic_results(seed, S=3, T=40, C=5, cls=EstimationResults):
    """Per-step traces decreasing to a per-SNR floor at a known step
    (tests/test_plots.py::_synthetic_results)."""
    rng = np.random.default_rng(seed)
    nmse = np.empty((1, 1, S, T, C), np.float32)
    for s in range(S):
        t = np.arange(T, dtype=np.float32)
        trough = 10 * (s + 1)
        curve = 0.1 + 0.01 * (t - trough) ** 2 / T
        nmse[0, 0, s] = curve[:, None] * (1 + 0.01 * rng.random(C))[None, :]
    avg = nmse.mean(-1)
    return cls(nmse_log=nmse, avg_nmse=avg, best_nmse=avg.min(-1),
               snr_range=np.array([-10.0, 0.0, 10.0])[:S],
               spacing_range=np.array([0.5]),
               pilot_alpha_range=np.array([0.6]))


def test_nmse_at_per_snr_steps_reads_the_diagonal():
    res = _synthetic_results(0)
    steps = [10, 20, 30]
    picked = plots.nmse_at_per_snr_steps(res, steps)
    expect = np.array([res.avg_nmse[0, 0, s, st]
                       for s, st in enumerate(steps)])
    np.testing.assert_allclose(picked, expect)
    np.testing.assert_array_equal(res.avg_nmse[0, 0].argmin(-1), steps)


def test_plot_pilot_axis_assembles_tables(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(chanstats, "lmmse_bound_db", FAKE_BOUND)
    hp_fmt = str(tmp_path / "hp-a{a}.npz")
    kn_fmt = str(tmp_path / "known-a{a}.npz")
    bl_fmt = str(tmp_path / "blind-a{a}.npz")
    for i, a in enumerate((1.0, 0.8, 0.6)):
        res = _synthetic_results(i)
        res.save(kn_fmt.format(a=a))
        res.save(bl_fmt.format(a=a))
        np.savez(hp_fmt.format(a=a),
                 blind_step=25, blind_alpha=3e-10, blind_beta=0.01,
                 best_step_snr=np.array([10, 20, 30]))
    out = str(tmp_path / "fig.png")
    plots.plot_pilot_axis(out, hparams_fmt=hp_fmt, blind_fmt=bl_fmt,
                          known_fmt=kn_fmt,
                          lasso_path=str(tmp_path / "absent.npz"))
    assert (tmp_path / "fig.png").exists()
    printed = capsys.readouterr().out
    res = _synthetic_results(0)
    blind_db = 10 * np.log10(res.avg_nmse[0, 0, 0, 25])
    assert f"{blind_db:.2f}" in printed
    for a in ("1.0", "0.8", "0.6"):
        assert f"| {a} | 25 |" in printed
    known_db = 10 * np.log10(res.avg_nmse[0, 0, 0, 10])
    assert f"{known_db:.2f}" in printed


def test_plot_pilot_axis_skips_missing_alphas(tmp_path, capsys):
    out = str(tmp_path / "fig.png")
    plots.plot_pilot_axis(out, hparams_fmt=str(tmp_path / "none-a{a}.npz"),
                          blind_fmt=str(tmp_path / "none-b{a}.npz"),
                          known_fmt=str(tmp_path / "none-k{a}.npz"),
                          lasso_path=str(tmp_path / "absent.npz"))
    printed = capsys.readouterr().out
    assert printed.count("skipping") == 3


@pytest.mark.parametrize("step", [0, 7, 39])
def test_selections_match_the_jax_functions(step):
    mine = _synthetic_results(3, S=4, T=40, C=6)
    theirs = _synthetic_results(3, S=4, T=40, C=6, cls=JaxResults)
    np.testing.assert_array_equal(plots.nmse_at_step(mine, step),
                                  jplots.nmse_at_step(theirs, step))
    steps = np.random.default_rng(step).integers(0, 40, 4)
    np.testing.assert_array_equal(
        plots.nmse_at_per_snr_steps(mine, steps),
        jplots.nmse_at_per_snr_steps(theirs, steps))


def test_pilot_axis_prints_what_jax_prints(tmp_path, capsys, monkeypatch):
    from score_based_channels_tpu.eval import chanstats as jchanstats

    monkeypatch.setattr(chanstats, "lmmse_bound_db", FAKE_BOUND)
    monkeypatch.setattr(jchanstats, "lmmse_bound_db", FAKE_BOUND)
    fmts = {k: str(tmp_path / f"{k}-a{{a}}.npz")
            for k in ("hparams_fmt", "blind_fmt", "known_fmt")}
    for i, a in enumerate((1.0, 0.6)):
        res = _synthetic_results(10 + i)
        res.save(fmts["known_fmt"].format(a=a))
        res.save(fmts["blind_fmt"].format(a=a))
        np.savez(fmts["hparams_fmt"].format(a=a), blind_step=17,
                 blind_alpha=1e-10, blind_beta=0.1,
                 best_step_snr=np.array([12, 22, 31]))
    printed = []
    for mod in (plots, jplots):
        mod.plot_pilot_axis(str(tmp_path / "f.png"),
                            lasso_path=str(tmp_path / "absent.npz"), **fmts)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "missing files for alpha=0.8" in printed[0]


def test_nmse_curves_and_ood_overlay_are_drawn(tmp_path):
    res = _synthetic_results(1)
    plots.plot_nmse_curves(res, str(tmp_path / "a" / "curves.png"))
    plots.plot_ood_comparison({"CDL-C": res, "CDL-A": _synthetic_results(2)},
                              str(tmp_path / "ood.png"), blind_step=12,
                              per_snr_steps={"CDL-A": [10, 20, 30]})
    assert (tmp_path / "a" / "curves.png").stat().st_size > 0
    assert (tmp_path / "ood.png").stat().st_size > 0


def test_flagship_reports_missing_artifacts_and_goes_on(tmp_path, capsys,
                                                        monkeypatch):
    monkeypatch.setattr(chanstats, "lmmse_bound_db", FAKE_BOUND)
    monkeypatch.chdir(tmp_path)  # none of the round-4 artifacts is here
    plots.plot_flagship(str(tmp_path / "flagship.png"))
    printed = capsys.readouterr().out
    assert printed.count("# missing:") == len(plots._FLAGSHIP_SOURCES)
    assert "| genie bound (fixed) |" in printed
    assert (tmp_path / "flagship.png").exists()


def test_compare_with_bound_on_results_the_jax_package_saved(tmp_path,
                                                             capsys):
    """`plots --compare a b --bound` on npz files written by the JAX
    package's EstimationResults.save, with the real genie bound."""
    files = []
    for i in range(2):
        f = str(tmp_path / f"r{i}.npz")
        _synthetic_results(i, cls=JaxResults).save(f)
        files.append(f)
    out = str(tmp_path / "cmp.png")
    plots.main(["--compare", *files, "--labels", "a", "b", "--bound",
                "--bound_coupling", "fixed", "--output", out])
    assert f"saved {out}" in capsys.readouterr().out
    assert os.path.getsize(out) > 0


def test_ood_from_the_results_layout(tmp_path, capsys):
    for prof in ("CDL-C", "CDL-B"):
        _synthetic_results(len(prof)).save(
            str(tmp_path / f"train-CDL-C_test-{prof}" / "results.npz"))
    out = str(tmp_path / "ood.png")
    plots.main(["--ood", "--results_dir", str(tmp_path), "--output", out])
    assert "(2 profiles)" in capsys.readouterr().out


def test_plots_with_nothing_to_plot_is_an_error():
    with pytest.raises(SystemExit):
        plots.main(["--output", "x.png"])


def test_the_cli_offers_plots(monkeypatch, capsys):
    from score_based_channels_torch import __main__ as cli

    monkeypatch.setattr(sys, "argv", ["sbc", "plots", "--help"])
    with pytest.raises(SystemExit) as e:
        cli.main()
    assert e.value.code == 0
    assert "--compare" in capsys.readouterr().out
    assert "plots" in cli.__doc__


@pytest.mark.parametrize("module", ["train.score", "eval.estimate"])
def test_train_score_and_estimate_refuse_cache(module, capsys):
    """--cache was accepted and ignored; both parsers now refuse it."""
    import importlib

    main = importlib.import_module(f"score_based_channels_torch.{module}").main
    with pytest.raises(SystemExit) as e:
        main(["--cache", "/tmp/c", "--device", "cpu"])
    assert e.value.code == 2
    assert "unrecognized arguments: --cache" in capsys.readouterr().err
