"""The comparison catches what a broken timed path would give: the rest
of a run (set-up, units, check with the cell's own limits) is driven at a
CPU test's size, with the port's path broken underneath, and `correct`
comes out false. A sound run comes out true."""

import math

import pytest

from perfbench import harness


def correct(config, cell, seed=2**35 + 1):
    drv = harness.driver_module(cell["driver"]).Driver(config, cell, seed,
                                                       "cpu")
    drv.setup()
    drv.unit()
    drv.release()
    return all(math.isfinite(v) and v <= lim for _, v, lim in drv.check())


CELLS = ["deepest.estimate.bf16", "deepest.estimate.f32",
         "deepest.train.b32", "ldamp.train.b128"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_cell, cell):
    assert correct(*tiny_cell(cell))


def _estimate_faults(mp, fault):
    from score_based_channels_torch.diffusion import sampling
    from score_based_channels_torch.eval import estimate

    if fault == "unchanged":  # a level step that leaves the state as it was
        mp.setattr(sampling.PosteriorRunner, "_level",
                   lambda self: self.lvl.add_(1))
    elif fault == "half_batch":  # the network sees half the rows
        orig = estimate.score_fn_from_params

        def half(model, dtype=None):
            fn = orig(model, dtype)

            def score(x, sigma):
                out = fn(x, sigma)
                out[x.shape[0] // 2:] = 0
                return out
            return score
        mp.setattr(estimate, "score_fn_from_params", half)
    else:  # every answer altered where it is produced
        orig = estimate.run_snr_sweep

        def altered(*a, **k):
            nmse, est = orig(*a, **k)
            return nmse, est * 1.1
        mp.setattr(estimate, "run_snr_sweep", altered)


def _train_faults(mp, fault, driver):
    from score_based_channels_torch.train import ldamp, score

    if fault == "unchanged":  # a step that returns its state unchanged
        mp.setattr(score.Optimizer, "update", lambda self: None)
        if driver == "train_score":
            mp.setattr(score, "ema_update", lambda *a, **k: None)
    elif fault == "half_batch" and driver == "train_score":
        orig = score.anneal_dsm_loss

        def half(model, x, sigmas, gen, labels=None, noise=None,
                 anneal_power=2.0, rows=None):
            return orig(model, x, sigmas, gen, labels, noise, anneal_power,
                        rows=slice(0, x.shape[0] // 2))
        mp.setattr(score, "anneal_dsm_loss", half)
    elif fault == "half_batch":
        from score_based_channels_torch import cplx

        def half(model, batch, generator=None, directions=None,
                 num_unrolls=None):
            h = model(batch["Y_herm"], batch["P_herm"], batch["eig1"],
                      generator, num_unrolls, directions)
            n = h.shape[0] // 2
            H = batch["H_herm_cplx"][:n]
            mse = cplx.sum_abs2(h[:n] - H, dim=(-1, -2)).mean()
            return mse, cplx.nmse(h[:n], H).mean()
        mp.setattr(ldamp, "ldamp_losses", half)
    elif driver == "train_score":  # each step's loss altered where made
        orig = score.make_score_update

        def make(*a, **k):
            update = orig(*a, **k)
            return lambda *b, **c: update(*b, **c) * 1.05
        mp.setattr(score, "make_score_update", make)
    else:
        orig = ldamp.ldamp_update

        def update(*a, **k):
            mse, nmse = orig(*a, **k)
            return mse * 1.05, nmse
        mp.setattr(ldamp, "ldamp_update", update)


@pytest.mark.parametrize("fault", ["no_drop", "late_drop"])
def test_staircase_fault_is_caught(tiny_cell, fault):
    """LDAMP's rate schedule broken in the port: the x0.1 drop left out,
    or made one step late."""
    from score_based_channels_torch.train import ldamp

    config, c = tiny_cell("ldamp.train.b128")
    orig = ldamp.staircase_decay

    def broken(lr, steps, rate):
        if fault == "no_drop":
            return orig(lr, steps, 1.0)
        late = orig(lr, steps, rate)
        return lambda count: late(max(count - 1, 0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ldamp, "staircase_decay", broken)
        assert not correct(config, c)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(tiny_cell, cell, fault):
    config, c = tiny_cell(cell)
    with pytest.MonkeyPatch.context() as mp:
        if c["driver"] == "estimate":
            _estimate_faults(mp, fault)
        else:
            _train_faults(mp, fault, c["driver"])
        assert not correct(config, c)
