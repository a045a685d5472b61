"""Checkpoints, resume and the entry points of the port's score trainer,
against the JAX package on the CPU: a port checkpoint loads in the JAX
package's `load_checkpoint` and resumes in its ScoreTrainer, a JAX
ScoreTrainer checkpoint resumes in the port, a resumed run equals an
uninterrupted one, and `estimate` runs on a default-config (source="cdl")
checkpoint. The tiny config of tests/test_train_eval.py:21-28.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.train import score as jax_train
from score_based_channels_tpu.utils.checkpoint import load_checkpoint as jax_load
from score_based_channels_torch.config import Config
from score_based_channels_torch.kernels import conv, grad_counts, reset_counts
from score_based_channels_torch.kernels import instance_norm as inorm
from score_based_channels_torch.models import state_dict_to_jax_params
from score_based_channels_torch.train import ScoreTrainer
from score_based_channels_torch.train.score import matmul_precision
from score_based_channels_torch.utils.checkpoint import load_checkpoint
from score_based_channels_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)

CFG = dict(model=dict(ngf=8, num_classes=12),
           training=dict(batch_size=8, n_epochs=2, log_every_steps=2),
           data=dict(num_channels=16))


def _cfg(cls_cfg, **over):
    """The tiny config in either package."""
    base = cls_cfg()
    secs = {k: dataclasses.replace(getattr(base, k), **v) for k, v in CFG.items()}
    for k, v in over.items():
        secs[k] = dataclasses.replace(secs.get(k, getattr(base, k)), **v)
    return base.replace(**secs)


def _leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _batch(seed=1, B=4):
    return np.random.RandomState(seed).randn(B, 64, 16, 2).astype(np.float32)


def test_port_checkpoint_reads_in_jax_and_resumes_there(tmp_path):
    cfg = _cfg(Config)
    path = str(tmp_path / "port.npz")
    seen = []
    state, logs = ScoreTrainer(cfg, device="cpu").train(
        checkpoint_path=path, log_fn=seen.append,
        metrics_path=str(tmp_path / "m.jsonl"))
    assert state.step == 4 and len(logs["val_loss"]) == 2
    assert np.isfinite(logs["train_loss"]).all()
    assert seen[0].startswith("Epoch 0, Step 2, Train Loss (EMA) ")
    assert (tmp_path / "m.jsonl").read_text().count('"event": "val"') == 2
    ck = jax_load(path)
    assert ck["config"].to_dict() == cfg.to_dict()
    assert ck["metadata"] == {"steps": 4}
    assert set(ck["extra"]) == {"train_loss", "val_loss", "norm_stats"}
    jm = jax_model(ck["config"].model)
    x = _batch(3)
    sig = np.array([0.05, 0.7, 2.3, 20.0], np.float32)
    want = np.asarray(jm.apply({"params": ck["ema"]}, jnp.asarray(x),
                               jnp.asarray(sig)))
    with torch.no_grad():
        got = state.ema(torch.from_numpy(x), torch.from_numpy(sig)).numpy()
    assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()
    # the JAX trainer resumes from the port's optimizer leaves
    jt = jax_train.ScoreTrainer(ck["config"], use_mesh=False)
    js = jt.restore_state(path)
    assert int(js.step) == 4 and int(js.opt_state[0].count) == 4
    for a, b in zip(_leaves(js.opt_state), state.opt.state_leaves()):
        np.testing.assert_array_equal(a, b)
    # the port's own reader
    mine = load_checkpoint(path)
    assert len(mine["opt_leaves"]) == 1 + 2 * len(list(state.model.parameters()))
    np.testing.assert_array_equal(mine["extra"]["train_loss"],
                                  logs["train_loss"])


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint of the JAX package's ScoreTrainer (its params, EMA,
    optax leaves and step) resumes in the port's trainer."""
    jcfg = _cfg(JConfig)
    path = str(tmp_path / "jax.npz")
    st, _ = jax_train.ScoreTrainer(jcfg, use_mesh=False).train(
        n_epochs=1, checkpoint_path=path, log_fn=lambda s: None)
    trainer = ScoreTrainer(Config.from_dict(jcfg.to_dict()), device="cpu")
    state = trainer.restore_state(path)
    assert state.step == 2 and state.opt.count == 2
    for a, b in zip(state.opt.state_leaves(), _leaves(st.opt_state)):
        np.testing.assert_array_equal(a, b)
    for mine, theirs in ((state.model, st.params), (state.ema, st.ema_params)):
        for a, b in zip(_leaves(state_dict_to_jax_params(mine.state_dict())),
                        _leaves(theirs)):
            np.testing.assert_array_equal(a, b)
    # and training goes on from there to the config's 4 steps
    state, logs = trainer.train(resume_from=path, log_fn=lambda s: None)
    assert state.step == 4 and len(logs["train_loss"]) == 2


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    cfg = _cfg(Config, training=dict(log_every_steps=3))
    full, full_logs = ScoreTrainer(cfg, device="cpu").train(
        log_fn=lambda s: None)
    path = str(tmp_path / "half.npz")
    ScoreTrainer(cfg, device="cpu").train(n_epochs=1, checkpoint_path=path,
                                          log_fn=lambda s: None)
    resumed, logs = ScoreTrainer(cfg, device="cpu").train(
        resume_from=path, log_fn=lambda s: None)
    assert resumed.step == full.step == 4
    for a, b in ((full.model, resumed.model), (full.ema, resumed.ema)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)
    np.testing.assert_array_equal(full_logs["train_loss"][2:],
                                  logs["train_loss"])


def test_estimate_runs_on_a_default_config_checkpoint(tmp_path):
    """A checkpoint whose config keeps source="cdl" (every checkpoint that
    train-score writes) runs through `estimate`."""
    from score_based_channels_torch.eval.estimate import main as estimate_main

    cfg = _cfg(Config)
    assert cfg.data.source == "cdl"
    path = str(tmp_path / "ck.npz")
    ScoreTrainer(cfg, device="cpu").train(n_epochs=1, checkpoint_path=path,
                                          log_fn=lambda s: None)
    out = str(tmp_path / "res.npz")
    estimate_main(["--checkpoint", path, "--device", "cpu", "--num_channels",
                   "2", "--chunk", "2", "--snr", "10", "--init", "noise",
                   "--dtype", "float32", "--output", out])
    with np.load(out) as f:
        assert f["nmse_log"].shape == (1, 1, 1, 12 * 3, 2)
        assert np.isfinite(f["nmse_log"]).all()


def test_train_score_cli(tmp_path, capsys):
    from score_based_channels_torch.train.score import main

    out = str(tmp_path / "cli.npz")
    main(["--epochs", "1", "--train_size", "32", "--output", out,
          "--device", "cpu", "--ray_coupling", "fixed"])
    ck = load_checkpoint(out)
    assert ck["config"].data.ray_coupling == "fixed"
    assert ck["config"].data.num_channels == 32
    assert ck["metadata"] == {"steps": 1}
    assert "saved checkpoint" in capsys.readouterr().out


def test_cpu_training_builds_no_autograd_function():
    reset_counts()
    trainer = ScoreTrainer(_cfg(Config), device="cpu")
    state = trainer.init_state(1)
    trainer.train_step(state, torch.from_numpy(_batch(B=2)),
                       torch.Generator().manual_seed(0))
    assert grad_counts() == {"conv2d_taps": {"functions": 0, "dgrad": 0},
                             "instance_norm_plus": {"functions": 0,
                                                    "backward": 0}}
    assert conv.COUNTS["plain"] == 113 and inorm.COUNTS["plain"] == 25


def test_matmul_precision_turns_tf32_off_and_restores():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with matmul_precision("highest"):
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


def test_metrics_logger(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    log = MetricsLogger(str(path))
    log.log("val", step=3, loss=np.float32(1.5))
    MetricsLogger(None).log("val", step=1)
    lines = path.read_text().splitlines()
    assert len(lines) == 1 and '"loss": 1.5' in lines[0]
