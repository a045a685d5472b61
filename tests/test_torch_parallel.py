"""Data parallelism of the PyTorch port on torch.distributed
(score_based_channels_torch/parallel/) against one process and against the
JAX package.

Two Gloo processes run `python -m score_based_channels_torch.parallel.mp_smoke`
as tests/test_multiprocess.py drives the JAX one. Both ranks must print
the same values; the 2-rank train steps must equal the 1-process steps on
the whole batch and the JAX package's steps on the same draws at 1e-6 on
the parameters (the bar of tests/test_torch_train.py); the 2-rank sweep
traces must equal the 1-process traces at the same chunk_size (1e-6 of
their largest value); every rank restores rank 0's checkpoint bit for
bit (mp_smoke asserts it and prints ckpt=ok).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.config import TrainingConfig as JTrainingConfig
from score_based_channels_tpu.diffusion.sigmas import (
    sigmas_from_config as jax_sigmas,
)
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.parallel.mesh import (
    pad_to_multiple as jax_pad_to_multiple,
)
from score_based_channels_tpu.train import score as jax_train
from score_based_channels_torch import cplx
from score_based_channels_torch.config import (
    Config, DataConfig, ModelConfig, TrainingConfig,
)
from score_based_channels_torch.diffusion.dsm import anneal_dsm_loss
from score_based_channels_torch.diffusion.sampling import (
    annealed_langevin_posterior_c2,
)
from score_based_channels_torch.diffusion.sigmas import get_sigmas
from score_based_channels_torch.models import (
    make_score_model, state_dict_to_jax_params,
)
from score_based_channels_torch.models.convert import tree_leaves, tree_paths
from score_based_channels_torch.parallel import (
    Mesh, data_sharding, initialize, is_primary, make_mesh, pad_to_multiple,
    replicate, shard_batch,
)
from score_based_channels_torch.parallel import mp_smoke
from score_based_channels_torch.train import ScoreTrainer
from score_based_channels_torch.train.score import (
    make_eval_loss, make_score_train_step,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS = 4, 2
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return env


# -----------------------------------------------------------------------------
# the mesh without a process group
# -----------------------------------------------------------------------------


def test_mesh_without_a_group_is_one_rank():
    mesh = make_mesh()
    assert (mesh.rank, mesh.world_size, mesh.distributed) == (0, 1, False)
    assert is_primary()
    x = torch.arange(12.0).reshape(6, 2)
    assert mesh.rows(6) == slice(0, 6)
    assert mesh.gather(x) is x
    assert replicate(mesh, x) is x
    t = torch.ones(3)
    mesh.mean([t])
    assert torch.equal(t, torch.ones(3))
    # a mesh of two ranks with no group refuses its collectives
    two = Mesh(1, 2)
    for collective in (lambda: two.gather(x), lambda: two.mean([t]),
                       two.barrier, lambda: replicate(two, x)):
        with pytest.raises(RuntimeError, match="initialised process group"):
            collective()


@pytest.mark.parametrize("rank,world,n", [(0, 2, 6), (1, 2, 6), (3, 4, 8)])
def test_rows_split_the_batch_in_rank_order(rank, world, n):
    mesh = Mesh(rank, world)
    x = torch.arange(float(n * 3)).reshape(n, 3)
    per = n // world
    assert torch.equal(mesh.shard(x), x[rank * per:(rank + 1) * per])
    assert torch.equal(data_sharding(mesh, 2)(x), mesh.shard(x))
    tree = shard_batch(mesh, {"x": x, "s": torch.tensor(2.0), "l": [x]})
    assert torch.equal(tree["x"], mesh.shard(x)) and tree["s"].dim() == 0
    assert torch.equal(tree["l"][0], mesh.shard(x))
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows(n + 1)
    with pytest.raises(ValueError, match="expected 3 dims"):
        data_sharding(mesh, 3)(x)


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (3, 8), (1, 2)])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    want, n_w = jax_pad_to_multiple(jnp.asarray(x), multiple)
    got, n_g = pad_to_multiple(torch.from_numpy(x), multiple)
    assert n_g == n_w == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_initialize_takes_all_three_or_none():
    with pytest.raises(ValueError, match="together"):
        initialize("127.0.0.1:1", num_processes=2, device="cpu")


def test_trainer_is_single_process_without_a_group():
    cfg = Config(model=ModelConfig(ngf=4, num_classes=8))
    assert ScoreTrainer(cfg, device="cpu").mesh is None


def test_dsm_loss_rows_split_the_whole_batch_draws():
    """Each rank draws the whole batch's labels and noise and keeps its
    rows: the mean of the ranks' losses and gradients is the whole-batch
    loss and gradient."""
    model = make_score_model(ModelConfig(ngf=4, num_classes=8), device="cpu")
    sig = torch.linspace(2.0, 0.1, 8)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        B, 64, 16, 2).astype(np.float32))

    def loss_and_grads(rows):
        model.zero_grad()
        loss = anneal_dsm_loss(model, x, sig,
                               torch.Generator().manual_seed(5), rows=rows)
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    whole, g_whole = loss_and_grads(None)
    parts = [loss_and_grads(Mesh(r, 2).rows(B)) for r in range(2)]
    assert abs((parts[0][0] + parts[1][0]) / 2 - whole) <= 1e-6 * whole
    for g, a, b in zip(g_whole, parts[0][1], parts[1][1]):
        torch.testing.assert_close((a + b) / 2, g, rtol=1e-5,
                                   atol=1e-6 * g.abs().max().item())


def test_eval_loss_splits_only_a_dividing_batch():
    """A batch that does not divide by the ranks is evaluated whole (no
    collective, the whole-batch loss on every rank); one that divides is
    split, and its mean needs the group."""
    model = make_score_model(ModelConfig(ngf=4, num_classes=8), device="cpu")
    sig = torch.linspace(2.0, 0.1, 8)
    whole = make_eval_loss(sig, 2.0)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        5, 64, 16, 2).astype(np.float32))
    want = whole(model, x, torch.Generator().manual_seed(3))
    for r in range(2):
        got = make_eval_loss(sig, 2.0, Mesh(r, 2))(
            model, x, torch.Generator().manual_seed(3))
        assert torch.equal(got, want)
        with pytest.raises(RuntimeError, match="initialised process group"):
            make_eval_loss(sig, 2.0, Mesh(r, 2))(
                model, x[:4], torch.Generator().manual_seed(3))


def test_a_batch_that_does_not_split_is_refused():
    step = make_score_train_step(torch.ones(4), 0.999, 2.0, Mesh(0, 2))
    with pytest.raises(ValueError, match="does not split"):
        step(None, torch.zeros(5, 64, 16, 2))


@pytest.mark.parametrize("chunk,world", [(4, 2), (3, 2), (5, 4)])
def test_sampler_noise_rows_do_not_depend_on_the_split(chunk, world):
    """A rank that keeps rows `keep` of the chunk's draws runs exactly the
    rows of the whole chunk (padded rows repeat the last one)."""
    g = torch.Generator().manual_seed(1)
    A = cplx.conj_transpose(cplx.qpsk_pilots(g, chunk, 64, 8))
    X = cplx.randn(g, (chunk, 64, 16))
    Y = cplx.matmul(A, X)
    x0 = cplx.randn(g, (chunk, 64, 16))
    sig = get_sigmas(1.0, 0.01, 3)
    score = lambda x, s: -x / s  # a fixed, batch-independent score

    def run(rows, noise_rows):
        xf, tr = annealed_langevin_posterior_c2(
            score, A[rows], Y[rows], sig, 0.1, x0[rows],
            generator=torch.Generator().manual_seed(7), alpha_step=1e-3,
            beta_noise=0.5, steps_each=2, oracle=X[rows],
            noise_rows=noise_rows)
        return xf, tr

    whole_x, whole_t = run(slice(None), None)
    per = -(-chunk // world)
    for r in range(world):
        keep = torch.arange(r * per, (r + 1) * per).clamp_max(chunk - 1)
        xf, tr = run(keep, (chunk, keep))
        assert torch.equal(xf, whole_x[keep])
        assert torch.equal(tr, whole_t[:, keep])


# -----------------------------------------------------------------------------
# two Gloo processes against one process and against JAX
# -----------------------------------------------------------------------------


def _jax_draws(key, L, shape):
    k_label, k_noise = jax.random.split(key)
    return (np.asarray(jax.random.randint(k_label, (shape[0],), 0, L)),
            np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """STEPS JAX train steps from the port's init (mp_smoke's seed 0) on
    fixed batches; the draws each step took, for the port to reuse."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = Config(model=ModelConfig(ngf=8, num_classes=16),
                 training=TrainingConfig(batch_size=B),
                 data=DataConfig(num_channels=B))
    state = ScoreTrainer(cfg, device="cpu").init_state(0)
    params = jax.tree.map(jnp.asarray,
                          state_dict_to_jax_params(state.model.state_dict()))
    jcfg = JConfig(model=JModelConfig(ngf=8, num_classes=16),
                   training=JTrainingConfig(batch_size=B))
    jm = jax_model(jcfg.model)
    tx = jax_train.make_optimizer(jcfg.optim)
    j_step, _ = jax_train.make_score_train_step(
        jm, tx, jax_sigmas(jcfg.model), jcfg.model.ema_rate,
        jcfg.training.anneal_power)
    j_state = jax_train.ScoreTrainState(
        params=params, opt_state=tx.init(params),
        ema_params=jax.tree.map(jnp.copy, params),
        step=jnp.zeros((), jnp.int32))
    rng = np.random.RandomState(11)
    xs, labels, noises, losses = [], [], [], []
    for s in range(STEPS):
        x = rng.randn(B, 64, 16, 2).astype(np.float32)
        key = jax.random.key(50 + s)
        lab, noise = _jax_draws(key, 16, x.shape)
        j_state, loss = j_step(j_state, jnp.asarray(x), key)
        xs.append(x)
        labels.append(lab)
        noises.append(noise)
        losses.append(float(loss))
    draws = dict(x=np.stack(xs), labels=np.stack(labels),
                 noise=np.stack(noises))
    path = str(tmp / "draws.npz")
    np.savez(path, **draws)
    return dict(tmp=tmp, draws_path=path, draws=draws, losses=losses,
                params=jax.tree.map(np.asarray, j_state.params),
                ema=jax.tree.map(np.asarray, j_state.ema_params))


def _two_ranks(tmp, draws_path, chunk, tag):
    port = _free_port()
    ckpt = str(tmp / f"ck_{tag}.npz")
    out = str(tmp / f"out_{tag}")
    workers = [subprocess.Popen(
        [sys.executable, "-m", "score_based_channels_torch.parallel.mp_smoke",
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(r), "--device", "cpu", "--ckpt", ckpt,
         "--draws", draws_path, "--steps", str(STEPS), "--chunk", str(chunk),
         "--out", out],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for r, w in enumerate(workers):
        try:
            outs.append(w.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for ww in workers:
                ww.kill()
                ww.wait()
            pytest.fail(f"rank {r} timed out")
    for r, (w, o) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"rank {r} failed:\n{o}"
    lines = [next(ln for ln in o.splitlines() if "MP_SMOKE_OK" in ln)
             for o in outs]
    results = [dict(np.load(f"{out}.rank{r}.npz")) for r in range(2)]
    return lines, results, ckpt


@pytest.fixture(scope="module", params=[4, 3])
def two_ranks(request, jax_run):
    chunk = request.param
    lines, results, ckpt = _two_ranks(jax_run["tmp"], jax_run["draws_path"],
                                      chunk, f"c{chunk}")
    one = mp_smoke.run_smoke("cpu", steps=STEPS, chunk_size=chunk,
                             ckpt_path=str(jax_run["tmp"] / f"one_{chunk}.npz"),
                             _draws=jax_run["draws"])
    return dict(chunk=chunk, lines=lines, results=results, one=one)


def _flat(tree, name):
    return {f"{name}/" + "/".join(p): l
            for p, l in zip(tree_paths(tree), tree_leaves(tree))}


def test_both_ranks_print_the_same_values(two_ranks):
    lines = two_ranks["lines"]
    stripped = [" ".join(t for t in ln.split() if not t.startswith("rank="))
                for ln in lines]
    assert stripped[0] == stripped[1], lines
    assert "world=2" in stripped[0] and "ckpt=ok" in stripped[0], lines
    r0, r1 = two_ranks["results"]
    assert r0.keys() == r1.keys()
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_two_ranks_step_as_one_process_on_the_whole_batch(two_ranks):
    got, one = two_ranks["results"][0], two_ranks["one"]
    assert one["world"] == 1
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6)
    want = {**_flat(one["params"], "params"), **_flat(one["ema"], "ema")}
    assert set(want) == {k for k in got if "/" in k}
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-6, k


def test_two_ranks_step_as_jax_on_the_same_draws(two_ranks, jax_run):
    got = two_ranks["results"][0]
    np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=2e-4)
    want = {**_flat(jax_run["params"], "params"),
            **_flat(jax_run["ema"], "ema")}
    assert set(want) == {k for k in got if "/" in k}
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-6, k


def test_two_rank_sweep_traces_equal_one_process(two_ranks):
    got = two_ranks["results"][0]["trace"]
    want = two_ranks["one"]["trace"]
    assert got.shape == want.shape == (20 * 2, B)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# -----------------------------------------------------------------------------
# ScoreTrainer.train in two Gloo processes against one process
# -----------------------------------------------------------------------------

# 9 realizations: two steps of 4 an epoch, and a validation set of 9 rows
# that does not divide by 2 (evaluated whole on every rank)
TRAIN_CFG = dict(model=dict(ngf=4, num_classes=8),
                 training=dict(batch_size=4, n_epochs=2, log_every_steps=1),
                 data=dict(num_channels=9))

_TRAIN_WORKER = """
import dataclasses, sys
import numpy as np, torch
import torch.distributed as dist
from score_based_channels_torch.config import Config
from score_based_channels_torch.parallel import initialize
from score_based_channels_torch.train import ScoreTrainer
torch.set_num_threads(1)
port, rank, tmp, spec = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
           device="cpu")
try:
    base = Config()
    spec = eval(spec)
    cfg = base.replace(**{k: dataclasses.replace(getattr(base, k), **v)
                          for k, v in spec.items()})
    trainer = ScoreTrainer(cfg, device="cpu")
    assert (trainer.mesh.rank, trainer.mesh.world_size) == (rank, 2)
    seen = []
    state, logs = trainer.train(
        checkpoint_path=f"{tmp}/ck.rank{rank}.npz", log_fn=seen.append,
        metrics_path=f"{tmp}/m.rank{rank}.jsonl")
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(5, 64, 16, 2).astype(np.float32))
    ev = [float(trainer.eval_loss(state.ema, x[:n],
                                  torch.Generator().manual_seed(6)))
          for n in (4, 5)]
    odd = ScoreTrainer(cfg.replace(training=dataclasses.replace(
        cfg.training, batch_size=3)), device="cpu")
    try:
        odd.train(n_epochs=1, log_fn=seen.append)
        refused = ""
    except ValueError as e:
        refused = str(e)
    np.savez(f"{tmp}/out.rank{rank}.npz", train_loss=logs["train_loss"],
             val_loss=logs["val_loss"], eval_loss=np.asarray(ev),
             n_logged=len(seen), refused=refused,
             **{"params/" + k: v.numpy()
                for k, v in state.model.state_dict().items()},
             **{"ema/" + k: v.numpy()
                for k, v in state.ema.state_dict().items()})
finally:
    dist.destroy_process_group()
"""


def _train_cfg(**training):
    base = Config()
    secs = {k: dataclasses.replace(getattr(base, k), **v)
            for k, v in TRAIN_CFG.items()}
    secs["training"] = dataclasses.replace(secs["training"], **training)
    return base.replace(**secs)


@pytest.fixture(scope="module")
def two_rank_training(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    port = _free_port()
    workers = [subprocess.Popen(
        [sys.executable, "-c", _TRAIN_WORKER, str(port), str(r), str(tmp),
         repr(TRAIN_CFG)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for r, w in enumerate(workers):
        try:
            outs.append(w.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for ww in workers:
                ww.kill()
                ww.wait()
            pytest.fail(f"rank {r} timed out")
    for r, (w, o) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"rank {r} failed:\n{o}"
    results = [dict(np.load(tmp / f"out.rank{r}.npz")) for r in range(2)]

    trainer = ScoreTrainer(_train_cfg(), device="cpu")
    assert trainer.mesh is None
    seen = []
    state, logs = trainer.train(log_fn=seen.append)
    x = torch.from_numpy(np.random.RandomState(4).randn(
        5, 64, 16, 2).astype(np.float32))
    ev = [float(trainer.eval_loss(state.ema, x[:n],
                                  torch.Generator().manual_seed(6)))
          for n in (4, 5)]
    one = dict(logs, eval_loss=np.asarray(ev), n_logged=len(seen),
               **{"params/" + k: v.numpy()
                  for k, v in state.model.state_dict().items()},
               **{"ema/" + k: v.numpy()
                  for k, v in state.ema.state_dict().items()})
    return dict(tmp=tmp, results=results, one=one)


def test_two_rank_training_logs_equal_one_process(two_rank_training):
    one = two_rank_training["one"]
    assert len(one["train_loss"]) == 4 and len(one["val_loss"]) == 4
    for got in two_rank_training["results"]:
        np.testing.assert_allclose(got["train_loss"], one["train_loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["val_loss"], one["val_loss"],
                                   rtol=1e-6)


def test_two_rank_training_parameters_equal_one_process(two_rank_training):
    one = two_rank_training["one"]
    keys = {k for k in one if "/" in k}
    r0, r1 = two_rank_training["results"]
    assert {k for k in r0 if "/" in k} == keys
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        assert np.abs(r0[k] - one[k]).max() <= 1e-6, k


def test_two_rank_eval_loss_splits_a_dividing_batch(two_rank_training):
    """The 4-row batch is split and its loss averaged over the ranks; the
    5-row one is evaluated whole on each: both equal one process."""
    one = two_rank_training["one"]["eval_loss"]
    for got in two_rank_training["results"]:
        np.testing.assert_allclose(got["eval_loss"], one, rtol=1e-6)


def test_only_rank_0_logs_and_writes(two_rank_training):
    tmp, (r0, r1) = two_rank_training["tmp"], two_rank_training["results"]
    assert (tmp / "ck.rank0.npz").exists()
    assert not (tmp / "ck.rank1.npz").exists()
    assert (tmp / "m.rank0.jsonl").read_text().count('"event": "val"') == 4
    assert not (tmp / "m.rank1.jsonl").exists()
    # 4 validation lines and the checkpoint's
    assert int(r0["n_logged"]) == two_rank_training["one"]["n_logged"] + 1
    assert int(r1["n_logged"]) == 0


def test_two_rank_training_refuses_a_batch_that_does_not_split(
        two_rank_training):
    for got in two_rank_training["results"]:
        assert "a batch of 3 rows does not split over 2 ranks" in str(
            got["refused"])


# -----------------------------------------------------------------------------
# weak scaling on the CPU
# -----------------------------------------------------------------------------


def test_weak_scaling_prints_a_cpu_line_per_world_size():
    r = subprocess.run(
        [sys.executable, "-m", "score_based_channels_torch.parallel.weak_scaling",
         "--world", "1", "2", "--per_rank", "2", "--stride", "1000",
         "--ngf", "4", "--reps", "1", "--timeout", str(TIMEOUT)],
        cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=2 * TIMEOUT)
    assert r.returncode == 0, r.stderr
    print(r.stdout)
    assert r.stdout.startswith("# weak scaling on the CPU (Gloo)")
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["world_size"] for ln in lines] == [1, 2]
    for ln in lines:
        assert ln["platform"] == "cpu" and ln["per_rank"] == 2
        assert ln["batch"] == 2 * ln["world_size"] and ln["wall_s"] > 0
