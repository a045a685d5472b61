"""LDAMP in the PyTorch port against the JAX package: the U-Nets, the CNN
denoisers, LDAMP's forward, one `train_ldamp_snr` run of two Adam steps
across the schedule's staircase, and `run_ldamp_eval` on a checkpoint the
JAX package's trainer wrote.

Inputs are made with numpy; the JAX package's random draws (batches,
divergence directions) are rebuilt from its own key splits
(train/ldamp.py:109-121, eval/ldamp.py:56-64, models/ldamp.py:66-69) and
injected through the port's seams. Bars: 1e-5 relative for the modules
(f32 round-off of two conv orders); the trained parameters within 1e-4
absolute after two Adam steps of 1e-3 (each step moves a parameter by at
most ~lr, so a sign flip of a near-zero gradient would show as 1e-3).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import DataConfig as JDataConfig
from score_based_channels_tpu.data.dataset import ChannelDataset as JDataset
from score_based_channels_tpu.eval.ldamp import run_ldamp_eval as jax_eval
from score_based_channels_tpu.models.cnn import DnCNN as JDnCNN
from score_based_channels_tpu.models.cnn import SRCNN as JSRCNN
from score_based_channels_tpu.models.ldamp import LDAMP as JLDAMP
from score_based_channels_tpu.models.unet import NormUnet as JNormUnet
from score_based_channels_tpu.models.unet import (
    TransposeConvBlock as JTransposeConvBlock,
)
from score_based_channels_tpu.models.unet import Unet as JUnet
from score_based_channels_tpu.train.ldamp import (
    LDAMPTrainConfig as JTrainConfig, _device_batch, train_ldamp_snr as
    jax_train,
)
from score_based_channels_torch import cplx
from score_based_channels_torch.config import Config, DataConfig, OptimConfig
from score_based_channels_torch.data import ChannelDataset
from score_based_channels_torch.eval.ldamp import run_ldamp_eval
from score_based_channels_torch.models.cnn import SRCNN, DnCNN
from score_based_channels_torch.models.convert import (
    jax_variables_to_state_dict, module_to_jax_variables,
    state_dict_to_jax_params,
)
from score_based_channels_torch.models.ldamp import LDAMP
from score_based_channels_torch.models.unet import (
    FlippedNormUnet, NormUnet, TransposeConvBlock, Unet,
)
from score_based_channels_torch.train.ldamp import (
    LDAMPStepRunner, LDAMPTrainConfig, ldamp_batch, ldamp_inputs,
    make_ldamp_model, make_ldamp_optimizer, train_ldamp_snr,
)
from score_based_channels_torch.train.score import Optimizer, staircase_decay

torch.set_num_threads(1)

TOL = 1e-5
TC = dict(max_unrolls=2, chans=4, num_pools=2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _x(seed, shape=(2, 64, 16, 2)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _load(module, variables):
    module.load_state_dict(jax_variables_to_state_dict(
        variables["params"], variables.get("batch_stats")), strict=True)
    return module


def test_transposed_conv_flips_a_non_symmetric_kernel():
    """flax's ConvTranspose applies its kernel unflipped; torch's is the
    adjoint of a conv. A random kernel (not symmetric) shows a missing
    flip; the converter's flip makes the two agree."""
    x = _x(1, (2, 8, 2, 6))
    jm = JTransposeConvBlock(4)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    kernel = np.asarray(v["params"]["tconv"]["kernel"])
    assert np.abs(kernel - kernel[::-1, ::-1]).max() > 1e-2
    tm = _load(TransposeConvBlock(6, 4), v)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    run = lambda: tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).detach().numpy()
    assert _rel(run(), want) < TOL
    with torch.no_grad():  # without the flip the outputs part
        tm.tconv.weight.copy_(tm.tconv.weight.flip(2, 3))
    assert _rel(run(), want) > 1e-2
    back, _ = module_to_jax_variables(TransposeConvBlock(6, 4))
    assert back["tconv"]["kernel"].shape == kernel.shape


@pytest.mark.parametrize("kind,shape", [
    ("unet", (2, 64, 16, 2)), ("normunet", (2, 64, 16, 2)),
    ("flipped", (2, 64, 16, 2)),
    # padded to 32 x 16 around the U-Net (the bare U-Net takes multiples
    # of 2**pools only)
    ("normunet", (1, 20, 10, 2)), ("flipped", (1, 20, 10, 2))])
def test_unets_match_flax(kind, shape):
    x = _x(2, shape)
    jm = {"unet": JUnet(out_chans=2, chans=4, num_pool_layers=2),
          "normunet": JNormUnet(chans=4, num_pools=2),
          "flipped": JNormUnet(chans=4, num_pools=2, residual=True)}[kind]
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    tm = {"unet": lambda: Unet(2, 2, 4, 2), "normunet": lambda: NormUnet(4, 2),
          "flipped": lambda: FlippedNormUnet(4, 2)}[kind]()
    _load(tm, v)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        if kind == "unet":
            got = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)).permute(0, 2, 3, 1)
        else:
            got = tm(torch.from_numpy(x))
    assert got.shape == x.shape
    assert _rel(got.numpy(), want) < TOL
    back, _ = module_to_jax_variables(tm)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("train", [True, False])
def test_dncnn_matches_flax_and_keeps_flax_running_stats(train):
    """DnCNN with flax's BatchNorm (momentum 0.9, eps 1e-4): the forward in
    train and eval mode, and in train mode the running statistics after
    the step (biased batch variance; torch's BatchNorm2d would store the
    unbiased one, n/(n-1) apart)."""
    x = _x(3)
    jm = JDnCNN(hidden=8, num_layers=4)
    v = jm.init(jax.random.key(2), jnp.asarray(x))
    # non-trivial running statistics, so eval mode reads them
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda s: s + 0.3, v["batch_stats"])}
    want, new = jm.apply(v, jnp.asarray(x), train=train,
                         mutable=["batch_stats"])
    tm = _load(DnCNN(hidden=8, num_layers=4), v).train(train)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, want) < TOL
    _, stats = module_to_jax_variables(tm)
    for a, b in zip(jax.tree.leaves(stats),
                    jax.tree.leaves(new["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=1e-7)


def test_batchnorm_step_keeps_the_biased_variance():
    """One flax BatchNorm step at n = 2 samples: the running variance takes
    the biased batch variance, which torch's BatchNorm2d would not."""
    from score_based_channels_torch.models.layers import BatchNorm2d

    x = _x(4, (2, 3, 2, 5))  # n = 2 x 3 x 2 per channel
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    want, new = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tb = BatchNorm2d(5)
    got = tb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(got.detach().numpy(), want) < TOL
    np.testing.assert_allclose(tb.var.numpy(), np.asarray(
        new["batch_stats"]["var"]), rtol=1e-6)
    tbn = torch.nn.BatchNorm2d(5)
    tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(tbn.running_var.numpy() - tb.var.numpy()).max() > 1e-3


def test_srcnn_matches_flax():
    x = _x(5)
    jm = JSRCNN()
    v = jm.init(jax.random.key(3), jnp.asarray(x))
    tm = _load(SRCNN(), v)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    assert _rel(tm(torch.from_numpy(x)).detach().numpy(), want) < TOL


def _jax_directions(key, n, shape):
    out = []
    for _ in range(n):
        key, k_dir = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(k_dir, shape, jnp.float32))))
    return out


def _ldamp_inputs(seed=6, B=2, Np=38):
    rng = np.random.RandomState(seed)
    Y = rng.randn(B, Np, 16, 2).astype(np.float32)
    P = (np.sign(rng.randn(B, Np, 64, 2)) * np.sqrt(0.5)).astype(np.float32)
    eig = np.full((B,), 100.0, np.float32) + rng.rand(B).astype(np.float32)
    return Y, P, eig


@pytest.mark.parametrize("shared", [False, True])
def test_ldamp_forward_matches_flax_with_the_jax_directions(shared):
    Y, P, eig = _ldamp_inputs()
    jm = JLDAMP(shared_nets=shared, **TC)
    km = jax.random.key(7)
    v = jm.init(jax.random.key(8), Y, P, eig, km, 2)
    want = np.asarray(jm.apply(v, Y, P, eig, km, 2))
    tm = _load(LDAMP(shared_nets=shared, **TC), v)
    got = tm(torch.from_numpy(Y), torch.from_numpy(P), torch.from_numpy(eig),
             directions=_jax_directions(km, 2, (2, 64, 16, 2)))
    assert got.shape == (2, 64, 16, 2)
    assert _rel(got.detach().numpy(), want) < TOL


def test_staircase_adam_matches_optax():
    """optax.adam(exponential_decay(..., staircase=True)) against the
    port's Optimizer with staircase_decay, over the decay's step."""
    rng = np.random.RandomState(9)
    p0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32) for _ in range(4)]
    tx = optax.adam(optax.exponential_decay(1e-2, 2, 0.1, staircase=True))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = Optimizer([("w", tp)], OptimConfig(lr=1e-2, eps=1e-8),
                    schedule=staircase_decay(1e-2, 2, 0.1))
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)
    assert len(opt.state_leaves()) == len(jax.tree.leaves(st))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX `train_ldamp_snr` of 2 epochs x 1 step (4 channels, batch 4,
    decay after 1 epoch: the second step takes lr x 0.1), its checkpoint,
    and the draws it made."""
    jcfg = JConfig(data=JDataConfig(num_channels=4))
    jtc = JTrainConfig(batch_size=4, n_epochs=2, decay_epochs=1, **TC)
    snr = 10.0
    d = tmp_path_factory.mktemp("ldamp")
    path = str(d / "train-CDL-C" / f"model_snr{snr:.2f}_alpha0.60.npz")
    params, logs = jax_train(jcfg, snr, jtc, checkpoint_path=path,
                             log_fn=lambda s: None)
    # the run's own draws (train/ldamp.py:98-121)
    noise_std = 10 ** (-snr / 20.0) * np.sqrt(64)
    ds = JDataset(1234, dataclasses.replace(
        jcfg.data, noise_std=float(noise_std), num_pilots=38), norm="global")
    key = jax.random.key(jtc.seed)
    key, k_init, k_b0 = jax.random.split(key, 3)
    b0 = _device_batch(ds, k_b0, 2)
    init = JLDAMP(**TC).init(k_init, b0["Y_herm"], b0["P_herm"], b0["eig1"],
                             jax.random.key(0), 2)["params"]
    batches, directions = [], []
    for _ in range(2):
        key, k_b, k_s = jax.random.split(key, 3)
        b = _device_batch(ds, k_b, 4)
        batches.append({k: torch.from_numpy(np.array(v))
                        for k, v in b.items()})
        directions.append(_jax_directions(k_s, 2, (4, 64, 16, 2)))
    return dict(params=params, logs=logs, init=init, batches=batches,
                directions=directions, dir=str(d), jcfg=jcfg, snr=snr)


def test_train_ldamp_snr_matches_jax(jax_run):
    cfg = Config(data=DataConfig(num_channels=4))
    tc = LDAMPTrainConfig(batch_size=4, n_epochs=2, decay_epochs=1, **TC)
    init = jax_variables_to_state_dict(jax_run["init"])
    model, logs = train_ldamp_snr(
        cfg, jax_run["snr"], tc, log_fn=lambda s: None, device="cpu",
        _init=init, _batches=lambda i: jax_run["batches"][i],
        _directions=lambda i: jax_run["directions"][i])
    np.testing.assert_allclose(logs["loss_log"], jax_run["logs"]["loss_log"],
                               rtol=TOL)
    np.testing.assert_allclose(logs["nmse_log"], jax_run["logs"]["nmse_log"],
                               rtol=TOL)
    got = state_dict_to_jax_params(model.state_dict())
    moved = 0.0
    for a, b, c in zip(jax.tree.leaves(got),
                       jax.tree.leaves(jax_run["params"]),
                       jax.tree.leaves(jax_run["init"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
        moved = max(moved, float(np.abs(np.asarray(b) - np.asarray(c)).max()))
    # lr 1e-3, then 1e-4 after the staircase: at most ~1.1e-3 moved
    assert 5e-4 < moved < 1.2e-3, moved


def test_eval_ldamp_reads_the_jax_checkpoint(jax_run):
    """Both packages' run_ldamp_eval on the JAX-written checkpoint, fed the
    JAX evaluation's draws (eval/ldamp.py:56-64): the same NMSE."""
    jcfg, snr, d = jax_run["jcfg"], jax_run["snr"], jax_run["dir"]
    want = jax_eval(jcfg, snr_range=[snr], model_dir=d, num_channels=3)
    ds = JDataset(4321, dataclasses.replace(
        jcfg.data, noise_std=float(10 ** (-snr / 20.0) * 8), num_pilots=38,
        num_channels=max(3, jcfg.data.num_channels)), norm="global")
    k_b, k_m = jax.random.split(jax.random.fold_in(jax.random.key(17), 0))
    b = {k: torch.from_numpy(np.array(v))
         for k, v in _device_batch(ds, k_b, 3).items()}
    got = run_ldamp_eval(Config(), snr_range=[snr], model_dir=d,
                         num_channels=3, device="cpu",
                         _batches=lambda i: b,
                         _directions=lambda i: _jax_directions(
                             k_m, 2, (3, 64, 16, 2)))
    np.testing.assert_allclose(got.nmse, want.nmse, rtol=1e-5)
    np.testing.assert_allclose(got.avg_db(), want.avg_db(), atol=1e-4)


def test_train_and_eval_ldamp_on_their_own_draws(tmp_path):
    """The port's own run: a training loss that falls, a checkpoint in the
    JAX layout at the reference name, and the eval command reading it."""
    from score_based_channels_torch.eval.ldamp import main as eval_main
    from score_based_channels_torch.train.ldamp import main as train_main

    train_main(["--snr_range", "20", "--epochs", "4", "--train_size", "8",
                "--model_dir", str(tmp_path), "--device", "cpu"])
    from score_based_channels_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(str(tmp_path / "train-CDL-C" /
                             "model_snr20.00_alpha0.60.npz"))
    assert ck["metadata"]["train_snr"] == 20.0
    assert sorted(ck["params"]) == [f"denoiser_{i}" for i in range(10)]
    out = str(tmp_path / "res.npz")
    eval_main(["--snr_range", "20", "--num_channels", "4", "--model_dir",
               str(tmp_path), "--device", "cpu", "--output", out])
    with np.load(out) as f:
        assert f["nmse"].shape == (1, 4) and np.isfinite(f["nmse"]).all()


def test_ldamp_commands_run_with_tf32_off(tmp_path, monkeypatch):
    """train-ldamp and eval-ldamp run with TF32 off for cuDNN and matmul
    (the config's matmul_precision "highest", as train-score), and give
    the settings back after."""
    from score_based_channels_torch.eval.ldamp import main as eval_main
    from score_based_channels_torch.train.ldamp import main as train_main

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen, forward = [], LDAMP.forward

    def spy(self, *args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(LDAMP, "forward", spy)
    train_main(["--snr_range", "20", "--epochs", "1", "--train_size", "4",
                "--model_dir", str(tmp_path), "--device", "cpu"])
    n_train = len(seen)
    eval_main(["--snr_range", "20", "--num_channels", "2", "--model_dir",
               str(tmp_path), "--device", "cpu", "--output",
               str(tmp_path / "res.npz")])
    assert 0 < n_train < len(seen)
    assert set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


@pytest.fixture(scope="module")
def file_sets(tmp_path_factory):
    """Two data sets of 130 random channels read from a file in the
    reference naming, at noise amplitude 0 and at 10 dB's."""
    d = tmp_path_factory.mktemp("draws")
    rng = np.random.default_rng(5)
    h = (rng.standard_normal((130, 1, 16, 64))
         + 1j * rng.standard_normal((130, 1, 16, 64))).astype(np.complex64)
    np.savez(d / "CDL-C_Nt64_Nr16_ULA0.50_seed1234.npz", output_h=h)
    return {noisy: ChannelDataset(1234, DataConfig(
        num_channels=130, source="file", data_dir=str(d), num_pilots=38,
        noise_std=float(10 ** -0.5 * 8) if noisy else 0.0), norm="global")
        for noisy in (False, True)}


def _host_assembled(ds, gen, B):
    """LDAMP's batch as the host made it before the draws went to the
    device: the data set's draws and the reference loader's arithmetic
    (loaders.py:77-106), eigvalsh included."""
    idx = torch.randperm(len(ds), generator=gen)[:B]
    H = torch.from_numpy(ds.channels)[idx]
    P = torch.view_as_complex(cplx.qpsk_pilots(gen, B, 64, ds.num_pilots))
    Y = H @ P
    if ds.noise_amp > 0:
        Y = Y + ds.noise_amp * torch.view_as_complex(
            torch.randn(Y.shape + (2,), generator=gen))
    herm = lambda t: t.transpose(-1, -2).conj().resolve_conj()
    return {"Y_herm": cplx.as_c2(herm(Y)), "P_herm": cplx.as_c2(herm(P)),
            "H_herm_cplx": cplx.as_c2(herm(H)),
            "eig1": torch.linalg.eigvalsh(P @ herm(P))[..., -1].float()}


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("B", [2, 3, 128])
@pytest.mark.parametrize("seed", [0, 17, 2**31 + 9])
def test_assembled_draws_equal_the_host_batch_bitwise(file_sets, noisy, B,
                                                      seed):
    """ldamp_inputs of ldamp_batch's draws on the CPU against the batch the
    host made before from the same seed: every tensor bit for bit, and
    the generator left in the same state."""
    ds = file_sets[noisy]
    gens = [torch.Generator().manual_seed(seed) for _ in range(2)]
    draws = ldamp_batch(ds, gens[0], B, "cpu")
    assert ("noise" in draws) == noisy
    got = ldamp_inputs(draws)
    want = _host_assembled(ds, gens[1], B)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_draws_leave_the_eigensolve_to_the_step(file_sets, monkeypatch):
    """ldamp_batch makes only the draws: no eigvalsh on the host (patched
    to raise), the raw rows, uint8 pilot bits, the noise and its
    amplitude."""
    def refuse(*args, **kwargs):
        raise AssertionError("eigvalsh on the host")

    monkeypatch.setattr(torch.linalg, "eigvalsh", refuse)
    ds = file_sets[True]
    d = ldamp_batch(ds, torch.Generator().manual_seed(3), 128, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in d.items()} == {
        "H": ((128, 16, 64, 2), torch.float32),
        "pilot_bits": ((128, 64, 38, 2), torch.uint8),
        "noise": ((128, 16, 38, 2), torch.float32),
        "amp": ((), torch.float32)}
    assert d["amp"].item() == np.float32(ds.noise_amp)
    with pytest.raises(AssertionError, match="eigvalsh on the host"):
        ldamp_inputs(d)


def test_runner_on_draws_equals_the_runner_on_host_batches(file_sets):
    """Two runners, one fed the draws (assembled in its step), one the
    host-assembled batches of the same seeds: every (mse, nmse) row, the
    parameters and the count bit for bit; only the first counts the
    steps it assembled."""
    ds = file_sets[True]
    tc = LDAMPTrainConfig(max_unrolls=2, chans=4, num_pools=1,
                          batch_size=2, decay_epochs=1)
    runs = []
    for form in (lambda s: ldamp_batch(ds, torch.Generator().manual_seed(
            s), 2, "cpu"), lambda s: _host_assembled(
            ds, torch.Generator().manual_seed(s), 2)):
        model = make_ldamp_model(tc, "cpu")
        opt = make_ldamp_optimizer(model, tc, 2)
        runner = LDAMPStepRunner(model, opt, torch.Generator(), 2, 4)
        rows = torch.cat([runner.run((form(s) for s in steps),
                                     [40 + s for s in steps]).clone()
                          for steps in (range(2), range(2, 4))])
        runs.append((model, opt, rows, runner.stats))
    (ma, oa, ra, sa), (mb, ob, rb, sb) = runs
    assert torch.equal(ra, rb) and torch.isfinite(ra).all()
    for p, q in zip(ma.parameters(), mb.parameters()):
        assert torch.equal(p, q)
    assert oa.count == ob.count == 4
    assert (sa["steps"], sa["assembled"]) == (4, 4)
    assert (sb["steps"], sb["assembled"]) == (4, 0)
