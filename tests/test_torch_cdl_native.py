"""The port's binding of the native C++ CDL generator (data/cdl_native.py)
and `generate-data --backend`.

The binding is held bit for bit against the JAX package's binding of the
same source, given the port's built library (so nothing is written into
native/): the same arguments, profile tables and reshape give the same
channels. The model itself is held to the torch generator (other random
streams) by the moment bars of the JAX package's own native test
(tests/test_cdl_native.py:29-44): entry power within 25%, the normalised
transmit covariances correlated above 0.9. Needs g++ with OpenMP, as the
JAX package's test does; the library is built under build/native/.
"""

import numpy as np
import pytest

from score_based_channels_torch.data import cdl_native
from score_based_channels_torch.data.cdl import generate_cdl_channels
from score_based_channels_torch.data.cdl_native import (
    NativeUnavailable, generate_cdl_channels_native, library_path,
)
from score_based_channels_torch.data.generate import main as generate_main


@pytest.fixture(scope="module")
def native():
    try:
        cdl_native.load_library()
    except NativeUnavailable as e:
        pytest.skip(f"g++/OpenMP unavailable: {e}")


def test_library_is_built_under_build(native):
    so = library_path()
    assert so.exists()
    assert so.parent.parent == cdl_native.BUILD_ROOT
    root = cdl_native.SOURCE.parent.parent
    assert cdl_native.BUILD_ROOT == root / "build" / "native"


def test_native_shapes_dtype(native):
    H = generate_cdl_channels_native(seed=1, profile="CDL-C", num_channels=6)
    assert H.shape == (6, 10, 16, 64)
    assert H.dtype == np.complex64


def test_native_deterministic(native):
    a = generate_cdl_channels_native(seed=5, num_channels=3)
    b = generate_cdl_channels_native(seed=5, num_channels=3)
    np.testing.assert_array_equal(a, b)
    c = generate_cdl_channels_native(seed=6, num_channels=3)
    assert np.abs(a - c).max() > 1e-3


@pytest.mark.parametrize("spacing", [0.5, 1.0])
@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("profile", ["CDL-A", "CDL-C", "CDL-D"])
def test_native_matches_the_jax_binding(native, monkeypatch, profile, seed,
                                        spacing):
    from score_based_channels_tpu.data import cdl_native as jax_native

    monkeypatch.setattr(jax_native, "_lib", cdl_native.load_library())
    kw = dict(seed=seed, profile=profile, num_channels=4, spacing=spacing)
    np.testing.assert_array_equal(generate_cdl_channels_native(**kw),
                                  jax_native.generate_cdl_channels_native(**kw))


def test_native_matches_the_jax_binding_off_the_defaults(native, monkeypatch):
    """Every argument away from its default, so a swapped or dropped one
    shows."""
    from score_based_channels_tpu.data import cdl_native as jax_native

    monkeypatch.setattr(jax_native, "_lib", cdl_native.load_library())
    kw = dict(seed=9, profile="CDL-B", num_channels=3, num_rx=4, num_tx=8,
              spacing=0.7, delay_spread_s=100e-9, subcarrier_hz=30e3,
              num_subcarriers=3, subcarrier_gap=7)
    got = generate_cdl_channels_native(**kw)
    assert got.shape == (3, 3, 4, 8)
    np.testing.assert_array_equal(
        got, jax_native.generate_cdl_channels_native(**kw))


@pytest.mark.parametrize("profile", ["CDL-A", "CDL-C", "CDL-D"])
def test_native_matches_torch_statistics(native, profile):
    N = 64
    Hn = generate_cdl_channels_native(seed=3, profile=profile, num_channels=N)
    Ht = generate_cdl_channels(seed=3, profile=profile, num_channels=N)
    pn = np.mean(np.abs(Hn[:, 0]) ** 2)
    pt = np.mean(np.abs(Ht[:, 0]) ** 2)
    assert abs(pn - pt) / pt < 0.25, (pn, pt)

    def tx_cov(H):
        X = H[:, 0].reshape(-1, H.shape[-1])  # (N Nr, Nt)
        C = X.conj().T @ X / X.shape[0]
        return C / np.trace(C).real

    Cn, Ct = tx_cov(Hn), tx_cov(Ht)
    corr = np.abs(np.vdot(Cn, Ct)) / (np.linalg.norm(Cn) * np.linalg.norm(Ct))
    assert corr > 0.9, corr


@pytest.mark.parametrize("backend,which", [("native", "native C++"),
                                           ("auto", "native C++"),
                                           ("torch", "torch")])
def test_generate_data_backends(native, backend, which, tmp_path, capsys):
    generate_main(["--profiles", "CDL-C", "--seeds", "7", "--num_channels",
                   "3", "--out_dir", str(tmp_path), "--backend", backend])
    assert f"using the {which} generator" in capsys.readouterr().out
    with np.load(tmp_path / "CDL-C_Nt64_Nr16_ULA0.50_seed7.npz") as f:
        H = f["output_h"]
    assert H.shape == (3, 10, 16, 64)
    want = (generate_cdl_channels_native if backend != "torch"
            else generate_cdl_channels)(seed=7, num_channels=3)
    np.testing.assert_array_equal(H, want)


def test_native_backend_raises_when_the_build_fails(monkeypatch, tmp_path,
                                                    capsys):
    monkeypatch.setattr(cdl_native, "_lib", None)
    monkeypatch.setattr(cdl_native, "SOURCE", tmp_path / "missing.cc")
    assert not cdl_native.native_available()
    with pytest.raises(NativeUnavailable):
        generate_main(["--profiles", "CDL-C", "--num_channels", "1",
                       "--out_dir", str(tmp_path), "--backend", "native"])
    generate_main(["--profiles", "CDL-C", "--seeds", "1", "--num_channels",
                   "1", "--out_dir", str(tmp_path), "--backend", "auto"])
    assert "using the torch generator" in capsys.readouterr().out
