"""Channel-file I/O (.npz, MATLAB .mat v5 and v7.3/HDF5), the counterpart
of the JAX package's data/io.py:18-52. scipy and h5py are imported
only when a .mat file is read or written."""

from __future__ import annotations

import os

import numpy as np


def load_output_h(path: str) -> np.ndarray:
    """Load `output_h` -> (N, S, Nr, Nt) complex64 from .npz/.mat/.h5."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return np.asarray(f["output_h"], np.complex64)
    try:
        import scipy.io as sio

        contents = sio.loadmat(path)
        return np.asarray(contents["output_h"], np.complex64)
    except NotImplementedError:
        pass  # v7.3 -> HDF5
    import h5py

    with h5py.File(path, "r") as f:
        ds = f["output_h"][...]
        if ds.dtype.names and {"real", "imag"} <= set(ds.dtype.names):
            arr = ds["real"] + 1j * ds["imag"]
        else:
            arr = ds
        # MATLAB's HDF5 is column-major: the dims arrive reversed
        return np.ascontiguousarray(np.transpose(arr)).astype(np.complex64)


def save_output_h(path: str, output_h: np.ndarray) -> None:
    """Save in the format implied by the extension (.npz or .mat v5)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npz"):
        np.savez_compressed(path, output_h=np.asarray(output_h, np.complex64))
    elif path.endswith(".mat"):
        import scipy.io as sio

        sio.savemat(path, {"output_h": np.asarray(output_h, np.complex64)})
    else:
        raise ValueError(f"unsupported extension: {path}")
