"""ctypes binding of the native C++/OpenMP CDL generator
(`native/cdl_gen.cc`), the counterpart of the JAX package's
data/cdl_native.py.

This is host code and no device kernel: the generator runs multithreaded
on the CPU for bulk offline data set generation (`generate-data
--backend native`). The source is compiled unchanged with g++ (-O3
-march=native -fopenmp) at first use into `build/native/<hash>/` at the
repository root, never next to the source; the hash covers the source,
the flags and the compiler's resolved target, so a changed source (or
another host CPU) rebuilds. A failed build raises `NativeUnavailable`.

Same model as data/cdl.py, different random streams: the two agree in
their moments, not bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .cdl import CDL_PROFILES

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "cdl_gen.cc"
BUILD_ROOT = _ROOT / "build" / "native"
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _run(cmd):
    try:
        return subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeUnavailable(
            f"cannot build the native CDL generator: {detail}") from e


def library_path() -> Path:
    """build/native/<hash>/libcdl_gen.so for this source and host."""
    if not SOURCE.exists():
        raise NativeUnavailable(f"no source {SOURCE}")
    target = _run(["g++", "-march=native", "-Q", "--help=target"]).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(target.encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libcdl_gen.so"


def load_library() -> ctypes.CDLL:
    """The loaded library, built first when missing; raises
    NativeUnavailable when the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
                out = Path(tmp) / so.name
                _run(["g++", *FLAGS, str(SOURCE), "-o", str(out)])
                out.replace(so)
        lib = ctypes.CDLL(str(so))
        lib.cdl_generate.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.cdl_generate.restype = None
        lib.cdl_num_threads.restype = ctypes.c_int
        _lib = lib
        return lib


def native_available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        load_library()
        return True
    except NativeUnavailable:
        return False


def generate_cdl_channels_native(
    seed: int,
    profile: str = "CDL-C",
    num_channels: int = 200,
    num_rx: int = 16,
    num_tx: int = 64,
    spacing: float = 0.5,
    delay_spread_s: float = 30e-9,
    subcarrier_hz: float = 15e3,
    num_subcarriers: int = 10,
    subcarrier_gap: int = 24,
) -> np.ndarray:
    """Native backend of data.cdl.generate_cdl_channels -> (N, S, Nr, Nt)
    complex64."""
    lib = load_library()
    prof = CDL_PROFILES[profile]
    rows = np.ascontiguousarray(prof.rows, np.float64)
    out = np.empty(num_channels * num_subcarriers * num_rx * num_tx * 2,
                   np.float32)
    lib.cdl_generate(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.shape[0], int(prof.los), float(prof.c_zsd), float(prof.c_zsa),
        num_channels, num_rx, num_tx, float(spacing), float(delay_spread_s),
        float(subcarrier_hz), num_subcarriers, subcarrier_gap,
        ctypes.c_uint64(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    ri = out.reshape(num_channels, num_subcarriers, num_rx, num_tx, 2)
    return (ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64)
