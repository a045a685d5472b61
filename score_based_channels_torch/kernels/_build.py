"""Build the CUDA sources of `csrc/` into one shared library and load it.

The library is compiled with `nvcc` for `sm_90a` (Hopper) at first use and
cached under `build/kernels/<source hash>/` at the repository root, so a
change to any source rebuilds it and an unchanged tree reuses it. Each
`.cu` file is compiled by its own `nvcc` process, all started together,
then linked; the hash covers the shared headers (`*.cuh`) too. The
library exposes a plain C interface, loaded with `ctypes`.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "sbc_conv2d_taps": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _IP, _IP,
                        _IP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P],
    "sbc_conv2d_taps_wgmma": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                              _IP, _IP, _IP, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P],
    "sbc_conv2d_taps_wide": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                             _IP, _IP, _IP, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    "sbc_conv_im2col": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L,
                        _L, _L, _I, _IP, _IP, _IP, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sbc_conv_chain": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L,
                       _L, _L, _L, _I, _IP, _IP, _IP, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _P],
    "sbc_conv_chain_max_clusters": [_I, _I, _I, _IP],
    "sbc_instance_norm_plus": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _P],
    "sbc_instance_norm_plus_two_pass": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _I, _I, _I, _P],
    "sbc_ldpc_minsum": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                        _I, _P],
    "sbc_conv_last_launch": [_IP],
    "sbc_pilot_eigmax": [_P, _P, _P, _I, _I, _I, _P],
    "sbc_pilot_eigmax_fits": [_I, _I],
    "sbc_pilot_eigmax_max_sweeps": [],
    "sbc_max_pool5": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sbc_mean_pool2": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process, if any
build_log = ""        # nvcc's output (-Xptxas=-v: registers, spills)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use with the CUDA toolkit (set CUDA_HOME)")


def source_hash() -> str:
    h = hashlib.sha256()
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    build_log = "\n".join(logs)
    (out.parent / "build.log").write_text(build_log)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if the sources changed."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path = BUILD_ROOT / source_hash() / "libsbc_kernels.so"
            if not path.exists():
                _build(path)
            elif not build_log and (path.parent / "build.log").exists():
                build_log = (path.parent / "build.log").read_text()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sbc_error_string.argtypes = [ctypes.c_int]
            lib.sbc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().sbc_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
