"""Build and load the hand-written CUDA kernels of ``pinc_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``)
into one shared library with a plain C interface,
``pinc_tpu_torch/_build/libpinc_tiled-<hash>.so``, where ``<hash>`` is a
content hash of the sources and the flags: an edited source builds anew,
an unchanged one is loaded from the previous build.  The library is bound
with ``ctypes``: every pointer and the stream are ``c_void_p``, and each
function returns the ``cudaGetLastError()`` code of its launch.

A missing ``nvcc`` or a failed build raises: nothing is downloaded and no
prebuilt binary is used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C signatures of csrc/tiled.cu, in argument order
SIGNATURES = {
    # xyz, value, tiles, NT, B, P, M, order, bf16, stream
    "pinc_tiled_deposit": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # xyz, vel, alive, q, tiles, new_xyz, nout, NT, B, P, M, order, bf16,
    # stream
    "pinc_tiled_deposit_move": [_P, _P, _P, _F, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _P],
    # field, xyz, out, NT, B, P, M, C, order, bf16, stream
    "pinc_tiled_gather": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # field, xyz, vel, alive, qm, params9 (host: e_ext, T, S), boris,
    # vel_out, vdot, NT, B, P, M, order, bf16, stream
    "pinc_tiled_gather_kick": [_P, _P, _P, _P, _F, _P, _I, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
#: wall seconds of the last nvcc run in this process (0.0 if none ran)
build_seconds = 0.0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "pinc_tpu_torch are built from source at first use")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpinc_tiled-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists.
    Returns its path; raises RuntimeError with nvcc's output on failure."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in _sources()]]
    if verbose:
        cmd.insert(1, "--ptxas-options=-v")
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.monotonic() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, file=sys.stderr)
    os.replace(tmp, out)
    return out


def load(verbose: bool = False) -> ctypes.CDLL:
    """The bound kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
