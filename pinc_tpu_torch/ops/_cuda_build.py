"""Build and load the hand-written CUDA kernels of ``pinc_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``)
— one ``nvcc -c`` per source, all started together — and links the objects
into one shared library with a plain C interface,
``pinc_tpu_torch/_build/libpinc_kernels-<hash>.so``, where ``<hash>`` is a
content hash of the sources, the headers they share (``csrc/*.cuh``) and
the flags: an edited source builds anew, an unchanged one is loaded from
the previous build.  The library is bound
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C signatures of csrc/*.cu, in argument order
SIGNATURES = {
    # -- csrc/tiled.cu
    # xyz, value, tiles, NT, B, P, M, order, bf16, stream, k, j (the
    # density's fixed point)
    "pinc_tiled_deposit": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I],
    # xyz, vel, alive, q, tiles, new_xyz, nout, NT, B, P, M, order, bf16,
    # stream, k, j
    "pinc_tiled_deposit_move": [_P, _P, _P, _F, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _P, _I, _I],
    # field, xyz, out, NT, B, P, M, C, order, bf16, stream
    "pinc_tiled_gather": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # field, xyz, vel, alive, qm, params9 (host: e_ext, T, S), boris,
    # vel_out, vdot, NT, B, P, M, order, bf16, stream
    "pinc_tiled_gather_kick": [_P, _P, _P, _P, _F, _P, _I, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P],
    # E, e_bf16, lpos, vel, alive, params (host: per species q, qm, T[3],
    # S[3], mg, md; then e_ext[3], k, j), S, boris, tiles, lpos_out, vel_out,
    # vdot, nout, NT, B, P, M, order_acc, order_distr, bf16, stream
    "pinc_tiled_pic_step": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                            _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # -- csrc/field.cu
    # phi, out, X, Y, Z, T, M, out_bf16, stream
    "pinc_field_efield": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # tiles, rho, X, Y, Z, T, M, stream
    "pinc_field_fold": [_P, _P, _I, _I, _I, _I, _I, _P],
    # -- csrc/gather_exchange.cu
    # alive, x, y, z, vx, vy, vz, buf, alive_out, NT, B, kind, Ks, T, stream
    "pinc_gx_extract": [_P] * 9 + [_I, _I, _I, _I, _F, _P],
    # inc, settled, extras0..5, NT, W, Ke, naxes, canon, T, stream
    "pinc_gx_cleanup": [_P] * 8 + [_I, _I, _I, _I, _I, _F, _P],
    # alive, inc, x, y, z, vx, vy, vz, table (host: off, w pairs), nblocks,
    # NT, B, KT, stream
    "pinc_gx_merge": [_P] * 9 + [_I, _I, _I, _I, _P],
    # -- csrc/onehot_exchange.cu
    # coord, alive, x, y, z, vx, vy, vz, buf, alive_out, NT, B, kind, rows,
    # K, T, stream
    "pinc_ox_extract": [_P] * 10 + [_I, _I, _I, _I, _I, _F, _P],
    # rank, alive, x, y, z, vx, vy, vz, buf, alive_out, NT, B, K2, stream
    "pinc_ox_extract_ranked": [_P] * 10 + [_I, _I, _I, _P],
    # alive, inc, x, y, z, vx, vy, vz, table (host: off, w pairs), nblocks,
    # NT, B, rows, KT, stream
    "pinc_ox_merge": [_P] * 9 + [_I, _I, _I, _I, _I, _P],
    # frank, alive, inc, active, x, y, z, vx, vy, vz, NT, B, K2, CB, NC,
    # stream
    "pinc_ox_merge_ranked": [_P] * 10 + [_I, _I, _I, _I, _I, _P],
    # -- csrc/kbench.cu
    # xyz, value, kron, tiles, NT, B, P, M, mode, inv, stream
    "pinc_kb_deposit": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # field, scale, inv, xyz, out, NT, B, P, M, mode, stream
    "pinc_kb_gather": [_P, _P, _F, _P, _P, _I, _I, _I, _I, _I, _P],
    # -- csrc/kbench_prims.cu
    # src, idx, out, batch, Rs, Cs, Ri, Ci, lanes, fill (bits), stream,
    # the plan's rows, cols, blocks and staged (kbench_prims.take_layout)
    "pinc_kp_take": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                     _I, _I, _I, _I],
    # x, out, shift (device int32 or null), shift_host, rows, R, C, lanes,
    # stream
    "pinc_kp_roll": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # ptrs (host: the inputs, then the outputs), np, NT, tile, G, stream
    "pinc_kp_plane_add": [_P, _I, _I, _I, _I, _P],
    # m, out, NT, B, W, R, stream
    "pinc_kp_lane_prefix": [_P, _P, _I, _I, _I, _I, _P],
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
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpinc_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands concurrently and wait for every one; returns
    [(cmd, returncode, output)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    done = [(cmd, proc.communicate()[0], proc) for cmd, proc in procs]
    return [(cmd, proc.returncode, text) for cmd, text, proc in done]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists.
    Returns its path; raises RuntimeError with nvcc's output on failure."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp / f"{src.stem}.o" for src in _sources()]
        compiles = [[nvcc, *(["--ptxas-options=-v"] if verbose else []),
                     *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(_sources(), objs)]
        lib = tmp / out.name
        link = [nvcc, *ARCH, "-shared", "-o", str(lib), *map(str, objs)]
        t0 = time.monotonic()
        for step in (compiles, [link]):
            for cmd, rc, text in _run_all(step):
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n"
                                       f"{' '.join(cmd)}\n{text}")
                if verbose:
                    print(text, file=sys.stderr)
        build_seconds = time.monotonic() - t0
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
