"""Native (C++) host components with ctypes bindings (the counterpart of
``pinc_tpu/native/__init__.py``): ``spool.cpp``, a copy of pinc_tpu's
background-thread snapshot spooler behind ``files:async`` (``spool.py``).
pinc_tpu's C++ ini parser is not ported: ``config.py``'s Python parser
has its semantics.

At first use ``g++`` builds the library into the git-ignored
``pinc_tpu_torch/_build/``, ``libpinc_native-<hash>.so``, where
``<hash>`` is a content hash of the sources and flags (an edited source
builds anew; the CUDA kernels' library there is ``libpinc_kernels-*``).
Without a compiler, ``lib()`` returns None and the writer falls back to
synchronous HDF5 writes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
_SOURCES = ["spool.cpp"]
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"libpinc_native-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the shared library unless it exists.  Returns its path, or
    None when it cannot be built."""
    out = library_path()
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    except OSError as e:
        print(f"pinc_tpu_torch.native: cannot build ({e}); writing "
              f"synchronously", file=sys.stderr)
        return None
    try:
        lib = tmp / out.name
        cmd = ["g++", *_FLAGS, "-o", str(lib),
               *[str(_DIR / s) for s in _SOURCES]]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(lib, out)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"pinc_tpu_torch.native: build failed ({e}); writing "
              f"synchronously", file=sys.stderr)
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    L = ctypes.CDLL(str(path))
    L.pinc_spool_open.argtypes = [ctypes.c_char_p]
    L.pinc_spool_open.restype = ctypes.c_void_p
    L.pinc_spool_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p,
        ctypes.c_uint64]
    L.pinc_spool_pending.argtypes = [ctypes.c_void_p]
    L.pinc_spool_pending.restype = ctypes.c_uint64
    L.pinc_spool_close.argtypes = [ctypes.c_void_p]
    L.pinc_spool_close.restype = ctypes.c_uint64
    _lib = L
    return _lib

