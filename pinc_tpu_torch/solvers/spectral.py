"""Spectral (FFT) Poisson solver, the counterpart of
``pinc_tpu/solvers/spectral.py``: solve grad^2 phi = -rho on a fully
periodic grid by dividing the charge spectrum by k^2 and zeroing the DC
mode (``sSolve``, src/spectral.c:92-115, generalized to N dimensions).

The transforms are ``torch.fft.rfftn``/``irfftn`` (cuFFT on the card);
the 1/k^2 table is the same numpy construction as ``pinc_tpu``.

* ``continuum`` — k_d = 2 pi n_d / L_d.
* ``finite-difference`` — k_d -> 2 sin(pi n_d / L_d), the exact inverse of
  the 2nd-order Laplacian.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import PincConfig
from ..registry import SOLVERS


def _inv_k2(shape: Sequence[int], fd: bool, dtype) -> np.ndarray:
    """Precomputed 1/k^2 over the rfftn spectrum layout (last axis halved),
    with the DC entry set to 0."""
    nd = len(shape)
    k2 = np.zeros([s if d < nd - 1 else s // 2 + 1
                   for d, s in enumerate(shape)], dtype=np.float64)
    for d, L in enumerate(shape):
        n = np.fft.fftfreq(L) * L          # integer mode numbers
        if d == nd - 1:
            n = n[: L // 2 + 1]
            n[-1] = L // 2                  # rfft Nyquist bin
        if fd:
            kd2 = (2.0 * np.sin(np.pi * n / L)) ** 2
        else:
            kd2 = (2.0 * np.pi * n / L) ** 2
        sh = [1] * nd
        sh[d] = len(n)
        k2 = k2 + kd2.reshape(sh)
    inv = np.zeros_like(k2)
    nz = k2 != 0.0
    inv[nz] = 1.0 / k2[nz]
    return inv.astype(dtype)


class SpectralSolver:
    """Callable solver: phi = solve(rho).  The 1/k^2 table is built once
    and moved to the device of the first rho it sees."""

    def __init__(self, shape: Sequence[int], fd: bool = False,
                 dtype=torch.float32):
        self.shape = tuple(shape)
        self.fd = fd
        self._inv_k2 = torch.from_numpy(_inv_k2(self.shape, fd, np.float32))
        self.dtype = dtype

    def __call__(self, rho: torch.Tensor) -> torch.Tensor:
        if self._inv_k2.device != rho.device:
            self._inv_k2 = self._inv_k2.to(rho.device)
        spec = torch.fft.rfftn(rho.float())
        spec = spec * self._inv_k2
        phi = torch.fft.irfftn(spec, s=self.shape)
        return phi.to(self.dtype)


def _validate_periodic(cfg: PincConfig):
    nd = cfg.get_int("grid:ndims")
    bnds = cfg.get_str_arr("grid:boundaries", 2 * nd)
    if any(b.strip().upper() != "PERIODIC" for b in bnds):
        raise ValueError("spectral solver requires all-PERIODIC boundaries "
                         "(reference: sSolver_set, src/spectral.c:80-90)")


def _make_spectral(fd: bool):
    def factory(cfg: PincConfig):
        from ..grid import GridSpec
        spec = GridSpec.from_config(cfg)
        return SpectralSolver(spec.global_size, fd=fd, dtype=spec.dtype)
    return factory


SOLVERS.register("sSolve", _validate_periodic)(_make_spectral(False))
SOLVERS.register("sSolver", _validate_periodic)(_make_spectral(False))
SOLVERS.register("spectral", _validate_periodic)(_make_spectral(False))
SOLVERS.register("spectralFD", _validate_periodic)(_make_spectral(True))
