"""The field kernels around the Poisson solve — the counterpart of
``pinc_tpu/ops/pallas_field.py``.

Two kernels, hand-written in CUDA C++ for Hopper (``csrc/field.cu``, built
by ``ops/_cuda_build.py``), each with a plain PyTorch version beside it:

================  ==========================================================
``efield_tiles``  K6, replaces ``pallas_field.efield_tiles``
                  (``_efield_kernel``): E = -grad(phi) as the padded
                  component-major tiles (NT, 3P, P*P) that ``pic_step``
                  reads
``fold_global``   K7, replaces ``pallas_field.fold_global_t``
                  (``_fold_kernel``): the periodic overlap-add of the
                  deposited (NT, P, P*P) tile blocks into rho (X, Y, Z)
================  ==========================================================

``fold_global`` returns rho in the grid's own (x, y, z) orientation:
pinc_tpu's transposed (y, x, z) output is a TPU layout trick.  Neither
kernel has pinc_tpu's gates (``efield_tiles_fits``' VMEM budget, the fold's
``M == 1``, ``nz % 128 == 0`` and ``T > 2M+1``): both run at every margin.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
checks device, dtype, shape and contiguity, launches the kernel on the
current stream, raises on a nonzero launch error, and adds one to
``LAUNCHES[name]``.  There is no fallback from a CUDA tensor to the plain
version.
"""

from __future__ import annotations

import torch

from . import _cuda_build
from .tiled import TileSpec
from .tiled_kernels import _check, _is_cpu, _launch, _ptr, _stream

#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"efield_tiles": 0, "fold_global": 0}

#: the TPU kernel each CUDA kernel replaces (file:line of the function
#: that reaches pl.pallas_call)
REPLACES = {
    "efield_tiles": "pinc_tpu/ops/pallas_field.py:85",
    "fold_global": "pinc_tpu/ops/pallas_field.py:209",
}

SOURCE = "pinc_tpu_torch/csrc/field.cu"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_out_dtype(out_dtype: torch.dtype) -> None:
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {out_dtype}")


def _check_grid(ts: TileSpec) -> None:
    if ts.n_dims != 3:
        raise ValueError("the field kernels are 3-D")
    ts.validate()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _padded_index(n_tiles: int, ts: TileSpec, n: int,
                  device) -> torch.Tensor:
    """(n_tiles, P) periodic grid index of each padded node offset."""
    t = torch.arange(n_tiles, device=device)[:, None] * ts.T
    a = torch.arange(ts.P, device=device)[None, :] - ts.M
    return torch.remainder(t + a, n)


def efield_tiles_plain(phi: torch.Tensor, ts: TileSpec,
                       out_dtype=torch.float32) -> torch.Tensor:
    """phi (X, Y, Z) f32 -> E = -grad(phi) as padded component-major tiles
    (NT, 3P, P*P): ``pad_tiles_cmajor(-gradient(phi))`` of pinc_tpu with
    the (3, P) axes merged, computed in float32 and cast to ``out_dtype``
    once."""
    _check_out_dtype(out_dtype)
    _check_grid(ts)
    phi = phi.float()
    P = ts.P
    E = [0.5 * (torch.roll(phi, 1, dims=d) - torch.roll(phi, -1, dims=d))
         for d in range(3)]
    ix, iy, iz = (_padded_index(nt, ts, n, phi.device)
                  for nt, n in zip(ts.ntiles, ts.grid))
    ix = ix[:, None, None, :, None, None]
    iy = iy[None, :, None, None, :, None]
    iz = iz[None, None, :, None, None, :]
    out = torch.stack([e[ix, iy, iz].reshape(ts.NT, P, P * P) for e in E],
                      dim=1)
    return out.reshape(ts.NT, 3 * P, P * P).to(out_dtype)


def _source_offsets(ts: TileSpec):
    """The offsets j of the tiles a node takes from, in the summation
    order of the kernel: 0, -1, +1, -2, +2, ..."""
    K = 2 * (ts.P // ts.T + 1) + 1
    return [-((k + 1) >> 1) if k & 1 else k >> 1 for k in range(K)]


def _fold_axis(x: torch.Tensor, tile_ax: int, node_ax: int,
               ts: TileSpec) -> torch.Tensor:
    """Overlap-add one axis: node m of tile t takes offset m + M + j*T of
    tile t - j for each j with that offset in [0, P), summed in the order
    of _source_offsets.  For T >= M + 1 these are ops/tiled.py's core,
    low and high planes, in its order."""
    T, M, P = ts.T, ts.M, ts.P
    out = None
    for j in _source_offsets(ts):
        a0, a1 = max(0, M + j * T), min(P, T + M + j * T)
        if a0 >= a1:
            continue
        piece = x.narrow(node_ax, a0, a1 - a0)
        if j:
            piece = torch.roll(piece, j, dims=tile_ax)
        m0 = a0 - M - j * T
        if a1 - a0 < T:
            shape = list(piece.shape)
            parts = []
            for n in (m0, T - m0 - (a1 - a0)):
                shape[node_ax] = n
                parts.append(piece.new_zeros(shape))
            piece = torch.cat([parts[0], piece, parts[1]], dim=node_ax)
        out = piece if out is None else out + piece
    return out


def fold_global_plain(tiles: torch.Tensor, ts: TileSpec) -> torch.Tensor:
    """(NT, P, P*P) padded tile blocks -> rho (X, Y, Z), the periodic
    overlap-add, x innermost."""
    _check_grid(ts)
    x = tiles.reshape(ts.ntiles + (ts.P,) * 3)
    for d in range(3):
        x = _fold_axis(x, tile_ax=d, node_ax=3 + d, ts=ts)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(ts.grid)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def efield_tiles(phi: torch.Tensor, ts: TileSpec,
                 out_dtype=torch.float32) -> torch.Tensor:
    """K6: phi (X, Y, Z) f32 -> E = -grad(phi) as the padded
    component-major tiles (NT, 3P, P*P) in ``out_dtype`` (bf16 when the
    step's weights are bf16: pic_step rounds E to bf16 anyway).

    Replaces pinc_tpu/ops/pallas_field.py ``efield_tiles``.  Bound on the
    card: the bytes, phi read once and the tiles written once (0.012 ms at
    128^3, M=1, bf16).  Design: one block per run of consecutive tiles
    along z (4 at T = 8), whose outputs are one contiguous span: it stages
    the run's periodic window of phi in shared memory once (16-byte loads;
    phi sits in L2), then a warp takes 32 rows of P outputs, a lane a row
    (its window planes skewed so that the lanes' reads fall on distinct
    banks), passes them through its shared staging slice and writes them
    with 16-byte stores; the ends off a 16-byte boundary take scalar
    stores."""
    if _is_cpu(phi, "efield_tiles"):
        return efield_tiles_plain(phi, ts, out_dtype=out_dtype)
    _check_out_dtype(out_dtype)
    _check_grid(ts)
    dev = phi.device
    _check(phi, "phi", ts.grid, dev)
    P = ts.P
    out = torch.empty((ts.NT, 3 * P, P * P), dtype=out_dtype, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("efield_tiles", lib.pinc_field_efield, _ptr(phi), _ptr(out),
                *ts.grid, ts.T, ts.M, int(out_dtype == torch.bfloat16),
                _stream(dev), counts=LAUNCHES)
    return out


def fold_global(tiles: torch.Tensor, ts: TileSpec) -> torch.Tensor:
    """K7: (NT, P, P*P) f32 deposited tile blocks -> rho (X, Y, Z) f32,
    the periodic overlap-add of ops/tiled.fold_to_global.

    Replaces pinc_tpu/ops/pallas_field.py ``fold_global_t``.  Bound on the
    card: the bytes, the tiles read once and rho written once (0.009 ms at
    128^3, M=1).  Design (M < T): one block per run of consecutive tiles
    along z (4 at T = 8, M = 2; 8 at M = 1): it stages the run's tiles and
    their two z-neighbours, each as a padded block assembled from the
    (x, y) neighbours' margin planes and rows, with 16-byte loads of
    contiguous spans; folds them in shared memory in the plain version's
    order (x, then y, then z), so the result is bit for bit the plain
    version's, with no atomics; and writes the run's rows of rho with
    16-byte stores.  M >= T takes a kernel of one thread per node
    (grids of fewer than 2^31 nodes either way)."""
    if _is_cpu(tiles, "fold_global"):
        return fold_global_plain(tiles, ts)
    _check_grid(ts)
    dev = tiles.device
    P = ts.P
    _check(tiles, "tiles", (ts.NT, P, P * P), dev)
    rho = torch.empty(ts.grid, dtype=torch.float32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("fold_global", lib.pinc_field_fold, _ptr(tiles), _ptr(rho),
                *ts.grid, ts.T, ts.M, _stream(dev), counts=LAUNCHES)
    return rho
