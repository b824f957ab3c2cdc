"""A numpy emulation of the deposit kernels' fixed-point density (K1
deposit, K2 deposit_move, K5 pic_step of pinc_tpu_torch/csrc/tiled.cu),
shared by tests/test_torch_pic_step.py and
tests/test_torch_deposit_fixed.py."""

import numpy as np

from pinc_tpu_torch.ops import tiled_kernels as tk


def bf16(a):
    """float32 -> bf16 (round to nearest even) -> float32, in numpy."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


def deposit_fixed(xn, values, magnitudes, ts, use_bf16, order=1,
                  margins=None):
    """The kernels' deposit of S sets of slots into one block a tile: xn
    (S, 3, NT, B) positions, values (S, NT, B) float32, on the grid
    tk.deposit_scale(magnitudes, B).  Each float32 contribution c (wx*val
    and wy*wz rounded to bf16 as the kernel does), y = c 2^k, hi = rint(y)
    and lo = rint((y - hi) 2^j) (ties to even), each summed in int32 per
    node over every set; a node's value is (hi + lo 2^-j) 2^-k in float64,
    rounded once to float32.  margins: per set (mg, md), the deposit on
    the nodes within md (default M)."""
    S, _, NT, B = xn.shape
    P, M, T = ts.P, ts.M, ts.T
    k, j = tk.deposit_scale(magnitudes, B)
    scale, lo_scale = np.float32(2.0 ** k), np.float32(2.0 ** j)
    rnd = bf16 if use_bf16 else (lambda a: np.asarray(a, np.float32))
    hi_sum = np.zeros(NT * P ** 3, np.int64)
    lo_sum = np.zeros(NT * P ** 3, np.int64)
    base = (np.arange(NT) * P ** 3)[:, None]
    for s in range(S):
        md = ts.M if margins is None else margins[s][1]
        val = np.asarray(values[s], np.float32)

        def nodes(x):
            f = np.floor(x)
            out = []
            for kk in (0, 1):
                n = f + np.float32(kk)
                d = x - n
                w = (np.maximum(np.float32(0), np.float32(1) - np.abs(d))
                     if order else ((d >= -0.5) & (d < 0.5)).astype(
                         np.float32))
                inside = (n >= -md) & (n <= T + md)
                out.append((np.where(inside, n + M, 0).astype(np.int64),
                            np.where(inside, w, np.float32(0))))
            return out

        nx, ny, nz = (nodes(xn[s, d]) for d in range(3))
        for ia, wx in nx:
            wa = rnd(wx * val)
            for ib, wy in ny:
                for ic, wz in nz:
                    y = (wa * rnd(wy * wz)) * scale
                    h = np.rint(y)
                    idx = (base + (ia * P + ib) * P + ic).ravel()
                    np.add.at(hi_sum, idx, h.astype(np.int64).ravel())
                    np.add.at(lo_sum, idx, np.rint(
                        (y - h) * lo_scale).astype(np.int64).ravel())
    assert np.abs(hi_sum).max() < 2 ** 31 and np.abs(lo_sum).max() < 2 ** 31
    v = hi_sum.astype(np.float64) + lo_sum.astype(np.float64) / 2.0 ** j
    return (v * 2.0 ** -k).astype(np.float32).reshape(NT, P, P * P)
