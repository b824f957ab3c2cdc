// The int32-pair fixed-point accumulator shared by the density deposits of
// tiled.cu (K1, K2, K5) and kbench.cu's WEIGHT_SUMS: a pair of int32
// blocks in shared memory; a contribution c (float32) becomes y = c 2^k
// (exact), hi = rint(y) and lo = rint((y - hi) 2^j) (y - hi is exact),
// each added with one native ATOMS.ADD (a float32 or 64-bit shared
// atomicAdd is a compare-and-swap loop on sm_90a, ATOMS.CAST.SPIN); a
// node's value is (hi + lo 2^-j) 2^-k, formed in double and rounded once
// to float32.  The sums do not depend on the order of the adds.  The host
// picks k and j for each launch so that neither sum can overflow
// (ops/tiled_kernels.deposit_scale).

#pragma once

#include <cmath>

#include <cuda_runtime.h>

namespace {

struct FixedPoint {
  float scale, inv_scale;  // 2^k, 2^-k: the density's grid
  float lo_scale;          // 2^j: its residual's finer grid
};

// Fills fp from the exponents k and j; false if the kernels do not take
// them (2^k and 2^-k must be normal float32 numbers, 0 <= j <= 30).
inline bool fixed_point(int k, int j, FixedPoint* fp) {
  if (k < -126 || k > 126 || j < 0 || j > 30) return false;
  fp->scale = ldexpf(1.0f, k);
  fp->inv_scale = ldexpf(1.0f, -k);
  fp->lo_scale = ldexpf(1.0f, j);
  return true;
}

__device__ __forceinline__ void acc_add(int* hi, int* lo, int i, float c,
                                        const FixedPoint& fp) {
  const float y = __fmul_rn(c, fp.scale);
  const float h = rintf(y);
  atomicAdd(hi + i, (int)h);
  atomicAdd(lo + i, __float2int_rn(__fmul_rn(__fsub_rn(y, h), fp.lo_scale)));
}

__device__ __forceinline__ float acc_value(const int* hi, const int* lo,
                                           int i, const FixedPoint& fp) {
  const double v = (double)hi[i] + (double)lo[i] / (double)fp.lo_scale;
  return (float)(v * (double)fp.inv_scale);
}

}  // namespace
