// Hand-written Hopper (sm_90a) kernels of the field glue around the
// Poisson solve: efield_tiles (K6) and fold_global (K7).
//
// They replace the Pallas TPU kernels of pinc_tpu/ops/pallas_field.py
// (_efield_kernel and _fold_kernel).  Both are pure data movement, bound by
// the bytes they move: phi (8.4 MB at 128^3) and the padded tile blocks
// (22-36 MB).  The TPU kernels keep a transposed (y, x, z) phi resident in
// VMEM and build lane rolls and concatenations around the Mosaic tiling;
// none of that is needed here.  efield_tiles is one block per tile: the
// tile's (P+2)^3 periodic window of phi is staged in shared memory (phi
// itself fits the 50 MB L2), then the tile's 3 P^3 values are written
// contiguously.  fold_global is one thread per grid node, reading the tile
// entries that cover it.  Index arithmetic is 32-bit where the sizes allow
// (the entry points check).
//
// Layouts (row-major):
//   phi, rho      (X, Y, Z) float32
//   E tiles       (NT, 3P, P*P): row c*P + a, column b*P + e holds E_c at
//                 the node (tx*T + a - M, ty*T + b - M, tz*T + e - M),
//                 periodic; float32 or bfloat16
//   tiles         (NT, P, P*P) float32 padded node blocks (offsets -M..T+M)
// with tile t = (tx*nty + ty)*ntz + tz and P = T + 1 + 2M.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument
// the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;

__device__ __forceinline__ int wrap(int g, int n) {
  while (g < 0) g += n;
  while (g >= n) g -= n;
  return g;
}

// The digits (fastest first) of a flat index that advances by a fixed
// stride, in the mixed radix r: the loops below walk a tile's nodes
// without an integer division per element.  The last digit is unbounded.
template <int N>
struct Digits {
  int d[N], s[N], r[N];
  __device__ __forceinline__ Digits(int i, int stride, const int (&radix)[N]) {
#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      r[k] = radix[k];
      d[k] = i % r[k];
      i /= r[k];
      s[k] = stride % r[k];
      stride /= r[k];
    }
    d[N - 1] = i;
    s[N - 1] = stride;
  }
  __device__ __forceinline__ void next() {
    int carry = 0;
#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      d[k] += s[k] + carry;          // < 2 r[k]
      carry = d[k] >= r[k];
      if (carry) d[k] -= r[k];
    }
    d[N - 1] += s[N - 1] + carry;
  }
};

// K6: E = -grad(phi) = 0.5 (phi[n-1] - phi[n+1]) per component, written
// as padded component-major tiles; E is computed in float32 and cast to
// the output type once.  One block per tile; win holds phi at the tile's
// offsets -M-1..T+M+1 on each axis, periodic.
template <bool OUT_BF16>
__global__ void __launch_bounds__(kThreads)
efield_kernel(const float* __restrict__ phi, void* __restrict__ out, int X,
              int Y, int Z, int nty, int ntz, int T, int M, int P) {
  extern __shared__ float win[];
  const int W = P + 2, W2 = W * W, W3 = W2 * W;
  const int t = blockIdx.x;
  const int tz = t % ntz, ty = (t / ntz) % nty, tx = t / (ntz * nty);
  const int gx0 = tx * T - M - 1, gy0 = ty * T - M - 1, gz0 = tz * T - M - 1;
  const int wr[3] = {W, W, W};
  Digits<3> w(threadIdx.x, blockDim.x, wr);   // (e, b, a) of window index i
  // kLoads loads in flight per thread before their stores
  for (int i0 = threadIdx.x; i0 < W3; i0 += kLoads * blockDim.x) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u, w.next())
      if (i0 + u * (int)blockDim.x < W3)
        v[u] = phi[((long long)wrap(gx0 + w.d[2], X) * Y +
                    wrap(gy0 + w.d[1], Y)) * Z + wrap(gz0 + w.d[0], Z)];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (i0 + u * (int)blockDim.x < W3) win[i0 + u * blockDim.x] = v[u];
  }
  __syncthreads();
  const int P3 = P * P * P;
  const int pr[4] = {P, P, P, 3};
  Digits<4> o(threadIdx.x, blockDim.x, pr);   // (e, b, a, c) of output r
  const long long base = (long long)t * 3 * P3;
  for (int r = threadIdx.x; r < 3 * P3; r += blockDim.x, o.next()) {
    const int s = ((o.d[2] + 1) * W + o.d[1] + 1) * W + o.d[0] + 1;
    const int d = o.d[3] == 0 ? W2 : (o.d[3] == 1 ? W : 1);
    const float v = 0.5f * (win[s - d] - win[s + d]);
    if (OUT_BF16)
      static_cast<__nv_bfloat16*>(out)[base + r] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[base + r] = v;
  }
}

// The k-th source of a grid node along one axis, in the summation order
// 0, -1, +1, -2, +2, ...: node m of tile t takes offset a = m + M + j*T
// of tile t - j, where 0 <= a < P.
__device__ __forceinline__ int source_offset(int k) {
  return (k & 1) ? -((k + 1) >> 1) : (k >> 1);
}

// x / d for 0 <= x < 2^22 and d > 0, inv = 1.0f / d: a float estimate of
// the quotient, off by at most one, corrected.
__device__ __forceinline__ int div_small(int x, int d, float inv) {
  const int q = (int)((float)x * inv);
  const int r = x - q * d;
  return r < 0 ? q - 1 : (r >= d ? q + 1 : q);
}

// One past the last k of that order whose offset lies in [0, P): the valid
// j form the range [-(m+M)/T, (T+M-m)/T] around 0.
__device__ __forceinline__ int sources_end(int m, int M, int T, float invT) {
  return max(2 * div_small(m + M, T, invT),
             2 * div_small(T + M - m, T, invT) + 1);
}

// K7: rho[g] = sum over the tiles whose padded block covers g.  The sum
// is nested per axis, x innermost, each axis in the order of
// source_offset: the order of ops/tiled.fold_to_global's three per-axis
// overlap-add passes (core, then the next tile's low planes, then the
// previous tile's high planes), so the result is that function's, bit for
// bit.  Deterministic, no atomics, any T and M.  One thread per node:
// blockIdx.z is x, blockIdx.y is y, z runs along the threads.
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ tiles, float* __restrict__ rho, int Y,
            int Z, int ntx, int nty, int ntz, int T, float invT, int M,
            int P) {
  const int gz = blockIdx.x * blockDim.x + threadIdx.x;
  if (gz >= Z) return;
  const int gy = blockIdx.y, gx = blockIdx.z;
  const int P2 = P * P, P3 = P2 * P;
  const int tx = div_small(gx, T, invT), ty = div_small(gy, T, invT),
            tz = div_small(gz, T, invT);
  const int mx = gx - tx * T, my = gy - ty * T, mz = gz - tz * T;
  const int kx_end = sources_end(mx, M, T, invT),
            ky_end = sources_end(my, M, T, invT),
            kz_end = sources_end(mz, M, T, invT);
  float rz = 0.0f;
  for (int kz = 0; kz < kz_end; ++kz) {
    const int jz = source_offset(kz), az = mz + M + jz * T;
    if (az < 0 || az >= P) continue;
    const int sz = wrap(tz - jz, ntz);
    float ry = 0.0f;
    for (int ky = 0; ky < ky_end; ++ky) {
      const int jy = source_offset(ky), ay = my + M + jy * T;
      if (ay < 0 || ay >= P) continue;
      const int sy = wrap(ty - jy, nty);
      float rx = 0.0f;
      for (int kx = 0; kx < kx_end; ++kx) {
        const int jx = source_offset(kx), ax = mx + M + jx * T;
        if (ax < 0 || ax >= P) continue;
        const int sx = wrap(tx - jx, ntx);
        rx += tiles[((long long)(sx * nty + sy) * ntz + sz) * P3 + ax * P2 +
                    ay * P + az];
      }
      ry += rx;
    }
    rz += ry;
  }
  rho[((long long)gx * Y + gy) * Z + gz] = rz;
}

}  // namespace

extern "C" {

int pinc_field_efield(const float* phi, void* out, int X, int Y, int Z,
                      int T, int M, int out_bf16, void* stream) {
  if (X % T || Y % T || Z % T || M < 0 || X <= M || Y <= M || Z <= M)
    return -1;
  const int P = T + 1 + 2 * M;
  const long long NT = (long long)(X / T) * (Y / T) * (Z / T);
  if (NT > 0x7fffffff) return -1;
  const size_t smem = (size_t)(P + 2) * (P + 2) * (P + 2) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  auto* kernel = out_bf16 ? efield_kernel<true> : efield_kernel<false>;
  if (smem > 48 * 1024) {
    if (int err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return err;
  }
  kernel<<<(int)NT, kThreads, smem, s>>>(phi, out, X, Y, Z, Y / T, Z / T, T,
                                         M, P);
  return (int)cudaGetLastError();
}

int pinc_field_fold(const float* tiles, float* rho, int X, int Y, int Z,
                    int T, int M, void* stream) {
  if (X % T || Y % T || Z % T || M < 0 || X > 65535 || Y > 65535 ||
      Z >= (1 << 22) || T + 2 * M >= (1 << 22))
    return -1;
  const int P = T + 1 + 2 * M;
  const int threads = Z < kThreads ? (Z + 31) / 32 * 32 : kThreads;
  const dim3 grid((Z + threads - 1) / threads, Y, X);
  fold_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      tiles, rho, Y, Z, X / T, Y / T, Z / T, T, 1.0f / (float)T, M, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
