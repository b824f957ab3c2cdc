// Hand-written Hopper (sm_90a) kernels of the field glue around the
// Poisson solve: efield_tiles (K6) and fold_global (K7).
//
// They replace the Pallas TPU kernels of pinc_tpu/ops/pallas_field.py
// (_efield_kernel and _fold_kernel).  Both are pure data movement, bound by
// the bytes they move: phi (8.4 MB at 128^3) and the padded tile blocks
// (22-36 MB).  The TPU kernels keep a transposed (y, x, z) phi resident in
// VMEM and build lane rolls and concatenations around the Mosaic tiling;
// none of that is needed here.  efield_tiles is one block per run of
// tiles along z: the run's periodic window of phi is staged in shared
// memory once (phi itself fits the 50 MB L2), then the run's contiguous
// span of outputs is written with 16-byte stores.  fold_global is one thread per grid node, reading the tile
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

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 2;     // efield's staging groups a thread in flight
constexpr int kRunMax = 8;   // tiles a run, at most

__device__ __forceinline__ int wrap(int g, int n) {
  while (g < 0) g += n;
  while (g >= n) g -= n;
  return g;
}

__device__ __forceinline__ int floor_div4(int x) { return x >> 2; }

// Mixed-radix digits, fastest first, of a flat index; the last digit is
// unbounded.  add() advances digits d by the digits s of a stride (each
// below its radix), so the loops below walk a tile's nodes without an
// integer division per element.
template <int N>
struct Radix {
  int r[N - 1];
  __device__ __forceinline__ void split(int i, int (&d)[N]) const {
#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      d[k] = i % r[k];
      i /= r[k];
    }
    d[N - 1] = i;
  }
  __device__ __forceinline__ void add(int (&d)[N], const int (&s)[N]) const {
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

template <bool BF16>
struct EOut {
  using T = float;
  __device__ static float cast(float v) { return v; }
};
template <>
struct EOut<true> {
  using T = __nv_bfloat16;
  __device__ static __nv_bfloat16 cast(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Shared memory of efield_kernel for runs of g tiles, in floats: the
// window (rounded to 16 bytes), then each warp's staging of its outputs,
// 32 rows of P values and up to 16 bytes of alignment shift, in 16-byte
// units.
__host__ __device__ inline int efield_window_floats(int g, int T, int M) {
  const int W = T + 2 * M + 3;
  return (W * (W * (g * T + 2 * M + 3) + 32) + 3) & ~3;
}

// The window's x-plane x starts at x (W Zw + 32) + skew(x): with the skew
// below, the rows (a, b) of 32 consecutive output rows of one (tile, c)
// fall on 32 distinct banks (bank = ((a P + b) Zw + const) % 32, Zw odd),
// where the plain layout, whose rows step by W Zw from a to a + 1, puts
// two on one bank.
__device__ __forceinline__ int plane_base(int x, int W, int Zw) {
  return x * (W * Zw + 32) + (((1 - 2 * x - W) * Zw) & 31);
}
__host__ __device__ inline int efield_stage_floats(int T, int M) {
  const int P = T + 1 + 2 * M;
  return (32 * P * 4 + 16 + 15) / 16 * 4;   // f32: 32 P values + shift
}
__host__ __device__ inline size_t efield_smem(int g, int T, int M) {
  return (size_t)(efield_window_floats(g, T, M) +
                  kWarps * efield_stage_floats(T, M)) * sizeof(float);
}

// The default run length: the longest run of 8, 4 or 2 tiles whose shared
// memory stays within kRunSmem bytes, else one tile.
constexpr size_t kRunSmem = 56 * 1024;
inline int efield_run(int T, int M) {
  for (int g = kRunMax; g > 1; g /= 2)
    if (efield_smem(g, T, M) <= kRunSmem) return g;
  return 1;
}

// K6: E = -grad(phi) = 0.5 (phi[n-1] - phi[n+1]) per component, written
// as padded component-major tiles; E is computed in float32 and cast to
// the output type once.  Bound: bytes (phi read once, the tiles written
// once).  Design: one block per run of up to g consecutive tiles along z
// (tile t = (tx nty + ty) ntz + tz, so their outputs are one contiguous
// span; a pencil's last run takes the ntz % g rest).  The run's periodic
// window of phi, (P+2)^2 rows along z of g T + 2M + 3 nodes (offsets -M-1
// .. on each axis), is staged in shared memory once, with 16-byte loads
// of phi's aligned 4-node groups (a row wraps only where it crosses the
// grid's z edge; Z % 4 != 0 takes scalar loads), kLoads groups a thread
// in flight.  The span is rows of P outputs along z (one (tile, c, a, b)
// each); a warp takes 32 consecutive rows, a lane a row: the index
// arithmetic is per row, and per output two shared reads, a difference
// and a cast.  The window's x-planes are skewed (plane_base) so that the
// lanes' reads fall on distinct banks.  The warp puts its 32 P outputs in its staging
// slice, shifted to the span's 16-byte alignment, and stores the aligned
// groups with 16-byte stores, the partial groups at either end scalar.
template <bool OUT_BF16, int PC>
__global__ void __launch_bounds__(kThreads, 3)
efield_kernel(const float* __restrict__ phi, void* __restrict__ out, int X,
              int Y, int Z, int nty, int ntz, int T, int M, int P_, int g) {
  using Out = typename EOut<OUT_BF16>::T;
  constexpr int V = 16 / sizeof(Out);
  extern __shared__ __align__(16) float smem[];
  const int P = PC ? PC : P_;   // a compile-time P unrolls the rows
  const int W = P + 2;
  const int runs = (ntz + g - 1) / g;
  const int rz = blockIdx.x % runs, pencil = blockIdx.x / runs;
  const int ty = pencil % nty, tx = pencil / nty;
  const int tz0 = rz * g, ng = min(g, ntz - tz0);
  const int Zw = ng * T + 2 * M + 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* win = smem;
  Out* stage = reinterpret_cast<Out*>(smem + efield_window_floats(g, T, M) +
                                      warp * efield_stage_floats(T, M));

  // the window: item (row, group) loads phi's 4-node group q0 + group of
  // window row (x, y) and keeps the nodes inside [gz0, gz0 + Zw)
  const int gx0 = tx * T - M - 1, gy0 = ty * T - M - 1, gz0 = tz0 * T - M - 1;
  const int q0 = floor_div4(gz0);
  const int nq = floor_div4(gz0 + Zw - 1) - q0 + 1;
  const bool vec = (Z & 3) == 0 && ((uintptr_t)phi & 15u) == 0;
  const int items = W * W * nq;
  const Radix<3> wr = {{nq, W}};
  int it[3], st[3];
  wr.split(threadIdx.x, it);     // (group, y, x) of item i
  wr.split(kThreads, st);
  for (int i0 = threadIdx.x; i0 < items; i0 += kLoads * kThreads) {
    float v[kLoads][4];
    int dst[kLoads], z0[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u, wr.add(it, st)) {
      if (i0 + u * kThreads >= items) continue;
      const float* rowp =
          phi + ((long long)wrap(gx0 + it[2], X) * Y + wrap(gy0 + it[1], Y)) *
                    Z;
      z0[u] = 4 * (q0 + it[0]);
      dst[u] = plane_base(it[2], W, Zw) + it[1] * Zw - gz0;
      if (vec) {
        const float4 t =
            *reinterpret_cast<const float4*>(rowp + wrap(z0[u], Z));
        v[u][0] = t.x;
        v[u][1] = t.y;
        v[u][2] = t.z;
        v[u][3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = rowp[wrap(z0[u] + j, Z)];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (i0 + u * kThreads >= items) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int zi = z0[u] + j - gz0;
        if (zi >= 0 && zi < Zw) win[dst[u] + z0[u] + j] = v[u][j];
      }
    }
  }
  __syncthreads();

  // row rho of the span is (b, a, c, k): offsets (a, b, 0..P-1) of
  // component c of the run's tile k; its P outputs are [rho P, rho P + P)
  const int n = ng * 3 * P * P * P, nrows = ng * 3 * P * P;
  const long long R0 = (long long)((tx * nty + ty) * ntz + tz0) * 3 * P * P * P;
  Out* o = static_cast<Out*>(out) + R0;   // out starts on 16 bytes
  const int nch = (nrows + 31) / 32;
  const Radix<4> rr = {{P, P, 3}};
  int d[4], hop[4];
  rr.split(warp * 32 + lane, d);
  rr.split(kWarps * 32, hop);
  for (int ch = warp; ch < nch; ch += kWarps, rr.add(d, hop)) {
    const int x0 = ch * 32 * P, x1 = min(x0 + 32 * P, n);
    const int sh = (int)((R0 + x0) % V);   // the chunk's 16-byte offset
    if (ch * 32 + lane < nrows) {
      // the row's neighbours along component c: planes a, a + 2 (x),
      // rows b, b + 2 of plane a + 1 (y), nodes -1, +1 (z)
      const int a = d[1], b = d[0], c = d[2], zo = d[3] * T + 1;
      const int mid = plane_base(a + 1, W, Zw);
      const int lo_i = c == 0 ? plane_base(a, W, Zw) + (b + 1) * Zw + zo
                     : (c == 1 ? mid + b * Zw + zo : mid + (b + 1) * Zw + zo - 1);
      const int hi_i = c == 0 ? plane_base(a + 2, W, Zw) + (b + 1) * Zw + zo
                     : (c == 1 ? lo_i + 2 * Zw : lo_i + 2);
      const float* lo = win + lo_i;
      const float* hi = win + hi_i;
      Out* op = stage + sh + lane * P;
#pragma unroll (PC ? PC : 4)
      for (int e = 0; e < P; ++e)
        op[e] = EOut<OUT_BF16>::cast(0.5f * (lo[e] - hi[e]));
    }
    __syncwarp();
    // [ga, gb): the chunk's whole 16-byte groups (span offsets)
    const int ga = min(x1, x0 + (V - sh) % V);
    const int gb = max(ga, x1 - (int)((R0 + x1) % V));
    for (int x = ga + lane * V; x < gb; x += 32 * V) {
      const uint4 w = *reinterpret_cast<const uint4*>(stage + sh + x - x0);
      asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(o + x),
                   "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w)
                   : "memory");
    }
    if (lane < ga - x0) o[x0 + lane] = stage[sh + lane];
    if (lane >= 16 && lane - 16 < x1 - gb)
      o[gb + lane - 16] = stage[sh + gb - x0 + lane - 16];
    __syncwarp();
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
  if (X % T || Y % T || Z % T || M < 0 || X <= M || Y <= M || Z <= M ||
      ((uintptr_t)out & 15u))
    return -1;
  const int P = T + 1 + 2 * M;
  const int ntz = Z / T;
  const int g = min(efield_run(T, M), ntz);
  const long long blocks = (long long)(X / T) * (Y / T) * ((ntz + g - 1) / g);
  if (blocks > 0x7fffffff) return -1;
  const size_t smem = efield_smem(g, T, M);
  if (smem > 227 * 1024) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  // P = 11 and 13 (T = 8 at M = 1 and 2) compiled with P known
  auto* kernel = out_bf16 ? (P == 11   ? efield_kernel<true, 11>
                             : P == 13 ? efield_kernel<true, 13>
                                       : efield_kernel<true, 0>)
                          : (P == 11   ? efield_kernel<false, 11>
                             : P == 13 ? efield_kernel<false, 13>
                                       : efield_kernel<false, 0>);
  if (smem > 48 * 1024) {
    if (int err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return err;
  }
  kernel<<<(int)blocks, kThreads, smem, s>>>(phi, out, X, Y, Z, Y / T, Z / T,
                                             T, M, P, g);
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
