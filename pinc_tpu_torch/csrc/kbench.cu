// Hand-written Hopper (sm_90a) kernels of the port's kernel benchmark
// (pinc_tpu_torch/kbench.py): the deposit and gather variants that the
// TPU probes of experiments/archive/kbench{,2,3,4,5}.py built around K1
// and K3 (the variants that are K1's or K3's own function run K1's or K3's
// kernel of csrc/tiled.cu).
//
// The deposits, each (NT, P, P^2) tiles from the slots of each tile:
//   deposit_variant_kernel<MODE> — one block per tile, 256 threads:
//   INT8         kbench.py _deposit_kernel_q (deposit_q) and kbench5.py
//                _dep_row_kernel_q: wx = rint(127 w(x) v), wyz =
//                rint(127 w(y) w(z)), their products summed exactly in an
//                int32 shared accumulator, then x inv (1/127^2).
//   BF16_NATIVE  kbench4.py _deposit_kernel_bf: the weights in bf16
//                arithmetic, rounded after every operation (d = bf16(x-n),
//                1-|d|, max(0, .), the products), each product wa wyz
//                (exact in float32) summed in the int32 pair of
//                fixed_point.cuh (native ATOMS.ADD) on the host's grid
//                deposit_scale((vmax,), B); the reference sums in float32.
//   weight_sums_kernel (WEIGHT_SUMS) — kbench3.py _deposit_kernel_vpuonly:
//                out[a][k] = X[a] + R[k], X the tile's sum of wx = w(x) v,
//                R of wyz = w(y) w(z): K1's weight arithmetic without the
//                product; one block per tile, X in per-thread float bins,
//                R in one int32-pair fixed-point block (native
//                ATOMS.ADD).
//   given_kron_kernel<VEC> (GIVEN_KRON) — kbench2.py
//                _deposit_kernel_constk: out[a][k] = sum over the 8 rows r
//                and columns l of wx_r[a][l] kron[k][l], the (P^2, L)
//                plane given: the reference's dense (P, L) by (L, P^2)
//                product a row, as one bf16 GEMM on the tensor cores
//                (wgmma), W built in registers, the plane staged in
//                shared memory and shared by the rows and tiles of a
//                block.
//   WEIGHT_SUMS and GIVEN_KRON round wx (and WEIGHT_SUMS wyz) to bf16, as
//   the probes' bf16 mxu_dtype does.
//
// gather_variant_kernel<MODE> — one block per tile, the tile's field block
// (P, P, P, 3) in shared memory, one thread a slot:
//   INT8         kbench.py _gather_kernel_q: field quantized per tile to
//                int8 outside (scale = max|E|), wyz = rint(127 w(y) w(z)),
//                G = sum E wyz in int32, e = (sum_a wx_a G_a) x scale/127^2.
//   BF16_NATIVE  kbench4.py _gather_kernel_bf: E rounded to bf16, wyz in
//                bf16 arithmetic as the deposit's, wx float32.
//   G_BF16       kbench5.py _gat_row_kernel with gdtype=bf16: K3's bf16
//                function with G = sum E wyz rounded to bf16 before the x
//                reduction.
//   NO_XREDUCE   kbench4.py _gather_kernel_nored: e = G at the block's
//                first x node (offset -M), no x weights at all.
//
// Layouts (row-major): xyz (3, NT, B) planes, which are the probes'
// (NT*8, B/8) rows; value (NT, B); tiles (NT, P, P*P); kron (P*P, B/8)
// bf16; field (NT, P, P, P, 3) float32, int8 for INT8, with scale (NT,);
// gathered (3, NT, B), the probes' (3, NT, 8, B/8).  Weights follow
// pallas_tiled._weights_t (CIC over the nodes -M..T+M) evaluated at the
// nodes floor(x) and floor(x)+1, as csrc/tiled.cu does.  Products and sums
// that a plain version repeats are rounded on their own (__fmul_rn,
// __fadd_rn), so only the sums differ from the plain versions: the
// deposits' atomics (BF16_NATIVE's on the pair's grid) and GIVEN_KRON's
// and WEIGHT_SUMS' sums, taken in another order.
//
// What bounds them on the card: the slot planes read once (4 bytes a slot
// of value and 12 of x, y, z a live slot for the deposits, 12 for the
// gathers plus 12 written), except GIVEN_KRON, whose 2 P^3 flops a slot at
// the bf16 tensor-core rate outweigh its bytes (4 of x and 4 of value a
// slot).  INT8 and BF16_NATIVE are K1's scatter: up to 8 (INT8) or 16
// (BF16_NATIVE: hi and lo) native int32 shared atomics a live slot, and
// BF16_NATIVE keeps kBfAhead slots' loads in flight ahead of them.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument the
// kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 16;
constexpr size_t kMaxSmem = 232448;  // 227 KB a block

enum DepositMode { kDepInt8 = 0, kDepBf16Native = 1, kDepWeightSums = 2,
                   kDepGivenKron = 3 };
enum GatherMode { kGatInt8 = 0, kGatBf16Native = 1, kGatGBf16 = 2,
                  kGatNoXReduce = 3 };

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// The candidate nodes floor(x), floor(x)+1: index into the padded block
// (0..P-1) and the CIC weight max(0, 1-|x-n|), 0 outside [-M, T+M].
__device__ __forceinline__ void nodes(float x, int M, int T, int idx[2],
                                      float w[2]) {
  const float f = floorf(x);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float n = f + (float)k;
    const bool inside = n >= (float)(-M) && n <= (float)(T + M);
    w[k] = inside ? fmaxf(0.0f, 1.0f - fabsf(x - n)) : 0.0f;
    idx[k] = inside ? (int)n + M : 0;
  }
}

// The same nodes with the weight in bf16 arithmetic (kbench4.py
// _weights_t_bf): d = bf16(x - n), w = max(0, 1 - |d|), each op rounded.
__device__ __forceinline__ void nodes_bf16(float x, int M, int T, int idx[2],
                                           __nv_bfloat16 w[2]) {
  const float f = floorf(x);
  const __nv_bfloat16 one = __float2bfloat16_rn(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float n = f + (float)k;
    const bool inside = n >= (float)(-M) && n <= (float)(T + M);
    const __nv_bfloat16 d = __float2bfloat16_rn(x - n);
    w[k] = inside ? __hmax(zero, __hsub(one, __habs(d))) : zero;
    idx[k] = inside ? (int)n + M : 0;
  }
}

// rint(127 * a * b), the probes' int8 weight (|a b| <= 1).
__device__ __forceinline__ int quant(float a, float b) {
  return __float2int_rn(mul(mul(a, b), 127.0f));
}

// INT8's slots, one a thread at a time: rint(127 wx v) rint(127 wy wz)
// added into the shared int32 block acc (exact).
__device__ __forceinline__ void int8_slots(const float* __restrict__ xyz,
                                           const float* __restrict__ value,
                                           int* acc, long long base, int B,
                                           long long plane, int P, int M,
                                           int T) {
  const int P2 = P * P;
  for (int j = threadIdx.x; j < B; j += kThreads) {
    const long long k = base + j;
    const float v = value[k];
    if (v == 0.0f) continue;
    int ix[2], iy[2], iz[2];
    float wx[2], wy[2], wz[2];
    nodes(xyz[k], M, T, ix, wx);
    nodes(xyz[plane + k], M, T, iy, wy);
    nodes(xyz[2 * plane + k], M, T, iz, wz);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int qa = quant(wx[a], v);
      if (qa == 0) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qyz = quant(wy[b], wz[c]);
          if (qyz != 0)
            atomicAdd(acc + ix[a] * P2 + iy[b] * P + iz[c], qa * qyz);
        }
    }
  }
}

// BF16_NATIVE's slots: kBfAhead slots a thread (j, j + kThreads, ...), all
// their loads (x, y, z and value, whether the slot is live or not) issued
// before the first of their adds; each product wa wyz of two bf16 numbers
// (exact in float32) added into the int32 pair (hi, lo) at the launch's
// grid fp, two native ATOMS.ADD.  The atomics set the pace: at 4096 x 9216
// on an H100, trial builds without them took 0.30 ms of 0.43, without the
// loads 0.41; 1 or 4 slots in flight 0.437 and 0.434 against 2's 0.427.
constexpr int kBfAhead = 2;

__device__ __forceinline__ void bf16_native_slots(
    const float* __restrict__ xyz, const float* __restrict__ value, int* hi,
    int* lo, const FixedPoint& fp, long long base, int B, long long plane,
    int P, int M, int T) {
  const int P2 = P * P;
  for (int j0 = threadIdx.x; j0 < B; j0 += kBfAhead * kThreads) {
    float xs[kBfAhead], ys[kBfAhead], zs[kBfAhead], vs[kBfAhead];
#pragma unroll
    for (int u = 0; u < kBfAhead; ++u) {
      const int j = j0 + u * kThreads;
      const long long k = base + (j < B ? j : j0);
      xs[u] = xyz[k];
      ys[u] = xyz[plane + k];
      zs[u] = xyz[2 * plane + k];
      vs[u] = j < B ? value[k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBfAhead; ++u) {
      if (vs[u] == 0.0f) continue;
      int ix[2], iy[2], iz[2];
      __nv_bfloat16 wx[2], wy[2], wz[2];
      nodes_bf16(xs[u], M, T, ix, wx);
      nodes_bf16(ys[u], M, T, iy, wy);
      nodes_bf16(zs[u], M, T, iz, wz);
      const __nv_bfloat16 vb = __float2bfloat16_rn(vs[u]);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float wa = __bfloat162float(__hmul(wx[a], vb));
        if (wa == 0.0f) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float wyz = __bfloat162float(__hmul(wy[b], wz[c]));
            if (wyz != 0.0f)
              acc_add(hi, lo, ix[a] * P2 + iy[b] * P + iz[c], mul(wa, wyz),
                      fp);
          }
      }
    }
  }
}

// INT8 and BF16_NATIVE: K1's scatter into shared (P, P*P) sums, one block
// per tile: INT8 in one int32 block (exact), BF16_NATIVE in the int32 pair
// of fixed_point.cuh (2 P^3 ints).  No sum depends on the order of the
// atomics: the tiles are the same bits from launch to launch.
//
// What the pair gives BF16_NATIVE: every addend wa wyz is a product of two
// bf16 numbers, exact in float32, and is rounded once onto the pair's grid
// 2^-(k+j).  With the kernel benchmark's 0/1 values (vmax = 1) every bf16
// weight max(0, 1 - |d|) is a multiple of 2^-8, so every addend is a
// multiple of 2^-24; at B = 9216 the host's deposit_scale((1,), B) is (k,
// j) = (15, 18), a grid of 2^-33, which holds every addend and every sum
// exactly: a node's value is its exact sum rounded once to float32, at
// least as close as the plain version's float32 sums in slot order.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
deposit_variant_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ value, float inv,
                       FixedPoint fp, float* __restrict__ tiles, int B,
                       long long plane, int P, int M) {
  extern __shared__ int acc[];     // INT8: (P^3); BF16_NATIVE: hi, lo
  const int T = P - 1 - 2 * M;
  const int P3 = P * P * P;
  constexpr int kBlocks = MODE == kDepInt8 ? 1 : 2;
  for (int i = threadIdx.x; i < kBlocks * P3; i += kThreads) acc[i] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * B;
  if constexpr (MODE == kDepInt8)
    int8_slots(xyz, value, acc, base, B, plane, P, M, T);
  else
    bf16_native_slots(xyz, value, acc, acc + P3, fp, base, B, plane, P, M,
                      T);
  __syncthreads();
  float* out = tiles + (long long)blockIdx.x * P3;
  for (int i = threadIdx.x; i < P3; i += kThreads) {
    if constexpr (MODE == kDepInt8)
      out[i] = mul(__int2float_rn(acc[i]), inv);
    else
      out[i] = acc_value(acc, acc + P3, i, fp);
  }
}

// WEIGHT_SUMS: one block per tile.  X[a] in per-thread float bins, P a
// thread (bin a of thread t at a * kThreads + t: bank t, no conflicts, no
// atomics), summed at the end by one warp a bin in a fixed order; R[k] in
// one (P^2) int32 pair a block (acc_add at the launch's grid fp: wyz <= 1,
// so the host's deposit_scale((1,), B) holds any tile), 4 hi and 4 lo
// ATOMS.ADD a slot.  12 KB of shared memory a block at P = 11 (per-thread
// R bins as well would take 135 KB, one block of 8 warps an SM), so
// registers, not shared memory, bound the blocks an SM holds.  No sum
// depends on the order of the atomics: the tiles are the same bits from
// launch to launch.
__global__ void __launch_bounds__(kThreads)
weight_sums_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ value,
                   float* __restrict__ tiles, int B, long long plane, int P,
                   int M, FixedPoint fp) {
  extern __shared__ float xbins[];                 // (P, kThreads)
  int* r_hi = reinterpret_cast<int*>(xbins + P * kThreads);   // (P^2)
  int* r_lo = r_hi + P * P;
  float* xsum = reinterpret_cast<float*>(r_lo + P * P);        // (P)
  const int T = P - 1 - 2 * M;
  const int P2 = P * P, P3 = P2 * P;
  const int t = threadIdx.x;
  for (int a = 0; a < P; ++a) xbins[a * kThreads + t] = 0.0f;
  for (int i = t; i < 2 * P2; i += kThreads) r_hi[i] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * B;
  constexpr int kU = 2;           // slots a thread in flight
  for (int j0 = t; j0 < B; j0 += kU * kThreads) {
    float xs[kU], ys[kU], zs[kU], vs[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + u * kThreads;
      const long long k = base + (j < B ? j : 0);
      xs[u] = xyz[k];
      ys[u] = xyz[plane + k];
      zs[u] = xyz[2 * plane + k];
      vs[u] = value[k];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (j0 + u * kThreads >= B) break;
      int ix[2], iy[2], iz[2];
      float wx[2], wy[2], wz[2];
      nodes(xs[u], M, T, ix, wx);
      nodes(ys[u], M, T, iy, wy);
      nodes(zs[u], M, T, iz, wz);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float wa = to_bf16(mul(wx[a], vs[u]));
        float* bin = xbins + ix[a] * kThreads + t;
        if (wa != 0.0f) *bin = add(*bin, wa);
      }
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float wyz = to_bf16(mul(wy[b], wz[c]));
          if (wyz != 0.0f) acc_add(r_hi, r_lo, iy[b] * P + iz[c], wyz, fp);
        }
    }
  }
  __syncthreads();
  // X[a]: warp w sums bins w, w + 8, ..., each lane 8 threads' bins in
  // order, then the lanes by a fixed butterfly
  const int warp = t >> 5, lane = t & 31;
  for (int a = warp; a < P; a += kThreads / 32) {
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < kThreads / 32; ++u)
      s = add(s, xbins[a * kThreads + u * 32 + lane]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = add(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) xsum[a] = s;
  }
  __syncthreads();
  float* out = tiles + (long long)blockIdx.x * P3;
  for (int i = t; i < P3; i += kThreads)
    out[i] = add(xsum[i / P2], acc_value(r_hi, r_lo, i % P2, fp));
}

// GIVEN_KRON on the tensor cores: the tiles' products as one bf16 GEMM,
// out (P, P^2) += W_r (P, L) . kron^T (L, P^2) summed over the 8 rows r of
// a tile, by wgmma (m64n128k16, A from registers, B from shared memory,
// float32 sums).  A block is one warpgroup and holds 4 tiles, warp w tile
// t0 + w as the 16 rows (P nodes padded) of A that wgmma takes from warp
// w, and kGkN columns of the result (gridDim.y blocks of columns cover
// P^2: one at P <= 11, two at P = 13).  A (W) is built in registers by
// the lanes: a lane's fragment is nodes gid and gid + 8 of 4 slots, its
// element bf16(hat(x_l, a - M) v_l), the reference's bf16 weight (the hat
// is 0 at every node but floor(x) and floor(x) + 1; a node past P gets one
// no slot reaches).  B (the plane) is staged kGkChunk columns at a time
// with the block's rows of x and value, double buffered by cp.async
// (16-byte copies where L % 8 == 0, VEC; element copies otherwise), the
// plane in wgmma's K-major core matrices (8 rows x 16 bytes); one stage
// of the plane serves the 8 rows of all 4 tiles.  A k16 step issues 8
// wgmmas (the 8 rows) as one group on two sets of A registers, so one
// group's A is built while the other's products run.  The tensor cores'
// float32 sums are not rounded to nearest over a long K, so the sum is
// taken in two levels: a fresh accumulator a stage (32 wgmmas), added into
// the total with __fadd_rn.  What holds it on an H100 is the lanes' work
// (staging, building A), not the tensor cores: at ~246 registers a thread
// an SM holds 2 warpgroups, which hide one's lane work under the other's
// wgmmas only in part.
constexpr int kGkTiles = 4;              // tiles a block, a warp each
constexpr int kGkN = 128;                // result columns a block
constexpr int kGkChunk = 64;             // plane columns a stage
constexpr int kGkPlane = kGkN * kGkChunk * 2;        // bytes of plane
constexpr int kGkSlots = kGkTiles * 8 * kGkChunk;    // x (and value) floats
constexpr int kGkStage = kGkPlane + 2 * kGkSlots * 4;  // bytes a stage

// byte offset of plane element (n, k) in a stage: core matrix (n / 8, k /
// 8), 128 bytes, its row n % 8 16 bytes
__device__ __forceinline__ int gk_plane_at(int n, int k) {
  return (n >> 3) * (kGkChunk * 16) + (k >> 3) * 128 + (n & 7) * 16 +
         (k & 7) * 2;
}

// wgmma's descriptor of a K-major (kGkN, 16) B without swizzle: core
// matrices 128 bytes apart along K (LBO) and kGkChunk * 16 along N (SBO)
__device__ __forceinline__ uint64_t gk_desc(const void* plane) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(plane);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((kGkChunk * 16) >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Stages plane columns [l0, l0 + kGkChunk) of plane rows [n0, n0 + kGkN)
// and of the block's tiles' 8 rows of x and value; zeros past L, P^2 and
// NT.
template <bool VEC>
__device__ void gk_stage(const float* __restrict__ xyz,
                         const float* __restrict__ value,
                         const __nv_bfloat16* __restrict__ kron,
                         unsigned char* buf, int t0, int n0, int NT, int B,
                         int L, int P2, int l0) {
  float* Xs = reinterpret_cast<float*>(buf + kGkPlane);
  float* Vs = Xs + kGkSlots;
  if constexpr (VEC) {
    constexpr int kp = kGkChunk / 8, xp = kGkChunk / 4;   // 16-byte pieces
    for (int e = threadIdx.x; e < kGkN * kp; e += blockDim.x) {
      const int n = e / kp, p = e % kp, l = l0 + 8 * p;
      const bool ok = n0 + n < P2 && l < L;
      cp_async16(buf + gk_plane_at(n, 8 * p),
                 ok ? kron + (long long)(n0 + n) * L + l : kron, ok);
    }
    for (int e = threadIdx.x; e < kGkTiles * 8 * xp; e += blockDim.x) {
      const int row = e / xp, p = e % xp, l = l0 + 4 * p;
      const int t = t0 + row / 8;
      const bool ok = t < NT && l < L;
      const long long at = (long long)t * B + (long long)(row % 8) * L + l;
      cp_async16(Xs + row * kGkChunk + 4 * p, ok ? xyz + at : xyz, ok);
      cp_async16(Vs + row * kGkChunk + 4 * p, ok ? value + at : value, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kGkN * kGkChunk; e += blockDim.x) {
      const int n = e / kGkChunk, k = e % kGkChunk, l = l0 + k;
      *reinterpret_cast<__nv_bfloat16*>(buf + gk_plane_at(n, k)) =
          n0 + n < P2 && l < L ? kron[(long long)(n0 + n) * L + l]
                               : __float2bfloat16_rn(0.0f);
    }
    for (int e = threadIdx.x; e < kGkSlots; e += blockDim.x) {
      const int row = e / kGkChunk, k = e % kGkChunk, l = l0 + k;
      const int t = t0 + row / 8;
      const bool ok = t < NT && l < L;
      const long long at = (long long)t * B + (long long)(row % 8) * L + l;
      Xs[e] = ok ? xyz[at] : 0.0f;
      Vs[e] = ok ? value[at] : 0.0f;
    }
  }
}

// bf16(hat(x, n) v), the reference's (_weights_t * val).astype(bf16)
__device__ __forceinline__ float hat_v(float x, float n, float v) {
  return mul(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(x, n)))), v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d (64, 128) = A (64, 16) . B (16, 128) + (scale_d ? d : 0), A in the
// warpgroup's registers, B at the descriptor
__device__ __forceinline__ void wgmma_128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// the compiler may not move accesses of these registers across the
// wgmma synchronisations (nor reuse them while a wgmma reads them)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[r][q])::"memory");
}

// A's fragments of k16 step s of a stage for the 8 rows of the warp's
// tile: nodes nA = gid - M and nB = gid + 8 - M of slots 2 tig, 2 tig + 1
// (a[0], a[1]) and 2 tig + 8, 2 tig + 9 (a[2], a[3]) of the step
__device__ __forceinline__ void gk_build(uint32_t (&A)[8][4],
                                         const float* Xs, const float* Vs,
                                         int s, int tig, float nA, float nB) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float* xr = Xs + r * kGkChunk + 16 * s + 2 * tig;
    const float* vr = Vs + r * kGkChunk + 16 * s + 2 * tig;
    const float2 x0 = *reinterpret_cast<const float2*>(xr);
    const float2 x8 = *reinterpret_cast<const float2*>(xr + 8);
    const float2 v0 = *reinterpret_cast<const float2*>(vr);
    const float2 v8 = *reinterpret_cast<const float2*>(vr + 8);
    A[r][0] = pack_bf16(hat_v(x0.x, nA, v0.x), hat_v(x0.y, nA, v0.y));
    A[r][1] = pack_bf16(hat_v(x0.x, nB, v0.x), hat_v(x0.y, nB, v0.y));
    A[r][2] = pack_bf16(hat_v(x8.x, nA, v8.x), hat_v(x8.y, nA, v8.y));
    A[r][3] = pack_bf16(hat_v(x8.x, nB, v8.x), hat_v(x8.y, nB, v8.y));
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kGkTiles * 32, 2)
given_kron_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ value,
                  const __nv_bfloat16* __restrict__ kron,
                  float* __restrict__ tiles, int NT, int B, int P, int M) {
  extern __shared__ __align__(128) unsigned char gk_smem[];
  const int L = B / 8, P2 = P * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int t0 = blockIdx.x * kGkTiles, t = t0 + warp;
  const int n0 = blockIdx.y * kGkN;
  // the lane's two nodes, as offsets; a node past P gets one that no slot
  // reaches (hat 0)
  const float nA = gid < P ? (float)(gid - M) : 1e30f;
  const float nB = gid + 8 < P ? (float)(gid + 8 - M) : 1e30f;
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.0f;
  uint32_t A[2][8][4];
  const int chunks = (L + kGkChunk - 1) / kGkChunk;
  gk_stage<VEC>(xyz, value, kron, gk_smem, t0, n0, NT, B, L, P2, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)
      gk_stage<VEC>(xyz, value, kron, gk_smem + ((c + 1) & 1) * kGkStage,
                    t0, n0, NT, B, L, P2, (c + 1) * kGkChunk);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    // this thread's stores of the stage, visible to wgmma's proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const unsigned char* buf = gk_smem + (c & 1) * kGkStage;
    const float* Xs = reinterpret_cast<const float*>(buf + kGkPlane) +
                      warp * 8 * kGkChunk;
    const uint64_t desc = gk_desc(buf);
    const int steps = (min(kGkChunk, L - c * kGkChunk) + 15) / 16;
#pragma unroll
    for (int s = 0; s < kGkChunk / 16; ++s) {
      if (s >= steps) break;
      if (s >= 2) {                   // group s - 2 read A[s & 1]
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(A[s & 1]);
      }
      gk_build(A[s & 1], Xs, Xs + kGkSlots, s, tig, nA, nB);
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wgmma_128(acc, A[s & 1][r], desc + (uint64_t)(16 * s),
                  (s | r) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    // the stage's sum, folded into the total; the buffer is free
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    fence_regs(A[0]);
    fence_regs(A[1]);
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = add(tot[i], acc[i]);
    __syncthreads();   // buffer c & 1 is restaged for chunk c + 2
  }
  if (t >= NT) return;
  float* out = tiles + (long long)t * P * P2;
#pragma unroll
  for (int j = 0; j < kGkN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = gid + 8 * h;
      if (a >= P) continue;
      if (n < P2) out[a * P2 + n] = tot[4 * j + 2 * h];
      if (n + 1 < P2) out[a * P2 + n + 1] = tot[4 * j + 2 * h + 1];
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gather_variant_kernel(const void* __restrict__ field,
                      const float* __restrict__ scale, float inv,
                      const float* __restrict__ xyz, float* __restrict__ out,
                      int B, long long plane, int P, int M) {
  constexpr int C = 3;
  extern __shared__ float F[];
  signed char* Fq = reinterpret_cast<signed char*>(F);
  const int T = P - 1 - 2 * M;
  const int P2 = P * P, n = P2 * P * C;
  const long long fbase = (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (MODE == kGatInt8)
      Fq[i] = static_cast<const signed char*>(field)[fbase + i];
    else
      F[i] = to_bf16(static_cast<const float*>(field)[fbase + i]);
  }
  __syncthreads();
  const float sc = MODE == kGatInt8 ? mul(scale[blockIdx.x], inv) : 0.0f;
  const long long base = (long long)blockIdx.x * B;
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    const long long k = base + j;
    const float x = xyz[k], y = xyz[plane + k], z = xyz[2 * plane + k];
    int ix[2], iy[2], iz[2];
    float wx[2], wyz[2][2];
    int qyz[2][2];
    if (MODE == kGatBf16Native) {
      __nv_bfloat16 by[2], bz[2];
      nodes_bf16(y, M, T, iy, by);
      nodes_bf16(z, M, T, iz, bz);
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          wyz[b][c] = __bfloat162float(__hmul(by[b], bz[c]));
    } else {
      float wy[2], wz[2];
      nodes(y, M, T, iy, wy);
      nodes(z, M, T, iz, wz);
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (MODE == kGatInt8) qyz[b][c] = quant(wy[b], wz[c]);
          else wyz[b][c] = to_bf16(mul(wy[b], wz[c]));
        }
    }
    if (MODE == kGatNoXReduce) {
      ix[0] = 0;           // the first x node only, weight 1
      wx[0] = 1.0f;
      wx[1] = 0.0f;
      ix[1] = 0;
    } else {
      nodes(x, M, T, ix, wx);
    }
    float e[C];
#pragma unroll
    for (int c = 0; c < C; ++c) e[c] = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (wx[a] == 0.0f) continue;
      float g[C];
      int gi[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        g[c] = 0.0f;
        gi[c] = 0;
      }
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const int at = (ix[a] * P2 + iy[b] * P + iz[cz]) * C;
          if (MODE == kGatInt8) {
            if (qyz[b][cz] == 0) continue;
#pragma unroll
            for (int c = 0; c < C; ++c) gi[c] += (int)Fq[at + c] * qyz[b][cz];
          } else {
            if (wyz[b][cz] == 0.0f) continue;
#pragma unroll
            for (int c = 0; c < C; ++c)
              g[c] = add(g[c], mul(F[at + c], wyz[b][cz]));
          }
        }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float gc = MODE == kGatInt8 ? __int2float_rn(gi[c]) : g[c];
        if (MODE == kGatGBf16) gc = to_bf16(gc);
        e[c] = MODE == kGatNoXReduce ? gc : add(e[c], mul(wx[a], gc));
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[c * plane + k] = MODE == kGatInt8 ? mul(e[c], sc) : e[c];
  }
}

template <typename Kernel>
int prepare(Kernel* kernel, size_t smem) {
  if (smem > kMaxSmem) return -1;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <int MODE>
int launch_deposit(const float* xyz, const float* value, float inv,
                   float* tiles, int NT, int B, int P, int M, int k, int j,
                   cudaStream_t stream) {
  FixedPoint fp = {};
  if (MODE == kDepBf16Native && !fixed_point(k, j, &fp)) return -1;
  const size_t smem = (size_t)(MODE == kDepInt8 ? 1 : 2) * P * P * P * 4;
  if (int err = prepare(deposit_variant_kernel<MODE>, smem)) return err;
  deposit_variant_kernel<MODE><<<NT, kThreads, smem, stream>>>(
      xyz, value, inv, fp, tiles, B, (long long)NT * B, P, M);
  return (int)cudaGetLastError();
}

int launch_weight_sums(const float* xyz, const float* value, float* tiles,
                       int NT, int B, int P, int M, int k, int j,
                       cudaStream_t stream) {
  FixedPoint fp;
  if (!fixed_point(k, j, &fp)) return -1;
  const size_t smem = ((size_t)P * kThreads + 2 * P * P + P) * 4;
  if (int err = prepare(weight_sums_kernel, smem)) return err;
  weight_sums_kernel<<<NT, kThreads, smem, stream>>>(
      xyz, value, tiles, B, (long long)NT * B, P, M, fp);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_given_kron(const float* xyz, const float* value,
                      const __nv_bfloat16* kron, float* tiles, int NT, int B,
                      int P, int M, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kGkStage;
  if (int err = prepare(given_kron_kernel<VEC>, smem)) return err;
  const dim3 grid((NT + kGkTiles - 1) / kGkTiles, (P * P + kGkN - 1) / kGkN);
  given_kron_kernel<VEC><<<grid, kGkTiles * 32, smem, stream>>>(
      xyz, value, kron, tiles, NT, B, P, M);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_gather(const void* field, const float* scale, float inv,
                  const float* xyz, float* out, int NT, int B, int P, int M,
                  cudaStream_t stream) {
  const size_t n = (size_t)P * P * P * 3;
  const size_t smem = MODE == kGatInt8 ? n : n * 4;
  if (int err = prepare(gather_variant_kernel<MODE>, smem)) return err;
  gather_variant_kernel<MODE><<<NT, kThreads, smem, stream>>>(
      field, scale, inv, xyz, out, B, (long long)NT * B, P, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pinc_kb_deposit(const float* xyz, const float* value, const void* kron,
                    float* tiles, int NT, int B, int P, int M, int mode,
                    float inv, void* stream, int k, int j) {
  cudaStream_t s = (cudaStream_t)stream;
  const auto* kb = static_cast<const __nv_bfloat16*>(kron);
  if (P < 2 || P > kMaxP || B % 8 != 0 || 2 * M + 1 > P) return -1;
  switch (mode) {
    case kDepInt8:
      return launch_deposit<kDepInt8>(xyz, value, inv, tiles, NT, B, P, M,
                                      k, j, s);
    case kDepBf16Native:
      return launch_deposit<kDepBf16Native>(xyz, value, inv, tiles, NT, B, P,
                                            M, k, j, s);
    case kDepWeightSums:
      return launch_weight_sums(xyz, value, tiles, NT, B, P, M, k, j, s);
    case kDepGivenKron: {
      // 16-byte copies need 16-byte rows: L % 8 == 0 and aligned planes
      const bool vec = (B / 8) % 8 == 0 &&
                       ((uintptr_t)xyz | (uintptr_t)value |
                        (uintptr_t)kron) % 16 == 0;
      return vec ? launch_given_kron<true>(xyz, value, kb, tiles, NT, B, P,
                                           M, s)
                 : launch_given_kron<false>(xyz, value, kb, tiles, NT, B, P,
                                            M, s);
    }
  }
  return -1;
}

int pinc_kb_gather(const void* field, const float* scale, float inv,
                   const float* xyz, float* out, int NT, int B, int P, int M,
                   int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (P < 2 || P > kMaxP || 2 * M + 1 > P) return -1;
  switch (mode) {
    case kGatInt8:
      return launch_gather<kGatInt8>(field, scale, inv, xyz, out, NT, B, P, M,
                                     s);
    case kGatBf16Native:
      return launch_gather<kGatBf16Native>(field, scale, inv, xyz, out, NT, B,
                                           P, M, s);
    case kGatGBf16:
      return launch_gather<kGatGBf16>(field, scale, inv, xyz, out, NT, B, P,
                                      M, s);
    case kGatNoXReduce:
      return launch_gather<kGatNoXReduce>(field, scale, inv, xyz, out, NT, B,
                                          P, M, s);
  }
  return -1;
}

}  // extern "C"
