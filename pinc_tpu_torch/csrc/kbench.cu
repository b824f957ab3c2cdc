// Hand-written Hopper (sm_90a) kernels of the port's kernel benchmark
// (pinc_tpu_torch/kbench.py): the deposit and gather variants that the
// TPU probes of experiments/archive/kbench{,2,3,4,5}.py built around K1
// and K3 (the variants that are K1's or K3's own function run K1's or K3's
// kernel of csrc/tiled.cu).
//
// deposit_variant_kernel<MODE> — one block per tile, 256 threads:
//   INT8         kbench.py _deposit_kernel_q (deposit_q) and kbench5.py
//                _dep_row_kernel_q: wx = rint(127 w(x) v), wyz =
//                rint(127 w(y) w(z)), their products summed exactly in an
//                int32 shared accumulator, then x inv (1/127^2).
//   BF16_NATIVE  kbench4.py _deposit_kernel_bf: the weights in bf16
//                arithmetic, rounded after every operation (d = bf16(x-n),
//                1-|d|, max(0, .), the products), summed in float32.
//   WEIGHT_SUMS  kbench3.py _deposit_kernel_vpuonly: out[a][k] = X[a] +
//                R[k], X the tile's sum of wx = w(x) v, R of wyz = w(y)
//                w(z): K1's weight arithmetic with the scatter replaced by
//                per-thread private bins (no shared atomics); the bins'
//                shared memory leaves 8 warps an SM, which bounds its time.
//   GIVEN_KRON   kbench2.py _deposit_kernel_constk: out[a][k] = sum over
//                the 8 rows r and columns l of wx_r[a][l] kron[k][l], the
//                (P^2, L) plane given: one dense (P, L) by (L, P^2)
//                product a row on the CUDA cores, as the reference does,
//                the plane streamed through shared memory in chunks of
//                kChunk columns beside the rows' wx of those columns.
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
// __fadd_rn), so only the order of the atomics' and of GIVEN_KRON's and
// WEIGHT_SUMS' sums differ from the plain versions.
//
// What bounds them on the card: the slot planes read once (4 bytes a slot
// of value and 12 of x, y, z a live slot for the deposits, 12 for the
// gathers plus 12 written), except GIVEN_KRON, whose 2 P^3 flops a slot
// on the CUDA cores outweigh its bytes, and INT8 and BF16_NATIVE, which
// are K1's shared atomics (int32 for INT8).
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument the
// kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 16;
constexpr int kChunk = 64;           // GIVEN_KRON plane columns a stage
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

// INT8 and BF16_NATIVE: K1's scatter into a shared (P, P*P) accumulator.
template <int MODE>
__device__ void scatter_tile(const float* __restrict__ xyz,
                             const float* __restrict__ value, float inv,
                             float* __restrict__ tiles, int B,
                             long long plane, int P, int M, void* smem) {
  using Acc = std::conditional_t<MODE == kDepInt8, int, float>;
  Acc* acc = static_cast<Acc*>(smem);
  const int T = P - 1 - 2 * M;
  const int P2 = P * P, P3 = P2 * P;
  for (int i = threadIdx.x; i < P3; i += blockDim.x) acc[i] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * B;
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    const long long k = base + j;
    const float v = value[k];
    if (v == 0.0f) continue;
    const float x = xyz[k], y = xyz[plane + k], z = xyz[2 * plane + k];
    int ix[2], iy[2], iz[2];
    if constexpr (MODE == kDepInt8) {
      float wx[2], wy[2], wz[2];
      nodes(x, M, T, ix, wx);
      nodes(y, M, T, iy, wy);
      nodes(z, M, T, iz, wz);
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
    } else {
      __nv_bfloat16 wx[2], wy[2], wz[2];
      nodes_bf16(x, M, T, ix, wx);
      nodes_bf16(y, M, T, iy, wy);
      nodes_bf16(z, M, T, iz, wz);
      const __nv_bfloat16 vb = __float2bfloat16_rn(v);
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
              atomicAdd(acc + ix[a] * P2 + iy[b] * P + iz[c], mul(wa, wyz));
          }
      }
    }
  }
  __syncthreads();
  float* out = tiles + (long long)blockIdx.x * P3;
  for (int i = threadIdx.x; i < P3; i += blockDim.x) {
    if constexpr (MODE == kDepInt8)
      out[i] = mul(__int2float_rn(acc[i]), inv);
    else
      out[i] = acc[i];
  }
}

// WEIGHT_SUMS: per-thread private bins, bin b of thread t at
// b * blockDim + t (bank t: no conflicts while the slots add in; the
// totals are summed with a skew, thread b reading column (u + b) mod
// blockDim at step u, so no conflicts there either).  The bins take
// (P + P^2) * 4 bytes a thread, 135 KB a block at P = 11: one block, 8
// warps, an SM, so this occupancy, not the weight arithmetic, sets its
// time.
__device__ void weight_sums_tile(const float* __restrict__ xyz,
                                 const float* __restrict__ value,
                                 float* __restrict__ tiles, int B,
                                 long long plane, int P, int M,
                                 float* bins) {
  const int T = P - 1 - 2 * M;
  const int P2 = P * P, P3 = P2 * P, nb = P + P2;
  constexpr int stride = kThreads;   // the block size
  const int t = threadIdx.x;
  for (int b = 0; b < nb; ++b) bins[b * stride + t] = 0.0f;
  const long long base = (long long)blockIdx.x * B;
  // kU slots a thread in flight: the bins leave room for one block of 8
  // warps an SM, too few to hide the loads' latency one slot at a time
  constexpr int kU = 4;
  for (int j0 = t; j0 < B; j0 += kU * blockDim.x) {
    float xs[kU], ys[kU], zs[kU], vs[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + u * blockDim.x;
      const long long k = base + (j < B ? j : 0);
      xs[u] = xyz[k];
      ys[u] = xyz[plane + k];
      zs[u] = xyz[2 * plane + k];
      vs[u] = value[k];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (j0 + u * (int)blockDim.x >= B) break;
      int ix[2], iy[2], iz[2];
      float wx[2], wy[2], wz[2];
      nodes(xs[u], M, T, ix, wx);
      nodes(ys[u], M, T, iy, wy);
      nodes(zs[u], M, T, iz, wz);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float wa = to_bf16(mul(wx[a], vs[u]));
        float* bin = bins + ix[a] * stride + t;
        *bin = add(*bin, wa);
      }
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float wyz = to_bf16(mul(wy[b], wz[c]));
          float* bin = bins + (P + iy[b] * P + iz[c]) * stride + t;
          *bin = add(*bin, wyz);
        }
    }
  }
  __syncthreads();
  // bin b's total (four interleaved partial sums), then all totals packed
  // at the front of the bins: X = bins[0, P), R = bins[P, P + P^2)
  float total = 0.0f;
  if (t < nb) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int u = 0; u < stride; u += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[q] = add(part[q], bins[t * stride + (u + q + t) % stride]);
    }
    total = add(add(part[0], part[1]), add(part[2], part[3]));
  }
  __syncthreads();
  if (t < nb) bins[t] = total;
  __syncthreads();
  float* out = tiles + (long long)blockIdx.x * P3;
  for (int i = t; i < P3; i += blockDim.x)
    out[i] = add(bins[i / P2], bins[P + i % P2]);
}

// GIVEN_KRON's row stride of W: P rounded up to a multiple of 4 (float4
// reads) whose quarter is odd (4-way, not 16-way, conflicts where W is
// filled).
__host__ __device__ constexpr int kron_pitch(int P) {
  return ((P + 3) / 4) % 2 ? (P + 3) / 4 * 4 : (P + 3) / 4 * 4 + 4;
}

// GIVEN_KRON: one (P, L) by (L, P^2) product a row, as the reference does.
// The plane is streamed through shared memory kChunk columns at a time,
// with the 8 rows' wx of those columns, W (8, kChunk, Pp), each (row,
// column) filled by one thread (no atomics); thread (k, g) then adds plane
// row k times every row's wx over g's interleaved share of the columns, W
// read 4 nodes at a time; the groups' partial sums are added in order at
// the end.
__device__ void given_kron_tile(const float* __restrict__ xyz,
                                const float* __restrict__ value,
                                const __nv_bfloat16* __restrict__ kron,
                                float* __restrict__ tiles, int B, int P,
                                int M, float* smem) {
  const int T = P - 1 - 2 * M;
  const int P2 = P * P, P3 = P2 * P, L = B / 8, Pp = kron_pitch(P);
  float* W = smem;                     // (8, kChunk, Pp)
  float* Kc = smem + 8 * kChunk * Pp;  // (kChunk, P2), then the partials
  const long long base = (long long)blockIdx.x * B;
  const int groups = blockDim.x / P2;
  const int k = threadIdx.x % P2, g = threadIdx.x / P2;
  const bool active = g < groups;
  float acc[kMaxP];
#pragma unroll
  for (int a = 0; a < kMaxP; ++a) acc[a] = 0.0f;
  for (int l0 = 0; l0 < L; l0 += kChunk) {
    __syncthreads();
    const int n = min(kChunk, L - l0);
    for (int e = threadIdx.x; e < 8 * kChunk; e += blockDim.x) {
      const int r = e / kChunk, lc = e % kChunk;
      float* w = W + e * Pp;
      for (int a = 0; a < Pp; ++a) w[a] = 0.0f;
      if (lc < n) {
        const long long at = base + r * L + l0 + lc;
        int ix[2];
        float wx[2];
        nodes(xyz[at], M, T, ix, wx);
        const float v = value[at];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float wa = to_bf16(mul(wx[a], v));
          if (wa != 0.0f) w[ix[a]] = add(w[ix[a]], wa);
        }
      }
    }
    // the chunk of the plane, kStage loads a thread in flight
    constexpr int kStage = 8;
    for (int e0 = threadIdx.x; e0 < P2 * kChunk;
         e0 += kStage * blockDim.x) {
      float kv[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = e0 + u * blockDim.x;
        const int kk = e / kChunk, lc = e % kChunk;
        kv[u] = e < P2 * kChunk && lc < n
                    ? __bfloat162float(kron[(long long)kk * L + l0 + lc])
                    : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < P2 * kChunk) Kc[(e % kChunk) * P2 + e / kChunk] = kv[u];
      }
    }
    __syncthreads();
    if (active) {
      for (int lc = g; lc < n; lc += groups) {
        const float kv = Kc[lc * P2 + k];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4* s =
              reinterpret_cast<const float4*>(W + (r * kChunk + lc) * Pp);
#pragma unroll
          for (int q = 0; q < kMaxP / 4; ++q) {
            if (4 * q >= P) break;
            const float4 sv = s[q];
            acc[4 * q] += sv.x * kv;
            acc[4 * q + 1] += sv.y * kv;
            acc[4 * q + 2] += sv.z * kv;
            acc[4 * q + 3] += sv.w * kv;
          }
        }
      }
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int a = 0; a < kMaxP; ++a)
      if (a < P) Kc[(g * P + a) * P2 + k] = acc[a];
  }
  __syncthreads();
  float* out = tiles + (long long)blockIdx.x * P3;
  for (int i = threadIdx.x; i < P3; i += blockDim.x) {
    const int a = i / P2, kk = i % P2;
    float s = 0.0f;
    for (int u = 0; u < groups; ++u) s = add(s, Kc[(u * P + a) * P2 + kk]);
    out[i] = s;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
deposit_variant_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ value,
                       const __nv_bfloat16* __restrict__ kron, float inv,
                       float* __restrict__ tiles, int B, long long plane,
                       int P, int M) {
  extern __shared__ float smem[];
  if constexpr (MODE == kDepInt8 || MODE == kDepBf16Native)
    scatter_tile<MODE>(xyz, value, inv, tiles, B, plane, P, M, smem);
  else if constexpr (MODE == kDepWeightSums)
    weight_sums_tile(xyz, value, tiles, B, plane, P, M, smem);
  else
    given_kron_tile(xyz, value, kron, tiles, B, P, M, smem);
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

size_t deposit_smem(int mode, int P) {
  const size_t P2 = (size_t)P * P;
  if (mode == kDepInt8 || mode == kDepBf16Native) return P2 * P * 4;
  if (mode == kDepWeightSums) return (P + P2) * kThreads * 4;
  const size_t stage = P2 * kChunk;
  const size_t groups = kThreads / P2;
  return ((size_t)8 * kChunk * kron_pitch(P) +
          (stage > groups * P * P2 ? stage : groups * P * P2)) * 4;
}

template <int MODE>
int launch_deposit(const float* xyz, const float* value,
                   const __nv_bfloat16* kron, float inv, float* tiles, int NT,
                   int B, int P, int M, cudaStream_t stream) {
  const size_t smem = deposit_smem(MODE, P);
  if (int err = prepare(deposit_variant_kernel<MODE>, smem)) return err;
  deposit_variant_kernel<MODE><<<NT, kThreads, smem, stream>>>(
      xyz, value, kron, inv, tiles, B, (long long)NT * B, P, M);
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
                    float inv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const auto* kb = static_cast<const __nv_bfloat16*>(kron);
  if (P < 2 || P > kMaxP || B % 8 != 0 || 2 * M + 1 > P) return -1;
  switch (mode) {
    case kDepInt8:
      return launch_deposit<kDepInt8>(xyz, value, kb, inv, tiles, NT, B, P,
                                      M, s);
    case kDepBf16Native:
      return launch_deposit<kDepBf16Native>(xyz, value, kb, inv, tiles, NT, B,
                                            P, M, s);
    case kDepWeightSums:
      if (P + P * P > kThreads) return -1;   // one reducing thread a bin
      return launch_deposit<kDepWeightSums>(xyz, value, kb, inv, tiles, NT, B,
                                            P, M, s);
    case kDepGivenKron:
      if (kThreads / (P * P) < 1) return -1;
      return launch_deposit<kDepGivenKron>(xyz, value, kb, inv, tiles, NT, B,
                                           P, M, s);
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
