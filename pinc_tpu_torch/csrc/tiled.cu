// Hand-written Hopper (sm_90a) kernels of the tiled PIC step:
// deposit, deposit_move, gather and gather_kick.
//
// They replace the Pallas TPU kernels of pinc_tpu/ops/pallas_tiled.py
// (_deposit_kernel, _deposit_move_kernel, _gather_kernel and
// _gather_kick_kernel).  The TPU kernels build dense (P, B) and (P*P, B)
// hat-weight matrices over every node of the padded tile block and contract
// them on the matrix unit.  On Hopper a slot touches only its 2x2x2 (CIC)
// or single (NGP) nodes, so these kernels work per slot instead: one thread
// block per tile, the tile's padded node block in shared memory (the
// accumulator of a deposit, the field of a gather), threads striding over
// the tile's B slots.  Deposits add into shared memory with atomics and
// write each tile's block once, with no global atomics.
//
// Layouts (row-major, float32):
//   xyz, vel      (3, NT, B)    tile-local coordinate / velocity planes
//   value, alive  (NT, B)
//   tiles         (NT, P, P*P)  padded node block, offsets -M..T+M, x major
//   field         (NT, P, P, P, C)
//   gathered      (C, NT, B)
// with P = T + 1 + 2M.  Weights follow pallas_tiled._w1d: max(0, 1-|x-n|)
// (CIC) or the half-open indicator -0.5 <= x-n < 0.5 (NGP), evaluated for
// the nodes n = floor(x) and floor(x)+1; a node outside [-M, T+M]
// contributes nothing, so dead slots (parked at -2M-2) and margin leavers
// deposit and gather exactly what the TPU kernels do.  With bf16 weights
// the products wx*value and wy*wz (deposit), and E and wy*wz (gather), are
// rounded to bf16 at the same points as the TPU kernels; all sums are
// float32.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument
// the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int ORDER>
__device__ __forceinline__ float w1d(float d) {
  if (ORDER == 0) return (d >= -0.5f && d < 0.5f) ? 1.0f : 0.0f;
  return fmaxf(0.0f, 1.0f - fabsf(d));
}

// The candidate nodes floor(x), floor(x)+1 of one coordinate: index into
// the padded block (0..P-1) and weight (0 outside [-M, T+M]).
template <int ORDER>
__device__ __forceinline__ void nodes(float x, int M, int T, int idx[2],
                                      float w[2]) {
  const float f = floorf(x);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float n = f + (float)k;
    const bool inside = n >= (float)(-M) && n <= (float)(T + M);
    w[k] = inside ? w1d<ORDER>(x - n) : 0.0f;
    idx[k] = inside ? (int)n + M : 0;
  }
}

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// K1 (MOVE = false): tiles[t] = sum over slots of value * w(x) w(y) w(z).
// K2 (MOVE = true): x += v first, new planes written out, the live slots
// outside [-M, T+M) counted per tile, then the deposit with value = alive*q.
template <int ORDER, bool BF16, bool MOVE>
__global__ void __launch_bounds__(kThreads)
deposit_kernel(const float* __restrict__ xyz, const float* __restrict__ vel,
               const float* __restrict__ weight, float q,
               float* __restrict__ tiles, float* __restrict__ new_xyz,
               float* __restrict__ nout, int B, long long plane, int P,
               int M) {
  extern __shared__ float acc[];
  __shared__ float red[kThreads / 32];
  const int T = P - 1 - 2 * M;
  const int P2 = P * P, P3 = P2 * P;
  for (int i = threadIdx.x; i < P3; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const long long base = (long long)blockIdx.x * B;
  const float lo = (float)(-M), hi = (float)(T + M);
  float bad = 0.0f;
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    const long long k = base + j;
    float x = xyz[k], y = xyz[plane + k], z = xyz[2 * plane + k];
    float v = weight[k];
    if (MOVE) {
      x += vel[k];
      y += vel[plane + k];
      z += vel[2 * plane + k];
      new_xyz[k] = x;
      new_xyz[plane + k] = y;
      new_xyz[2 * plane + k] = z;
      if (x < lo || x >= hi || y < lo || y >= hi || z < lo || z >= hi)
        bad += v;
      v = v * q;
    }
    if (v == 0.0f) continue;
    int ix[2], iy[2], iz[2];
    float wx[2], wy[2], wz[2];
    nodes<ORDER>(x, M, T, ix, wx);
    nodes<ORDER>(y, M, T, iy, wy);
    nodes<ORDER>(z, M, T, iz, wz);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float wa = wx[a] * v;
      if (BF16) wa = to_bf16(wa);
      if (wa == 0.0f) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float wyz = wy[b] * wz[c];
          if (BF16) wyz = to_bf16(wyz);
          if (wyz == 0.0f) continue;
          atomicAdd(&acc[ix[a] * P2 + iy[b] * P + iz[c]], wa * wyz);
        }
      }
    }
  }
  __syncthreads();
  float* out = tiles + (long long)blockIdx.x * P3;
  for (int i = threadIdx.x; i < P3; i += blockDim.x) out[i] = acc[i];
  if (MOVE) {
    const float s = block_sum(bad, red);
    if (threadIdx.x == 0) nout[blockIdx.x] = s;
  }
}

struct KickParams {
  float qm;
  float ext[3];   // external E, added to the gathered field
  float T[3];     // Boris rotation vectors (unused by the leapfrog kick)
  float S[3];
};

// K3 (KICK = 0): out[c] = sum_a wx_a * sum_bc E[a,b,c] w(y)_b w(z)_c.
// K4 (KICK = 1 leapfrog, 2 Boris): the same field plus e_ext, the kick of
// pallas_tiled._kick_rows, velocities written masked by alive, and the
// per-tile sum of alive * vdot.
template <int ORDER, bool BF16, int KICK, int C>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ field, const float* __restrict__ xyz,
              const float* __restrict__ vel, const float* __restrict__ alive,
              KickParams kp, float* __restrict__ out,
              float* __restrict__ vdot_out, int B, long long plane, int P,
              int M) {
  extern __shared__ float F[];
  __shared__ float red[kThreads / 32];
  const int T = P - 1 - 2 * M;
  const int P2 = P * P, n = P2 * P * C;
  const float* src = field + (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float e = src[i];
    F[i] = BF16 ? to_bf16(e) : e;
  }
  __syncthreads();
  const long long base = (long long)blockIdx.x * B;
  float vdot_acc = 0.0f;
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    const long long k = base + j;
    const float x = xyz[k], y = xyz[plane + k], z = xyz[2 * plane + k];
    int ix[2], iy[2], iz[2];
    float wx[2], wy[2], wz[2];
    nodes<ORDER>(x, M, T, ix, wx);
    nodes<ORDER>(y, M, T, iy, wy);
    nodes<ORDER>(z, M, T, iz, wz);
    float e[C];
#pragma unroll
    for (int c = 0; c < C; ++c) e[c] = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (wx[a] == 0.0f) continue;
      float g[C];
#pragma unroll
      for (int c = 0; c < C; ++c) g[c] = 0.0f;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          float wyz = wy[b] * wz[cz];
          if (BF16) wyz = to_bf16(wyz);
          if (wyz == 0.0f) continue;
          const float* f = F + (ix[a] * P2 + iy[b] * P + iz[cz]) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) g[c] += f[c] * wyz;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) e[c] += wx[a] * g[c];
    }
    if (KICK == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[c * plane + k] = e[c];
      continue;
    }
    const float al = alive[k];
    float v[3], E[3], vn[3], vd;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = vel[c * plane + k];
      E[c] = e[c < C ? c : 0] + kp.ext[c];
    }
    if (KICK == 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) vn[c] = v[c] + kp.qm * E[c];
      vd = v[0] * vn[0] + v[1] * vn[1] + v[2] * vn[2];
    } else {
      const float hq = 0.5f * kp.qm;
      float h[3], vm[3], vp[3], vl[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        h[c] = hq * E[c];
        vm[c] = v[c] + h[c];
      }
      vp[0] = vm[0] + (vm[1] * kp.T[2] - vm[2] * kp.T[1]);
      vp[1] = vm[1] + (vm[2] * kp.T[0] - vm[0] * kp.T[2]);
      vp[2] = vm[2] + (vm[0] * kp.T[1] - vm[1] * kp.T[0]);
      vl[0] = vm[0] + (vp[1] * kp.S[2] - vp[2] * kp.S[1]);
      vl[1] = vm[1] + (vp[2] * kp.S[0] - vp[0] * kp.S[2]);
      vl[2] = vm[2] + (vp[0] * kp.S[1] - vp[1] * kp.S[0]);
#pragma unroll
      for (int c = 0; c < 3; ++c) vn[c] = vl[c] + h[c];
      vd = vl[0] * vl[0] + vl[1] * vl[1] + vl[2] * vl[2];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * plane + k] = v[c] + al * (vn[c] - v[c]);
    vdot_acc += vd * al;
  }
  if (KICK != 0) {
    const float s = block_sum(vdot_acc, red);
    if (threadIdx.x == 0) vdot_out[blockIdx.x] = s;
  }
}

template <typename Kernel>
int prepare(Kernel* kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <int ORDER, bool BF16, bool MOVE>
int launch_deposit(const float* xyz, const float* vel, const float* weight,
                   float q, float* tiles, float* new_xyz, float* nout, int NT,
                   int B, int P, int M, cudaStream_t stream) {
  const size_t smem = (size_t)P * P * P * sizeof(float);
  if (int err = prepare(deposit_kernel<ORDER, BF16, MOVE>, smem)) return err;
  deposit_kernel<ORDER, BF16, MOVE><<<NT, kThreads, smem, stream>>>(
      xyz, vel, weight, q, tiles, new_xyz, nout, B, (long long)NT * B, P, M);
  return (int)cudaGetLastError();
}

template <bool MOVE>
int deposit_dispatch(int order, int bf16, const float* xyz, const float* vel,
                     const float* weight, float q, float* tiles,
                     float* new_xyz, float* nout, int NT, int B, int P, int M,
                     cudaStream_t s) {
  if (order == 0)
    return bf16 ? launch_deposit<0, true, MOVE>(xyz, vel, weight, q, tiles,
                                                new_xyz, nout, NT, B, P, M, s)
                : launch_deposit<0, false, MOVE>(xyz, vel, weight, q, tiles,
                                                 new_xyz, nout, NT, B, P, M, s);
  if (order == 1)
    return bf16 ? launch_deposit<1, true, MOVE>(xyz, vel, weight, q, tiles,
                                                new_xyz, nout, NT, B, P, M, s)
                : launch_deposit<1, false, MOVE>(xyz, vel, weight, q, tiles,
                                                 new_xyz, nout, NT, B, P, M, s);
  return -1;
}

template <int ORDER, bool BF16, int KICK, int C>
int launch_gather(const float* field, const float* xyz, const float* vel,
                  const float* alive, KickParams kp, float* out, float* vdot,
                  int NT, int B, int P, int M, cudaStream_t stream) {
  const size_t smem = (size_t)P * P * P * C * sizeof(float);
  if (int err = prepare(gather_kernel<ORDER, BF16, KICK, C>, smem)) return err;
  gather_kernel<ORDER, BF16, KICK, C><<<NT, kThreads, smem, stream>>>(
      field, xyz, vel, alive, kp, out, vdot, B, (long long)NT * B, P, M);
  return (int)cudaGetLastError();
}

template <int KICK, int C>
int gather_dispatch(int order, int bf16, const float* field, const float* xyz,
                    const float* vel, const float* alive, KickParams kp,
                    float* out, float* vdot, int NT, int B, int P, int M,
                    cudaStream_t s) {
  if (order == 0)
    return bf16 ? launch_gather<0, true, KICK, C>(field, xyz, vel, alive, kp,
                                                  out, vdot, NT, B, P, M, s)
                : launch_gather<0, false, KICK, C>(field, xyz, vel, alive, kp,
                                                   out, vdot, NT, B, P, M, s);
  if (order == 1)
    return bf16 ? launch_gather<1, true, KICK, C>(field, xyz, vel, alive, kp,
                                                  out, vdot, NT, B, P, M, s)
                : launch_gather<1, false, KICK, C>(field, xyz, vel, alive, kp,
                                                   out, vdot, NT, B, P, M, s);
  return -1;
}

}  // namespace

extern "C" {

int pinc_tiled_deposit(const float* xyz, const float* value, float* tiles,
                       int NT, int B, int P, int M, int order, int bf16,
                       void* stream) {
  return deposit_dispatch<false>(order, bf16, xyz, nullptr, value, 0.0f,
                                 tiles, nullptr, nullptr, NT, B, P, M,
                                 (cudaStream_t)stream);
}

int pinc_tiled_deposit_move(const float* xyz, const float* vel,
                            const float* alive, float q, float* tiles,
                            float* new_xyz, float* nout, int NT, int B, int P,
                            int M, int order, int bf16, void* stream) {
  return deposit_dispatch<true>(order, bf16, xyz, vel, alive, q, tiles,
                                new_xyz, nout, NT, B, P, M,
                                (cudaStream_t)stream);
}

int pinc_tiled_gather(const float* field, const float* xyz, float* out,
                      int NT, int B, int P, int M, int C, int order, int bf16,
                      void* stream) {
  KickParams kp = {};
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 3)
    return gather_dispatch<0, 3>(order, bf16, field, xyz, nullptr, nullptr,
                                 kp, out, nullptr, NT, B, P, M, s);
  if (C == 1)
    return gather_dispatch<0, 1>(order, bf16, field, xyz, nullptr, nullptr,
                                 kp, out, nullptr, NT, B, P, M, s);
  return -1;
}

int pinc_tiled_gather_kick(const float* field, const float* xyz,
                           const float* vel, const float* alive, float qm,
                           const float* params9, int boris, float* vel_out,
                           float* vdot, int NT, int B, int P, int M,
                           int order, int bf16, void* stream) {
  KickParams kp;
  kp.qm = qm;
  for (int c = 0; c < 3; ++c) {
    kp.ext[c] = params9[c];
    kp.T[c] = params9[3 + c];
    kp.S[c] = params9[6 + c];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (boris)
    return gather_dispatch<2, 3>(order, bf16, field, xyz, vel, alive, kp,
                                 vel_out, vdot, NT, B, P, M, s);
  return gather_dispatch<1, 3>(order, bf16, field, xyz, vel, alive, kp,
                               vel_out, vdot, NT, B, P, M, s);
}

}  // extern "C"
