// Hand-written Hopper (sm_90a) kernels of the tiled PIC step:
// deposit, deposit_move, gather, gather_kick and pic_step.
//
// They replace the Pallas TPU kernels of pinc_tpu/ops/pallas_tiled.py
// (_deposit_kernel, _deposit_move_kernel, _gather_kernel,
// _gather_kick_kernel and the mega-fused _pic_step_kernel).  The TPU
// kernels build dense (P, B) and (P*P, B) hat-weight matrices over every
// node of the padded tile block and contract them on the matrix unit.  On
// Hopper a slot touches only its 2x2x2 (CIC) or single (NGP) nodes, so
// these kernels work per slot instead: one thread
// block per tile, the tile's padded node block in shared memory (the
// accumulator of a deposit, the field of a gather), threads striding over
// the tile's B slots.  Deposits add into shared memory with atomics and
// write each tile's block once, with no global atomics.  K1, K2 and
// pic_step sum in integers, a pair of int32 fixed-point blocks that each
// add with one native ATOMS.ADD (a float32 or 64-bit shared atomicAdd is a
// compare-and-swap loop on sm_90a, ATOMS.CAST.SPIN), so their tiles do not
// depend on the order of the adds (acc_add, csrc/fixed_point.cuh).
//
// Layouts (row-major, float32):
//   xyz, vel      (3, NT, B)    tile-local coordinate / velocity planes
//   value, alive  (NT, B)
//   tiles         (NT, P, P*P)  padded node block, offsets -M..T+M, x major
//   field         (NT, P, P, P, C)
//   gathered      (C, NT, B)
//   lpos, vel     (S, 3, NT, B) and alive (S, NT, B): pic_step's species
//   E tiles       (NT, 3P, P*P) component-major field, f32 or bf16
//                 (pic_step; ops/field_kernels.efield_tiles writes it)
// with P = T + 1 + 2M.  Weights follow pallas_tiled._w1d: max(0, 1-|x-n|)
// (CIC) or the half-open indicator -0.5 <= x-n < 0.5 (NGP), evaluated for
// the nodes n = floor(x) and floor(x)+1; a node outside [-M, T+M]
// contributes nothing, so dead slots (parked at -2M-2) and margin leavers
// deposit and gather exactly what the TPU kernels do.  pic_step works per
// species at margins (mg, md) <= M inside the layout of margin M: the node
// range test uses mg or md, the block index M, which is what the TPU
// kernel's 0/1 embed matmuls compute.  With bf16 weights the products
// wx*value and wy*wz (deposit), and E and wy*wz (gather), are rounded to
// bf16 at the same points as the TPU kernels; all sums are float32 but
// the deposits' densities, whose integer sums are converted back once a
// node.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument
// the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "fixed_point.cuh"

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
// the padded block of layout margin M (0..P-1) and weight (0 outside
// [-m, T+m], m <= M the margin the call works at).
template <int ORDER>
__device__ __forceinline__ void nodes_m(float x, int m, int M, int T,
                                        int idx[2], float w[2]) {
  const float f = floorf(x);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float n = f + (float)k;
    const bool inside = n >= (float)(-m) && n <= (float)(T + m);
    w[k] = inside ? w1d<ORDER>(x - n) : 0.0f;
    idx[k] = inside ? (int)n + M : 0;
  }
}

template <int ORDER>
__device__ __forceinline__ void nodes(float x, int M, int T, int idx[2],
                                      float w[2]) {
  nodes_m<ORDER>(x, M, M, T, idx, w);
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
// The tile's density sums in the int32 pair (acc_add, 2 P^3 ints of shared
// memory) at the launch's grid fp.
template <int ORDER, bool BF16, bool MOVE>
__global__ void __launch_bounds__(kThreads)
deposit_kernel(const float* __restrict__ xyz, const float* __restrict__ vel,
               const float* __restrict__ weight, float q, FixedPoint fp,
               float* __restrict__ tiles, float* __restrict__ new_xyz,
               float* __restrict__ nout, int B, long long plane, int P,
               int M) {
  extern __shared__ int acc_hi[];  // density, 2^-k units
  __shared__ float red[kThreads / 32];
  const int T = P - 1 - 2 * M;
  const int P2 = P * P, P3 = P2 * P;
  int* acc_lo = acc_hi + P3;       // residual, 2^-(k+j) units
  for (int i = threadIdx.x; i < 2 * P3; i += blockDim.x) acc_hi[i] = 0;
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
          acc_add(acc_hi, acc_lo, ix[a] * P2 + iy[b] * P + iz[c],
                  __fmul_rn(wa, wyz), fp);
        }
      }
    }
  }
  __syncthreads();
  float* out = tiles + (long long)blockIdx.x * P3;
  for (int i = threadIdx.x; i < P3; i += blockDim.x)
    out[i] = acc_value(acc_hi, acc_lo, i, fp);
  if (MOVE) {
    const float s = block_sum(bad, red);
    if (threadIdx.x == 0) nout[blockIdx.x] = s;
  }
}

// The kick of pallas_tiled._kick_rows: KICK = 1 the leapfrog kick
// v + qm E with vdot = v.(v+dv); KICK = 2 the Boris rotation (T, S) with
// vdot = |v_plus|^2.  Writes the unmasked new velocity to vn, returns vdot.
// Every product and sum is rounded on its own (no fused multiply-add), in
// the order of the plain version, so the two agree bit for bit on the
// same field.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}
// a + a x b
__device__ __forceinline__ void add_cross(const float a[3], const float b[3],
                                          const float base[3], float o[3]) {
  o[0] = add(base[0], sub(mul(a[1], b[2]), mul(a[2], b[1])));
  o[1] = add(base[1], sub(mul(a[2], b[0]), mul(a[0], b[2])));
  o[2] = add(base[2], sub(mul(a[0], b[1]), mul(a[1], b[0])));
}

template <int KICK>
__device__ __forceinline__ float kick(const float v[3], const float E[3],
                                      float qm, const float Tv[3],
                                      const float Sv[3], float vn[3]) {
  if (KICK == 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) vn[c] = add(v[c], mul(qm, E[c]));
    return dot3(v, vn);
  }
  const float hq = 0.5f * qm;
  float h[3], vm[3], vp[3], vl[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    h[c] = mul(hq, E[c]);
    vm[c] = add(v[c], h[c]);
  }
  add_cross(vm, Tv, vm, vp);   // v' = v- + v- x T
  add_cross(vp, Sv, vm, vl);   // v+ = v- + v' x S
#pragma unroll
  for (int c = 0; c < 3; ++c) vn[c] = add(vl[c], h[c]);
  return dot3(vl, vl);
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
    float v[3], E[3], vn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = vel[c * plane + k];
      E[c] = e[c < C ? c : 0] + kp.ext[c];
    }
    const float vd = kick<KICK>(v, E, kp.qm, kp.T, kp.S, vn);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * plane + k] = v[c] + al * (vn[c] - v[c]);
    vdot_acc += vd * al;
  }
  if (KICK != 0) {
    const float s = block_sum(vdot_acc, red);
    if (threadIdx.x == 0) vdot_out[blockIdx.x] = s;
  }
}


constexpr int kMaxSpecies = 8;

// Per-species parameters of pic_step, passed by value.
struct StepParams {
  float q[kMaxSpecies];       // deposit charge
  float qm[kMaxSpecies];      // kick factor q/m (dt folded in)
  float T[kMaxSpecies][3];    // Boris rotation vectors
  float S[kMaxSpecies][3];
  int mg[kMaxSpecies];        // gather margin, <= M
  int md[kMaxSpecies];        // deposit margin, <= M
  float ext[3];               // external E
  FixedPoint fp;              // the density's fixed point
  int nspecies;
};

// Sums a and b over the block into thread 0's a and b, then syncs so that
// red can be used again.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[kThreads / 32]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = 0.0f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      a += red[0][i];
      b += red[1][i];
    }
  }
  __syncthreads();
}

// K5: the particle half of a step for every species, one block per tile.
// The tile's E block (3 P^3, rounded to bf16 when BF16) is loaded into
// shared memory once for all species, and its density block (P^3)
// accumulates in shared memory across species, in integers (acc_add), and
// is written once.  Per slot: gather E(x_n) at nodes in [-mg, T+mg], the
// kick (+ ext), the alive-masked update v + alive (v' - v), the drift
// x + v of every slot, the margin count of live slots outside [-md, T+md),
// and the deposit of alive*q at x_{n+1} on nodes in [-md, T+md].  Each
// thread reads its slot's x and v before writing them, so lpos_out/vel_out
// may alias lpos/vel (the in-place step).  vdot and n_out are reduced per
// block into (S, NT) partials.
template <int OACC, int ODEP, bool BF16, int KICK>
__global__ void __launch_bounds__(kThreads)
pic_step_kernel(const void* __restrict__ E, int e_bf16, const float* lpos,
                const float* vel, const float* __restrict__ alive,
                StepParams sp, float* __restrict__ tiles, float* lpos_out,
                float* vel_out, float* __restrict__ vdot_out,
                float* __restrict__ nout_out, int NT, int B, int P, int M) {
  extern __shared__ float smem[];
  __shared__ float red[2][kThreads / 32];
  const int T = P - 1 - 2 * M;
  const int P2 = P * P, P3 = P2 * P;
  int* acc_hi = reinterpret_cast<int*>(smem);  // density, 2^-k units
  int* acc_lo = acc_hi + P3;                    // residual, 2^-(k+j) units
  float* F = smem + 2 * P3;                     // E, component-major (3, P^3)
  const long long ebase = (long long)blockIdx.x * 3 * P3;
  for (int i = threadIdx.x; i < 3 * P3; i += blockDim.x) {
    const float e =
        e_bf16 ? __bfloat162float(
                     static_cast<const __nv_bfloat16*>(E)[ebase + i])
               : static_cast<const float*>(E)[ebase + i];
    F[i] = BF16 ? to_bf16(e) : e;
  }
  for (int i = threadIdx.x; i < 2 * P3; i += blockDim.x) acc_hi[i] = 0;
  __syncthreads();
  const long long plane = (long long)NT * B;
  for (int s = 0; s < sp.nspecies; ++s) {
    const float q = sp.q[s], qm = sp.qm[s];
    const float Tv[3] = {sp.T[s][0], sp.T[s][1], sp.T[s][2]};
    const float Sv[3] = {sp.S[s][0], sp.S[s][1], sp.S[s][2]};
    const int mg = sp.mg[s], md = sp.md[s];
    const float lo = (float)(-md), hi = (float)(T + md);
    const long long sbase = 3 * s * plane + (long long)blockIdx.x * B;
    const long long abase = s * plane + (long long)blockIdx.x * B;
    float vd_acc = 0.0f, bad = 0.0f;
    for (int j = threadIdx.x; j < B; j += blockDim.x) {
      const long long k = sbase + j;
      const float x[3] = {lpos[k], lpos[plane + k], lpos[2 * plane + k]};
      float v[3] = {vel[k], vel[plane + k], vel[2 * plane + k]};
      const float al = alive[abase + j];
      int ix[2], iy[2], iz[2];
      float wx[2], wy[2], wz[2];
      nodes_m<OACC>(x[0], mg, M, T, ix, wx);
      nodes_m<OACC>(x[1], mg, M, T, iy, wy);
      nodes_m<OACC>(x[2], mg, M, T, iz, wz);
      float e[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (wx[a] == 0.0f) continue;
        float g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float wyz = wy[b] * wz[c];
            if (BF16) wyz = to_bf16(wyz);
            if (wyz == 0.0f) continue;
            const float* f = F + ix[a] * P2 + iy[b] * P + iz[c];
#pragma unroll
            for (int d = 0; d < 3; ++d) g[d] = add(g[d], mul(f[d * P3], wyz));
          }
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) e[d] = add(e[d], mul(wx[a], g[d]));
      }
      float En[3], vn[3], xn[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) En[d] = add(e[d], sp.ext[d]);
      const float vd = kick<KICK>(v, En, qm, Tv, Sv, vn);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        vn[d] = add(v[d], mul(al, sub(vn[d], v[d])));
        xn[d] = add(x[d], vn[d]);
        vel_out[d * plane + k] = vn[d];
        lpos_out[d * plane + k] = xn[d];
      }
      vd_acc = add(vd_acc, mul(vd, al));
      if (xn[0] < lo || xn[0] >= hi || xn[1] < lo || xn[1] >= hi ||
          xn[2] < lo || xn[2] >= hi)
        bad += al;
      const float val = al * q;
      if (val == 0.0f) continue;
      nodes_m<ODEP>(xn[0], md, M, T, ix, wx);
      nodes_m<ODEP>(xn[1], md, M, T, iy, wy);
      nodes_m<ODEP>(xn[2], md, M, T, iz, wz);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float wa = wx[a] * val;
        if (BF16) wa = to_bf16(wa);
        if (wa == 0.0f) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float wyz = wy[b] * wz[c];
            if (BF16) wyz = to_bf16(wyz);
            if (wyz == 0.0f) continue;
            acc_add(acc_hi, acc_lo, ix[a] * P2 + iy[b] * P + iz[c],
                    mul(wa, wyz), sp.fp);
          }
        }
      }
    }
    block_sum2(vd_acc, bad, red);
    if (threadIdx.x == 0) {
      vdot_out[s * NT + blockIdx.x] = vd_acc;
      nout_out[s * NT + blockIdx.x] = bad;
    }
  }
  __syncthreads();
  float* out = tiles + (long long)blockIdx.x * P3;
  for (int i = threadIdx.x; i < P3; i += blockDim.x)
    out[i] = acc_value(acc_hi, acc_lo, i, sp.fp);
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
                   float q, const FixedPoint& fp, float* tiles,
                   float* new_xyz, float* nout, int NT, int B, int P, int M,
                   cudaStream_t stream) {
  const size_t smem = (size_t)2 * P * P * P * sizeof(int);  // the int32 pair
  if (int err = prepare(deposit_kernel<ORDER, BF16, MOVE>, smem)) return err;
  deposit_kernel<ORDER, BF16, MOVE><<<NT, kThreads, smem, stream>>>(
      xyz, vel, weight, q, fp, tiles, new_xyz, nout, B, (long long)NT * B, P,
      M);
  return (int)cudaGetLastError();
}

template <bool MOVE>
int deposit_dispatch(int order, int bf16, const float* xyz, const float* vel,
                     const float* weight, float q, int k, int j,
                     float* tiles, float* new_xyz, float* nout, int NT, int B,
                     int P, int M, cudaStream_t s) {
  FixedPoint fp;
  if (!fixed_point(k, j, &fp)) return -1;
  if (order == 0)
    return bf16 ? launch_deposit<0, true, MOVE>(xyz, vel, weight, q, fp,
                                                tiles, new_xyz, nout, NT, B,
                                                P, M, s)
                : launch_deposit<0, false, MOVE>(xyz, vel, weight, q, fp,
                                                 tiles, new_xyz, nout, NT, B,
                                                 P, M, s);
  if (order == 1)
    return bf16 ? launch_deposit<1, true, MOVE>(xyz, vel, weight, q, fp,
                                                tiles, new_xyz, nout, NT, B,
                                                P, M, s)
                : launch_deposit<1, false, MOVE>(xyz, vel, weight, q, fp,
                                                 tiles, new_xyz, nout, NT, B,
                                                 P, M, s);
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

template <int OACC, int ODEP, bool BF16, int KICK>
int launch_pic_step(const void* E, int e_bf16, const float* lpos,
                    const float* vel, const float* alive,
                    const StepParams& sp, float* tiles, float* lpos_out,
                    float* vel_out, float* vdot, float* nout, int NT, int B,
                    int P, int M, cudaStream_t stream) {
  // the int32 pair (2 P^3) and E (3 P^3)
  const size_t smem = (size_t)5 * P * P * P * sizeof(float);
  auto* kernel = pic_step_kernel<OACC, ODEP, BF16, KICK>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<NT, kThreads, smem, stream>>>(E, e_bf16, lpos, vel, alive, sp,
                                          tiles, lpos_out, vel_out, vdot,
                                          nout, NT, B, P, M);
  return (int)cudaGetLastError();
}

template <int OACC, int ODEP>
int pic_step_dispatch(int bf16, int boris, const void* E, int e_bf16,
                      const float* lpos, const float* vel,
                      const float* alive, const StepParams& sp, float* tiles,
                      float* lpos_out, float* vel_out, float* vdot,
                      float* nout, int NT, int B, int P, int M,
                      cudaStream_t s) {
  if (bf16)
    return boris ? launch_pic_step<OACC, ODEP, true, 2>(
                       E, e_bf16, lpos, vel, alive, sp, tiles, lpos_out,
                       vel_out, vdot, nout, NT, B, P, M, s)
                 : launch_pic_step<OACC, ODEP, true, 1>(
                       E, e_bf16, lpos, vel, alive, sp, tiles, lpos_out,
                       vel_out, vdot, nout, NT, B, P, M, s);
  return boris ? launch_pic_step<OACC, ODEP, false, 2>(
                     E, e_bf16, lpos, vel, alive, sp, tiles, lpos_out,
                     vel_out, vdot, nout, NT, B, P, M, s)
               : launch_pic_step<OACC, ODEP, false, 1>(
                     E, e_bf16, lpos, vel, alive, sp, tiles, lpos_out,
                     vel_out, vdot, nout, NT, B, P, M, s);
}

}  // namespace

extern "C" {

// k and j: the exponents of the density's fixed point (FixedPoint)
int pinc_tiled_deposit(const float* xyz, const float* value, float* tiles,
                       int NT, int B, int P, int M, int order, int bf16,
                       void* stream, int k, int j) {
  return deposit_dispatch<false>(order, bf16, xyz, nullptr, value, 0.0f, k,
                                 j, tiles, nullptr, nullptr, NT, B, P, M,
                                 (cudaStream_t)stream);
}

int pinc_tiled_deposit_move(const float* xyz, const float* vel,
                            const float* alive, float q, float* tiles,
                            float* new_xyz, float* nout, int NT, int B, int P,
                            int M, int order, int bf16, void* stream, int k,
                            int j) {
  return deposit_dispatch<true>(order, bf16, xyz, vel, alive, q, k, j, tiles,
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

int pinc_tiled_pic_step(const void* E, int e_bf16, const float* lpos,
                        const float* vel, const float* alive,
                        const float* params, int S, int boris, float* tiles,
                        float* lpos_out, float* vel_out, float* vdot,
                        float* nout, int NT, int B, int P, int M,
                        int order_acc, int order_distr, int bf16,
                        void* stream) {
  // params (host): per species q, qm, T[3], S[3], mg, md; then ext[3],
  // and the density's scale exponents k and j
  if (S < 1 || S > kMaxSpecies) return -1;
  StepParams sp = {};
  sp.nspecies = S;
  for (int s = 0; s < S; ++s) {
    const float* p = params + 10 * s;
    sp.q[s] = p[0];
    sp.qm[s] = p[1];
    for (int c = 0; c < 3; ++c) {
      sp.T[s][c] = p[2 + c];
      sp.S[s][c] = p[5 + c];
    }
    sp.mg[s] = (int)p[8];
    sp.md[s] = (int)p[9];
    if (sp.mg[s] < 0 || sp.mg[s] > M || sp.md[s] < 1 || sp.md[s] > M)
      return -1;
  }
  for (int c = 0; c < 3; ++c) sp.ext[c] = params[10 * S + c];
  if (!fixed_point((int)params[10 * S + 3], (int)params[10 * S + 4],
                   &sp.fp))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if ((order_acc != 0 && order_acc != 1) ||
      (order_distr != 0 && order_distr != 1))
    return -1;
  if (order_acc == 0)
    return order_distr == 0
               ? pic_step_dispatch<0, 0>(bf16, boris, E, e_bf16, lpos, vel,
                                         alive, sp, tiles, lpos_out, vel_out,
                                         vdot, nout, NT, B, P, M, s)
               : pic_step_dispatch<0, 1>(bf16, boris, E, e_bf16, lpos, vel,
                                         alive, sp, tiles, lpos_out, vel_out,
                                         vdot, nout, NT, B, P, M, s);
  return order_distr == 0
             ? pic_step_dispatch<1, 0>(bf16, boris, E, e_bf16, lpos, vel,
                                       alive, sp, tiles, lpos_out, vel_out,
                                       vdot, nout, NT, B, P, M, s)
             : pic_step_dispatch<1, 1>(bf16, boris, E, e_bf16, lpos, vel,
                                       alive, sp, tiles, lpos_out, vel_out,
                                       vdot, nout, NT, B, P, M, s);
}

}  // extern "C"
