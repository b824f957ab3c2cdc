// Device code shared by the exchange kernels: gather_exchange.cu (K8-K10)
// and onehot_exchange.cu (K11).
//
// A tile's B slots are 8 rows of L = B/8 contiguous slots (pinc_tpu's
// (8, B/8) sublane view, whose rows are part of the result: caps, ranks and
// the order in which free slots are filled are per row).  One thread block
// of 8 warps handles one tile, warp w walking row w in 32-slot chunks;
// __ballot_sync + __popc(mask & lanemask_lt) gives each lane its rank inside
// a chunk, and the warp carries the run from chunk to chunk.
//
// Buffers are payload-major (NT, 7, R, W): x, y, z, vx, vy, vz, flag; R = 8
// rows, or R = 1 for the per-tile kernels of K11, whose ranks run over the
// whole tile in slot order.  In each row the valid entries (flag 1.0) form a
// prefix of every run, zero beyond.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: one per row
constexpr int kRows = 8;
constexpr int kNPay = 7;
constexpr int kMaxBlocks = 8;
constexpr unsigned kFull = 0xffffffffu;

// classifier kinds: one axis (classes minus, plus of the given coordinate
// plane), all axes with priority x > y > z (xm, xp, ym, yp, zm, zp), any
// (one class); the C entry points take 0, 1, 2 for the axis of kDim
constexpr int kDim = 0;
constexpr int kAll = 3;
constexpr int kAny = 4;

template <int KIND>
__host__ __device__ constexpr int n_classes() {
  return KIND == kAll ? 6 : (KIND == kAny ? 1 : 2);
}

struct Planes {
  const float* p[6];
};

struct Outs {
  float* p[7];   // cleanup: settled, then two extras per remaining axis
};

struct MutPlanes {
  float* p[6];
};

struct BlockTable {
  int n;
  int off[kMaxBlocks];
  int w[kMaxBlocks];
};

// The merges' table of compacted runs from its host (offset, width) pairs;
// false unless 1..kMaxBlocks runs lie inside [0, KT).
inline bool read_table(const int* table, int nblocks, int KT,
                       BlockTable* bt) {
  if (nblocks < 1 || nblocks > kMaxBlocks) return false;
  bt->n = nblocks;
  for (int b = 0; b < nblocks; ++b) {
    bt->off[b] = table[2 * b];
    bt->w[b] = table[2 * b + 1];
    if (bt->off[b] < 0 || bt->w[b] < 0 || bt->off[b] + bt->w[b] > KT)
      return false;
  }
  return true;
}

// The class of the live slot k, or -1 if it stays.  Comparisons are those
// of pinc_tpu's extract kernels (NaN stays).
template <int KIND>
__device__ __forceinline__ int classify(const Planes& pl, const float* coord,
                                        long long k, float T) {
  if (KIND == kDim) {
    const float c = coord[k];
    return c < 0.0f ? 0 : (c >= T ? 1 : -1);
  }
  const float x = pl.p[0][k], y = pl.p[1][k], z = pl.p[2][k];
  if (KIND == kAll) {
    if (x < 0.0f) return 0;
    if (x >= T) return 1;
    if (y < 0.0f) return 2;
    if (y >= T) return 3;
    if (z < 0.0f) return 4;
    if (z >= T) return 5;
    return -1;
  }
  return (x < 0.0f || x >= T || y < 0.0f || y >= T || z < 0.0f || z >= T)
             ? 0 : -1;
}

// A payload as the kernel stores it.  CANON: x + 0.0f, which turns -0.0
// into +0.0 as pinc_tpu's one-hot selection matmuls do (a sum of one
// product and +0.0 products); the gather kernels copy bits.
template <bool CANON>
__device__ __forceinline__ float stored(float x) {
  return CANON ? __fadd_rn(x, 0.0f) : x;
}

// Zero columns [n, cap) of every payload of one row of one run, thread
// `first` of `step` taking every step-th column.
__device__ __forceinline__ void zero_tail(float* run0, long long pstride,
                                          int n, int cap, int first,
                                          int step) {
#pragma unroll
  for (int p = 0; p < kNPay; ++p)
    for (int i = n + first; i < cap; i += step) run0[p * pstride + i] = 0.0f;
}

// The leaver extract: K8 (R = 8, bit copies) and K11's extract_rows,
// extract_all_rows (R = 8) and extract_fused (R = 1), with CANON.
//
// Every slot reads alive and its classifier's coordinates and writes alive
// (leavers killed); a leaver of class c ranked r < Ks (per row for R = 8,
// per tile in slot order for R = 1) reads its 6 values and writes 7 to
// column c*Ks + r; leavers ranked >= Ks are killed and not copied (dropped).
// Bound: bytes.  Design: velocities are read only for leavers (a few per
// cent of the slots at a re-bucket cadence); a chunk without a leaver costs
// one __any_sync; each buffer entry is written exactly once (a leaver or a
// zero), so the buffer needs no memset.  R = 1 adds a counting pass over
// the classifier planes (each warp's leavers per class, so that warp w
// starts its ranks at the count of the rows before it); the tile's slices
// are read again from L2.
template <int KIND, int R, bool CANON>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const float* __restrict__ alive, const float* coord, Planes pl,
               float* __restrict__ buf, float* __restrict__ alive_out, int B,
               int Ks, float T) {
  constexpr int NCLS = n_classes<KIND>();
  __shared__ int counts[R == 1 ? kRows : 1][NCLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int L = B / kRows;
  const int W = NCLS * Ks;
  const long long base = (long long)blockIdx.x * B + (long long)warp * L;
  const long long pstride = (long long)R * W;
  float* out =
      buf + ((long long)blockIdx.x * kNPay * R + (R == 1 ? 0 : warp)) * W;
  int run[NCLS], total[NCLS];
#pragma unroll
  for (int c = 0; c < NCLS; ++c) run[c] = total[c] = 0;
  if (R == 1) {
    for (int c0 = 0; c0 < L; c0 += 32) {
      const int i = c0 + lane;
      const int cls = i < L && alive[base + i] > 0.5f
                          ? classify<KIND>(pl, coord, base + i, T) : -1;
#pragma unroll
      for (int c = 0; c < NCLS; ++c)
        run[c] += __popc(__ballot_sync(kFull, cls == c));
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NCLS; ++c) counts[warp][c] = run[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      run[c] = 0;
      for (int w = 0; w < kRows; ++w) {
        if (w < warp) run[c] += counts[w][c];
        total[c] += counts[w][c];
      }
    }
  }
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int i = c0 + lane;
    const long long k = base + i;
    int cls = -1;
    if (i < L) {
      const float a = alive[k];
      cls = a > 0.5f ? classify<KIND>(pl, coord, k, T) : -1;
      alive_out[k] = cls >= 0 ? 0.0f : a;
    }
    if (!__any_sync(kFull, cls >= 0)) continue;
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      const unsigned m = __ballot_sync(kFull, cls == c);
      if (cls == c) {
        const int rank = run[c] + __popc(m & lt);
        if (rank < Ks) {
          float* dst = out + c * Ks + rank;
#pragma unroll
          for (int q = 0; q < 6; ++q)
            dst[q * pstride] = stored<CANON>(pl.p[q][k]);
          dst[6 * pstride] = 1.0f;
        }
      }
      run[c] += __popc(m);
    }
  }
#pragma unroll
  for (int c = 0; c < NCLS; ++c) {
    if (R == 1)
      zero_tail(out + c * Ks, pstride, min(total[c], Ks), Ks, threadIdx.x,
                kThreads);
    else
      zero_tail(out + c * Ks, pstride, min(run[c], Ks), Ks, lane, 32);
  }
}

// Launch extract_kernel<kDim or KIND, R, CANON>: kind 0, 1, 2 classify on
// `coord`, kAll and kAny on x, y, z.  Returns the launch error, -1 for a
// kind the kernel does not take.
template <int R, bool CANON>
int launch_extract(int kind, const float* alive, const float* coord,
                   const Planes& pl, float* buf, float* alive_out, int NT,
                   int B, int Ks, float T, cudaStream_t s) {
  switch (kind) {
    case 0:
    case 1:
    case 2:
      extract_kernel<kDim, R, CANON><<<NT, kThreads, 0, s>>>(
          alive, coord, pl, buf, alive_out, B, Ks, T);
      break;
    case kAll:
      extract_kernel<kAll, R, CANON><<<NT, kThreads, 0, s>>>(
          alive, coord, pl, buf, alive_out, B, Ks, T);
      break;
    case kAny:
      extract_kernel<kAny, R, CANON><<<NT, kThreads, 0, s>>>(
          alive, coord, pl, buf, alive_out, B, Ks, T);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace
