// Hand-written Hopper (sm_90a) kernels of the gather-exchange re-bucket:
// extract (K8), cleanup (K10) and merge (K9).
//
// They replace the Pallas TPU kernels of pinc_tpu/ops/pallas_gather_exchange.py
// (_extract_g_kernel, _cleanup_g_kernel and _merge_g_kernel).  Those see a
// tile's B slots as 8 rows of L = B/8 contiguous slots, and count ranks per
// row with a triangular-matrix cumsum per 128-lane chunk plus a binary
// search to invert it.  The row partition is part of the result (caps,
// ranks and the order in which free slots are filled are per row), so it is
// kept; the arithmetic is not: here one warp walks one row in 32-slot
// chunks, __ballot_sync + __popc(mask & lanemask_lt) gives each lane its
// rank inside the chunk, and the warp carries the run from chunk to chunk.
// One thread block of 8 warps per tile.
//
// Layouts (row-major, float32):
//   alive, planes   (NT, B)         B % 1024 == 0; row r is [r*L, (r+1)*L)
//   buffers         (NT, 7, 8, W)   payload-major: x, y, z, vx, vy, vz, flag;
//                                   in each row the valid entries (flag 1.0)
//                                   form a prefix of every run, zero beyond
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument the
// kernels do not take).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: one per row
constexpr int kRows = 8;
constexpr int kNPay = 7;
constexpr int kMaxBlocks = 8;
constexpr unsigned kFull = 0xffffffffu;

// classifier kinds of the extract: per-axis 0, 1, 2 (classes minus, plus),
// all axes with priority x > y > z (xm, xp, ym, yp, zm, zp), any (one class)
constexpr int kAll = 3;
constexpr int kAny = 4;

// The class of a live slot at tile-local (x, y, z), or -1 if it stays.
// Comparisons are those of pallas_gather_exchange._classify_*.
template <int KIND>
__device__ __forceinline__ int classify(float x, float y, float z, float T) {
  if (KIND < 3) {
    const float c = KIND == 0 ? x : (KIND == 1 ? y : z);
    return c < 0.0f ? 0 : (c >= T ? 1 : -1);
  }
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

// Zero columns [n, cap) of every payload of one row of one run.
__device__ __forceinline__ void zero_tail(float* run0, long long pstride,
                                          int n, int cap, int lane) {
#pragma unroll
  for (int p = 0; p < kNPay; ++p)
    for (int i = n + lane; i < cap; i += 32) run0[p * pstride + i] = 0.0f;
}

// K8.  Replaces _extract_g_kernel.  Bound: bytes.  Every slot reads alive,
// x, y, z (16 B) and writes alive (4 B); a leaver also reads its velocity
// (12 B) and writes 7 floats; the rest of the buffer is written as zeros
// once.  Design: velocities are read only for leavers (a few per cent of
// the slots at a re-bucket cadence); a chunk without a leaver costs one
// __any_sync; each buffer entry is written exactly once (a leaver or a
// zero), so the buffer needs no memset.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const float* __restrict__ alive, Planes pl,
               float* __restrict__ buf, float* __restrict__ alive_out, int B,
               int Ks, float T) {
  constexpr int NCLS = KIND == kAll ? 6 : (KIND == kAny ? 1 : 2);
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int L = B / kRows;
  const int W = NCLS * Ks;
  const long long base = (long long)blockIdx.x * B + (long long)row * L;
  const long long pstride = (long long)kRows * W;
  float* out = buf + ((long long)blockIdx.x * kNPay * kRows + row) * W;
  int run[NCLS];
#pragma unroll
  for (int c = 0; c < NCLS; ++c) run[c] = 0;
  for (int c0 = 0; c0 < L; c0 += 32) {
    const long long k = base + c0 + lane;
    const float a = alive[k];
    const float x = pl.p[0][k], y = pl.p[1][k], z = pl.p[2][k];
    const int cls = a > 0.5f ? classify<KIND>(x, y, z, T) : -1;
    alive_out[k] = cls >= 0 ? 0.0f : a;
    if (!__any_sync(kFull, cls >= 0)) continue;
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      const unsigned m = __ballot_sync(kFull, cls == c);
      if (cls == c) {
        const int rank = run[c] + __popc(m & lt);
        if (rank < Ks) {
          float* dst = out + c * Ks + rank;
          dst[0] = x;
          dst[pstride] = y;
          dst[2 * pstride] = z;
          dst[3 * pstride] = pl.p[3][k];
          dst[4 * pstride] = pl.p[4][k];
          dst[5 * pstride] = pl.p[5][k];
          dst[6 * pstride] = 1.0f;
        }
      }
      run[c] += __popc(m);
    }
  }
#pragma unroll
  for (int c = 0; c < NCLS; ++c)
    zero_tail(out + c * Ks, pstride, min(run[c], Ks), Ks, lane);
}

// K10.  Replaces _cleanup_g_kernel.  Classes: settled (valid and inside
// every remaining axis, cap W), then minus/plus of each remaining axis in
// order (cap Ke each); the first axis a column is out of wins.  The
// remaining axes are (3 - NAX, ..., 2), the tuples the drivers use.
// Bound: bytes: the flag plane is read, a valid column reads 7 floats and
// writes 7, and every output is written once (entries or zeros).
template <int NAX>
__global__ void __launch_bounds__(kThreads)
cleanup_kernel(const float* __restrict__ inc, Outs outs, int W, int Ke,
               float T) {
  constexpr int NCLS = 1 + 2 * NAX;
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const long long tile_row = (long long)blockIdx.x * kNPay * kRows + row;
  const long long ipstride = (long long)kRows * W;
  const float* in = inc + tile_row * W;
  int run[NCLS];
#pragma unroll
  for (int c = 0; c < NCLS; ++c) run[c] = 0;
  for (int c0 = 0; c0 < W; c0 += 32) {
    const int j = c0 + lane;
    const bool valid = in[6 * ipstride + j] > 0.5f;
    if (!__any_sync(kFull, valid)) continue;
    int cls = -1;
    if (valid) {
      cls = 0;
#pragma unroll
      for (int a = 0; a < NAX; ++a) {
        const float cc = in[(3 - NAX + a) * ipstride + j];
        if (cc < 0.0f) {
          cls = 1 + 2 * a;
          break;
        }
        if (cc >= T) {
          cls = 2 + 2 * a;
          break;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      const unsigned m = __ballot_sync(kFull, cls == c);
      if (cls == c) {
        const int cap = c == 0 ? W : Ke;
        const int rank = run[c] + __popc(m & lt);
        if (rank < cap) {
          const long long opstride = (long long)kRows * cap;
          float* dst = outs.p[c] + tile_row * cap + rank;
#pragma unroll
          for (int p = 0; p < kNPay; ++p)
            dst[p * opstride] = in[p * ipstride + j];
        }
      }
      run[c] += __popc(m);
    }
  }
#pragma unroll
  for (int c = 0; c < NCLS; ++c) {
    const int cap = c == 0 ? W : Ke;
    zero_tail(outs.p[c] + tile_row * cap, (long long)kRows * cap,
              min(run[c], cap), cap, lane);
  }
}

// K9.  Replaces _merge_g_kernel.  Pass 0: row r's free slots (alive <=
// 0.5), in slot order, take row r's arrivals in block order.  Spill pass
// p = 1..7 (only while the tile has leftovers): row r's remaining free
// slots take the leftovers of row (r - p) % 8, from that row's consumed
// count on.  Arrivals still unplaced are dropped.  The arrivals are written
// IN PLACE into the planes and alive; no other slot is touched, so a dead
// slot that is not refilled keeps its stale payload, as in pinc_tpu.
// Bound: bytes: the alive plane up to the last free slot a row needs, the
// flag plane, and 24 B read plus 28 B written per placed arrival.  Design:
// per-row block counts and per-source-row consumed counters in shared
// memory; each slot is always handled by the same lane, which therefore
// reads back its own alive writes in later passes.
__global__ void __launch_bounds__(kThreads)
merge_kernel(float* __restrict__ alive, const float* __restrict__ inc,
             MutPlanes pl, BlockTable bt, int B, int KT) {
  __shared__ int nb[kRows][kMaxBlocks];
  __shared__ int narr[kRows];
  __shared__ int consumed[kRows];
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const long long ipstride = (long long)kRows * KT;
  const float* tile_in = inc + (long long)blockIdx.x * kNPay * kRows * KT;

  int total = 0;
  for (int b = 0; b < bt.n; ++b) {
    const float* flag = tile_in + 6 * ipstride + (long long)row * KT + bt.off[b];
    int cnt = 0;
    for (int c0 = 0; c0 < bt.w[b]; c0 += 32) {
      const int j = c0 + lane;
      cnt += __popc(__ballot_sync(kFull, j < bt.w[b] && flag[j] > 0.5f));
    }
    if (lane == 0) nb[row][b] = cnt;
    total += cnt;
  }
  if (lane == 0) {
    narr[row] = total;
    consumed[row] = 0;
  }
  __syncthreads();

  const int L = B / kRows;
  const long long base = (long long)blockIdx.x * B + (long long)row * L;
  for (int p = 0; p < kRows; ++p) {
    if (p > 0) {
      int left = 0;
      for (int s = 0; s < kRows; ++s) left += narr[s] - consumed[s];
      if (left == 0) break;
    }
    const int s = (row - p) & (kRows - 1);
    const int first = consumed[s];
    const int avail = narr[s] - first;
    int taken = 0;
    if (avail > 0) {
      int run = 0;
      for (int c0 = 0; c0 < L && run < avail; c0 += 32) {
        const long long k = base + c0 + lane;
        const bool is_free = alive[k] <= 0.5f;
        const unsigned m = __ballot_sync(kFull, is_free);
        const int frank = run + __popc(m & lt);
        if (is_free && frank < avail) {
          int arank = first + frank;
          int b = 0;
          while (arank >= nb[s][b]) arank -= nb[s][b++];
          const float* src = tile_in + (long long)s * KT + bt.off[b] + arank;
#pragma unroll
          for (int q = 0; q < 6; ++q) pl.p[q][k] = src[q * ipstride];
          alive[k] = 1.0f;
        }
        run += __popc(m);
      }
      taken = min(run, avail);
    }
    __syncthreads();
    if (lane == 0) consumed[s] += taken;
    __syncthreads();
  }
}

template <int KIND>
int launch_extract(const float* alive, const Planes& pl, float* buf,
                   float* alive_out, int NT, int B, int Ks, float T,
                   cudaStream_t stream) {
  extract_kernel<KIND><<<NT, kThreads, 0, stream>>>(alive, pl, buf,
                                                    alive_out, B, Ks, T);
  return (int)cudaGetLastError();
}

template <int NAX>
int launch_cleanup(const float* inc, const Outs& outs, int NT, int W, int Ke,
                   float T, cudaStream_t stream) {
  cleanup_kernel<NAX><<<NT, kThreads, 0, stream>>>(inc, outs, W, Ke, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pinc_gx_extract(const float* alive, const float* x, const float* y,
                    const float* z, const float* vx, const float* vy,
                    const float* vz, float* buf, float* alive_out, int NT,
                    int B, int kind, int Ks, float T, void* stream) {
  if (NT <= 0 || B <= 0 || B % (kRows * 32) != 0 || Ks <= 0) return -1;
  const Planes pl = {{x, y, z, vx, vy, vz}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: return launch_extract<0>(alive, pl, buf, alive_out, NT, B, Ks, T, s);
    case 1: return launch_extract<1>(alive, pl, buf, alive_out, NT, B, Ks, T, s);
    case 2: return launch_extract<2>(alive, pl, buf, alive_out, NT, B, Ks, T, s);
    case kAll:
      return launch_extract<kAll>(alive, pl, buf, alive_out, NT, B, Ks, T, s);
    case kAny:
      return launch_extract<kAny>(alive, pl, buf, alive_out, NT, B, Ks, T, s);
    default: return -1;
  }
}

int pinc_gx_cleanup(const float* inc, float* settled, float* e0, float* e1,
                    float* e2, float* e3, float* e4, float* e5, int NT, int W,
                    int Ke, int naxes, float T, void* stream) {
  if (NT <= 0 || W <= 0 || W % 32 != 0 || Ke <= 0) return -1;
  const Outs outs = {{settled, e0, e1, e2, e3, e4, e5}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (naxes) {
    case 3: return launch_cleanup<3>(inc, outs, NT, W, Ke, T, s);
    case 2: return launch_cleanup<2>(inc, outs, NT, W, Ke, T, s);
    case 1: return launch_cleanup<1>(inc, outs, NT, W, Ke, T, s);
    default: return -1;
  }
}

int pinc_gx_merge(float* alive, const float* inc, float* x, float* y,
                  float* z, float* vx, float* vy, float* vz,
                  const int* table, int nblocks, int NT, int B, int KT,
                  void* stream) {
  if (NT <= 0 || B <= 0 || B % (kRows * 32) != 0 || nblocks < 1 ||
      nblocks > kMaxBlocks)
    return -1;
  BlockTable bt = {};
  bt.n = nblocks;
  for (int b = 0; b < nblocks; ++b) {
    bt.off[b] = table[2 * b];
    bt.w[b] = table[2 * b + 1];
    if (bt.off[b] < 0 || bt.w[b] < 0 || bt.off[b] + bt.w[b] > KT) return -1;
  }
  const MutPlanes pl = {{x, y, z, vx, vy, vz}};
  merge_kernel<<<NT, kThreads, 0, (cudaStream_t)stream>>>(alive, inc, pl, bt,
                                                          B, KT);
  return (int)cudaGetLastError();
}

}  // extern "C"
