// Hand-written Hopper (sm_90a) kernels of the gather-exchange re-bucket:
// extract (K8), cleanup (K10) and merge (K9).
//
// They replace the Pallas TPU kernels of pinc_tpu/ops/pallas_gather_exchange.py
// (_extract_g_kernel, _cleanup_g_kernel and _merge_g_kernel).  Those see a
// tile's B slots as 8 rows of L = B/8 contiguous slots, and count ranks per
// row with a triangular-matrix cumsum per 128-lane chunk plus a binary
// search to invert it.  The row partition is part of the result, so it is
// kept; the arithmetic is not (exchange_common.cuh: one warp per row,
// ballot/popc ranks).  K8 is the shared extract_kernel template; K10 also
// serves pinc_tpu's one-hot cleanup_rows (K11, through
// ops/onehot_exchange.py), whose widths are not multiples of 32 and whose
// copies turn -0.0 into +0.0 (canon = 1).
//
// Layouts (row-major, float32):
//   alive, planes   (NT, B)         B % 256 == 0; row r is [r*L, (r+1)*L)
//   buffers         (NT, 7, 8, W)   payload-major: x, y, z, vx, vy, vz, flag;
//                                   in each row the valid entries (flag 1.0)
//                                   form a prefix of every run, zero beyond
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument the
// kernels do not take).

#include "exchange_common.cuh"

namespace {

// K10.  Replaces _cleanup_g_kernel.  Classes: settled (valid and inside
// every remaining axis, cap W), then minus/plus of each remaining axis in
// order (cap Ke each); the first axis a column is out of wins.  The
// remaining axes are (3 - NAX, ..., 2), the tuples the drivers use.  Any
// W and Ke; CANON copies as stored<true> (the one-hot cleanup_rows).
// Bound: bytes: the flag plane is read, a valid column reads 7 floats and
// writes 7, and every output is written once (entries or zeros).
template <int NAX, bool CANON>
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
    const bool valid = j < W && in[6 * ipstride + j] > 0.5f;
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
            dst[p * opstride] = stored<CANON>(in[p * ipstride + j]);
        }
      }
      run[c] += __popc(m);
    }
  }
#pragma unroll
  for (int c = 0; c < NCLS; ++c) {
    const int cap = c == 0 ? W : Ke;
    zero_tail(outs.p[c] + tile_row * cap, (long long)kRows * cap,
              min(run[c], cap), cap, lane, 32);
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

template <int NAX>
int launch_cleanup(const float* inc, const Outs& outs, int NT, int W, int Ke,
                   int canon, float T, cudaStream_t stream) {
  if (canon)
    cleanup_kernel<NAX, true><<<NT, kThreads, 0, stream>>>(inc, outs, W, Ke, T);
  else
    cleanup_kernel<NAX, false><<<NT, kThreads, 0, stream>>>(inc, outs, W, Ke,
                                                            T);
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
  const float* coord = kind >= 0 && kind < 3 ? pl.p[kind] : nullptr;
  return launch_extract<kRows, false>(kind, alive, coord, pl, buf, alive_out,
                                      NT, B, Ks, T, (cudaStream_t)stream);
}

int pinc_gx_cleanup(const float* inc, float* settled, float* e0, float* e1,
                    float* e2, float* e3, float* e4, float* e5, int NT, int W,
                    int Ke, int naxes, int canon, float T, void* stream) {
  if (NT <= 0 || W <= 0 || Ke <= 0) return -1;
  const Outs outs = {{settled, e0, e1, e2, e3, e4, e5}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (naxes) {
    case 3: return launch_cleanup<3>(inc, outs, NT, W, Ke, canon, T, s);
    case 2: return launch_cleanup<2>(inc, outs, NT, W, Ke, canon, T, s);
    case 1: return launch_cleanup<1>(inc, outs, NT, W, Ke, canon, T, s);
    default: return -1;
  }
}

int pinc_gx_merge(float* alive, const float* inc, float* x, float* y,
                  float* z, float* vx, float* vy, float* vz,
                  const int* table, int nblocks, int NT, int B, int KT,
                  void* stream) {
  BlockTable bt = {};
  if (NT <= 0 || B <= 0 || B % (kRows * 32) != 0 ||
      !read_table(table, nblocks, KT, &bt))
    return -1;
  const MutPlanes pl = {{x, y, z, vx, vy, vz}};
  merge_kernel<<<NT, kThreads, 0, (cudaStream_t)stream>>>(alive, inc, pl, bt,
                                                          B, KT);
  return (int)cudaGetLastError();
}

}  // extern "C"
