// Hand-written Hopper (sm_90a) kernels of pinc_tpu's one-hot exchange
// re-bucket (K11, pinc_tpu/ops/pallas_exchange.py).
//
// The TPU kernels select leavers and place arrivals with one-hot matmuls
// (each output a sum of exactly one payload product, split bf16x3 to stay
// bit-exact), and rank them with triangular-matrix scans.  Here ranks come
// from __ballot_sync/__popc and every value is copied by index, as x + 0.0f
// (the matmuls' sums turn -0.0 into +0.0; every other finite value is
// copied exactly).  What the TPU kernels compute is kept: the row partition
// (8 rows of L = B/8 slots) for the row kernels, tile-wide ranks in slot
// order for the per-tile ones, the caps, and a merge with no spill pass.
//
//   extract  extract_kernel<kind, R, true> of exchange_common.cuh:
//            extract_rows, extract_all_rows (R = 8), extract_fused (R = 1)
//   extract_ranked_kernel   extract (ranks given, any B)
//   merge_kernel<R>         merge_rows, merge_all_rows (R = 8), merge_fused
//                           (R = 1): a block table of compacted runs,
//                           rows walked in 16-byte lane groups
//   merge_ranked_kernel     merge (free ranks given, any B)
//
// cleanup_rows runs K10's kernel (gather_exchange.cu, canon = 1).
//
// Layouts (row-major, float32 unless noted):
//   alive, planes      (NT, B)            B % 8 == 0 for R = 1, 8
//   rank, frank        (NT, B) int32      the ranked modes, any B
//   buffers            (NT, 7, R, W)      payload-major, see exchange_common
//   active             (NT, NC) int32     merge_ranked, optional
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument the
// kernels do not take).

#include "exchange_common.cuh"

namespace {

// K11 merge: merge_rows and merge_all_rows (R = 8: row r's free slots take
// row r's arrivals), merge_fused (R = 1: the tile's free slots take the
// tile's arrivals).  Free slot f of a segment (alive <= 0.5, counted in slot
// order) takes arrival f, counted over the compacted blocks in table order
// (every set flag of a block counts, wherever it lies in the block); it is
// placed if the flag of that column is set.  Arrivals beyond the free slots
// are dropped: there is no spill pass.  The arrivals are written IN PLACE
// into the planes and alive, as x + 0.0f; no other slot is touched
// (pinc_tpu passes them through).  Bound: bytes: the alive plane up to the
// last free slot a segment needs, the flag plane of the buffer, and 28 B
// read and written per placed arrival.
//
// Design.  (1) Flag counts per block in 16-byte lane groups (one RowWalk
// over the span the blocks cover, the next chunk's loads in flight): for R
// = 8 each warp its row; for R = 1 the tile's one row split over all 8
// warps, chunk c to warp c % 8, the per-warp counts summed through shared
// memory.  Their prefix (arrivals through block b) is held in registers,
// the blocks' offsets in shared memory: a rank finds its block in 7
// compares.  (2) Alive is walked in 16-byte lane groups (a scalar head
// where a segment starts off a 16-byte boundary); a chunk's four ballots
// become four words of 32 free-slot bits (free_words), and a lane places
// as the chunk is ranked: lane l takes slot 32 s + l of word s, free rank
// k < arrivals taking arrival k, so that a store instruction covers one
// 128-byte line of a plane.  A lane issues its 4 x 7 loads (payloads and
// flag) before its stores.  R = 8: each warp walks its row, the next
// chunk's loads in flight, and stops once the row's arrivals are ranked.
// R = 1: ranks run over the tile in slot order, so the 8 warps walk the
// tile in rounds of 8 chunks, chunk c to warp c % 8: each warp counts its
// chunk's free slots, one __syncthreads makes the round's counts known,
// each warp places its chunk from the count before it, and the rounds
// stop once the tile's arrivals are ranked.  Alive is read once, up to the
// round of the last slot the tile needs, and all 8 warps place (a first
// build walked a slice of B/8 slots a warp: all of alive read, the
// placing left to the warps whose slices hold the first free slots).
template <int R>
__global__ void __launch_bounds__(kThreads)
merge_kernel(float* __restrict__ alive, const float* __restrict__ inc,
             MutPlanes pl, BlockTable bt, int B, int KT) {
  __shared__ int part[kWarps][kMaxBlocks];    // R = 1: each warp's counts
  __shared__ int boff[kMaxBlocks];
  __shared__ int rfree[2][kWarps];            // R = 1: a round's counts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const long long ipstride = (long long)R * KT;
  const float* rin =
      inc + ((long long)blockIdx.x * kNPay * R + (R == 1 ? 0 : warp)) * KT;
  // the segment: row `warp` of the tile (R = 8), or the whole tile
  const long long seg0 =
      (long long)blockIdx.x * B + (R == 1 ? 0 : (long long)warp * (B / kRows));
  float* seg = alive + seg0;
  const RowWalk aw(seg, R == 1 ? B : B / kRows);

  // (1) arrivals per block
  int lo = KT, hi = 0;
  for (int b = 0; b < bt.n; ++b) {
    lo = min(lo, bt.off[b]);
    hi = max(hi, bt.off[b] + bt.w[b]);
  }
  int cnt[kMaxBlocks];
#pragma unroll
  for (int b = 0; b < kMaxBlocks; ++b) cnt[b] = 0;
  if (lo < hi) {
    const float* flag = rin + 6 * ipstride + lo;
    const RowWalk fw(flag, hi - lo);
    const int step = R == 1 ? kWarps : 1;
    const int c0 = fw.first + (R == 1 ? warp : 0);
    const int n = c0 < fw.end ? (fw.end - c0 + step - 1) / step : 0;
    walk_pipelined<RowGroup>(
        0, n,
        [&](RowGroup& g, int i) {
          fw.group(c0 + i * step, lane, &g.off, &g.n);
          load4(g.v, flag + g.off, g.n);
        },
        [&](const RowGroup& g) { count_flags(g, lo, bt, cnt); });
  }
  int nbe[kMaxBlocks];   // arrivals through block b (max past the table)
  int narr = 0;
#pragma unroll
  for (int b = 0; b < kMaxBlocks; ++b) {
    cnt[b] = __reduce_add_sync(kFull, cnt[b]);
    narr += cnt[b];
    nbe[b] = b < bt.n ? narr : 0x7fffffff;
    if (R == 1 && lane == 0) part[warp][b] = cnt[b];
  }
  if (threadIdx.x < kMaxBlocks) boff[threadIdx.x] = bt.off[threadIdx.x];
  __syncthreads();
  if (R == 1) {
    narr = 0;
#pragma unroll
    for (int b = 0; b < kMaxBlocks; ++b) {
      for (int w = 0; w < kWarps; ++w) narr += part[w][b];
      nbe[b] = b < bt.n ? narr : 0x7fffffff;
    }
  }

  // (2) placing: the free slots of a chunk whose first slot is c0, as four
  // words; run counts the segment's free slots before the chunk
  int run = 0;
  auto place = [&](const unsigned (&w)[kVec], int c0) {
    const float* src[kVec];
#pragma unroll
    for (int s = 0; s < kVec; ++s) {
      const int rank = run + __popc(w[s] & lt);
      src[s] = nullptr;
      if ((w[s] >> lane & 1u) && rank < narr) {
        int b = 0, base = 0;
#pragma unroll
        for (int q = 0; q < kMaxBlocks - 1; ++q)
          if (rank >= nbe[q]) {
            b = q + 1;
            base = nbe[q];
          }
        src[s] = rin + boff[b] + rank - base;
      }
      run += __popc(w[s]);
    }
    float v[kVec][kNPay];
#pragma unroll
    for (int s = 0; s < kVec; ++s)
#pragma unroll
      for (int q = 0; q < kNPay; ++q)
        v[s][q] = src[s] != nullptr ? src[s][q * ipstride] : 0.0f;
#pragma unroll
    for (int s = 0; s < kVec; ++s) {
      if (src[s] == nullptr || !(v[s][6] > 0.5f)) continue;
      const int k = c0 + 32 * s + lane;
#pragma unroll
      for (int q = 0; q < 6; ++q) pl.p[q][seg0 + k] = stored<true>(v[s][q]);
      seg[k] = 1.0f;
    }
  };
  auto load_alive = [&](RowGroup& g, int c) {
    aw.group(c, lane, &g.off, &g.n);
    g.c = c;
    load4(g.v, seg + g.off, g.n);
  };
  auto first_slot = [&](int c) { return c < 0 ? 0 : aw.h + kChunk * c; };
  if (R == kRows) {
    if (narr > 0)
      walk_until<RowGroup>(aw.first, aw.end, load_alive,
                           [&](const RowGroup& g) {
        unsigned w[kVec];
        free_words(g, w);
        place(w, first_slot(g.c));
        return run < narr;
      });
    return;
  }
  // R = 1: rounds of 8 chunks, the next round's chunk loaded ahead
  RowGroup g{};
  int c = aw.first + warp;
  if (c < aw.end) load_alive(g, c);
  int before = 0;   // the tile's free slots before the round
  for (int round = 0; aw.first + kWarps * round < aw.end && before < narr;
       ++round, c += kWarps) {
    unsigned w[kVec];
    free_words(g, w);   // no free slot in a chunk past the end (n = 0)
    int mine = 0;
#pragma unroll
    for (int s = 0; s < kVec; ++s) mine += __popc(w[s]);
    RowGroup next{};
    if (c + kWarps < aw.end) load_alive(next, c + kWarps);
    if (lane == 0) rfree[round & 1][warp] = mine;
    __syncthreads();
    run = before;
    for (int v = 0; v < kWarps; ++v) {
      const int f = rfree[round & 1][v];
      run += v < warp ? f : 0;
      before += f;
    }
    if (c < aw.end) place(w, first_slot(c));
    g = next;
  }
}

// K11 extract with the buffer column of every slot given (pinc_tpu's
// `extract`, kept for B % 8 != 0): rank -1 stays, rank >= 0 is killed, and
// 0 <= rank < K2 is copied to that column (ranks there are unique).  Bound:
// bytes: rank and alive read, alive written, 24 B read and 28 B written per
// copied slot, the buffer's other entries zeroed.  Design: the block zeroes
// its tile's buffer, synchronises, then scatters.
__global__ void __launch_bounds__(kThreads)
extract_ranked_kernel(const int* __restrict__ rank,
                      const float* __restrict__ alive, Planes pl,
                      float* __restrict__ buf, float* __restrict__ alive_out,
                      int B, int K2) {
  float* out = buf + (long long)blockIdx.x * kNPay * K2;
  for (int j = threadIdx.x; j < kNPay * K2; j += kThreads) out[j] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const long long k = (long long)blockIdx.x * B + i;
    const int r = rank[k];
    alive_out[k] = r >= 0 ? 0.0f : alive[k];
    if (r >= 0 && r < K2) {
#pragma unroll
      for (int q = 0; q < 6; ++q) out[q * K2 + r] = stored<true>(pl.p[q][k]);
      out[6 * K2 + r] = 1.0f;
    }
  }
}

// K11 merge with the free rank of every slot given (pinc_tpu's `merge`,
// kept for B % 8 != 0): the buffer is one minus run [0, K) and one plus run
// [K, 2K), each compacted; free rank f takes arrival f (minus first), if
// its flag is set.  active (optional, (NT, NC) per chunk of CB slots): a
// chunk whose flag is 0 is skipped, as in pinc_tpu.  In place, as
// merge_kernel.  Bound: bytes: frank read, 28 B read and written per placed
// arrival.
__global__ void __launch_bounds__(kThreads)
merge_ranked_kernel(const int* __restrict__ frank, float* __restrict__ alive,
                    const float* __restrict__ inc,
                    const int* __restrict__ active, MutPlanes pl, int B,
                    int K2, int CB, int NC) {
  __shared__ int counts[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = K2 / 2;
  const float* tin = inc + (long long)blockIdx.x * kNPay * K2;
  if (warp < 2) {
    int cnt = 0;
    for (int c0 = 0; c0 < K; c0 += 32) {
      const int j = c0 + lane;
      cnt += __popc(__ballot_sync(
          kFull, j < K && tin[6 * K2 + warp * K + j] > 0.5f));
    }
    if (lane == 0) counts[warp] = cnt;
  }
  __syncthreads();
  const int n_m = counts[0], n_p = counts[1];
  for (int i = threadIdx.x; i < B; i += kThreads) {
    if (active != nullptr && active[(long long)blockIdx.x * NC + i / CB] == 0)
      continue;
    const long long k = (long long)blockIdx.x * B + i;
    const int f = frank[k];
    int col;
    if (f < 0)
      continue;
    else if (f < n_m)
      col = f;
    else if (f - n_m < n_p)
      col = K + (f - n_m);
    else
      continue;
    const float* src = tin + col;
    if (src[6 * K2] > 0.5f) {
#pragma unroll
      for (int q = 0; q < 6; ++q) pl.p[q][k] = stored<true>(src[q * K2]);
      alive[k] = 1.0f;
    }
  }
}

}  // namespace

extern "C" {

// kind 0, 1, 2: leavers along that axis of `coord`; 3: all axes.  rows 8
// or 1.  buf (NT, 7, rows, n_cls * K).
int pinc_ox_extract(const float* coord, const float* alive, const float* x,
                    const float* y, const float* z, const float* vx,
                    const float* vy, const float* vz, float* buf,
                    float* alive_out, int NT, int B, int kind, int rows, int K,
                    float T, void* stream) {
  if (NT <= 0 || B <= 0 || B % kRows != 0 || K <= 0 ||
      !(kind == kAll || (kind >= 0 && kind < 3)))
    return -1;
  const Planes pl = {{x, y, z, vx, vy, vz}};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == kRows)
    return launch_extract<kRows, true>(kind, alive, coord, pl, buf, alive_out,
                                       NT, B, K, T, s);
  if (rows == 1)
    return launch_extract<1, true>(kind, alive, coord, pl, buf, alive_out, NT,
                                   B, K, T, s);
  return -1;
}

// rank (NT, B) int32; buf (NT, 7, 1, K2).
int pinc_ox_extract_ranked(const int* rank, const float* alive, const float* x,
                           const float* y, const float* z, const float* vx,
                           const float* vy, const float* vz, float* buf,
                           float* alive_out, int NT, int B, int K2,
                           void* stream) {
  if (NT <= 0 || B <= 0 || K2 <= 0) return -1;
  const Planes pl = {{x, y, z, vx, vy, vz}};
  extract_ranked_kernel<<<NT, kThreads, 0, (cudaStream_t)stream>>>(
      rank, alive, pl, buf, alive_out, B, K2);
  return (int)cudaGetLastError();
}

// inc (NT, 7, rows, KT); table: (offset, width) pairs of the runs.
int pinc_ox_merge(float* alive, const float* inc, float* x, float* y, float* z,
                  float* vx, float* vy, float* vz, const int* table,
                  int nblocks, int NT, int B, int rows, int KT, void* stream) {
  BlockTable bt = {};
  if (NT <= 0 || B <= 0 || B % kRows != 0 ||
      !read_table(table, nblocks, KT, &bt))
    return -1;
  const MutPlanes pl = {{x, y, z, vx, vy, vz}};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == kRows)
    merge_kernel<kRows><<<NT, kThreads, 0, s>>>(alive, inc, pl, bt, B, KT);
  else if (rows == 1)
    merge_kernel<1><<<NT, kThreads, 0, s>>>(alive, inc, pl, bt, B, KT);
  else
    return -1;
  return (int)cudaGetLastError();
}

// frank (NT, B) int32; inc (NT, 7, 1, K2); active (NT, NC) int32 or null.
int pinc_ox_merge_ranked(const int* frank, float* alive, const float* inc,
                         const int* active, float* x, float* y, float* z,
                         float* vx, float* vy, float* vz, int NT, int B,
                         int K2, int CB, int NC, void* stream) {
  if (NT <= 0 || B <= 0 || K2 <= 0 || K2 % 2 != 0 || CB <= 0 ||
      (long long)CB * NC != B)
    return -1;
  const MutPlanes pl = {{x, y, z, vx, vy, vz}};
  merge_ranked_kernel<<<NT, kThreads, 0, (cudaStream_t)stream>>>(
      frank, alive, inc, active, pl, B, K2, CB, NC);
  return (int)cudaGetLastError();
}

}  // extern "C"
