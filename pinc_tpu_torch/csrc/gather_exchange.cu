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
// W and Ke; CANON copies as stored<true> (the one-hot cleanup_rows).  A
// null settled output (outs.p[0]) is neither written nor zeroed: the
// first cleanup of the fused exchange, whose columns are all out on some
// axis.
// Bound: bytes: the flag plane is read, a valid column reads 6 more floats
// and writes 7, and every output is written once (entries or zeros); the
// zero tails are most of it.  Design: the extract's (RowWalk, rank_class,
// fill_segments): a ranking pass loads each lane's 4 columns of the flags
// and of the remaining axes' coordinates with 16-byte loads, issued
// together, the next chunk's in flight while a chunk is ranked, and a valid
// column writes only its column index into its output's flag entry; then
// the fill pass writes every output entry once with 16-byte stores,
// gathering the valid columns' 7 values from the row just read (L2) with
// all the block's warps, zeros beyond each count, so that a short row's
// tails do not wait on the longest row.  A row whose start is not 16-byte
// aligned (W % 4 != 0) takes a scalar head.
template <int NAX>
struct CleanupGroup {
  int off, n;
  float f[kVec];
  float c[NAX][kVec];   // the remaining axes' coordinates
};

// 4 blocks an SM (64 registers): faster on the card than the 3 that 80
// registers allow NAX = 3.
template <int NAX, bool CANON>
__global__ void __launch_bounds__(kThreads, 4)
cleanup_kernel(const float* __restrict__ inc, Outs outs, int W, int Ke,
               float T) {
  constexpr int NCLS = 1 + 2 * NAX;
  using G = CleanupGroup<NAX>;
  __shared__ int counts[kRows][NCLS];
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const long long tile_row0 = (long long)blockIdx.x * kNPay * kRows;
  const long long ipstride = (long long)kRows * W;
  const float* in = inc + (tile_row0 + row) * W;
  // the payload rows lie 32 W bytes apart: one alignment for all seven
  const RowWalk walk(in, W);
  int run[NCLS];
#pragma unroll
  for (int c = 0; c < NCLS; ++c) run[c] = 0;

  walk_pipelined<G>(
      walk.first, walk.end,
      [&](G& g, int c) {
        walk.group(c, lane, &g.off, &g.n);
        load4(g.f, in + 6 * ipstride + g.off, g.n);
#pragma unroll
        for (int a = 0; a < NAX; ++a)
          load4(g.c[a], in + (3 - NAX + a) * ipstride + g.off, g.n);
      },
      [&](const G& g) {
        int cls[kVec];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          cls[j] = -1;
          if (g.f[j] > 0.5f) {
            any = true;
            cls[j] = 0;
#pragma unroll
            for (int a = 0; a < NAX; ++a) {
              if (g.c[a][j] < 0.0f) {
                cls[j] = 1 + 2 * a;
                break;
              }
              if (g.c[a][j] >= T) {
                cls[j] = 2 + 2 * a;
                break;
              }
            }
          }
        }
        if (!__any_sync(kFull, any)) return;
#pragma unroll
        for (int c = 0; c < NCLS; ++c)
          rank_class(cls, c, lt, &run[c], [&](int j, int rank) {
            const int cap = c == 0 ? W : Ke;
            if (rank < cap && outs.p[c] != nullptr)
              outs.p[c][(tile_row0 + 6 * kRows + row) * cap + rank] =
                  __int_as_float(g.off + j);
          });
      });

  // the outputs' table in shared memory: the fill indexes it by a class
  // known only at run time, which would copy the parameter to local memory
  __shared__ float* outp[NCLS];
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < NCLS; ++c) counts[row][c] = run[c];
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NCLS; ++c) outp[c] = outs.p[c];
  }
  __syncthreads();
  fill_segments(
      kRows * NCLS, max(W, Ke),
      [&](int s, float** o, long long* ps, int* n, int* cap) {
        const int r = s / NCLS, c = s - r * NCLS;
        if (outp[c] == nullptr) return false;
        const int w = c == 0 ? W : Ke;
        *o = outp[c] + (tile_row0 + r) * w;
        *ps = (long long)kRows * w;
        *n = min(counts[r][c], w);
        *cap = w;
        return true;
      },
      [&](int s, int q, int j) {
        return stored<CANON>(
            inc[(tile_row0 + s / NCLS) * W + q * ipstride + j]);
      });
}

// K9.  Replaces _merge_g_kernel.  Pass 0: row r's free slots (alive <=
// 0.5), in slot order, take row r's arrivals in block order.  Spill pass
// p = 1..7 (only while the tile has leftovers): row r's remaining free
// slots take the leftovers of row (r - p) % 8, from that row's consumed
// count on.  Arrivals still unplaced are dropped.  The arrivals are written
// IN PLACE into the planes and alive; no other slot is touched, so a dead
// slot that is not refilled keeps its stale payload, as in pinc_tpu.
// Bound: bytes: the alive plane up to the last free slot a row needs, the
// flag plane, and 24 B read plus 28 B written per placed arrival.  The 6
// scattered plane stores are most of the kernel's time.  Design: (1) each
// warp counts its row's arrivals per block from the flag plane in 16-byte
// lane groups (one RowWalk over the span the blocks cover, the next
// chunk's loads in flight).  (2) It walks its row's alive the same way,
// chunk c being slots [128 c, 128 c + 128) (the host checks that alive
// starts on a 16-byte boundary), turns the chunk's four ballots into four
// words of 32 free-slot bits, and places pass 0 as it goes: lane l takes
// slot 32 s + l of word s, free rank k < a_r taking the row's arrival k,
// its block and column from the per-block counts (in registers).  A store
// instruction thus covers one 128-byte line of a plane, as few as the
// free slots allow (a lane storing its own 4 consecutive slots covers
// four lines an instruction, and took 1.8x as long).  A lane's 4 x 6
// payload loads are issued together before its stores.  The walk stops
// once a_r slots are placed or the row ends, so alive is read up to the
// last slot the row needs.  (3) Only while the tile has leftovers do the
// spill passes run, each rescanning the row from slot 0 in 32-slot
// chunks, a slot a lane, with per-source-row consumed counters in shared
// memory: lane l handles slots 32 i + l in both steps, so it reads back
// its own alive writes.
__global__ void __launch_bounds__(kThreads)
merge_rows_kernel(float* __restrict__ alive, const float* __restrict__ inc,
                  MutPlanes pl, BlockTable bt, int B, int KT) {
  __shared__ int nb_end[kRows][kMaxBlocks];   // arrivals through block b
  __shared__ int boff[kMaxBlocks];
  __shared__ int narr[kRows];                 // arrivals per row
  __shared__ int consumed[kRows];
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const long long ipstride = (long long)kRows * KT;
  const float* tile_in = inc + (long long)blockIdx.x * kNPay * kRows * KT;
  const int L = B / kRows;

  // (1) arrivals per block: one walk over the span the blocks cover
  int lo = KT, hi = 0;
  for (int b = 0; b < bt.n; ++b) {
    lo = min(lo, bt.off[b]);
    hi = max(hi, bt.off[b] + bt.w[b]);
  }
  int cnt[kMaxBlocks];
#pragma unroll
  for (int b = 0; b < kMaxBlocks; ++b) cnt[b] = 0;
  if (lo < hi) {
    const float* flag = tile_in + 6 * ipstride + (long long)row * KT + lo;
    const RowWalk fw(flag, hi - lo);
    walk_pipelined<RowGroup>(
        fw.first, fw.end,
        [&](RowGroup& g, int c) {
          fw.group(c, lane, &g.off, &g.n);
          load4(g.v, flag + g.off, g.n);
        },
        [&](const RowGroup& g) { count_flags(g, lo, bt, cnt); });
  }
  int nbe[kMaxBlocks];   // the row's arrivals through block b
  int total = 0;
#pragma unroll
  for (int b = 0; b < kMaxBlocks; ++b) {
    total += __reduce_add_sync(kFull, cnt[b]);
    nbe[b] = b < bt.n ? total : 0x7fffffff;
    if (lane == 0) nb_end[row][b] = nbe[b];
  }
  if (lane == 0) narr[row] = total;
  if (threadIdx.x < kMaxBlocks) boff[threadIdx.x] = bt.off[threadIdx.x];
  __syncthreads();

  // (2) the walk: pass 0 placed as the free slots are ranked.  The row
  // starts on a 16-byte boundary (the host checks), so chunk c is slots
  // [128 c, 128 c + 128) and its free slots are four 32-slot words; lane l
  // places slot 32 s + l of word s, so that a store covers one 128-byte
  // line of a plane, as few lines as the free slots allow.
  const long long row0 = (long long)blockIdx.x * B + (long long)row * L;
  float* arow = alive + row0;
  const float* rsrc = tile_in + (long long)row * KT;
  const RowWalk aw(arow, L);
  auto load_alive = [&](RowGroup& g, int c) {
    aw.group(c, lane, &g.off, &g.n);
    load4(g.v, arow + g.off, g.n);
  };
  const int a_r = total;
  int run = 0;
  if (a_r > 0) {
    walk_until<RowGroup>(0, aw.end, load_alive, [&](const RowGroup& g) {
      unsigned w[kVec];
      free_words(g, w);
      const int c0 = g.off - kVec * lane;   // the chunk's first slot
      const float* src[kVec];
#pragma unroll
      for (int s = 0; s < kVec; ++s) {
        const int rank = run + __popc(w[s] & lt);
        src[s] = nullptr;
        if ((w[s] >> lane & 1u) && rank < a_r) {
          int b = 0, base = 0;
#pragma unroll
          for (int q = 0; q < kMaxBlocks - 1; ++q)
            if (rank >= nbe[q]) {
              b = q + 1;
              base = nbe[q];
            }
          src[s] = rsrc + boff[b] + rank - base;
        }
        run += __popc(w[s]);
      }
      float v[kVec][6];
#pragma unroll
      for (int s = 0; s < kVec; ++s)
#pragma unroll
        for (int q = 0; q < 6; ++q)
          v[s][q] = src[s] != nullptr ? src[s][q * ipstride] : 0.0f;
#pragma unroll
      for (int s = 0; s < kVec; ++s) {
        if (src[s] == nullptr) continue;
        const int k = c0 + 32 * s + lane;
#pragma unroll
        for (int q = 0; q < 6; ++q) pl.p[q][row0 + k] = v[s][q];
        arow[k] = 1.0f;
      }
      return run < a_r;
    });
  }
  if (lane == 0) consumed[row] = min(run, a_r);
  __syncthreads();

  // (3) spill pass p: row r's free slots left take the leftovers of row
  // (r - p) & 7, from its consumed count on
  for (int p = 1; p < kRows; ++p) {
    int left = 0;
    for (int s = 0; s < kRows; ++s) left += narr[s] - consumed[s];
    if (left == 0) break;
    const int s = (row - p) & (kRows - 1);
    const int first = consumed[s];
    const int avail = narr[s] - first;
    int taken = 0;
    if (avail > 0) {
      int frun = 0;
      for (int c0 = 0; c0 < L && frun < avail; c0 += 32) {
        const int k = c0 + lane;
        const bool is_free = arow[k] <= 0.5f;
        const unsigned m = __ballot_sync(kFull, is_free);
        const int frank = frun + __popc(m & lt);
        if (is_free && frank < avail) {
          int a = first + frank, b = 0;
          while (a >= nb_end[s][b]) ++b;
          a -= b ? nb_end[s][b - 1] : 0;
          const float* src = tile_in + (long long)s * KT + boff[b] + a;
#pragma unroll
          for (int q = 0; q < 6; ++q) pl.p[q][row0 + k] = src[q * ipstride];
          arow[k] = 1.0f;
        }
        frun += __popc(m);
      }
      taken = min(frun, avail);
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

// settled may be null: no settled output is written.
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
  if (misalign16(alive)) return -1;   // rows on 16-byte boundaries
  const MutPlanes pl = {{x, y, z, vx, vy, vz}};
  merge_rows_kernel<<<NT, kThreads, 0, (cudaStream_t)stream>>>(alive, inc, pl,
                                                               bt, B, KT);
  return (int)cudaGetLastError();
}

}  // extern "C"
