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
//   extract_ranked_kernel   extract (ranks given, any B, any K2): a block
//                           maps up to 4096 columns of a tile's buffer to
//                           their source slots in shared memory, then
//                           writes the columns out whole
//   merge_kernel<R>         merge_rows, merge_all_rows (R = 8), merge_fused
//                           (R = 1): a block table of compacted runs,
//                           rows walked in 16-byte lane groups
//   merge_ranked_kernel     merge (free ranks given, any B): the tile's
//                           arrivals staged in shared memory, the active
//                           chunks listed by ballots, frank read and the
//                           placed slots' groups rewritten 16 bytes at a
//                           time where aligned
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
// 0 <= rank < K2 is copied to that column as x + 0.0f with flag 1 (ranks
// there are unique); every other entry of the buffer is 0.  Bound: bytes:
// rank and alive read, alive written, 24 B read per copied slot, the
// buffer written once (chip_smoke.py's check_ranked_bench).  Its floor is
// higher: a copied slot's six payloads are scattered 4-byte loads, a
// sector each (see below).
//
// Design: a block handles columns [c0, c0 + Kc) of one tile's buffer, Kc
// = min(K2 rounded up to 4, kRankedCols): ceil(K2 / Kc) blocks a tile.
// (1) It sets each column's source slot to none, in shared memory.  (2)
// Its 8 warps walk the tile's rank row in 16-byte lane groups (RowWalk: a
// scalar head where the row starts off a 16-byte boundary, chunk c to warp
// c % 8, the warp's next group loaded before it uses this one); a slot
// whose rank falls in the block's columns becomes that column's source.
// The first block of a tile also reads alive and writes alive', 16 bytes
// at a time where alive's and alive''s rows lie on rank's 16-byte offset.
// (3) After one barrier the block writes its columns out whole, a thread
// a 4-column group: the sources' six payloads (x + 0.0f) and flags, one
// 16-byte store a row where the buffer's rows start on a 16-byte boundary
// (K2 % 4 == 0), scalar stores otherwise.  No payload goes to device
// memory a scattered word at a time, and no entry is written twice.  At
// 4096 x 6524, K2 = 512 on an H100 (trial builds, PERF.md): without the
// payload loads the kernel takes 0.13 ms of 0.27; staging the payloads
// themselves in shared memory (7 Kc floats) in the walk took 0.28, and
// the first design (the buffer zeroed in device memory, then seven
// scattered stores a copied slot, a slot a thread) 0.36.
constexpr int kRankedCols = 4096;   // a block's columns: 16 KB of slots

__global__ void __launch_bounds__(kThreads)
extract_ranked_kernel(const int* __restrict__ rank,
                      const float* __restrict__ alive, Planes pl,
                      float* __restrict__ buf, float* __restrict__ alive_out,
                      int B, int K2, int Kc, int nblk) {
  extern __shared__ int4 src4[];                // (Kc): each column's slot
  int* src = reinterpret_cast<int*>(src4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x / nblk;
  const int c0 = (blockIdx.x - tile * nblk) * Kc;
  const int nc = min(Kc, K2 - c0);
  const bool first = c0 == 0;
  // (1) no column has a source yet
  for (int i = threadIdx.x; i < Kc / kVec; i += kThreads)
    src4[i] = make_int4(-1, -1, -1, -1);
  __syncthreads();
  // (2) walk the rank row: each slot ranked into the block's columns
  // becomes its column's source; alive' from the first block
  const long long base = (long long)tile * B;
  const int* rk = rank + base;
  const float* al = alive + base;
  float* ao = alive_out + base;
  const RowWalk rw(reinterpret_cast<const float*>(rk), B);
  const bool vec_al = misalign16(al) == misalign16(rk) &&
                      misalign16(ao) == misalign16(rk);
  struct Group {
    int off, n, r[kVec];
    float a[kVec];
  };
  auto load = [&](Group& g, int c) {
    rw.group(c, lane, &g.off, &g.n);
    if (g.n == kVec) {
      const int4 t = *reinterpret_cast<const int4*>(rk + g.off);
      g.r[0] = t.x, g.r[1] = t.y, g.r[2] = t.z, g.r[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) g.r[e] = e < g.n ? rk[g.off + e] : -1;
    }
    if (first) {
      if (g.n == kVec && vec_al) {
        load4(g.a, al + g.off, kVec);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) g.a[e] = e < g.n ? al[g.off + e] : 0.0f;
      }
    }
  };
  auto place = [&](const Group& g) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int col = g.r[e] - c0;
      if (e < g.n && col >= 0 && col < nc) src[col] = g.off + e;
    }
    if (!first) return;
    float v[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = g.r[e] >= 0 ? 0.0f : g.a[e];
    if (g.n == kVec && vec_al) {
      *reinterpret_cast<float4*>(ao + g.off) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (e < g.n) ao[g.off + e] = v[e];
    }
  };
  int c = rw.first + warp;
  Group cur{}, nxt{};
  if (c < rw.end) load(cur, c);
  for (; c < rw.end; c += kWarps) {
    if (c + kWarps < rw.end) load(nxt, c + kWarps);
    place(cur);
    cur = nxt;
  }
  __syncthreads();
  // (3) the block's columns of the 7 rows, each entry written once: a
  // thread loads the payloads of a 4-column group's sources (up to 24
  // independent loads in flight) and stores the group's 7 rows
  float* out = buf + (long long)tile * kNPay * K2 + c0;
  auto value = [&](int q, int s) -> float {
    return s < 0 ? 0.0f : (q < 6 ? stored<true>(pl.p[q][base + s]) : 1.0f);
  };
  if (K2 % kVec == 0 && misalign16(buf) == 0) {
    const int ng = nc / kVec;
    for (int j = threadIdx.x; j < ng; j += kThreads) {
      const int4 s = src4[j];
      float4 v[kNPay];
#pragma unroll
      for (int q = 0; q < kNPay; ++q)
        v[q] = make_float4(value(q, s.x), value(q, s.y), value(q, s.z),
                           value(q, s.w));
#pragma unroll
      for (int q = 0; q < kNPay; ++q)
        reinterpret_cast<float4*>(out + (long long)q * K2)[j] = v[q];
    }
  } else {
    for (int i = threadIdx.x; i < kNPay * nc; i += kThreads) {
      const int q = i / nc, j = i - q * nc;
      out[(long long)q * K2 + j] = value(q, src[j]);
    }
  }
}

// K11 merge with the free rank of every slot given (pinc_tpu's `merge`,
// kept for B % 8 != 0): the buffer is one minus run [0, K) and one plus run
// [K, 2K), each compacted; free rank f < n_m takes column f, n_m <= f <
// n_m + n_p column K + f - n_m (n_m, n_p: the runs' set flags), placed if
// that column's flag is set.  frank is any int32 plane: ranks need not
// rise in slot order, and two slots may hold one rank (both take it).
// active (optional, (NT, NC) per chunk of CB slots): a chunk whose flag is
// 0 places nothing, as in pinc_tpu.  In place, as merge_kernel.  Bound:
// bytes: the flag row, active, frank of the walked slots (the active
// chunks', or all), 24 B read and 28 B written per placed arrival; in
// 32-byte sectors, the placed slots' scattered stores, a sector a plane
// (chip_smoke.py's check_ranked_bench computes both).  Neither is its
// floor: scattered writes of part of a sector run far below the HBM rate.
//
// Design, one block a tile.  (1) Every warp reads the tile's flag row
// (16-byte loads where the buffer's rows are 16-byte aligned), keeps it in
// shared memory and counts its set flags of each run (summed through
// shared memory); in the same pass the warps list the active chunks: warp
// v reads the flags of chunks [w0 + 256 v, w0 + 256 v + 256) of a window
// of kActWindow, one ballot a 32, and writes the indices of the set ones,
// in order, into its part of a shared list.  (2) After one barrier the
// block stages the arrivals it can place, columns [0, n_m) and [K, K + n_p)
// of the six payload rows (16-byte cp.async where the rows and K allow,
// element copies otherwise), and walks its items with the copies in
// flight: without active the tile's row, as a scalar head up to the first
// 16-byte boundary of frank, 16-byte groups and a scalar tail; with active
// the listed chunks, as 16-byte groups where CB % 4 == 0 and the row is
// 16-byte aligned, else slot by slot.  A thread loads the ranks of
// kRankAhead items before it uses any; the first batch's loads are in
// flight across the barrier that publishes the staged block.  (3) Each
// slot with a rank in [0, n_m + n_p) whose column's flag is set takes its
// six payloads from shared memory (x + 0.0f) and alive = 1: a 16-byte
// item with such a slot reads its group of the six planes and alive,
// replaces its placed slots and writes the group back whole, one 16-byte
// store a plane (the group is the tile's: no other block writes it).  A
// window of active chunks past the first is listed and walked after a
// barrier.  Dynamic shared memory: the staged block, 7 K2 floats (14 KB
// at K = 256); the list takes 8 KB more.  The scattered stores set the
// pace: at 4096 x 6524 on an H100 the kernel without them takes 0.04 ms
// of 0.35, and trial builds that stored each placed slot's 4 bytes (0.46
// ms), or
// walked the whole row in slot order (0.41 ms; 0.43 with 32-byte groups)
// were slower.  (The first design read active for every slot, every
// thread walking slots i, i + 256, ... through chains of dependent loads:
// active, frank, the flag, the payloads, each slot's 4-byte stores.)
constexpr int kRankAhead = 4;      // items a thread loads before it places
constexpr int kActSpan = 256;      // active chunks a warp lists in a window
constexpr int kActWindow = kWarps * kActSpan;
constexpr size_t kRankedStaticSmem = sizeof(int) * (kActWindow + 3 * kWarps);
constexpr size_t kMaxSmem = 232448;  // 227 KB a block

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Warp `warp`'s part of the active list of the window from chunk w0: the
// set flags of chunks [w0 + kActSpan warp, + kActSpan) in order, from
// list + kActSpan warp; their count into nlist[warp].
__device__ __forceinline__ void list_active(const int* __restrict__ act,
                                            int w0, int NC, int* list,
                                            int* nlist, int warp, int lane) {
  constexpr int kR = kActSpan / 32;
  const int c0 = w0 + warp * kActSpan;
  int v[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int c = c0 + 32 * r + lane;
    v[r] = c < NC ? act[c] : 0;
  }
  const unsigned lt = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const unsigned b = __ballot_sync(kFull, v[r] != 0);
    if (v[r] != 0)
      list[warp * kActSpan + n + __popc(b & lt)] = c0 + 32 * r + lane;
    n += __popc(b);
  }
  if (lane == 0) nlist[warp] = n;
}

// The walk's items over a tile's frank row fr: item q is `width` slots
// from slot `at` (width 4: one 16-byte load; 1: one slot).  Without
// active: the row's scalar head (h slots), ng 16-byte groups, the scalar
// tail.  With active: item q is part q - o ipc of listed chunk o = q / ipc,
// ipc parts of `width` slots a chunk; the list is the warps' parts, warp
// v's from entry pre[v] of the window.
struct RankedItems {
  const int* list;
  int pre[kWarps + 1];
  int n, h, ng, ipc, CB, width;
  bool listed;
  __device__ __forceinline__ void item(int q, int* at, int* w) const {
    if (!listed) {
      if (q < h) {
        *at = q, *w = 1;
      } else if (q < h + ng) {
        *at = h + kVec * (q - h), *w = kVec;
      } else {
        *at = q + (kVec - 1) * ng, *w = 1;
      }
      return;
    }
    const int o = q / ipc;
    int from = 0;            // list entry of o: warp v's part, pre[v] <= o
#pragma unroll
    for (int v = 1; v < kWarps; ++v)
      if (o >= pre[v]) from = v * kActSpan - pre[v];
    const int chunk = list[from + o];
    *at = chunk * CB + (q - o * ipc) * width;
    *w = width;
  }
};

__global__ void __launch_bounds__(kThreads)
merge_ranked_kernel(const int* __restrict__ frank, float* __restrict__ alive,
                    const float* __restrict__ inc,
                    const int* __restrict__ active, MutPlanes pl, int B,
                    int K2, int CB, int NC) {
  extern __shared__ float4 stage4[];            // (7, K2): the arrivals
  __shared__ int nflag[2][kWarps];              // set flags: minus, plus
  __shared__ int nlist[kWarps];
  __shared__ int list[kActWindow];
  float* stage = reinterpret_cast<float*>(stage4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = K2 / 2;
  const float* tin = inc + (long long)blockIdx.x * kNPay * K2;
  const long long base = (long long)blockIdx.x * B;
  const int* fr = frank + base;
  const int* act = active == nullptr ? nullptr
                                     : active + (long long)blockIdx.x * NC;
  // (1) the flag row: counted by run, kept in the staged block
  const bool vec_in = K2 % kVec == 0 && misalign16(tin) == 0;
  int cm = 0, cp = 0;
  if (vec_in) {
    for (int g = threadIdx.x; g < K2 / kVec; g += kThreads) {
      const float4 f = reinterpret_cast<const float4*>(tin + 6 * K2)[g];
      reinterpret_cast<float4*>(stage + 6 * K2)[g] = f;
      const float v[kVec] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int set = v[e] > 0.5f;
        if (kVec * g + e < K) cm += set; else cp += set;
      }
    }
  } else {
    for (int c = threadIdx.x; c < K2; c += kThreads) {
      const float f = tin[6 * K2 + c];
      stage[6 * K2 + c] = f;
      const int set = f > 0.5f;
      if (c < K) cm += set; else cp += set;
    }
  }
  cm = __reduce_add_sync(kFull, cm);
  cp = __reduce_add_sync(kFull, cp);
  if (lane == 0) nflag[0][warp] = cm, nflag[1][warp] = cp;
  if (act != nullptr) list_active(act, 0, NC, list, nlist, warp, lane);
  __syncthreads();
  int n_m = 0, n_p = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) n_m += nflag[0][v], n_p += nflag[1][v];
  // (2) stage columns [0, n_m) and [K, K + n_p) of the six payload rows
  if (vec_in && K % kVec == 0) {
    const int gm = (n_m + kVec - 1) / kVec, gp = (n_p + kVec - 1) / kVec;
    for (int i = threadIdx.x; i < 6 * (gm + gp); i += kThreads) {
      const int q = i / (gm + gp), g = i - q * (gm + gp);
      const int c = q * K2 + (g < gm ? kVec * g : K + kVec * (g - gm));
      cp_async16(stage + c, tin + c);
    }
  } else {
    for (int i = threadIdx.x; i < 6 * (n_m + n_p); i += kThreads) {
      const int q = i / (n_m + n_p), g = i - q * (n_m + n_p);
      const int c = q * K2 + (g < n_m ? g : K + g - n_m);
      stage[c] = tin[c];
    }
  }
  RankedItems it;
  it.list = list;
  it.CB = CB;
  it.listed = act != nullptr;
  const bool vec_fr = misalign16(fr) == 0;
  if (!it.listed) {
    it.h = min(B, (int)(((16u - misalign16(fr)) & 15u) >> 2));
    it.ng = (B - it.h) / kVec;
    it.n = B - (kVec - 1) * it.ng;
  }
  it.width = CB % kVec == 0 && vec_fr ? kVec : 1;
  it.ipc = CB / it.width;
  // (3) place: a rank's column, if that column's flag is set, else -1
  auto column = [&](int f) -> int {
    int col;
    if (f < 0)
      return -1;
    else if (f < n_m)
      col = f;
    else if (f - n_m < n_p)
      col = K + (f - n_m);
    else
      return -1;
    return stage[6 * K2 + col] > 0.5f ? col : -1;
  };
  // the planes' and alive's rows as frank's, off a 16-byte boundary alike
  bool vec_pl = misalign16(alive + base) == misalign16(fr);
#pragma unroll
  for (int q = 0; q < 6; ++q)
    vec_pl &= misalign16(pl.p[q] + base) == misalign16(fr);
  // an item's placed slots (f: its ranks, -1 past its width): a 16-byte
  // group is read from the six planes and alive, its placed slots replaced
  // and written back whole; a scalar item stores its slot
  auto place = [&](int at, int w, const int (&f)[kVec]) {
    int col[kVec];
    bool any = false;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      col[e] = column(f[e]);
      any |= col[e] >= 0;
    }
    if (!any) return;
    const long long k = base + at;
    if (w == kVec && vec_pl) {
      float4 d[kNPay];
#pragma unroll
      for (int q = 0; q < kNPay; ++q)
        d[q] = *reinterpret_cast<const float4*>((q < 6 ? pl.p[q] : alive) +
                                                 k);
#pragma unroll
      for (int q = 0; q < kNPay; ++q) {
        float v[kVec] = {d[q].x, d[q].y, d[q].z, d[q].w};
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (col[e] >= 0)
            v[e] = q < 6 ? stored<true>(stage[q * K2 + col[e]]) : 1.0f;
        *reinterpret_cast<float4*>((q < 6 ? pl.p[q] : alive) + k) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (col[e] >= 0) {
#pragma unroll
        for (int q = 0; q < 6; ++q)
          pl.p[q][k + e] = stored<true>(stage[q * K2 + col[e]]);
        alive[k + e] = 1.0f;
      }
  };
  bool staged = false;
  auto walk = [&]() {
    constexpr int kStep = kRankAhead * kThreads;
    const int rounds = max(1, (it.n + kStep - 1) / kStep);
    for (int r = 0; r < rounds; ++r) {
      int f[kRankAhead][kVec], at[kRankAhead], wd[kRankAhead];
#pragma unroll
      for (int u = 0; u < kRankAhead; ++u) {
        const int q = r * kStep + u * kThreads + threadIdx.x;
        int w = 0;
        at[u] = 0;
        if (q < it.n) it.item(q, &at[u], &w);
        wd[u] = w;
        if (w == kVec) {
          const int4 t = *reinterpret_cast<const int4*>(fr + at[u]);
          f[u][0] = t.x, f[u][1] = t.y, f[u][2] = t.z, f[u][3] = t.w;
        } else {
          f[u][0] = w == 1 ? fr[at[u]] : -1;
          f[u][1] = f[u][2] = f[u][3] = -1;
        }
      }
      if (!staged) {         // block-uniform: the first round of the walk
        cp_async_wait_all();
        __syncthreads();
        staged = true;
      }
#pragma unroll
      for (int u = 0; u < kRankAhead; ++u) place(at[u], wd[u], f[u]);
    }
  };
  for (int w0 = 0;; w0 += kActWindow) {
    if (it.listed) {
      if (w0 > 0) {          // the window's list, once the last is walked
        __syncthreads();
        list_active(act, w0, NC, list, nlist, warp, lane);
        __syncthreads();
      }
      it.pre[0] = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) it.pre[v + 1] = it.pre[v] + nlist[v];
      it.n = it.pre[kWarps] * it.ipc;
    }
    walk();
    if (!it.listed || w0 + kActWindow >= NC) break;
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
  const int K2r = (K2 + kVec - 1) / kVec * kVec;
  const int Kc = K2r < kRankedCols ? K2r : kRankedCols;
  const int nblk = (K2 + Kc - 1) / Kc;
  if ((long long)NT * nblk > 0x7fffffffLL) return -1;
  const size_t smem = sizeof(int) * Kc;        // <= 16 KB
  const Planes pl = {{x, y, z, vx, vy, vz}};
  extract_ranked_kernel<<<NT * nblk, kThreads, smem, (cudaStream_t)stream>>>(
      rank, alive, pl, buf, alive_out, B, K2, Kc, nblk);
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
  const size_t smem = sizeof(float) * kNPay * K2;
  if (smem + kRankedStaticSmem > kMaxSmem) return -1;
  if (smem + kRankedStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_ranked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const MutPlanes pl = {{x, y, z, vx, vy, vz}};
  merge_ranked_kernel<<<NT, kThreads, smem, (cudaStream_t)stream>>>(
      frank, alive, inc, active, pl, B, K2, CB, NC);
  return (int)cudaGetLastError();
}

}  // extern "C"
