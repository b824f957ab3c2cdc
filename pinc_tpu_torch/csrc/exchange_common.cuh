// Device code shared by the exchange kernels: gather_exchange.cu (K8-K10)
// and onehot_exchange.cu (K11).
//
// A tile's B slots are 8 rows of L = B/8 contiguous slots (pinc_tpu's
// (8, B/8) sublane view, whose rows are part of the result: caps, ranks and
// the order in which free slots are filled are per row).  One thread block
// of 8 warps handles one tile, warp w walking row w.  The kernels walk a
// row in chunks of 128 slots, each lane owning 4 consecutive slots that it
// loads and stores with one 16-byte access (RowWalk); only K9's spill
// passes rescan 32 slots a chunk, a slot a lane.  __ballot_sync +
// __popc(mask & lanemask_lt) gives each slot its rank inside a chunk, and
// the warp carries the run from chunk to chunk.
//
// Buffers are payload-major (NT, 7, R, W): x, y, z, vx, vy, vz, flag; R = 8
// rows, or R = 1 for the per-tile kernels of K11, whose ranks run over the
// whole tile in slot order.  In each row the valid entries (flag 1.0) form a
// prefix of every run, zero beyond.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: one per row
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;
constexpr int kNPay = 7;
constexpr int kMaxBlocks = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 4;             // slots of one 16-byte access
constexpr int kChunk = 32 * kVec;   // slots of one warp-wide access

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
  float* p[7];   // cleanup: settled (may be null), then two extras per
                 // remaining axis
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

// Byte offset of p past a 16-byte boundary.
__host__ __device__ __forceinline__ unsigned misalign16(const void* p) {
  return (unsigned)((uintptr_t)p & 15u);
}

// A row of len floats starting at p (4-byte aligned), walked a chunk at a
// time.  The head is the h < 4 slots before the row's first 16-byte
// boundary; chunk -1 holds them in lane 0 (only when h > 0).  In chunk c >=
// 0 lane l owns the 4 slots from h + 4 (32 c + l), one 16-byte access; the
// row's last group may be short (scalar accesses).  Slot order is chunk
// order, then lane order, then the order of a lane's slots, so ranks
// counted that way are the row's slot order.
struct RowWalk {
  int h, len, first, end;   // chunks first (-1 or 0) to end - 1
  __device__ __forceinline__ RowWalk(const float* p, int n) : len(n) {
    h = min(n, (int)(((16u - misalign16(p)) & 15u) >> 2));
    first = h > 0 ? -1 : 0;
    end = (n - h + kChunk - 1) / kChunk;
  }
  // the first slot and the slot count of the lane's group in chunk c
  __device__ __forceinline__ void group(int c, int lane, int* off,
                                        int* n) const {
    if (c < 0) {
      *off = 0;
      *n = lane == 0 ? h : 0;
      return;
    }
    *off = h + kVec * (32 * c + lane);
    *n = max(0, min(kVec, len - *off));
  }
};

// v[0, n) = p[0, n), zeros beyond: one 16-byte load for a whole group (p is
// then 16-byte aligned), else n scalar loads.
__device__ __forceinline__ void load4(float (&v)[kVec], const float* p,
                                      int n) {
  if (n == kVec) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = j < n ? p[j] : 0.0f;
  }
}

// Walk chunks first..end-1 with the loads of chunk c + 1 issued before
// chunk c is processed (registers double-buffered): load(g, c) fills g
// (or part of it: g starts zeroed), proc(g) uses it and returns whether to
// go on (a warp-uniform value).
template <class G, class Load, class Proc>
__device__ __forceinline__ void walk_until(int first, int end, Load load,
                                           Proc proc) {
  if (first >= end) return;
  G cur{}, nxt{};
  load(cur, first);
  for (int c = first;; ++c) {
    const bool more = c + 1 < end;
    if (more) load(nxt, c + 1);
    if (!proc(cur) || !more) return;
    cur = nxt;
  }
}

// walk_until over every chunk: proc(g) returns nothing.
template <class G, class Load, class Proc>
__device__ __forceinline__ void walk_pipelined(int first, int end, Load load,
                                               Proc proc) {
  walk_until<G>(first, end, load, [&](const G& g) {
    proc(g);
    return true;
  });
}

// Ranks of the lane's slots of class c (cls[j] == c) among the warp's, in
// slot order, from *run (the class's slots before this chunk), which is
// advanced past the chunk; take(j, rank) for each.  Four ballots, one per
// slot position: rank(l, j) = run + sum_j' popc(m_j' & lanes below l) +
// #{j' < j : cls[j'] == c}.
template <class Take>
__device__ __forceinline__ void rank_class(const int (&cls)[kVec], int c,
                                           unsigned lt, int* run, Take take) {
  int below = 0, total = 0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const unsigned m = __ballot_sync(kFull, cls[j] == c);
    below += __popc(m & lt);
    total += __popc(m);
  }
  int r = *run + below;
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (cls[j] == c) take(j, r++);
  *run += total;
}

// One lane's group of a walked row as loaded: its first slot, slot count
// and chunk, and the values (zeros past the count).
struct RowGroup {
  int off, n, c;
  float v[kVec];
};

// Bits 0..7 of x to bits 0, 4, ..., 28.
__device__ __forceinline__ unsigned spread8(unsigned x) {
  x &= 0xffu;
  x = (x ^ (x << 12)) & 0x000f000fu;
  x = (x ^ (x << 6)) & 0x03030303u;
  return (x ^ (x << 3)) & 0x11111111u;
}

// The free slots (alive <= 0.5) of a chunk of alive as four 32-slot words:
// bit i of word s is slot 32 s + i of the chunk (the chunk's four ballots,
// one per slot of a lane's group, spread).  Lane l of a merge then places
// slot 32 s + l, so that one store instruction covers one 128-byte line.
__device__ __forceinline__ void free_words(const RowGroup& g,
                                           unsigned (&w)[kVec]) {
  unsigned m[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    m[j] = __ballot_sync(kFull, j < g.n && g.v[j] <= 0.5f);
#pragma unroll
  for (int s = 0; s < kVec; ++s) {
    w[s] = 0u;
#pragma unroll
    for (int j = 0; j < kVec; ++j) w[s] |= spread8(m[j] >> (8 * s)) << j;
  }
}

// The merges' arrival count per block: a group of a walk over the flag
// row's columns [lo, ...) adds its set flags (> 0.5) to cnt[b] for each
// block b of the table that holds them; whole blocks take the group's
// count, a block boundary inside the group counts slot by slot.
__device__ __forceinline__ void count_flags(const RowGroup& g, int lo,
                                            const BlockTable& bt,
                                            int (&cnt)[kMaxBlocks]) {
  int k = 0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) k += g.v[j] > 0.5f;   // 0 past n
  if (!__any_sync(kFull, k)) return;
  const int c0 = lo + g.off, c1 = c0 + g.n;
#pragma unroll
  for (int b = 0; b < kMaxBlocks; ++b) {
    if (b >= bt.n) break;
    const int b0 = bt.off[b], b1 = b0 + bt.w[b];
    if (c0 >= b0 && c1 <= b1) {
      cnt[b] += k;
    } else if (c0 < b1 && c1 > b0) {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        cnt[b] += g.v[j] > 0.5f && c0 + j >= b0 && c0 + j < b1;
    }
  }
}

// p[0, n) = v[0, n): one 16-byte st.global for a whole group that starts
// on a 16-byte boundary, else n scalar stores.  (An output taken from the
// cleanup's table of pointers would otherwise be stored through a generic
// address.)
__device__ __forceinline__ void store4(float* p, const float (&v)[kVec],
                                       int n) {
  if (n == kVec && misalign16(p) == 0) {
    asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                 : "memory");
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < n) p[j] = v[j];
  }
}

// The fill pass of the extract and the cleanup, with all the block's
// warps: it writes every entry of nseg output segments once.  seg(s, &row,
// &pstride, &n, &cap) gives segment s's payload-0 row, its payload stride
// and its count n <= cap, or returns false for a segment not written; the
// segment's flag row (payload 6) holds, at [0, n), the source index of
// each entry as the bits of a float, put there by the ranking pass.
// Column j < n takes src(s, q, index) for payload q = 0..6, column j >= n
// zeros.  The columns are walked as RowWalk groups of the payload-0 row, a
// work item a (segment, chunk): a lane reads its group's indices, issues
// its 7 x 4 gathers together and stores each payload row with one 16-byte
// store (scalar stores where a payload row's group is off a 16-byte
// boundary).  A lane reads and then overwrites only its own columns'
// indices.
template <class Seg, class Src>
__device__ __forceinline__ void fill_segments(int nseg, int maxcap, Seg seg,
                                              Src src) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (maxcap + kChunk - 1) / kChunk + 1;   // head included
  // with more segments than warps the segments are interleaved, so that
  // each warp takes first chunks (most of the copies) and later ones
  // (mostly zeros) alike; with fewer, the warps take consecutive chunks of
  // a segment, whose stores then fall on one stretch of memory (faster on
  // the card for K8's one class a row)
  const bool spread = nseg > kWarps;
  for (int i = warp; i < nseg * per; i += kWarps) {
    const int s = spread ? i % nseg : i / per;
    float* row;
    long long ps;
    int n, cap;
    if (!seg(s, &row, &ps, &n, &cap)) continue;
    const RowWalk walk(row, cap);
    const int c = walk.first + (spread ? i / nseg : i % per);
    if (c >= walk.end) continue;
    int off, cnt;
    walk.group(c, lane, &off, &cnt);
    const int m = max(0, min(cnt, n - off));   // columns copied
    const float* ix = row + 6 * ps + off;   // indices as float bits
    int idx[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      idx[j] = j < m ? __float_as_int(ix[j]) : 0;
    float v[kNPay][kVec];
#pragma unroll
    for (int q = 0; q < kNPay; ++q)
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[q][j] = j < m ? src(s, q, idx[j]) : 0.0f;
#pragma unroll
    for (int q = 0; q < kNPay; ++q) store4(row + q * ps + off, v[q], cnt);
  }
}

// The class of a live slot from its classifier coordinates (c[0] for kDim,
// x, y, z otherwise), or -1 if it stays.  Comparisons are those of
// pinc_tpu's extract kernels (NaN stays).
template <int KIND>
__device__ __forceinline__ int classify(const float* c, float T) {
  if constexpr (KIND == kDim) {
    return c[0] < 0.0f ? 0 : (c[0] >= T ? 1 : -1);
  } else {
    const float x = c[0], y = c[1], z = c[2];
    if (KIND == kAll) {
      if (x < 0.0f) return 0;
      if (x >= T) return 1;
      if (y < 0.0f) return 2;
      if (y >= T) return 3;
      if (z < 0.0f) return 4;
      if (z >= T) return 5;
      return -1;
    }
    return (x < 0.0f || x >= T || y < 0.0f || y >= T || z < 0.0f ||
            z >= T) ? 0 : -1;
  }
}

// A payload as the kernel stores it.  CANON: x + 0.0f, which turns -0.0
// into +0.0 as pinc_tpu's one-hot selection matmuls do (a sum of one
// product and +0.0 products); the gather kernels copy bits.
template <bool CANON>
__device__ __forceinline__ float stored(float x) {
  return CANON ? __fadd_rn(x, 0.0f) : x;
}

// One lane's group of an extract chunk as loaded: its first slot and slot
// count, alive, and the classifier's coordinates (coord for kDim; x, y, z).
template <int KIND>
struct ExtractGroup {
  static constexpr int NC = KIND == kDim ? 1 : 3;
  int off, n;
  float a[kVec];
  float c[NC][kVec];
};

// The leaver extract: K8 (R = 8, bit copies) and K11's extract_rows,
// extract_all_rows (R = 8) and extract_fused (R = 1), with CANON.
//
// Every slot reads alive and its classifier's coordinates and writes alive
// (leavers killed); a leaver of class c ranked r < Ks (per row for R = 8,
// per tile in slot order for R = 1) reads its 6 values and writes 7 to
// column c*Ks + r; leavers ranked >= Ks are killed and not copied
// (dropped).  Bound: bytes.  Design: a ranking pass streams the planes:
// each lane loads 4 slots of alive and of each classifier plane with
// 16-byte loads, issued together and for every slot (dead ones included,
// ~6% at slack 1.0625), with the next chunk's in flight while a chunk is
// ranked, and writes alive with one 16-byte store.  Ranks in slot order
// take four ballots a class (rank_class; no shuffle, no shared memory), and
// a leaver writes only its slot, into its buffer column's flag entry (a
// chunk without a leaver costs one __any_sync).  After a __syncthreads the
// fill pass (fill_segments) writes every buffer entry once with 16-byte
// stores, gathering the leavers' 6 values by slot with all the block's
// warps and many loads in flight, zeros beyond each count, so the buffer
// needs no memset.  Rows whose start is not 16-byte aligned (L % 4 != 0,
// K11 only) take a scalar head and a short last group.  R = 1 adds a
// counting pass with the same loads (each warp's leavers per class, so that
// warp w starts its ranks at the count of the rows before it); the tile's
// slices are read again from L2.  The host checks that alive, alive_out
// and the classifier planes share one alignment mod 16 bytes.
template <int KIND, int R, bool CANON>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const float* __restrict__ alive, const float* coord, Planes pl,
               float* __restrict__ buf, float* __restrict__ alive_out, int B,
               int Ks, float T) {
  constexpr int NCLS = n_classes<KIND>();
  constexpr int NC = ExtractGroup<KIND>::NC;
  using G = ExtractGroup<KIND>;
  __shared__ int counts[kRows][NCLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int L = B / kRows;
  const int W = NCLS * Ks;
  const long long base = (long long)blockIdx.x * B + (long long)warp * L;
  const long long pstride = (long long)R * W;
  float* tile_out = buf + (long long)blockIdx.x * kNPay * R * W;
  // the ranking pass puts each leaver's slot (in the tile) into its flag
  // entry; the fill pass then copies
  float* ix = tile_out + 6 * pstride + (R == 1 ? 0 : warp) * W;
  const float* cpl[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) cpl[i] = KIND == kDim ? coord : pl.p[i];
  const RowWalk walk(alive + base, L);

  auto load = [&](G& g, int c) {
    walk.group(c, lane, &g.off, &g.n);
    load4(g.a, alive + base + g.off, g.n);
#pragma unroll
    for (int i = 0; i < NC; ++i) load4(g.c[i], cpl[i] + base + g.off, g.n);
  };
  auto classes = [&](const G& g, int (&cls)[kVec]) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float v[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) v[i] = g.c[i][j];
      cls[j] = j < g.n && g.a[j] > 0.5f ? classify<KIND>(v, T) : -1;
    }
  };

  int run[NCLS];
#pragma unroll
  for (int c = 0; c < NCLS; ++c) run[c] = 0;
  if (R == 1) {
    int own[NCLS];
#pragma unroll
    for (int c = 0; c < NCLS; ++c) own[c] = 0;
    walk_pipelined<G>(walk.first, walk.end, load, [&](const G& g) {
      int cls[kVec];
      classes(g, cls);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
#pragma unroll
        for (int c = 0; c < NCLS; ++c) own[c] += cls[j] == c;
    });
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      own[c] = __reduce_add_sync(kFull, own[c]);
      if (lane == 0) counts[warp][c] = own[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NCLS; ++c)
      for (int w = 0; w < warp; ++w) run[c] += counts[w][c];
  }

  walk_pipelined<G>(walk.first, walk.end, load, [&](const G& g) {
    int cls[kVec];
    classes(g, cls);
    float kept[kVec];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      kept[j] = cls[j] >= 0 ? 0.0f : g.a[j];
      any |= cls[j] >= 0;
    }
    store4(alive_out + base + g.off, kept, g.n);
    if (!__any_sync(kFull, any)) return;
#pragma unroll
    for (int c = 0; c < NCLS; ++c)
      rank_class(cls, c, lt, &run[c], [&](int j, int rank) {
        if (rank < Ks)
          ix[c * Ks + rank] = __int_as_float(warp * L + g.off + j);
      });
  });

  // the counts: for R = 1 those of the counting pass, run[c] ending at the
  // count of rows 0..warp
  if (R == kRows && lane == 0) {
#pragma unroll
    for (int c = 0; c < NCLS; ++c) counts[warp][c] = run[c];
  }
  __syncthreads();
  const float* tile_pl[6];
#pragma unroll
  for (int q = 0; q < 6; ++q)
    tile_pl[q] = pl.p[q] + (long long)blockIdx.x * B;
  fill_segments(
      (R == 1 ? 1 : kRows) * NCLS, Ks,
      [&](int s, float** row, long long* ps, int* n, int* cap) {
        const int r = s / NCLS, c = s - r * NCLS;
        int count = counts[r][c];
        if (R == 1)
          for (int w = 1; w < kRows; ++w) count += counts[w][c];
        *row = tile_out + (long long)r * W + c * Ks;
        *ps = pstride;
        *n = min(count, Ks);
        *cap = Ks;
        return true;
      },
      [&](int, int q, int k) {
        return q == 6 ? 1.0f : stored<CANON>(tile_pl[q][k]);
      });
}

// Launch extract_kernel<kDim or KIND, R, CANON>: kind 0, 1, 2 classify on
// `coord`, kAll and kAny on x, y, z.  Returns the launch error, -1 for a
// kind the kernel does not take or planes whose 16-byte alignment differs
// from alive's and alive_out's (the kernel's 16-byte groups start at the
// same slot in each).
template <int R, bool CANON>
int launch_extract(int kind, const float* alive, const float* coord,
                   const Planes& pl, float* buf, float* alive_out, int NT,
                   int B, int Ks, float T, cudaStream_t s) {
  const unsigned a = misalign16(alive);
  const bool dim = kind >= 0 && kind < 3;
  if (misalign16(alive_out) != a ||
      (dim ? misalign16(coord) != a
           : (misalign16(pl.p[0]) != a || misalign16(pl.p[1]) != a ||
              misalign16(pl.p[2]) != a)))
    return -1;
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
