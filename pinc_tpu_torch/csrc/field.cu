// Hand-written Hopper (sm_90a) kernels of the field glue around the
// Poisson solve: efield_tiles (K6) and fold_global (K7).
//
// They replace the Pallas TPU kernels of pinc_tpu/ops/pallas_field.py
// (_efield_kernel and _fold_kernel).  Both are pure data movement, bound by
// the bytes they move: phi (8.4 MB at 128^3) and the padded tile blocks
// (22-36 MB).  The TPU kernels keep a transposed (y, x, z) phi resident in
// VMEM and build lane rolls and concatenations around the Mosaic tiling;
// none of that is needed here.  efield_tiles is one block per run of
// tiles along z: the run's periodic window of phi is staged in shared
// memory once (phi itself fits the 50 MB L2), then the run's contiguous
// span of outputs is written with 16-byte stores.  fold_global is one
// block per run of tiles along z too: the run's tiles and their
// neighbours' margins are staged with 16-byte loads, folded in shared
// memory and the run's rows of rho written with 16-byte stores (M >= T,
// which no deck uses, takes a kernel of one thread per node).  Index
// arithmetic is 32-bit where the sizes allow (the entry points check).
//
// Layouts (row-major):
//   phi, rho      (X, Y, Z) float32
//   E tiles       (NT, 3P, P*P): row c*P + a, column b*P + e holds E_c at
//                 the node (tx*T + a - M, ty*T + b - M, tz*T + e - M),
//                 periodic; float32 or bfloat16
//   tiles         (NT, P, P*P) float32 padded node blocks (offsets -M..T+M)
// with tile t = (tx*nty + ty)*ntz + tz and P = T + 1 + 2M.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument
// the kernels do not take).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 2;     // efield's staging groups a thread in flight
constexpr int kLoadsFold = 4; // the fold's staging items a thread in flight
constexpr int kRunMax = 8;   // tiles a run, at most

__device__ __forceinline__ int wrap(int g, int n) {
  while (g < 0) g += n;
  while (g >= n) g -= n;
  return g;
}

__device__ __forceinline__ int floor_div4(int x) { return x >> 2; }

// Byte offset of p past a 16-byte boundary.
__device__ __forceinline__ unsigned misalign16(const void* p) {
  return (unsigned)((uintptr_t)p & 15u);
}

// Mixed-radix digits, fastest first, of a flat index; the last digit is
// unbounded.  add() advances digits d by the digits s of a stride (each
// below its radix), so the loops below walk a tile's nodes without an
// integer division per element.
template <int N>
struct Radix {
  int r[N - 1];
  __device__ __forceinline__ void split(int i, int (&d)[N]) const {
#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      d[k] = i % r[k];
      i /= r[k];
    }
    d[N - 1] = i;
  }
  __device__ __forceinline__ void add(int (&d)[N], const int (&s)[N]) const {
    int carry = 0;
#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      d[k] += s[k] + carry;          // < 2 r[k]
      carry = d[k] >= r[k];
      if (carry) d[k] -= r[k];
    }
    d[N - 1] += s[N - 1] + carry;
  }
};

template <bool BF16>
struct EOut {
  using T = float;
  __device__ static float cast(float v) { return v; }
};
template <>
struct EOut<true> {
  using T = __nv_bfloat16;
  __device__ static __nv_bfloat16 cast(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Shared memory of efield_kernel for runs of g tiles, in floats: the
// window (rounded to 16 bytes), then each warp's staging of its outputs,
// 32 rows of P values and up to 16 bytes of alignment shift, in 16-byte
// units.
__host__ __device__ inline int efield_window_floats(int g, int T, int M) {
  const int W = T + 2 * M + 3;
  return (W * (W * (g * T + 2 * M + 3) + 32) + 3) & ~3;
}

// The window's x-plane x starts at x (W Zw + 32) + skew(x): with the skew
// below, the rows (a, b) of 32 consecutive output rows of one (tile, c)
// fall on 32 distinct banks (bank = ((a P + b) Zw + const) % 32, Zw odd),
// where the plain layout, whose rows step by W Zw from a to a + 1, puts
// two on one bank.
__device__ __forceinline__ int plane_base(int x, int W, int Zw) {
  return x * (W * Zw + 32) + (((1 - 2 * x - W) * Zw) & 31);
}
__host__ __device__ inline int efield_stage_floats(int T, int M) {
  const int P = T + 1 + 2 * M;
  return (32 * P * 4 + 16 + 15) / 16 * 4;   // f32: 32 P values + shift
}
__host__ __device__ inline size_t efield_smem(int g, int T, int M) {
  return (size_t)(efield_window_floats(g, T, M) +
                  kWarps * efield_stage_floats(T, M)) * sizeof(float);
}

// The default run length: the longest run of 8, 4 or 2 tiles whose shared
// memory stays within kRunSmem bytes, else one tile.
constexpr size_t kRunSmem = 56 * 1024;
inline int efield_run(int T, int M) {
  for (int g = kRunMax; g > 1; g /= 2)
    if (efield_smem(g, T, M) <= kRunSmem) return g;
  return 1;
}

// K6: E = -grad(phi) = 0.5 (phi[n-1] - phi[n+1]) per component, written
// as padded component-major tiles; E is computed in float32 and cast to
// the output type once.  Bound: bytes (phi read once, the tiles written
// once).  Design: one block per run of up to g consecutive tiles along z
// (tile t = (tx nty + ty) ntz + tz, so their outputs are one contiguous
// span; a pencil's last run takes the ntz % g rest).  The run's periodic
// window of phi, (P+2)^2 rows along z of g T + 2M + 3 nodes (offsets -M-1
// .. on each axis), is staged in shared memory once, with 16-byte loads
// of phi's aligned 4-node groups (a row wraps only where it crosses the
// grid's z edge; Z % 4 != 0 takes scalar loads), kLoads groups a thread
// in flight.  The span is rows of P outputs along z (one (tile, c, a, b)
// each); a warp takes 32 consecutive rows, a lane a row: the index
// arithmetic is per row, and per output two shared reads, a difference
// and a cast.  The window's x-planes are skewed (plane_base) so that the
// lanes' reads fall on distinct banks.  The warp puts its 32 P outputs in its staging
// slice, shifted to the span's 16-byte alignment, and stores the aligned
// groups with 16-byte stores, the partial groups at either end scalar.
template <bool OUT_BF16, int PC>
__global__ void __launch_bounds__(kThreads, 3)
efield_kernel(const float* __restrict__ phi, void* __restrict__ out, int X,
              int Y, int Z, int nty, int ntz, int T, int M, int P_, int g) {
  using Out = typename EOut<OUT_BF16>::T;
  constexpr int V = 16 / sizeof(Out);
  extern __shared__ __align__(16) float smem[];
  const int P = PC ? PC : P_;   // a compile-time P unrolls the rows
  const int W = P + 2;
  const int runs = (ntz + g - 1) / g;
  const int rz = blockIdx.x % runs, pencil = blockIdx.x / runs;
  const int ty = pencil % nty, tx = pencil / nty;
  const int tz0 = rz * g, ng = min(g, ntz - tz0);
  const int Zw = ng * T + 2 * M + 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* win = smem;
  Out* stage = reinterpret_cast<Out*>(smem + efield_window_floats(g, T, M) +
                                      warp * efield_stage_floats(T, M));

  // the window: item (row, group) loads phi's 4-node group q0 + group of
  // window row (x, y) and keeps the nodes inside [gz0, gz0 + Zw)
  const int gx0 = tx * T - M - 1, gy0 = ty * T - M - 1, gz0 = tz0 * T - M - 1;
  const int q0 = floor_div4(gz0);
  const int nq = floor_div4(gz0 + Zw - 1) - q0 + 1;
  const bool vec = (Z & 3) == 0 && ((uintptr_t)phi & 15u) == 0;
  const int items = W * W * nq;
  const Radix<3> wr = {{nq, W}};
  int it[3], st[3];
  wr.split(threadIdx.x, it);     // (group, y, x) of item i
  wr.split(kThreads, st);
  for (int i0 = threadIdx.x; i0 < items; i0 += kLoads * kThreads) {
    float v[kLoads][4];
    int dst[kLoads], z0[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u, wr.add(it, st)) {
      if (i0 + u * kThreads >= items) continue;
      const float* rowp =
          phi + ((long long)wrap(gx0 + it[2], X) * Y + wrap(gy0 + it[1], Y)) *
                    Z;
      z0[u] = 4 * (q0 + it[0]);
      dst[u] = plane_base(it[2], W, Zw) + it[1] * Zw - gz0;
      if (vec) {
        const float4 t =
            *reinterpret_cast<const float4*>(rowp + wrap(z0[u], Z));
        v[u][0] = t.x;
        v[u][1] = t.y;
        v[u][2] = t.z;
        v[u][3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = rowp[wrap(z0[u] + j, Z)];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (i0 + u * kThreads >= items) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int zi = z0[u] + j - gz0;
        if (zi >= 0 && zi < Zw) win[dst[u] + z0[u] + j] = v[u][j];
      }
    }
  }
  __syncthreads();

  // row rho of the span is (b, a, c, k): offsets (a, b, 0..P-1) of
  // component c of the run's tile k; its P outputs are [rho P, rho P + P)
  const int n = ng * 3 * P * P * P, nrows = ng * 3 * P * P;
  const long long R0 = (long long)((tx * nty + ty) * ntz + tz0) * 3 * P * P * P;
  Out* o = static_cast<Out*>(out) + R0;   // out starts on 16 bytes
  const int nch = (nrows + 31) / 32;
  const Radix<4> rr = {{P, P, 3}};
  int d[4], hop[4];
  rr.split(warp * 32 + lane, d);
  rr.split(kWarps * 32, hop);
  for (int ch = warp; ch < nch; ch += kWarps, rr.add(d, hop)) {
    const int x0 = ch * 32 * P, x1 = min(x0 + 32 * P, n);
    const int sh = (int)((R0 + x0) % V);   // the chunk's 16-byte offset
    if (ch * 32 + lane < nrows) {
      // the row's neighbours along component c: planes a, a + 2 (x),
      // rows b, b + 2 of plane a + 1 (y), nodes -1, +1 (z)
      const int a = d[1], b = d[0], c = d[2], zo = d[3] * T + 1;
      const int mid = plane_base(a + 1, W, Zw);
      const int lo_i = c == 0 ? plane_base(a, W, Zw) + (b + 1) * Zw + zo
                     : (c == 1 ? mid + b * Zw + zo : mid + (b + 1) * Zw + zo - 1);
      const int hi_i = c == 0 ? plane_base(a + 2, W, Zw) + (b + 1) * Zw + zo
                     : (c == 1 ? lo_i + 2 * Zw : lo_i + 2);
      const float* lo = win + lo_i;
      const float* hi = win + hi_i;
      Out* op = stage + sh + lane * P;
#pragma unroll (PC ? PC : 4)
      for (int e = 0; e < P; ++e)
        op[e] = EOut<OUT_BF16>::cast(0.5f * (lo[e] - hi[e]));
    }
    __syncwarp();
    // [ga, gb): the chunk's whole 16-byte groups (span offsets)
    const int ga = min(x1, x0 + (V - sh) % V);
    const int gb = max(ga, x1 - (int)((R0 + x1) % V));
    for (int x = ga + lane * V; x < gb; x += 32 * V) {
      const uint4 w = *reinterpret_cast<const uint4*>(stage + sh + x - x0);
      asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(o + x),
                   "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w)
                   : "memory");
    }
    if (lane < ga - x0) o[x0 + lane] = stage[sh + lane];
    if (lane >= 16 && lane - 16 < x1 - gb)
      o[gb + lane - 16] = stage[sh + gb - x0 + lane - 16];
    __syncwarp();
  }
}

// The k-th source of a grid node along one axis, in the summation order
// 0, -1, +1, -2, +2, ...: node m of tile t takes offset a = m + M + j*T
// of tile t - j, where 0 <= a < P.
__device__ __forceinline__ int source_offset(int k) {
  return (k & 1) ? -((k + 1) >> 1) : (k >> 1);
}

// x / d for 0 <= x < 2^22 and d > 0, inv = 1.0f / d: a float estimate of
// the quotient, off by at most one, corrected.
__device__ __forceinline__ int div_small(int x, int d, float inv) {
  const int q = (int)((float)x * inv);
  const int r = x - q * d;
  return r < 0 ? q - 1 : (r >= d ? q + 1 : q);
}

// One past the last k of that order whose offset lies in [0, P): the valid
// j form the range [-(m+M)/T, (T+M-m)/T] around 0.
__device__ __forceinline__ int sources_end(int m, int M, int T, float invT) {
  return max(2 * div_small(m + M, T, invT),
             2 * div_small(T + M - m, T, invT) + 1);
}

// fold_kernel's staged blocks: padded plane ax of block k starts at float
// (k P + ax) S + pad, row ay of it at + ay P; S (a multiple of 4) and pad
// put every plane and its core rows (ay = M) on a 16-byte boundary.
struct FoldLayout {
  int pad, S;
  __host__ __device__ FoldLayout(int T, int M) {
    const int P = T + 1 + 2 * M;
    pad = (-M * P) & 3;
    S = (pad + P * P + 3) & ~3;
  }
};

// Shared memory of fold_kernel for runs of g tiles: g + 2 staged blocks of
// P planes, and the staging's table of spans (3 a plane).
__host__ __device__ inline size_t fold_smem(int g, int T, int M) {
  const int P = T + 1 + 2 * M;
  return ((size_t)(g + 2) * P * (FoldLayout(T, M).S + 3)) * sizeof(float);
}

// The default run length of the fold: the longest run of 8, 4 or 2 tiles
// whose shared memory stays within kRunSmem bytes, else one tile (4 at T =
// 8, M = 2; 8 at M = 1).
inline int fold_run(int T, int M) {
  for (int g = kRunMax; g > 1; g /= 2)
    if (fold_smem(g, T, M) <= kRunSmem) return g;
  return 1;
}

// a + b where the plain version adds a piece of the neighbouring tile, a +
// 0.0f where it adds the zeros that pad that piece
__device__ __forceinline__ float add_piece(float a, bool covered, float b) {
  return a + (covered ? b : 0.0f);
}

// the same for 4 entries of one plane: *b is read only where covered
__device__ __forceinline__ float4 add_piece4(float4 a, bool covered,
                                             const float4* b) {
  const float4 c = covered ? *b : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_float4(a.x + c.x, a.y + c.y, a.z + c.z, a.w + c.w);
}

// K7: rho[g] = sum over the tiles whose padded block covers g.  The sum is
// nested per axis, x innermost, each axis in the order of source_offset
// (0, -1, +1): the order of ops/tiled.fold_to_global's three per-axis
// overlap-add passes, so the result is that function's (fold_global_plain's)
// bit for bit, its additions of a piece's zero padding included.  No
// atomics.  Bound: bytes (the tiles read once, rho written once).
//
// Design, for M < T (a node then takes from the tiles t - 1, t, t + 1 of
// each axis): one block per run of up to g consecutive tiles along z at
// (tx, ty) (tile t = (tx nty + ty) ntz + tz, fold_run; a pencil's last run
// takes the ntz % g rest).  It stages in shared memory, for each of the
// run's tiles and its two z-neighbours (periodic), a P^3 block assembled
// from the 9 tiles of the (x, y) neighbourhood: padded plane ax of the
// block comes from tile tx + 1 for ax < M (the low margin planes the run's
// high nodes take), tx - 1 for ax >= T + M, tx otherwise; within a plane
// the rows ay the same way along y.  Each (plane, y-region) is one
// contiguous span of the tiles array (n P floats, n = M, T or M + 1 rows):
// a table of the spans' offsets is built first, then every thread loads
// items of them, a span's head up to its first 16-byte boundary scalar,
// then 16-byte groups (the last one short), kLoadsFold items in flight.
// The fold then runs in shared memory, in place, pass by pass, on the
// layout of FoldLayout: x (each core plane takes the margin planes T
// away, as float4s over the whole plane), y (the core rows of each core
// plane take the margin rows T P floats away, float4s where T P % 4 ==
// 0), z (each run tile's core nodes take its neighbours' margins) as the
// rows of rho are written: a row of rho is the run's g T contiguous z
// nodes at (gx, gy), written in 16-byte groups from its first 16-byte
// boundary on.  Every pass reads only entries no pass writes, or the one
// it writes.  The work is mostly index arithmetic and shared-memory
// traffic, not bytes: a build that decoded each staging item from
// mixed-radix digits and ran scalar passes took 0.0556 ms at 128^3, M = 2,
// on an H100 in a CUDA graph (bound 0.0132).  (T, M) = (8, 1) and (8, 2)
// are compiled with T and M known.
template <int TC, int MC>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ tiles, float* __restrict__ rho, int Y,
            int Z, int ntx, int nty, int ntz, int T_, int M_, int g) {
  extern __shared__ __align__(16) float blk[];
  const int T = TC ? TC : T_, M = TC ? MC : M_;
  const int P = T + 1 + 2 * M, P2 = P * P;
  const FoldLayout lay(T, M);
  const int S = lay.S;
  const int runs = (ntz + g - 1) / g;
  const int rz = blockIdx.x % runs, pencil = blockIdx.x / runs;
  const int ty = pencil % nty, tx = pencil / nty;
  const int tz0 = rz * g, ng = min(g, ntz - tz0);
  const int nk = ng + 2;   // staged blocks: tiles tz0 - 1 .. tz0 + ng
  int* span = reinterpret_cast<int*>(blk + nk * P * S);

  // (1) staging.  Span (j, r) of plane j = k P + ax: rows [ay0(r), ay0(r) +
  // n(r)), region r = 0 (rows [0, M), tile ty + 1), 1 (core, ty), 2 (rows
  // [T + M, P), ty - 1), its offset in the tiles array in the table
  for (int i = threadIdx.x; i < 3 * nk * P; i += kThreads) {
    const int j = i / 3, r = i - 3 * j, k = j / P, ax = j - k * P;
    const int sx = wrap(tx + (ax < M ? 1 : (ax < T + M ? 0 : -1)), ntx);
    const int sy = wrap(ty + 1 - r, nty);
    const int sz = wrap(tz0 - 1 + k, ntz);
    span[i] = (((sx * nty + sy) * ntz + sz) * P + ax) * P2 +
              (r == 0 ? 0 : (r == 1 ? M : T + M)) * P;
  }
  __syncthreads();
  // a plane's items: 0 the head of a span, q >= 1 its 16-byte group
  // [h + 4 (q - 1), h + 4 q)
  const int Q0 = (M * P + 3) / 4 + 1, Q1 = (T * P + 3) / 4 + 1;
  const int Q = Q0 + Q1 + (M * P + P + 3) / 4 + 1;
  const int items = nk * P * Q;
  const unsigned mis = (unsigned)((uintptr_t)tiles >> 2) & 3u;
  const Radix<2> sr = {{Q}};
  int it[2], st[2];
  sr.split(threadIdx.x, it);     // (item of the plane, plane)
  sr.split(kThreads, st);
  for (int i0 = threadIdx.x; i0 < items; i0 += kLoadsFold * kThreads) {
    float v[kLoadsFold][4];
    int dst[kLoadsFold], cnt[kLoadsFold];
#pragma unroll
    for (int u = 0; u < kLoadsFold; ++u, sr.add(it, st)) {
      cnt[u] = 0;
      if (i0 + u * kThreads >= items) continue;
      const int qq = it[0], j = it[1];
      const int r = qq < Q0 ? 0 : (qq < Q0 + Q1 ? 1 : 2);
      const int q = qq - (r == 0 ? 0 : (r == 1 ? Q0 : Q0 + Q1));
      const int n = (r == 0 ? M : (r == 1 ? T : M + 1)) * P;
      const int so = span[3 * j + r];
      const int h = min(n, (int)((0u - (mis + (unsigned)so)) & 3u));
      const int off = q == 0 ? 0 : h + 4 * (q - 1);
      cnt[u] = q == 0 ? h : max(0, min(4, n - off));
      dst[u] = j * S + lay.pad + (r == 0 ? 0 : (r == 1 ? M : T + M)) * P +
               off;
      const float* src = tiles + so + off;
      if (cnt[u] == 4) {
        const float4 t = *reinterpret_cast<const float4*>(src);
        v[u][0] = t.x;
        v[u][1] = t.y;
        v[u][2] = t.z;
        v[u][3] = t.w;
      } else {
#pragma unroll
        for (int e = 0; e < 3; ++e)
          if (e < cnt[u]) v[u][e] = src[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadsFold; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < cnt[u]) blk[dst[u] + e] = v[u][e];
  }
  __syncthreads();

  // (2) the x pass: core plane mx + M of every staged block takes plane
  // mx + M - T (j = -1, mx >= T - M) and mx + M + T (j = +1, mx <= M),
  // float4s over the plane's S floats (its padding too, never read after)
  {
    float4* b4 = reinterpret_cast<float4*>(blk);
    const int S4 = S / 4, TS4 = T * S4;
    const Radix<3> xr = {{S4, T}};
    int d[3], s[3];
    xr.split(threadIdx.x, d);
    xr.split(kThreads, s);
    for (int i = threadIdx.x; i < nk * T * S4; i += kThreads, xr.add(d, s)) {
      const int mx = d[1];
      float4* e = b4 + (d[2] * P + mx + M) * S4 + d[0];
      float4 x = *e;
      if (M > 0) x = add_piece4(x, mx >= T - M, e - TS4);
      *e = add_piece4(x, mx <= M, e + TS4);
    }
  }
  __syncthreads();

  // (3) the y pass: core row my + M of each core plane takes rows my + M
  // - T and my + M + T: the core rows are T P floats from a 16-byte
  // boundary, in float4s where T P % 4 == 0
  const int TP = T * P;
  if (TP % 4 == 0) {
    const int TP4 = TP / 4;
    const Radix<3> yr = {{TP4, T}};
    int d[3], s[3];
    yr.split(threadIdx.x, d);
    yr.split(kThreads, s);
    for (int i = threadIdx.x; i < nk * T * TP4; i += kThreads, yr.add(d, s)) {
      float* e = blk + (d[2] * P + d[1] + M) * S + lay.pad + M * P + 4 * d[0];
      const float4 c = *reinterpret_cast<const float4*>(e);
      // the rows of the float4's first and last entries
      const int my0 = 4 * d[0] / P, my3 = (4 * d[0] + 3) / P;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 lo = M > 0 && my3 >= T - M
                            ? *reinterpret_cast<const float4*>(e - TP) : zero;
      const float4 hi = my0 <= M ? *reinterpret_cast<const float4*>(e + TP)
                                 : zero;
      float y[4] = {c.x, c.y, c.z, c.w};
      const float l[4] = {lo.x, lo.y, lo.z, lo.w};
      const float h[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int my = (4 * d[0] + u) / P;
        if (M > 0) y[u] = add_piece(y[u], my >= T - M, l[u]);
        y[u] = add_piece(y[u], my <= M, h[u]);
      }
      *reinterpret_cast<float4*>(e) = make_float4(y[0], y[1], y[2], y[3]);
    }
  } else {
    const Radix<3> yr = {{TP, T}};
    int d[3], s[3];
    yr.split(threadIdx.x, d);
    yr.split(kThreads, s);
    for (int i = threadIdx.x; i < nk * T * TP; i += kThreads, yr.add(d, s)) {
      float* e = blk + (d[2] * P + d[1] + M) * S + lay.pad + M * P + d[0];
      const int my = d[0] / P;
      float y = *e;
      if (M > 0) y = add_piece(y, my >= T - M, my >= T - M ? e[-TP] : 0.0f);
      *e = add_piece(y, my <= M, my <= M ? e[TP] : 0.0f);
    }
  }
  __syncthreads();

  // (4) the z pass as rho is written: node mz of run tile k (block k + 1)
  // takes node mz + M - T of block k + 2 and mz + M + T of block k.  Row
  // (mx, my) of rho holds the run's ng T nodes from tz0 T on; its items:
  // 0 the head before the row's first 16-byte boundary, q >= 1 a group
  const int nz = ng * T;
  const int Qz = (nz + 3) / 4 + 1;
  const int PS = P * S;
  const Radix<3> zr = {{Qz, T}};
  int d[3], s[3];
  zr.split(threadIdx.x, d);
  zr.split(kThreads, s);
  for (int i = threadIdx.x; i < T * T * Qz; i += kThreads, zr.add(d, s)) {
    const int q = d[0], my = d[1], mx = d[2];
    float* row = rho + ((long long)(tx * T + mx) * Y + ty * T + my) * Z +
                 tz0 * T;
    const int h = min(nz, (int)(((16u - misalign16(row)) & 15u) >> 2));
    const int off = q == 0 ? 0 : h + 4 * (q - 1);
    const int n = q == 0 ? h : max(0, min(4, nz - off));
    const float* core = blk + (P + mx + M) * S + lay.pad + (my + M) * P + M;
    float out[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u >= n) continue;
      const int ez = off + u, k = ez / T, mz = ez - k * T;
      const float* e = core + k * PS + mz;
      float z = *e;
      if (M > 0) z = add_piece(z, mz >= T - M, e[PS - T]);
      out[u] = add_piece(z, mz <= M, e[T - PS]);
    }
    if (n == 4) {
      asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(row + off),
                   "f"(out[0]), "f"(out[1]), "f"(out[2]), "f"(out[3])
                   : "memory");
    } else {
#pragma unroll
      for (int u = 0; u < 3; ++u)
        if (u < n) row[off + u] = out[u];
    }
  }
}

// K7 for any T and M (fold_kernel takes M < T): the gather form, one thread
// per node, reading the tile entries that cover it in the same nested
// order.  Bound: bytes, as fold_kernel.  blockIdx.z is x, blockIdx.y is y,
// z runs along the threads.
__global__ void __launch_bounds__(kThreads)
fold_generic_kernel(const float* __restrict__ tiles, float* __restrict__ rho,
                    int Y, int Z, int ntx, int nty, int ntz, int T,
                    float invT, int M, int P) {
  const int gz = blockIdx.x * blockDim.x + threadIdx.x;
  if (gz >= Z) return;
  const int gy = blockIdx.y, gx = blockIdx.z;
  const int P2 = P * P, P3 = P2 * P;
  const int tx = div_small(gx, T, invT), ty = div_small(gy, T, invT),
            tz = div_small(gz, T, invT);
  const int mx = gx - tx * T, my = gy - ty * T, mz = gz - tz * T;
  const int kx_end = sources_end(mx, M, T, invT),
            ky_end = sources_end(my, M, T, invT),
            kz_end = sources_end(mz, M, T, invT);
  float rz = 0.0f;
  for (int kz = 0; kz < kz_end; ++kz) {
    const int jz = source_offset(kz), az = mz + M + jz * T;
    if (az < 0 || az >= P) continue;
    const int sz = wrap(tz - jz, ntz);
    float ry = 0.0f;
    for (int ky = 0; ky < ky_end; ++ky) {
      const int jy = source_offset(ky), ay = my + M + jy * T;
      if (ay < 0 || ay >= P) continue;
      const int sy = wrap(ty - jy, nty);
      float rx = 0.0f;
      for (int kx = 0; kx < kx_end; ++kx) {
        const int jx = source_offset(kx), ax = mx + M + jx * T;
        if (ax < 0 || ax >= P) continue;
        const int sx = wrap(tx - jx, ntx);
        rx += tiles[((long long)(sx * nty + sy) * ntz + sz) * P3 + ax * P2 +
                    ay * P + az];
      }
      ry += rx;
    }
    rz += ry;
  }
  rho[((long long)gx * Y + gy) * Z + gz] = rz;
}

}  // namespace

extern "C" {

int pinc_field_efield(const float* phi, void* out, int X, int Y, int Z,
                      int T, int M, int out_bf16, void* stream) {
  if (X % T || Y % T || Z % T || M < 0 || X <= M || Y <= M || Z <= M ||
      ((uintptr_t)out & 15u))
    return -1;
  const int P = T + 1 + 2 * M;
  const int ntz = Z / T;
  const int g = min(efield_run(T, M), ntz);
  const long long blocks = (long long)(X / T) * (Y / T) * ((ntz + g - 1) / g);
  if (blocks > 0x7fffffff) return -1;
  const size_t smem = efield_smem(g, T, M);
  if (smem > 227 * 1024) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  // P = 11 and 13 (T = 8 at M = 1 and 2) compiled with P known
  auto* kernel = out_bf16 ? (P == 11   ? efield_kernel<true, 11>
                             : P == 13 ? efield_kernel<true, 13>
                                       : efield_kernel<true, 0>)
                          : (P == 11   ? efield_kernel<false, 11>
                             : P == 13 ? efield_kernel<false, 13>
                                       : efield_kernel<false, 0>);
  if (smem > 48 * 1024) {
    if (int err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return err;
  }
  kernel<<<(int)blocks, kThreads, smem, s>>>(phi, out, X, Y, Z, Y / T, Z / T,
                                             T, M, P, g);
  return (int)cudaGetLastError();
}

int pinc_field_fold(const float* tiles, float* rho, int X, int Y, int Z,
                    int T, int M, void* stream) {
  if (X % T || Y % T || Z % T || M < 0 || X > 65535 || Y > 65535 ||
      Z >= (1 << 22) || T + 2 * M >= (1 << 22))
    return -1;
  const int P = T + 1 + 2 * M;
  const int ntx = X / T, nty = Y / T, ntz = Z / T;
  if ((long long)ntx * nty * ntz * P * P * P >= 0x7fffffffLL) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = min(fold_run(T, M), ntz);
  const size_t smem = fold_smem(g, T, M);
  if (M < T && smem <= 227 * 1024) {
    auto* kernel = T == 8 && M == 1   ? fold_kernel<8, 1>
                   : T == 8 && M == 2 ? fold_kernel<8, 2>
                                      : fold_kernel<0, 0>;
    if (smem > 48 * 1024) {
      if (int err = (int)cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              (int)smem))
        return err;
    }
    kernel<<<ntx * nty * ((ntz + g - 1) / g), kThreads, smem, s>>>(
        tiles, rho, Y, Z, ntx, nty, ntz, T, M, g);
    return (int)cudaGetLastError();
  }
  const int threads = Z < kThreads ? (Z + 31) / 32 * 32 : kThreads;
  const dim3 grid((Z + threads - 1) / threads, Y, X);
  fold_generic_kernel<<<grid, threads, 0, s>>>(
      tiles, rho, Y, Z, ntx, nty, ntz, T, 1.0f / (float)T, M, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
