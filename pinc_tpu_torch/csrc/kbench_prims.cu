// Hand-written Hopper (sm_90a) kernels of the port's kernel benchmark
// (pinc_tpu_torch/kbench.py, sweep "prims"): the exchange primitives that
// the TPU probes experiments/r4_gather_probe{,2,3}.py, r4_roll_probe.py,
// r5_progoverhead.py and archive/kbench7.py measured
// (ops/kbench_prims.FUNCTIONS maps each probe to its kernel).
//
// take_kernel<V> — take_along_axis along the rows (lanes = 0) or the lanes
//   (lanes = 1) of a (batch, R, C) stack of 4-byte words.  A lane gather's
//   output row r reads only source row r, a row gather's output column c
//   only source column c, so a CTA takes a chunk: g whole rows (lanes) or
//   a strip of w >= 32 adjacent columns over all Rs rows (rows), of about
//   a fixed number of source bytes; small blocks pack several whole blocks
//   into one CTA, large ones spread over several CTAs, so an SM holds
//   several CTAs and one's loads overlap another's gathers.  The plan
//   (chunk shape, blocks a CTA, whether to stage) comes from the host,
//   ops/kbench_prims.take_layout, and is launched as given.  A staged
//   chunk is copied to shared memory with 16-byte loads where aligned,
//   then each thread gathers V adjacent output words at a time from it
//   (V = 4 where the index rows are 16-byte aligned: one 16-byte index
//   load and output store), coalesced; a chunk too wide to stage reads
//   the source through L1 (__ldg) instead.  JAX's index rules: j in
//   [-n, 0) wraps, any other j outside [0, n) writes the fill (NaN or
//   INT32_MIN bits).
//   Replaces the lane and row gathers of r4_gather_probe{,2,3}.py; bound
//   by bytes (src, idx, out).
// roll_kernel — np.roll along the rows or lanes, one block a row of the
//   (batch R, C) view; the shift a host int or an int32 on the device
//   (the counterpart of the probe's SMEM scalar: no host sync), taken mod
//   n.  A row roll copies a whole source row (16-byte loads where
//   aligned); a lane roll reads the row at the shifted offset.  Replaces
//   r4_roll_probe.py run and r4_gather_probe3.py dyn_roll; bound by bytes.
// plane_add_kernel<VEC> — out_k = in_k + 1.0f (round to nearest) for up
//   to 8 float32 planes passed as one struct; G tiles a block, the tile
//   outer and the planes inner as in r5_progoverhead.py _kernel, float4
//   where every tile is 16-byte aligned.  Replaces r5_progoverhead.py mk
//   (G tiles a grid program); bound by bytes.
// lane_prefix_kernel<R> — the inclusive prefix sum of a row of (NT, B)
//   float32 in archive/kbench7.py _prefix_lanes' log-step order: x_s[i] =
//   x_{s-1}[i] + x_{s-1}[i-s] (i >= s) or x_{s-1}[i] + 0 (i < s), s = 1, 2,
//   4, ... < B, each add __fadd_rn (no contraction), so it is bit-equal to
//   the plain version on any input.  One block of W threads a row, the row
//   in registers (element r * W + t in register r of thread t; W and R
//   from ops/kbench_prims.lane_prefix_layout): the passes s >= W add
//   another register of the same thread (no shared memory, no sync), the
//   passes s < 32 shuffle within the warp and take only the first s lanes'
//   partners through shared memory, and only the passes 32 <= s < W (4 of
//   14 at B = 9216, W = 512) write and read the row in shared memory,
//   double-buffered (72 KB at B = 9216) for one __syncthreads a pass.
//   R is a template argument (1..32), so the row stays in registers with
//   no guard but on register R - 1 (R = 18 at B = 9216: 64 registers a
//   thread, two 512-thread blocks an SM).  Replaces kbench7.py
//   pallas_scan; bound by bytes on paper, by its instructions and syncs
//   in fact.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the cudaGetLastError() code of its launch (-1 for an argument the
// kernels do not take).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTakeThreads = 256;
constexpr int kThreads = 256;
constexpr int kMaxPlanes = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB a block

struct Planes {
  const float* in[kMaxPlanes];
  float* out[kMaxPlanes];
};

__host__ __device__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// CTA x takes chunk k = x % chunks of the nb blocks from (x / chunks) nb:
// source rows [r0, r0 + nr) (lanes; cc = Cs) or columns [c0, c0 + nc)
// (rows; cr = Rs) of each.  nb > 1 only where a chunk is a whole block.
// Staged, the chunk sits in shared memory as nb blocks of nr x nc words.
// The chunk's output is G rows of W words: lanes, the rows [r0, r0 + nr)
// of the nbk blocks (G = nbk nr, W = Ci), row g reading source row g of
// the chunk; rows, every row r of block i (g = i Ri + r, G = nbk Ri) at
// the columns [c0, c0 + nc) (W = nc), column c reading source column c.
// A thread takes V adjacent words of a row at a time (V = 4: one 16-byte
// index load and output store), stepping its row and column by adds.
template <int V>
__global__ void __launch_bounds__(kTakeThreads)
    take_kernel(const uint32_t* __restrict__ src, const int* __restrict__ idx,
                uint32_t* __restrict__ out, int batch, int Rs, int Cs,
                int Ri, int Ci, int lanes, uint32_t fill, int cr, int cc,
                int nb, int chunks, int staged) {
  extern __shared__ uint4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  const int grp = blockIdx.x / chunks, k = blockIdx.x - grp * chunks;
  const long long b0 = (long long)grp * nb;
  const int nbk = (int)min((long long)nb, batch - b0);
  const int r0 = lanes ? k * cr : 0, nr = lanes ? min(cr, Rs - r0) : Rs;
  const int c0 = lanes ? 0 : k * cc, nc = lanes ? Cs : min(cc, Cs - c0);
  const long long ns = (long long)Rs * Cs;
  const uint32_t* s = src + b0 * ns;
  const int n = lanes ? Cs : Rs;
  if (staged) {
    if (nc == Cs) {  // whole rows: one contiguous range
      const uint32_t* from = s + (long long)r0 * Cs;
      const int len = nbk * nr * Cs;
      if ((len & 3) == 0 && aligned16(from)) {
        const uint4* f4 = reinterpret_cast<const uint4*>(from);
        for (int v = threadIdx.x; v < len / 4; v += blockDim.x)
          smem4[v] = __ldg(f4 + v);
      } else {
        for (int e = threadIdx.x; e < len; e += blockDim.x)
          sm[e] = __ldg(from + e);
      }
    } else {         // a strip of nc columns over the Rs rows of one block
      const uint32_t* from = s + c0;
      if ((nc & 3) == 0 && (Cs & 3) == 0 && aligned16(from)) {
        const int q = nc / 4;
        for (int v = threadIdx.x; v < Rs * q; v += blockDim.x) {
          const int r = v / q;
          smem4[v] = __ldg(reinterpret_cast<const uint4*>(
                               from + (long long)r * Cs) + (v - r * q));
        }
      } else {
        for (int e = threadIdx.x; e < Rs * nc; e += blockDim.x) {
          const int r = e / nc;
          sm[e] = __ldg(from + (long long)r * Cs + (e - r * nc));
        }
      }
    }
    __syncthreads();
  }
  const int G = lanes ? nbk * nr : nbk * Ri, W = (lanes ? Ci : nc) / V;
  // output row g starts at word `first + g Ci` (+ c0 along the rows)
  const long long first =
      lanes ? (b0 * Ri + r0) * Ci : b0 * Ri * (long long)Ci + c0;
  const int bd = blockDim.x, dg = bd / W, dc = bd - dg * W;
  int g = threadIdx.x / W, c = threadIdx.x - (threadIdx.x / W) * W;
  for (; g < G; g += dg, c += dc) {
    if (c >= W) {
      c -= W;
      ++g;
      if (g >= G) break;
    }
    const long long at = first + (long long)g * Ci + c * V;
    // the source word of index j: base + j step
    long long base, step;
    if (lanes) {
      base = staged ? (long long)g * Cs : ((long long)r0 + g) * Cs;
      step = 1;
    } else {
      const int i = nbk == 1 ? 0 : g / Ri;
      base = staged ? (long long)i * Rs * nc + c * V
                    : i * ns + c0 + c * V;
      step = staged ? nc : Cs;
    }
    int j[V];
    uint32_t v[V];
    if (V == 4) {
      const int4 j4 = __ldg(reinterpret_cast<const int4*>(idx + at));
      j[0] = j4.x, j[1] = j4.y, j[2] = j4.z, j[3] = j4.w;
    } else {
      j[0] = __ldg(idx + at);
    }
#pragma unroll
    for (int t = 0; t < V; ++t) {
      int jj = j[t];
      if (jj < 0) jj += n;
      v[t] = fill;
      if (jj >= 0 && jj < n) {
        const long long w = base + (lanes ? 0 : t) + jj * step;
        v[t] = staged ? sm[(int)w] : __ldg(s + w);
      }
    }
    if (V == 4)
      *reinterpret_cast<uint4*>(out + at) = make_uint4(v[0], v[1], v[2], v[3]);
    else
      out[at] = v[0];
  }
}

__global__ void __launch_bounds__(kThreads)
    roll_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                const int* __restrict__ shift_dev, int shift_host, int R,
                int C, int lanes, bool vec) {
  const long long q = blockIdx.x;  // row of the (batch R, C) view
  const int n = lanes ? C : R;
  int s = shift_dev ? __ldg(shift_dev) : shift_host;
  s = ((s % n) + n) % n;
  uint32_t* o = out + q * C;
  if (lanes) {
    const uint32_t* from = x + q * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      int cs = c - s;
      if (cs < 0) cs += C;
      o[c] = __ldg(from + cs);
    }
    return;
  }
  const long long blk = q / R;
  const int r = (int)(q - blk * R);
  int rs = r - s;
  if (rs < 0) rs += R;
  const uint32_t* from = x + (blk * R + rs) * C;
  if (vec) {
    const uint4* f4 = reinterpret_cast<const uint4*>(from);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int v = threadIdx.x; v < C / 4; v += blockDim.x)
      o4[v] = __ldg(f4 + v);
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x) o[c] = __ldg(from + c);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    plane_add_kernel(Planes p, int np, int NT, int tile, int G) {
  const int t0 = blockIdx.x * G;
  const int t1 = min(t0 + G, NT);
  for (int t = t0; t < t1; ++t) {
    const long long base = (long long)t * tile;
#pragma unroll
    for (int k = 0; k < kMaxPlanes; ++k) {  // unrolled: p stays a parameter
      if (k >= np) break;
      if (VEC) {
        const float4* a = reinterpret_cast<const float4*>(p.in[k] + base);
        float4* o = reinterpret_cast<float4*>(p.out[k] + base);
        for (int v = threadIdx.x; v < tile / 4; v += blockDim.x) {
          float4 x = __ldg(a + v);
          x.x = __fadd_rn(x.x, 1.0f);
          x.y = __fadd_rn(x.y, 1.0f);
          x.z = __fadd_rn(x.z, 1.0f);
          x.w = __fadd_rn(x.w, 1.0f);
          o[v] = x;
        }
      } else {
        const float* a = p.in[k] + base;
        float* o = p.out[k] + base;
        for (int e = threadIdx.x; e < tile; e += blockDim.x)
          o[e] = __fadd_rn(__ldg(a + e), 1.0f);
      }
    }
  }
}

// Row element i = r * W + t lives in register r of thread t (W =
// blockDim.x, a power of two >= 32; R = ceil(B / W) registers a thread, so
// only register R - 1 can hold an element past B).  Pass s adds element
// i - s: for s < 32 by a shuffle up within the warp, the first s lanes
// taking theirs (the last s lanes of the warp before, or of the last warp
// one register back) through shared memory; for 32 <= s < W through the
// row in shared memory; for s = W, 2W, ... from register r - s/W of the
// same thread.  Shared memory holds the row twice, so each pass that
// touches it syncs once.
template <int R>
__global__ void __launch_bounds__(R > 29 ? 512 : 1024)
    lane_prefix_kernel(const float* __restrict__ m, float* __restrict__ out,
                       int B) {
  extern __shared__ float buf[];
  const int W = blockDim.x, t = threadIdx.x, lane = t & 31;
  const long long row = blockIdx.x;
  const float* in = m + row * B + t;
  const bool last = (R - 1) * W + t < B;   // register R - 1 holds an element
  float x[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    x[r] = (r < R - 1 || last) ? __ldg(in + r * W) : 0.0f;
  int p = 0;
  for (int s = 1; s < 32 && s < B; s *= 2, p ^= 1) {
    float* b = buf + p * B + t;
    if (lane >= 32 - s) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < R - 1 || last) b[r * W] = x[r];
    }
    __syncthreads();
    const bool head = lane < s;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float y = __shfl_up_sync(0xffffffffu, x[r], s);
      float z = 0.0f;
      if (head && (r > 0 || t >= s) && (r < R - 1 || last))
        z = b[r * W - s];
      x[r] = __fadd_rn(x[r], head ? z : y);
    }
  }
  for (int s = 32; s < W && s < B; s *= 2, p ^= 1) {
    float* b = buf + p * B + t;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < R - 1 || last) b[r * W] = x[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < R - 1 || last)
        x[r] = __fadd_rn(x[r], (r > 0 || t >= s) ? b[r * W - s] : 0.0f);
  }
#pragma unroll
  for (int mm = 1; mm < R; mm *= 2) {
#pragma unroll
    for (int r = R - 1; r >= 0; --r)
      x[r] = __fadd_rn(x[r], r >= mm ? x[r - mm] : 0.0f);
  }
  float* o = out + row * B + t;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < R - 1 || last) o[r * W] = x[r];
}

template <typename Kernel>
int prepare(Kernel* kernel, size_t smem) {
  if (smem > kMaxSmem) return -1;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

constexpr int kMaxPrefixR = 32;

// Launches lane_prefix_kernel<Rr> for any Rr in 1..R.
template <int R>
int launch_prefix(const float* m, float* out, int NT, int B, int W, int Rr,
                  size_t smem, cudaStream_t st) {
  if (Rr != R) {
    if constexpr (R > 1)
      return launch_prefix<R - 1>(m, out, NT, B, W, Rr, smem, st);
    return -1;
  }
  if (int err = prepare(lane_prefix_kernel<R>, smem)) return err;
  lane_prefix_kernel<R><<<NT, W, smem, st>>>(m, out, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows, cols, blocks, staged: the plan of ops/kbench_prims.take_layout
// (the chunk's source rows and columns, blocks a CTA, shared memory or
// direct reads)
int pinc_kp_take(const void* src, const int* idx, void* out, int batch,
                 int Rs, int Cs, int Ri, int Ci, int lanes, int fill,
                 void* stream, int rows, int cols, int blocks, int staged) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch < 1 || Rs < 1 || Cs < 1 || Ri < 1 || Ci < 1) return -1;
  if (lanes ? Ri != Rs : Ci != Cs) return -1;
  if (rows < 1 || cols < 1 || blocks < 1) return -1;
  if (lanes ? (cols != Cs || rows > Rs) : (rows != Rs || cols > Cs))
    return -1;
  const int chunks = lanes ? (Rs + rows - 1) / rows : (Cs + cols - 1) / cols;
  if (blocks > 1 && chunks > 1) return -1;
  const long long ctas = ((long long)batch + blocks - 1) / blocks * chunks;
  if (ctas > 0x7fffffffLL) return -1;
  const size_t smem = staged ? (size_t)blocks * rows * cols * 4 : 0;
  // 4 adjacent words a thread where every output row of every chunk
  // starts on 16 bytes
  const bool vec = Ci % 4 == 0 && (lanes || cols % 4 == 0) &&
                   aligned16(idx) && aligned16(out);
  auto* kernel = vec ? take_kernel<4> : take_kernel<1>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<(int)ctas, kTakeThreads, smem, st>>>(
      static_cast<const uint32_t*>(src), idx, static_cast<uint32_t*>(out),
      batch, Rs, Cs, Ri, Ci, lanes, (uint32_t)fill, rows, cols, blocks,
      chunks, staged);
  return (int)cudaGetLastError();
}

int pinc_kp_roll(const void* x, void* out, const int* shift, int shift_host,
                 int rows, int R, int C, int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || R < 1 || C < 1 || rows % R != 0) return -1;
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(out);
  roll_kernel<<<rows, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), shift,
      shift_host, R, C, lanes, vec);
  return (int)cudaGetLastError();
}

int pinc_kp_plane_add(void* const* ptrs, int np, int NT, int tile, int G,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (np < 1 || np > kMaxPlanes || NT < 1 || tile < 1 || G < 1) return -1;
  Planes p{};
  bool vec = tile % 4 == 0;
  for (int k = 0; k < np; ++k) {
    p.in[k] = static_cast<const float*>(ptrs[k]);
    p.out[k] = static_cast<float*>(ptrs[np + k]);
    vec = vec && aligned16(p.in[k]) && aligned16(p.out[k]);
  }
  const int blocks = (NT + G - 1) / G;
  if (vec)
    plane_add_kernel<true><<<blocks, kThreads, 0, st>>>(p, np, NT, tile, G);
  else
    plane_add_kernel<false><<<blocks, kThreads, 0, st>>>(p, np, NT, tile, G);
  return (int)cudaGetLastError();
}

int pinc_kp_lane_prefix(const float* m, float* out, int NT, int B, int W,
                        int R, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (NT < 1 || B < 1 || W < 32 || W > 1024 || (W & (W - 1)) != 0 ||
      R < 1 || R > kMaxPrefixR || (R > 29 && W > 512) ||
      (long long)R * W < B || (R - 1) * W >= B)
    return -1;
  return launch_prefix<kMaxPrefixR>(m, out, NT, B, W, R, (size_t)B * 2 * 4,
                                    st);
}

}  // extern "C"
