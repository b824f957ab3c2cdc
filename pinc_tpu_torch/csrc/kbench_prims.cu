// Hand-written Hopper (sm_90a) kernels of the port's kernel benchmark
// (pinc_tpu_torch/kbench.py, sweep "prims"): the exchange primitives that
// the TPU probes experiments/r4_gather_probe{,2,3}.py, r4_roll_probe.py,
// r5_progoverhead.py and archive/kbench7.py measured
// (ops/kbench_prims.FUNCTIONS maps each probe to its kernel).
//
// take_kernel — take_along_axis along the rows (lanes = 0) or the lanes
//   (lanes = 1) of a (batch, R, C) stack of 4-byte words, one block a
//   block of the stack.  The source block (Rs, Cs) is staged in shared
//   memory, with 16-byte loads where aligned (69.6 KB at the extract's
//   (8, 2176)); each thread then gathers output words from it, idx read
//   and the output written coalesced.
//   JAX's index rules: j in [-n, 0) wraps, any other j outside [0, n)
//   writes the fill (NaN or INT32_MIN bits).  Replaces the lane and row
//   gathers of r4_gather_probe{,2,3}.py; bound by bytes (src, idx, out).
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

constexpr int kTakeThreads = 512;
constexpr int kThreads = 256;
constexpr int kMaxPlanes = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB a block

struct Planes {
  const float* in[kMaxPlanes];
  float* out[kMaxPlanes];
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kTakeThreads)
    take_kernel(const uint32_t* __restrict__ src, const int* __restrict__ idx,
                uint32_t* __restrict__ out, int Rs, int Cs, int Ri, int Ci,
                int lanes, uint32_t fill, bool vec) {
  extern __shared__ uint4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  const long long b = blockIdx.x;
  const int ns = Rs * Cs;
  const uint32_t* s = src + b * ns;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    for (int v = threadIdx.x; v < ns / 4; v += blockDim.x)
      smem4[v] = __ldg(s4 + v);
  } else {
    for (int e = threadIdx.x; e < ns; e += blockDim.x) sm[e] = __ldg(s + e);
  }
  __syncthreads();
  const int n = lanes ? Cs : Rs;
  const int ni = Ri * Ci;
  const int* ib = idx + b * ni;
  uint32_t* ob = out + b * ni;
  for (int e = threadIdx.x; e < ni; e += blockDim.x) {
    int j = __ldg(ib + e);
    if (j < 0) j += n;
    uint32_t v = fill;
    if (j >= 0 && j < n) {
      const int r = e / Ci;
      const int c = e - r * Ci;
      v = sm[lanes ? r * Cs + j : j * Cs + c];
    }
    ob[e] = v;
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

int pinc_kp_take(const void* src, const int* idx, void* out, int batch,
                 int Rs, int Cs, int Ri, int Ci, int lanes, int fill,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch < 1 || Rs < 1 || Cs < 1 || Ri < 1 || Ci < 1) return -1;
  if (lanes ? Ri != Rs : Ci != Cs) return -1;
  const auto* s = static_cast<const uint32_t*>(src);
  auto* o = static_cast<uint32_t*>(out);
  const size_t smem = (size_t)Rs * Cs * 4;
  const bool vec = (Rs * Cs) % 4 == 0 && aligned16(src);
  if (int err = prepare(take_kernel, smem)) return err;
  take_kernel<<<batch, kTakeThreads, smem, st>>>(s, idx, o, Rs, Cs, Ri, Ci,
                                                  lanes, (uint32_t)fill, vec);
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
