// Local response normalization across channels for Hopper (sm_90a):
// forward and backward.
//
// Replaces the TPU kernels of deeplearning4j_tpu/helpers/pallas_ops.py:
//   `_lrn_fwd_kernel` (launched by `_lrn_fwd`)
//   `_lrn_bwd_kernel` (launched by `_lrn_bwd_rule`)
// on a channel-contiguous [rows, C] view (rows = B*H*W of an NHWC tensor):
//
//   forward:  s = k + alpha * sum_{|w| <= n/2} x[c + w]^2, channels outside
//             [0, C) counting as 0;  y = x * s^-beta
//   backward: t = g * x * s^(-beta - 1);
//             dx = g * s^-beta - 2 alpha beta * x * sum_{|w| <= n/2} t[c + w]
//
// The window runs over the offsets -n/2 .. n/2, so an even n sums n + 1
// channels, as the TPU kernel does.  alpha is not divided by the window
// size (DL4J's semantics; cuDNN's LRN divides).  x, y, g and dx are
// float32, bfloat16 or float16; the arithmetic is float32 whatever their
// type.
//
// What bounds it: bytes.  The forward reads x and writes y, the backward
// reads x and g and writes dx, with about 2n + 10 flops an element: far
// below the ~295 flops a byte at which the H100's memory stops being the
// limit.  So every element is read from device memory once and written
// once, and the kernels must keep enough loads in flight to stream at the
// memory's rate.  Two routes, chosen by the caller from the shape, type,
// n and alignment (lrn.py `route`), never on a failure:
//
// Vector route (`lrn_fwd_vec`, `lrn_bwd_vec`): C a whole number of 16-byte
// vectors (V = 8 channels in 16 bits, 4 in float32), 2 (n/2) <= V, every
// pointer 16-byte aligned.  One lane holds one vector, loaded with one
// 16-byte load; a warp holds 32 consecutive vectors of the flattened
// tensor, so a row's neighbouring channels sit in neighbouring lanes, and
// the n/2 halo channels on each side come from lanes i-1 and i+1 by warp
// shuffles (zeros where the neighbour is another row's).  A warp's first
// and last lanes load but do not store: they only feed their neighbours'
// halos, so a warp tile stores 30 vectors and the next tile starts there.
// No shared memory, no barrier; the window sums run in registers.  The
// grid gives every warp one tile, so a lane has one 16-byte load of each
// input in flight; few registers (about 30 forward, 40 backward) let 48
// to 64 warps an SM keep 32 to 48 KB of loads in flight.  (A one-wave
// grid striding over the tiles was 4-9% slower at AlexNet's shapes: its
// last pass left SMs idle.  scripts/torch_lrn_probe.py times variants.)
// The backward computes s, s^-beta and t for its own channels only (one lg2
// and two ex2 an element) and takes t's halo from its neighbours: the
// edge lanes' outer t values are wrong (their far halo is missing), but
// only their inner n/2 channels, which need x no further than 2 (n/2)
// <= V channels in, are ever shuffled to a storing lane.
//
// Staged route (`lrn_fwd_kernel`, `lrn_bwd_kernel`), for every other
// shape: one block of 256 threads takes a tile of rows x channels (about
// 2048 elements, the caller's choice) and stages it in shared memory in
// its own type, with a halo of channels on each side (zeros outside
// [0, C)).  Where a row fits a tile the tile spans whole rows, one
// contiguous span of the tensor copied in 16-byte vectors; wider rows are
// cut into channel tiles whose halos overlap their neighbours' (scalar
// loads).  Then consecutive threads take consecutive elements, so every
// window sum reads shared memory without bank conflicts and the stores
// coalesce.  The TPU kernel pads channels to 128 lanes and holds the whole
// array in one VMEM block (which the JAX package caps at 2^20 elements);
// neither applies here.
//
// The backward recomputes s from x instead of reading a saved s: it reads x
// anyway (for t), so a saved s would cost the forward a write and the
// backward a read, and a bfloat16 s would lose the precision the float32
// recompute keeps.  The staged backward stages x with a halo of 2 (n/2)
// channels and g with n/2, computes s^-beta and t over the tile and a halo
// of n/2, then t's window sums.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

struct Params {
  int rows, c;  // the [rows, C] view
  int rpb, ct;  // rows and channels of a block's tile
  int half;     // n / 2
  float k, alpha, beta;
};

// s^-beta.  s = 0 (only with k = 0 and a zero window) gives inf, and then
// y = 0 * inf = NaN, as in the reference.
__device__ __forceinline__ float pow_neg(float s, float beta) {
  return exp2f(-beta * __log2f(s));
}

constexpr int kAlign = 8;  // elements: 16 bytes of a 16-bit type

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory rows of one staged tensor: column j holds channel
// c0 - pad + j, the halo columns [pad - halo, pad) and [pad + w, pad + w +
// halo) hold the neighbours (0 outside [0, C)); pad and ld are multiples of
// kAlign, so every row starts 16-byte aligned.
struct Rows {
  int halo, pad, ld;
};

__host__ __device__ __forceinline__ Rows rows_for(int halo, int ct) {
  const int pad = round_up(halo, kAlign);
  return Rows{halo, pad, round_up(pad + ct + halo, kAlign)};
}

// Rows [row0, row0 + nr), channels [c0 - halo, c0 + w + halo) of a [rows, C]
// tensor into shared memory in its own type.  VEC: the tile spans whole
// rows (c0 = 0, w = C), C is a whole number of 16-byte vectors and `src` is
// aligned, so each row is copied in 16-byte vectors and the halo zeroed.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(T* dst, const Rows& s,
                                      const T* __restrict__ src, int row0,
                                      int nr, int c0, int w,
                                      const Params& p) {
  const T zero = from_f32<T>(0.f);
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    for (int idx = threadIdx.x; idx < nr * 2 * s.halo; idx += kThreads) {
      const int r = idx / (2 * s.halo), j = idx % (2 * s.halo);
      dst[r * s.ld + (j < s.halo ? s.pad - s.halo + j : s.pad + p.c + j -
                                                             s.halo)] = zero;
    }
    const uint4* base =
        reinterpret_cast<const uint4*>(src + (size_t)row0 * p.c);
    const int per_row = p.c / V;
    for (int e = threadIdx.x; e < nr * per_row; e += kThreads) {
      const int r = e / per_row, col = e % per_row * V;
      *reinterpret_cast<uint4*>(dst + r * s.ld + s.pad + col) =
          __ldg(base + e);
    }
  } else {
    const int count = w + 2 * s.halo;
    for (int idx = threadIdx.x; idx < nr * count; idx += kThreads) {
      const int r = idx / count, j = idx % count;
      const int ch = c0 - s.halo + j;
      dst[r * s.ld + s.pad - s.halo + j] =
          ch >= 0 && ch < p.c ? src[(size_t)(row0 + r) * p.c + ch] : zero;
    }
  }
}

// The elements [0, nr * w) of a tile, row-major, consecutive threads on
// consecutive elements (so their shared-memory reads never conflict and
// their stores coalesce), keeping (r, col) without a division per element.
struct Walk {
  int r, col, dr, dc, w;
  __device__ explicit Walk(int width) : w(width) {
    r = threadIdx.x / w;
    col = threadIdx.x - r * w;
    dr = kThreads / w;
    dc = kThreads - dr * w;
  }
  __device__ void next() {
    r += dr;
    col += dc;
    if (col >= w) {
      col -= w;
      ++r;
    }
  }
};

// H: n / 2 known when compiled (the window loops unroll), or -1 to read it
// from p.half.
template <typename T, bool VEC, int H>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = H >= 0 ? H : p.half;
  const int row0 = blockIdx.x * p.rpb, c0 = blockIdx.y * p.ct;
  const int nr = min(p.rpb, p.rows - row0), w = min(p.ct, p.c - c0);
  const Rows sx = rows_for(h, p.ct);
  T* xs = reinterpret_cast<T*>(smem);
  stage<T, VEC>(xs, sx, x, row0, nr, c0, w, p);
  __syncthreads();

  for (Walk it(w); it.r < nr; it.next()) {
    const int r = it.r, col = it.col;
    const T* xr = xs + r * sx.ld + sx.pad + col - h;  // channels c0+col-h..
    float sum = 0.f;
#pragma unroll
    for (int d = 0; d <= 2 * h; ++d) {
      const float v = to_f32(xr[d]);
      sum += v * v;
    }
    const float s = p.k + p.alpha * sum;
    y[(size_t)(row0 + r) * p.c + c0 + col] =
        from_f32<T>(to_f32(xr[h]) * pow_neg(s, p.beta));
  }
}

template <typename T, bool VEC, int H>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ dx, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = H >= 0 ? H : p.half;
  const int row0 = blockIdx.x * p.rpb, c0 = blockIdx.y * p.ct;
  const int nr = min(p.rpb, p.rows - row0), w = min(p.ct, p.c - c0);
  const Rows sx = rows_for(2 * h, p.ct), sg = rows_for(h, p.ct);
  const int ldt = p.ct + 2 * h;  // s^-beta and t: channel c0 - h + j
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + p.rpb * sx.ld;
  float* ps = reinterpret_cast<float*>(gs + p.rpb * sg.ld);
  float* ts = ps + p.rpb * ldt;
  stage<T, VEC>(xs, sx, x, row0, nr, c0, w, p);
  stage<T, VEC>(gs, sg, g, row0, nr, c0, w, p);
  __syncthreads();

  // s^-beta and t over the tile and a halo of h; t is 0 outside [0, C)
  const int ext = w + 2 * h;
  for (Walk it(ext); it.r < nr; it.next()) {
    const int r = it.r, j = it.col;
    const int ch = c0 - h + j;
    const T* xr = xs + r * sx.ld + sx.pad + j - 2 * h;  // channels ch-h..
    float sum = 0.f;
#pragma unroll
    for (int d = 0; d <= 2 * h; ++d) {
      const float v = to_f32(xr[d]);
      sum += v * v;
    }
    const float s = p.k + p.alpha * sum;
    const float pw = pow_neg(s, p.beta);
    ps[r * ldt + j] = pw;
    ts[r * ldt + j] =
        ch >= 0 && ch < p.c
            ? to_f32(gs[r * sg.ld + sg.pad + j - h]) * to_f32(xr[h]) *
                  __fdividef(pw, s)
            : 0.f;
  }
  __syncthreads();

  const float c2 = 2.f * p.alpha * p.beta;
  for (Walk it(w); it.r < nr; it.next()) {
    const int r = it.r, col = it.col;
    const float* tr = ts + r * ldt + col;  // channels c0 + col - h ..
    float sum = 0.f;
#pragma unroll
    for (int d = 0; d <= 2 * h; ++d) sum += tr[d];
    const float gv = to_f32(gs[r * sg.ld + sg.pad + col]);
    const float xv = to_f32(xs[r * sx.ld + sx.pad + col]);
    dx[(size_t)(row0 + r) * p.c + c0 + col] =
        from_f32<T>(gv * ps[r * ldt + col + h] - c2 * xv * sum);
  }
}

// x staged with a halo of h (forward); x with 2h and g with h in their own
// type, and s^-beta and t in float32 (backward)
template <typename T>
size_t smem_bytes(int which, const Params& p) {
  const size_t rpb = p.rpb;
  if (which == 0) return sizeof(T) * rpb * rows_for(p.half, p.ct).ld;
  return sizeof(T) * rpb *
             (rows_for(2 * p.half, p.ct).ld + rows_for(p.half, p.ct).ld) +
         sizeof(float) * 2 * rpb * (p.ct + 2 * p.half);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

// which: 0 forward (x -> out), 1 backward (x, g -> out)
template <typename T, int H>
cudaError_t run_h(int which, const void* x, const void* g, void* out,
                  const Params& p, bool v, size_t smem, cudaStream_t stream) {
  const dim3 grid((p.rows + p.rpb - 1) / p.rpb, (p.c + p.ct - 1) / p.ct);
  cudaError_t err;
  if (which == 0) {
    auto kernel =
        v ? &lrn_fwd_kernel<T, true, H> : &lrn_fwd_kernel<T, false, H>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                             static_cast<T*>(out), p);
  } else {
    auto kernel =
        v ? &lrn_bwd_kernel<T, true, H> : &lrn_bwd_kernel<T, false, H>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<T*>(out), p);
  }
  return cudaGetLastError();
}

// n = 3, 5 and 7, and their even neighbours, get unrolled window loops;
// any other n reads its half-width at run time
template <typename T>
cudaError_t run(int which, const void* x, const void* g, void* out,
                const Params& p, int vec, cudaStream_t stream) {
  const bool v = vec && p.ct == p.c && p.c % (16 / sizeof(T)) == 0;
  const size_t smem = smem_bytes<T>(which, p);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  switch (p.half) {
    case 1: return run_h<T, 1>(which, x, g, out, p, v, smem, stream);
    case 2: return run_h<T, 2>(which, x, g, out, p, v, smem, stream);
    case 3: return run_h<T, 3>(which, x, g, out, p, v, smem, stream);
    default: return run_h<T, -1>(which, x, g, out, p, v, smem, stream);
  }
}

int launch(int which, const void* x, const void* g, void* out, int dtype,
           int rows, int c, int rpb, int ct, int half, float k, float alpha,
           float beta, int vec, void* stream) {
  const Params p{rows, c, rpb, ct, half, k, alpha, beta};
  if (rows < 1 || c < 1 || rpb < 1 || ct < 1 || half < 0 ||
      (c + ct - 1) / ct > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(which, x, g, out, p, vec, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(which, x, g, out, p, vec, s);
  if (dtype == 2) return (int)run<__half>(which, x, g, out, p, vec, s);
  return (int)cudaErrorInvalidValue;
}


// ------------------------------------------------------------ vector route
constexpr int kVecThreads = 256;
constexpr int kTileVecs = 30;  // vectors a warp tile stores: lanes 1..30
// warp tiles a warp takes, their loads issued before any arithmetic (1:
// 2 to 8 were no faster, the extra registers cost resident warps)
constexpr int kFwdTiles = 1;
constexpr int kBwdTiles = 1;

struct VecParams {
  int nvec;     // rows * C / V
  int per_row;  // C / V
  int tiles;    // ceil(nvec / kTileVecs)
  float k, alpha, beta;
};

// A 16-byte vector as floats, one 32-bit word at a time: V channels, E of
// them a word (little-endian: the lower half holds the lower channel).
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int V = 4, E = 1;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
  __device__ static uint32_t pack(const float* f) {
    return __float_as_uint(f[0]);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8, E = 2;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack(const float* f) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <>
struct Pack<__half> {
  static constexpr int V = 8, E = 2;
  __device__ static void unpack(uint32_t w, float* f) {
    const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w));
    f[0] = v.x;
    f[1] = v.y;
  }
  __device__ static uint32_t pack(const float* f) {
    const __half2 v = __floats2half2_rn(f[0], f[1]);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <typename T>
__device__ __forceinline__ void unpack_all(const uint4& r, float* f) {
  using P = Pack<T>;
  P::unpack(r.x, f);
  P::unpack(r.y, f + P::E);
  P::unpack(r.z, f + 2 * P::E);
  P::unpack(r.w, f + 3 * P::E);
}

template <typename T>
__device__ __forceinline__ uint4 pack_all(const float* f) {
  using P = Pack<T>;
  return make_uint4(P::pack(f), P::pack(f + P::E), P::pack(f + 2 * P::E),
                    P::pack(f + 3 * P::E));
}

// The first of the `tiles` consecutive warp tiles this warp takes.
__device__ __forceinline__ int first_tile(int tiles) {
  return (int)((blockIdx.x * kVecThreads + threadIdx.x) >> 5) * tiles;
}

// Lane l of warp tile `tile` holds vector tile * kTileVecs + l - 1.
__device__ __forceinline__ int vec_index(int tile) {
  return tile * kTileVecs + (int)(threadIdx.x & 31) - 1;
}

__device__ __forceinline__ uint4 load_vec(const uint4* __restrict__ src,
                                          int e, int nvec) {
  return e >= 0 && e < nvec ? __ldg(src + e) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ bool stores(int e, int nvec) {
  const int lane = threadIdx.x & 31;
  return lane >= 1 && lane <= kTileVecs && e < nvec;
}

// xs[0, V + 2H): channel j - H of this lane's vector, its own from `r`, the
// H on each side from the neighbour lanes' words (zeros where the
// neighbour's vector is another row's).  Every lane of the warp calls it.
template <typename T, int H>
__device__ __forceinline__ void with_halo(const uint4& r, bool first,
                                          bool last, float* xs) {
  using P = Pack<T>;
  constexpr int V = P::V, E = P::E, NW = (H + E - 1) / E;
  unpack_all<T>(r, xs + H);
  if constexpr (H > 0) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    float left[NW * E], right[NW * E];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      P::unpack(__shfl_up_sync(0xffffffffu, w[4 - NW + j], 1), left + j * E);
      P::unpack(__shfl_down_sync(0xffffffffu, w[j], 1), right + j * E);
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      xs[i] = first ? 0.f : left[NW * E - H + i];
      xs[V + H + i] = last ? 0.f : right[i];
    }
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kVecThreads)
lrn_fwd_vec(const T* __restrict__ x, T* __restrict__ y, VecParams p) {
  constexpr int V = Pack<T>::V;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const int t0 = first_tile(kFwdTiles);
  if (t0 >= p.tiles) return;  // the whole warp
  uint4 raw[kFwdTiles];
#pragma unroll
  for (int u = 0; u < kFwdTiles; ++u)
    raw[u] = load_vec(xv, vec_index(t0 + u), p.nvec);
#pragma unroll
  for (int u = 0; u < kFwdTiles; ++u) {
    const int e = vec_index(t0 + u);
    const int pos = (int)((unsigned)e % (unsigned)p.per_row);
    float xs[V + 2 * H], out[V];
    with_halo<T, H>(raw[u], pos == 0, pos == p.per_row - 1, xs);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int d = 0; d <= 2 * H; ++d) sum += xs[i + d] * xs[i + d];
      out[i] = xs[H + i] * pow_neg(p.k + p.alpha * sum, p.beta);
    }
    if (stores(e, p.nvec)) yv[e] = pack_all<T>(out);
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kVecThreads)
lrn_bwd_vec(const T* __restrict__ x, const T* __restrict__ g,
            T* __restrict__ dx, VecParams p) {
  constexpr int V = Pack<T>::V;
  static_assert(2 * H <= V, "an edge lane's inner t needs x within V");
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* dv = reinterpret_cast<uint4*>(dx);
  const float c2 = 2.f * p.alpha * p.beta;
  const int t0 = first_tile(kBwdTiles);
  if (t0 >= p.tiles) return;  // the whole warp
  uint4 xr[kBwdTiles], gr[kBwdTiles];
#pragma unroll
  for (int u = 0; u < kBwdTiles; ++u) {
    xr[u] = load_vec(xv, vec_index(t0 + u), p.nvec);
    gr[u] = load_vec(gv, vec_index(t0 + u), p.nvec);
  }
#pragma unroll
  for (int u = 0; u < kBwdTiles; ++u) {
    const int e = vec_index(t0 + u);
    const int pos = (int)((unsigned)e % (unsigned)p.per_row);
    const bool first = pos == 0, last = pos == p.per_row - 1;
    float xs[V + 2 * H], gs[V], pw[V], t[V + 2 * H], out[V];
    with_halo<T, H>(xr[u], first, last, xs);
    unpack_all<T>(gr[u], gs);
    // s, s^-beta and t = g x s^(-beta-1) for this lane's channels
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int d = 0; d <= 2 * H; ++d) sum += xs[i + d] * xs[i + d];
      const float lg = __log2f(p.k + p.alpha * sum);
      pw[i] = exp2f(-p.beta * lg);
      t[H + i] = gs[i] * xs[H + i] * exp2f((-p.beta - 1.f) * lg);
    }
    // t's halo: the neighbours' outermost H channels of their own
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float l = __shfl_up_sync(0xffffffffu, t[V + i], 1);
      const float r = __shfl_down_sync(0xffffffffu, t[H + i], 1);
      t[i] = first ? 0.f : l;
      t[V + H + i] = last ? 0.f : r;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int d = 0; d <= 2 * H; ++d) sum += t[i + d];
      out[i] = gs[i] * pw[i] - c2 * xs[H + i] * sum;
    }
    if (stores(e, p.nvec)) dv[e] = pack_all<T>(out);
  }
}

// Blocks that give every warp its `tiles_per_warp` tiles.
int blocks_for(int tiles, int tiles_per_warp) {
  const int per_block = tiles_per_warp * (kVecThreads / 32);
  return (tiles + per_block - 1) / per_block;
}

template <typename T, int H>
cudaError_t run_vec_h(int which, const void* x, const void* g, void* out,
                      const VecParams& p, cudaStream_t stream) {
  if (which == 0)
    lrn_fwd_vec<T, H><<<blocks_for(p.tiles, kFwdTiles), kVecThreads, 0,
                        stream>>>(static_cast<const T*>(x),
                                  static_cast<T*>(out), p);
  else
    lrn_bwd_vec<T, H><<<blocks_for(p.tiles, kBwdTiles), kVecThreads, 0,
                        stream>>>(static_cast<const T*>(x),
                                  static_cast<const T*>(g),
                                  static_cast<T*>(out), p);
  return cudaGetLastError();
}

// n / 2 from 0 to V / 2, unrolled
template <typename T>
cudaError_t run_vec(int which, const void* x, const void* g, void* out,
                    const VecParams& p, int half, cudaStream_t stream) {
  constexpr int V = Pack<T>::V;
  switch (half) {
    case 0: return run_vec_h<T, 0>(which, x, g, out, p, stream);
    case 1: return run_vec_h<T, 1>(which, x, g, out, p, stream);
    case 2: return run_vec_h<T, 2>(which, x, g, out, p, stream);
    case 3:
      if constexpr (V >= 6)
        return run_vec_h<T, 3>(which, x, g, out, p, stream);
      break;
    case 4:
      if constexpr (V >= 8)
        return run_vec_h<T, 4>(which, x, g, out, p, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_vec_t(int which, const void* x, const void* g, void* out,
                         int rows, int c, int half, float k, float alpha,
                         float beta, cudaStream_t stream) {
  constexpr int V = Pack<T>::V;
  const long long nvec = (long long)rows * c / V;
  const bool aligned = ((uintptr_t)x | (uintptr_t)out |
                        (uintptr_t)(g ? g : x)) % 16 == 0;
  if (c % V || !aligned || nvec > 0x7fffff00LL) return cudaErrorInvalidValue;
  const int tiles = (int)((nvec + kTileVecs - 1) / kTileVecs);
  const VecParams p{(int)nvec, c / V, tiles, k, alpha, beta};
  return run_vec<T>(which, x, g, out, p, half, stream);
}

int launch_vec(int which, const void* x, const void* g, void* out, int dtype,
               int rows, int c, int half, float k, float alpha, float beta,
               void* stream) {
  if (rows < 1 || c < 1 || half < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_vec_t<float>(which, x, g, out, rows, c, half, k,
                                    alpha, beta, s);
  if (dtype == 1)
    return (int)launch_vec_t<__nv_bfloat16>(which, x, g, out, rows, c, half,
                                            k, alpha, beta, s);
  if (dtype == 2)
    return (int)launch_vec_t<__half>(which, x, g, out, rows, c, half, k,
                                     alpha, beta, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, g, y and dx share it).
// rpb, ct: rows and channels of a block's tile; half = n / 2.  vec: x, g
// and the output are 16-byte aligned (the whole-row tiles then move
// 16-byte vectors when C allows).  Each returns the cudaError_t of its
// launch (0 on success); the caller validates shapes and contiguity.
extern "C" int dl4j_lrn_fwd(const void* x, void* y, int dtype, int rows,
                            int c, int rpb, int ct, int half, float k,
                            float alpha, float beta, int vec, void* stream) {
  return launch(0, x, nullptr, y, dtype, rows, c, rpb, ct, half, k, alpha,
                beta, vec, stream);
}

extern "C" int dl4j_lrn_bwd(const void* x, const void* g, void* dx,
                            int dtype, int rows, int c, int rpb, int ct,
                            int half, float k, float alpha, float beta,
                            int vec, void* stream) {
  return launch(1, x, g, dx, dtype, rows, c, rpb, ct, half, k, alpha, beta,
                vec, stream);
}

// The vector route: the same arguments but the tiling and vec.  Returns
// cudaErrorInvalidValue (without launching) where the route does not
// apply: C not a whole number of 16-byte vectors, a pointer not 16-byte
// aligned, 2 half > V, or more than 2^31 - 256 vectors.
extern "C" int dl4j_lrn_fwd_vec(const void* x, void* y, int dtype, int rows,
                                int c, int half, float k, float alpha,
                                float beta, void* stream) {
  return launch_vec(0, x, nullptr, y, dtype, rows, c, half, k, alpha, beta,
                    stream);
}

extern "C" int dl4j_lrn_bwd_vec(const void* x, const void* g, void* dx,
                                int dtype, int rows, int c, int half,
                                float k, float alpha, float beta,
                                void* stream) {
  return launch_vec(1, x, g, dx, dtype, rows, c, half, k, alpha, beta,
                    stream);
}
