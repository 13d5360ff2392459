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
// once: one block of 256 threads takes a tile of rows x channels (about
// 2048 elements, the caller's choice) and stages it in shared memory in
// its own type, with a halo of channels on each side (zeros outside
// [0, C)).  Where a row fits a tile the tile spans whole rows, one
// contiguous span of the tensor copied in 16-byte vectors; wider rows are
// cut into channel tiles whose halos overlap their neighbours' (scalar
// loads).  Then consecutive threads take consecutive elements, so every
// window sum reads shared memory without bank conflicts (eight neighbouring
// channels a thread would read it 8-way conflicted) and the stores
// coalesce.  The arithmetic is float32.  The TPU kernel pads channels to
// 128 lanes and holds the whole array in one VMEM block (which the JAX
// package caps at 2^20 elements); neither applies here.
//
// The backward recomputes s from x instead of reading a saved s: it reads x
// anyway (for t), so a saved s would cost the forward a write and the
// backward a read, and a bfloat16 s would lose the precision the float32
// recompute keeps.  It stages x with a halo of 2 (n/2) channels and g with
// n/2, computes s^-beta and t over the tile and a halo of n/2, then t's
// window sums.

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

// n = 3, 5 (AlexNet's) and 7, and their even neighbours, get unrolled
// window loops; any other n reads its half-width at run time
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
