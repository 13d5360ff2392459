// BatchNorm for Hopper (sm_90a): training forward, training backward and
// inference, on a channel-contiguous [M, C] view of any rank.
//
// Replaces the TPU kernels of deeplearning4j_tpu/helpers/pallas_ops.py:
//   `_bn_train_kernel`     (launched by `_bn_training_fwd_impl`)
//   `_bn_train_bwd_kernel` (launched by `_bn_training_bwd_rule`)
//   `_bn_inf_kernel`       (launched by `_bn_inference_impl`)
//
//   train forward:  mean, biased var over the M rows; inv = rsqrt(var+eps);
//                   y = (x - mean) * (gamma * inv) + beta
//   train backward: dbeta = sum g, dgamma = sum g * xhat,
//                   dx = gamma*inv/M * (M*g - sum g - xhat * sum g*xhat),
//                   xhat = (x - mean) * inv recomputed from x
//   inference:      y = (x - mean) * (gamma * rsqrt(var+eps)) + beta
//
// x, y, g and dx are float32, bfloat16 or float16; gamma and beta are read
// in their own type (float32, bfloat16 or float16), so the caller casts
// nothing per call; running stats, moments and every sum are float32.
//
// What bounds it: bytes.  Each element takes a few flops against 2-4 bytes
// moved, far below the ~295 flops a byte at which the H100's memory stops
// being the limit.  The TPU kernels hold the whole array in one VMEM block
// (the JAX package caps them at 2^20 elements); these are gridded and take
// any M >= 1 and any C:
//   - a reduction pass over blocks of (row chunk, 32 channels): each
//     warp reads 32 neighbouring channels of a row, 8 warps stride over
//     the chunk's rows; a block writes one float32 partial per channel
//     and chunk (count is implied; mean and M2 of the chunk, or the sums
//     of g and g*xhat);
//   - a finalize pass that merges the chunks of a channel in a fixed
//     order (Chan's formula for the moments) and writes the per-channel
//     coefficients;
//   - an elementwise pass on a 2-D grid of channel slices x row chunks:
//     a thread keeps its channels' coefficients in registers (worked out
//     once per thread for inference) and walks its rows with 16-byte
//     vectors where C and the pointers allow.
// No float atomics: the moments and gradients are the same run to run.
// The backward recomputes xhat from x, mean and inv instead of reading a
// saved xhat: the saved tensor is one [M, C] either way, and the forward
// then writes y alone.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 32;   // channels of a reduction block (one warp wide)
constexpr int kTy = 8;    // rows a reduction block walks at once
constexpr int kFy = 16;   // chunk lanes of a finalize block
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void from_f32(__half* p, float v) {
  *p = __float2half(v);
}

// V consecutive elements of T as floats (one 16-byte load when V*sizeof(T)
// is 16; the caller guarantees alignment)
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const T* t = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f32(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f32(p[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    alignas(16) T t[V];
#pragma unroll
    for (int j = 0; j < V; ++j) from_f32(&t[j], f[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(t);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) from_f32(&p[j], f[j]);
  }
}

// one channel's value stored as float32 (code 0), bfloat16 (1) or
// float16 (2); converting to float32 is exact
__device__ __forceinline__ float chan(const void* p, int code, int i) {
  if (code == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (code == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// Chan et al.: merge (nb, mb, m2b) into (n, mean, m2)
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  const float f = nb / nn;
  mean += d * f;
  m2 += m2b + d * d * n * f;
  n = nn;
}

// ---------------------------------------------------------------- moments
// grid (ceil(C/32), n_chunks), block (32, 8).  Each thread sums its rows
// shifted by its first value (so the sum of squares does not cancel), then
// the block merges its 8 row lanes in order and writes the chunk's mean
// and M2 per channel.
template <typename T>
__global__ void __launch_bounds__(kTx * kTy)
bn_moments_kernel(const T* __restrict__ x, float* __restrict__ part_mean,
                  float* __restrict__ part_m2, long long m, int c, int rpc) {
  __shared__ float sn[kTy][kTx], smean[kTy][kTx], sm2[kTy][kTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kTx + tx;
  const long long r0 = (long long)blockIdx.y * rpc;
  const long long r1 = min(r0 + rpc, m);
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (ch < c && r0 + ty < r1) {
    const T* col = x + ch;
    const float shift = to_f32(col[(size_t)(r0 + ty) * c]);
    float s = 0.f, q = 0.f;
    long long r = r0 + ty;
    for (; r + 3 * kTy < r1; r += 4 * kTy) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = to_f32(col[(size_t)(r + u * kTy) * c]) - shift;
#pragma unroll
      for (int u = 0; u < 4; ++u) { s += v[u]; q += v[u] * v[u]; }
      n += 4.f;
    }
    for (; r < r1; r += kTy) {
      const float v = to_f32(col[(size_t)r * c]) - shift;
      s += v; q += v * v; n += 1.f;
    }
    mean = shift + s / n;
    m2 = fmaxf(q - s * s / n, 0.f);
  }
  sn[ty][tx] = n; smean[ty][tx] = mean; sm2[ty][tx] = m2;
  __syncthreads();
  if (ty == 0 && ch < c) {
    for (int k = 1; k < kTy; ++k)
      chan_merge(n, mean, m2, sn[k][tx], smean[k][tx], sm2[k][tx]);
    part_mean[(size_t)blockIdx.y * c + ch] = mean;
    part_m2[(size_t)blockIdx.y * c + ch] = m2;
  }
}

// grid ceil(C/32), block (32, 16).  Merges the chunks of each channel in a
// fixed order; writes stats rows 0..4 = mean, var, inv, gamma*inv, beta.
__global__ void __launch_bounds__(kTx * kFy)
bn_moments_finalize(const float* __restrict__ part_mean,
                    const float* __restrict__ part_m2,
                    const void* __restrict__ gamma,
                    const void* __restrict__ beta, int adt,
                    float* __restrict__ stats, long long m, int c, int rpc,
                    int n_chunks, float eps) {
  __shared__ float sn[kFy][kTx], smean[kFy][kTx], sm2[kFy][kTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kTx + tx;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (ch < c) {
    for (int k = ty; k < n_chunks; k += kFy) {
      const float nb = (float)min((long long)rpc, m - (long long)k * rpc);
      chan_merge(n, mean, m2, nb, part_mean[(size_t)k * c + ch],
                 part_m2[(size_t)k * c + ch]);
    }
  }
  sn[ty][tx] = n; smean[ty][tx] = mean; sm2[ty][tx] = m2;
  __syncthreads();
  if (ty == 0 && ch < c) {
    for (int k = 1; k < kFy; ++k)
      chan_merge(n, mean, m2, sn[k][tx], smean[k][tx], sm2[k][tx]);
    const float var = m2 / (float)m;
    const float inv = rsqrtf(var + eps);
    stats[ch] = mean;
    stats[c + ch] = var;
    stats[2 * c + ch] = inv;
    stats[3 * c + ch] = chan(gamma, adt, ch) * inv;
    stats[4 * c + ch] = chan(beta, adt, ch);
  }
}

// ------------------------------------------------------------- grad sums
// grid (ceil(C/32), n_chunks), block (32, 8): per chunk and channel the
// sums of g and g * xhat, xhat = (x - mean) * inv.
template <typename T>
__global__ void __launch_bounds__(kTx * kTy)
bn_grad_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv, float* __restrict__ part_g,
                    float* __restrict__ part_gx, long long m, int c,
                    int rpc) {
  __shared__ float sg[kTy][kTx], sgx[kTy][kTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kTx + tx;
  const long long r0 = (long long)blockIdx.y * rpc;
  const long long r1 = min(r0 + rpc, m);
  float sum_g = 0.f, sum_gx = 0.f;
  if (ch < c) {
    const float mu = mean[ch], iv = inv[ch];
    long long r = r0 + ty;
    for (; r + 3 * kTy < r1; r += 4 * kTy) {
      float xv[4], gv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t off = (size_t)(r + u * kTy) * c + ch;
        xv[u] = to_f32(x[off]);
        gv[u] = to_f32(g[off]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sum_g += gv[u];
        sum_gx += gv[u] * ((xv[u] - mu) * iv);
      }
    }
    for (; r < r1; r += kTy) {
      const size_t off = (size_t)r * c + ch;
      const float gv = to_f32(g[off]);
      sum_g += gv;
      sum_gx += gv * ((to_f32(x[off]) - mu) * iv);
    }
  }
  sg[ty][tx] = sum_g; sgx[ty][tx] = sum_gx;
  __syncthreads();
  if (ty == 0 && ch < c) {
    for (int k = 1; k < kTy; ++k) { sum_g += sg[k][tx]; sum_gx += sgx[k][tx]; }
    part_g[(size_t)blockIdx.y * c + ch] = sum_g;
    part_gx[(size_t)blockIdx.y * c + ch] = sum_gx;
  }
}

// grid ceil(C/32), block (32, 16).  dgb rows 0, 1 = dgamma, dbeta; coef
// rows 0..3 = mean, -a*inv*sum_gx/M, -a*sum_g/M, a with a = gamma*inv, so
// that dx = a*g + coef1*(x - mean) + coef2.
__global__ void __launch_bounds__(kTx * kFy)
bn_grad_finalize(const float* __restrict__ part_g,
                 const float* __restrict__ part_gx,
                 const void* __restrict__ gamma, int adt,
                 const float* __restrict__ mean, const float* __restrict__ inv,
                 float* __restrict__ dgb, float* __restrict__ coef,
                 long long m, int c, int n_chunks) {
  __shared__ float sg[kFy][kTx], sgx[kFy][kTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kTx + tx;
  float sum_g = 0.f, sum_gx = 0.f;
  if (ch < c) {
    for (int k = ty; k < n_chunks; k += kFy) {
      sum_g += part_g[(size_t)k * c + ch];
      sum_gx += part_gx[(size_t)k * c + ch];
    }
  }
  sg[ty][tx] = sum_g; sgx[ty][tx] = sum_gx;
  __syncthreads();
  if (ty == 0 && ch < c) {
    for (int k = 1; k < kFy; ++k) { sum_g += sg[k][tx]; sum_gx += sgx[k][tx]; }
    const float iv = inv[ch];
    const float a = chan(gamma, adt, ch) * iv;
    dgb[ch] = sum_gx;
    dgb[c + ch] = sum_g;
    coef[ch] = mean[ch];
    coef[c + ch] = -a * iv * (sum_gx / (float)m);
    coef[2 * c + ch] = -a * (sum_g / (float)m);
    coef[3 * c + ch] = a;
  }
}

// ------------------------------------------------------------ elementwise
// out = (x - ctr) * scl + sft (+ gsc * g in the backward), per channel,
// with the coefficients taken once per thread into registers:
//   kInference: ctr = mean, scl = gamma * rsqrt(var + eps), sft = beta,
//               from the running stats (float32) and gamma and beta (in
//               their own type).  The reference kernel's x * scl + (beta
//               - mean * scl) cancels where scl is large (a variance near
//               0: 1 / sqrt(eps) = 316 at eps 1e-5), so x is centred
//               first, as in the training passes;
//   otherwise:  ctr, scl, sft (and gsc) read from the float32 rows the
//               finalize kernel wrote.
// Grid (channel slices, row chunks), block (bx, by): thread (tx, ty) of
// slice sx owns the V adjacent channels of vector column sx * bx + tx
// and walks rows ty, ty + by, ... of its chunk, four rows at a time, so
// x and out move as 16-byte vectors along a row (V = 16 / sizeof(T)) with
// no per-vector index arithmetic beyond the row offset; V = 1 is the
// scalar path for a C that is not whole vectors or unaligned pointers.
enum { kApply = 0, kGradPass = 1, kInference = 2 };

struct Coef {
  const float* p0;  // kInference: mean; else ctr
  const float* p1;  // kInference: var; else scl
  const float* p2;  // sft (training passes)
  const float* p3;  // gsc (kGradPass)
  const void* gamma;  // kInference, in type `adt`
  const void* beta;   // kInference, in type `adt`
  int adt;
  float eps;
};

template <typename T, int V, int kMode>
__global__ void __launch_bounds__(kThreads)
bn_elementwise_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      Coef k, T* __restrict__ out, long long m, int c,
                      int rpc) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col * V >= c) return;
  const int c0 = col * V;
  float ctr[V], scl[V], sft[V], gsc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ctr[j] = k.p0[c0 + j];
    if constexpr (kMode == kInference) {
      scl[j] = chan(k.gamma, k.adt, c0 + j) * rsqrtf(k.p1[c0 + j] + k.eps);
      sft[j] = chan(k.beta, k.adt, c0 + j);
    } else {
      scl[j] = k.p1[c0 + j];
      sft[j] = k.p2[c0 + j];
      if constexpr (kMode == kGradPass) gsc[j] = k.p3[c0 + j];
    }
  }
  const long long r1 = min((long long)(blockIdx.y + 1) * rpc, m);
  const long long by = blockDim.y;
  long long r = (long long)blockIdx.y * rpc + threadIdx.y;
  auto row = [&](const float (&xv)[V], const float (&gv)[V], long long rr) {
    float y[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      y[j] = (xv[j] - ctr[j]) * scl[j] + sft[j];
      if constexpr (kMode == kGradPass) y[j] += gsc[j] * gv[j];
    }
    store_vec<T, V>(out + (size_t)rr * c + c0, y);
  };
  for (; r + 3 * by < r1; r += 4 * by) {
    float xv[4][V], gv[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      load_vec<T, V>(x + (size_t)(r + u * by) * c + c0, xv[u]);
      if constexpr (kMode == kGradPass)
        load_vec<T, V>(g + (size_t)(r + u * by) * c + c0, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) row(xv[u], gv[u], r + u * by);
  }
  for (; r < r1; r += by) {
    float xv[V], gv[V];
    load_vec<T, V>(x + (size_t)r * c + c0, xv);
    if constexpr (kMode == kGradPass)
      load_vec<T, V>(g + (size_t)r * c + c0, gv);
    row(xv, gv, r);
  }
}

// The elementwise grid, as the caller sized it (``elementwise_grid`` in
// batch_norm.py): vec is 1 or 16 / sizeof(T), block (bx, by), rpc rows a
// chunk.
struct Grid {
  int vec, bx, by, rpc;
};

inline bool grid_ok(const Grid& gr, long long m, int c, int kv) {
  return (gr.vec == 1 || (gr.vec == kv && c % kv == 0)) && gr.bx >= 1 &&
         gr.by >= 1 && gr.bx * gr.by <= kThreads && gr.rpc >= 1 &&
         (m + gr.rpc - 1) / gr.rpc <= 65535;
}

template <typename T, int kMode>
cudaError_t elementwise(const void* x, const void* g, const Coef& k,
                        void* out, long long m, int c, const Grid& gr,
                        cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (!grid_ok(gr, m, c, kV)) return cudaErrorInvalidValue;
  const int cols = c / gr.vec;
  const dim3 grid((cols + gr.bx - 1) / gr.bx,
                  (unsigned)((m + gr.rpc - 1) / gr.rpc));
  const dim3 block(gr.bx, gr.by);
  if (gr.vec == kV)
    bn_elementwise_kernel<T, kV, kMode><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), k,
        static_cast<T*>(out), m, c, gr.rpc);
  else
    bn_elementwise_kernel<T, 1, kMode><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), k,
        static_cast<T*>(out), m, c, gr.rpc);
  return cudaGetLastError();
}

inline int n_chunks_of(long long m, int rpc) {
  return (int)((m + rpc - 1) / rpc);
}

template <typename T>
cudaError_t train_fwd(const void* x, const void* gamma, const void* beta,
                      int adt, void* y, float* stats, float* scratch,
                      long long m, int c, int rpc, float eps, const Grid& gr,
                      cudaStream_t s) {
  const int n_chunks = n_chunks_of(m, rpc);
  const int ctiles = (c + kTx - 1) / kTx;
  float* part_mean = scratch;
  float* part_m2 = scratch + (size_t)n_chunks * c;
  bn_moments_kernel<T><<<dim3(ctiles, n_chunks), dim3(kTx, kTy), 0, s>>>(
      static_cast<const T*>(x), part_mean, part_m2, m, c, rpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_moments_finalize<<<ctiles, dim3(kTx, kFy), 0, s>>>(
      part_mean, part_m2, gamma, beta, adt, stats, m, c, rpc, n_chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // y = (x - mean) * (gamma * inv) + beta
  const Coef k{stats, stats + 3 * c, stats + 4 * c, nullptr,
               nullptr, nullptr, 0, 0.f};
  return elementwise<T, kApply>(x, nullptr, k, y, m, c, gr, s);
}

template <typename T>
cudaError_t train_bwd(const void* x, const void* g, const void* gamma,
                      int adt, const float* mean, const float* inv, void* dx,
                      float* dgb, float* scratch, long long m, int c, int rpc,
                      const Grid& gr, cudaStream_t s) {
  const int n_chunks = n_chunks_of(m, rpc);
  const int ctiles = (c + kTx - 1) / kTx;
  float* part_g = scratch;
  float* part_gx = scratch + (size_t)n_chunks * c;
  float* coef = scratch + 2 * (size_t)n_chunks * c;
  bn_grad_sums_kernel<T><<<dim3(ctiles, n_chunks), dim3(kTx, kTy), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mean, inv, part_g,
      part_gx, m, c, rpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_grad_finalize<<<ctiles, dim3(kTx, kFy), 0, s>>>(
      part_g, part_gx, gamma, adt, mean, inv, dgb, coef, m, c, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dx = (x - mean) * coef1 + coef2 + a * g
  const Coef k{coef, coef + c, coef + 2 * c, coef + 3 * c,
               nullptr, nullptr, 0, 0.f};
  return elementwise<T, kGradPass>(x, g, k, dx, m, c, gr, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, y, g and dx share it);
// adt: the same codes for gamma and beta (gamma alone in the backward),
// read in their own type; mean, var and inv are float32, as are stats,
// dgb and scratch.  Shapes: x, y, g, dx [m, c]; gamma, beta, mean, var,
// inv [c]; stats [5, c] (mean, var, inv, gamma*inv, beta); dgb [2, c]
// (dgamma, dbeta); scratch 2*n_chunks*c floats (forward) or 2*n_chunks*c +
// 4*c (backward), n_chunks = ceil(m / rows_per_chunk).  The elementwise
// pass runs on the grid (vec, bx, by, ew_rpc) the caller sized: vec = 16 /
// sizeof(x's type) only when C is whole vectors and x, y, g and dx are
// 16-byte aligned, else 1.  Each returns the cudaError_t of its launches
// (the forward and backward launch three kernels each, the inference
// one); the caller validates shapes, contiguity and alignment.

extern "C" int dl4j_bn_train_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, float* stats,
                                 float* scratch, int dtype, int adt,
                                 long long m, int c, int rows_per_chunk,
                                 float eps, int vec, int bx, int by,
                                 int ew_rpc, void* stream) {
  if (m < 1 || c < 1 || rows_per_chunk < 1 || adt < 0 || adt > 2 ||
      n_chunks_of(m, rows_per_chunk) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid gr{vec, bx, by, ew_rpc};
  if (dtype == 0)
    return (int)train_fwd<float>(x, gamma, beta, adt, y, stats, scratch, m,
                                 c, rows_per_chunk, eps, gr, s);
  if (dtype == 1)
    return (int)train_fwd<__nv_bfloat16>(x, gamma, beta, adt, y, stats,
                                         scratch, m, c, rows_per_chunk, eps,
                                         gr, s);
  if (dtype == 2)
    return (int)train_fwd<__half>(x, gamma, beta, adt, y, stats, scratch, m,
                                  c, rows_per_chunk, eps, gr, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dl4j_bn_train_bwd(const void* x, const void* g,
                                 const void* gamma, const float* mean,
                                 const float* inv, void* dx, float* dgb,
                                 float* scratch, int dtype, int adt,
                                 long long m, int c, int rows_per_chunk,
                                 int vec, int bx, int by, int ew_rpc,
                                 void* stream) {
  if (m < 1 || c < 1 || rows_per_chunk < 1 || adt < 0 || adt > 2 ||
      n_chunks_of(m, rows_per_chunk) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid gr{vec, bx, by, ew_rpc};
  if (dtype == 0)
    return (int)train_bwd<float>(x, g, gamma, adt, mean, inv, dx, dgb,
                                 scratch, m, c, rows_per_chunk, gr, s);
  if (dtype == 1)
    return (int)train_bwd<__nv_bfloat16>(x, g, gamma, adt, mean, inv, dx,
                                         dgb, scratch, m, c, rows_per_chunk,
                                         gr, s);
  if (dtype == 2)
    return (int)train_bwd<__half>(x, g, gamma, adt, mean, inv, dx, dgb,
                                  scratch, m, c, rows_per_chunk, gr, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dl4j_bn_inference(const void* x, const float* mean,
                                 const float* var, const void* gamma,
                                 const void* beta, void* y, int dtype,
                                 int adt, long long m, int c, float eps,
                                 int vec, int bx, int by, int ew_rpc,
                                 void* stream) {
  if (m < 1 || c < 1 || adt < 0 || adt > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid gr{vec, bx, by, ew_rpc};
  // y = (x - mean) * (gamma * rsqrt(var + eps)) + beta
  const Coef k{mean, var, nullptr, nullptr, gamma, beta, adt, eps};
  if (dtype == 0)
    return (int)elementwise<float, kInference>(x, nullptr, k, y, m, c, gr, s);
  if (dtype == 1)
    return (int)elementwise<__nv_bfloat16, kInference>(x, nullptr, k, y, m,
                                                       c, gr, s);
  if (dtype == 2)
    return (int)elementwise<__half, kInference>(x, nullptr, k, y, m, c, gr,
                                                s);
  return (int)cudaErrorInvalidValue;
}
