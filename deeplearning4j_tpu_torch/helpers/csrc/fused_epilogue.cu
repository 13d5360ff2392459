// Fused dropout + residual + LayerNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/helpers/fused_epilogue.py
// `_drn_kernel` (launched by `_drn_call`):
//
//     out = mask * LayerNorm_affine(h + res) / keep
//
// on [rows, C] (float32, bfloat16 or float16), moments over the true C in
// f32, the output in h's type.
// `res` may be absent (the prologue form, dropout(LayerNorm(h)), that a
// pre-norm ResidualBlock runs), and so may the keep-mask, which is drawn
// outside the kernel (one byte per element, nonzero keeps) exactly as the
// unfused path draws it.
//
// What bounds it: bytes.  Each element is read once (h, res, mask) and
// written once, with a few flops in between, far below the ~295 flops a
// byte at which the H100's memory stops being the limit.  The design reads
// every byte once in 16-byte loads and keeps the row in registers between
// the two reductions (mean, then the variance about it) and the write: one
// block of 128 threads per row, each thread holding K vectors of 16 bytes
// (K a power of two, C <= 128 * K * 16 / sizeof(T)).  The TPU kernel holds
// the whole [rows, C] array in VMEM and so caps a pass at 2^20 elements;
// here the grid covers any number of rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}

// sum over the block; `red` holds kWarps floats
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // `red` is free (a previous reduction has been read)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
drn_kernel(const T* __restrict__ h, const T* __restrict__ res,
           const T* __restrict__ gamma, const T* __restrict__ beta,
           const uint8_t* __restrict__ mask, T* __restrict__ out, int c,
           float eps, float keep) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red[kWarps];
  const size_t base = (size_t)blockIdx.x * c;

  float x[K][kVec];
  float sum = 0.f;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int col = (kk * kThreads + threadIdx.x) * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[kk][j] = 0.f;
    if (col < c) {
      const uint4 hr = *reinterpret_cast<const uint4*>(h + base + col);
      const T* hv = reinterpret_cast<const T*>(&hr);
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[kk][j] = to_f32(hv[j]);
      if (res != nullptr) {
        const uint4 rr = *reinterpret_cast<const uint4*>(res + base + col);
        const T* rv = reinterpret_cast<const T*>(&rr);
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[kk][j] += to_f32(rv[j]);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += x[kk][j];
    }
  }
  const float mu = block_sum(sum, red) / c;

  float sq = 0.f;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int col = (kk * kThreads + threadIdx.x) * kVec;
    if (col < c) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float dv = x[kk][j] - mu;
        sq += dv * dv;
      }
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / c + eps);

#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int col = (kk * kThreads + threadIdx.x) * kVec;
    if (col >= c) continue;
    const uint4 gr = *reinterpret_cast<const uint4*>(gamma + col);
    const uint4 br = *reinterpret_cast<const uint4*>(beta + col);
    const T* gv = reinterpret_cast<const T*>(&gr);
    const T* bv = reinterpret_cast<const T*>(&br);
    alignas(16) T y[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float val = (x[kk][j] - mu) * rstd * to_f32(gv[j]) + to_f32(bv[j]);
      if (mask != nullptr) val = mask[base + col + j] ? val / keep : 0.f;
      store(&y[j], val);
    }
    *reinterpret_cast<uint4*>(out + base + col) =
        *reinterpret_cast<const uint4*>(y);
  }
}

template <typename T, int K>
cudaError_t run(const void* h, const void* res, const void* gamma,
                const void* beta, const void* mask, void* out, int rows,
                int c, float eps, float keep, cudaStream_t stream) {
  drn_kernel<T, K><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(res),
      static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), c, eps, keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* h, const void* res, const void* gamma,
                     const void* beta, const void* mask, void* out, int rows,
                     int c, float eps, float keep, cudaStream_t stream) {
  constexpr int kChunk = kThreads * (16 / sizeof(T));  // elements per K step
  const int k = (c + kChunk - 1) / kChunk;
#define DL4J_CASE(N)                                                       \
  if (k <= N)                                                              \
    return run<T, N>(h, res, gamma, beta, mask, out, rows, c, eps, keep,   \
                     stream);
  DL4J_CASE(1) DL4J_CASE(2) DL4J_CASE(4) DL4J_CASE(8) DL4J_CASE(16)
#undef DL4J_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (h, res, gamma, beta and
// out share it).
// res and mask may be NULL.  C must be a multiple of 16 / sizeof(dtype) and
// at most 128 * 16 of those vectors.  Returns the cudaError_t of the launch;
// the caller validates shapes, contiguity and alignment.
extern "C" int dl4j_dropout_residual_norm(const void* h, const void* res,
                                          const void* gamma,
                                          const void* beta, const void* mask,
                                          void* out, int dtype, int rows,
                                          int c, float eps, float keep,
                                          void* stream) {
  if (rows < 1 || c < 1 || !(keep > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (c % 4) return (int)cudaErrorInvalidValue;
    return (int)dispatch<float>(h, res, gamma, beta, mask, out, rows, c, eps,
                                keep, s);
  }
  if (dtype == 1 || dtype == 2) {
    if (c % 8) return (int)cudaErrorInvalidValue;
    if (dtype == 2)
      return (int)dispatch<__half>(h, res, gamma, beta, mask, out, rows, c,
                                   eps, keep, s);
    return (int)dispatch<__nv_bfloat16>(h, res, gamma, beta, mask, out, rows,
                                        c, eps, keep, s);
  }
  return (int)cudaErrorInvalidValue;
}
