// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/helpers/paged_attention.py
// `_decode_kernel` (launched by `_pallas_paged`): per-row causal attention
// of q [B, T, Hq, D] straight off the flattened K/V page pools
// [P * page_size, Hkv, D] through the int32 block table [B, MAXP], without
// ever gathering the [B, MAXP * page_size, Hkv, D] view.  A key's global
// position is its logical slot p * page_size + i; a query row at position
// q_pos sees the keys with q_pos >= p * page_size + i.  That mask also hides
// the trash page 0 and slots not yet written.  Query head h reads kv head
// h / G (G = Hq / Hkv), the grouping of q.reshape(b, t, hkv, g, d) in the
// reference.  A row that sees no key (l = 0) writes 0.
//
// What bounds it: bytes.  Each (row, kv head) reads the live K and V
// pages once and does 4 * D flops per key, far below the ~295 flops a
// byte at which the H100's tensor cores, not its memory, would become the
// limit.  The design therefore reads every live K/V byte once per block,
// with coalesced 16-byte loads, and reads nothing above the block's
// highest query position: the TPU kernel's sequential page axis becomes a
// loop over 32-key chunks inside the block, which stops at that position.
//
// Layout of the work: one block of 4 warps per (batch row b, kv head,
// tile of 4 query rows); each warp owns one of the G * T query rows of
// (b, kv head).  The TPU kernel holds all G * T rows in one VMEM block;
// tiling them keeps a block's shared memory small and gives a prefill
// (B = 1, T = bucket) more than B * Hkv blocks.  Per chunk the block
// stages 32 keys of K and V in shared memory as f32 (K rows padded by one
// word so that lane j reading key j is free of bank conflicts); lane j
// scores key j, the warp runs the online softmax (running max m, sum l)
// in registers, and each lane accumulates D / 32 output dims.
//
// This is the simple first version: no cp.async/TMA double buffering, no
// wgmma, no split over keys for long contexts.  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;          // keys per chunk: one per lane
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// DPL = output dims per lane = ceil(D / 32), 1..8 (D <= 256).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                    const T* __restrict__ pv, const int32_t* __restrict__ block,
                    const int32_t* __restrict__ qpos, T* __restrict__ out,
                    int t_len, int hq, int hkv, int d, int page_size, int maxp,
                    int num_pages, float scale) {
  extern __shared__ float smem[];
  const int ks_stride = d + 1;
  float* ks = smem;                    // [kKeys][d + 1]
  float* vs = ks + kKeys * ks_stride;  // [kKeys][d]
  float* qs = vs + kKeys * d;          // [kWarps][d]

  const int g = hq / hkv;
  const int rows = g * t_len;  // query rows of one (b, kv head)
  const int b = blockIdx.x / hkv;
  const int h_kv = blockIdx.x % hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.y * kWarps + warp;
  const bool row_ok = row < rows;
  const int gi = row_ok ? row / t_len : 0;
  const int ti = row_ok ? row % t_len : 0;
  const int h = h_kv * g + gi;
  const int my_pos = row_ok ? qpos[b * t_len + ti] : -1;

  // the block's highest query position: no key above it is ever read
  int max_pos = -1;
  for (int w = 0; w < kWarps; ++w) {
    const int r = blockIdx.y * kWarps + w;
    if (r < rows) max_pos = max(max_pos, qpos[b * t_len + r % t_len]);
  }
  const int n_keys = min(max_pos + 1, maxp * page_size);

  if (row_ok) {
    const T* qrow = q + ((size_t)(b * t_len + ti) * hq + h) * d;
    for (int i = lane; i < d; i += 32) qs[warp * d + i] = to_f32(qrow[i]);
  }

  float m = kNegInf, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int vec_per_key = d / kVec;
  const int32_t* brow = block + (size_t)b * maxp;

  for (int c0 = 0; c0 < n_keys; c0 += kKeys) {
    __syncthreads();  // the previous chunk is consumed; qs is visible
    for (int idx = threadIdx.x; idx < kKeys * vec_per_key; idx += kThreads) {
      const int kk = idx / vec_per_key;
      const int dv = (idx % vec_per_key) * kVec;
      const int kp = c0 + kk;
      float kf[kVec], vf[kVec];
      if (kp < n_keys) {
        int page = brow[kp / page_size];
        page = min(max(page, 0), num_pages - 1);  // clamp, as XLA's gather
        const size_t src =
            (((size_t)page * page_size + kp % page_size) * hkv + h_kv) * d + dv;
        const uint4 kraw = *reinterpret_cast<const uint4*>(pk + src);
        const uint4 vraw = *reinterpret_cast<const uint4*>(pv + src);
        const T* kt = reinterpret_cast<const T*>(&kraw);
        const T* vt = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          kf[j] = to_f32(kt[j]);
          vf[j] = to_f32(vt[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) kf[j] = vf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ks[kk * ks_stride + dv + j] = kf[j];
        vs[kk * d + dv + j] = vf[j];
      }
    }
    __syncthreads();
    if (!row_ok) continue;  // uniform per warp

    const int kp = c0 + lane;
    const float* kr = ks + lane * ks_stride;
    const float* qr = qs + warp * d;
    float s = 0.f;
    for (int i = 0; i < d; ++i) s = fmaf(qr[i], kr[i], s);
    const bool keep = kp < n_keys && kp <= my_pos;
    s = keep ? s * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float p = keep ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = alpha * l + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    for (int j = 0; j < kKeys; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
      const float* vr = vs + j * d;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < d) acc[i] = fmaf(pj, vr[dd], acc[i]);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = out + ((size_t)(b * t_len + ti) * hq + h) * d;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int dd = lane + 32 * i;
    if (dd < d) store_out(orow + dd, acc[i] * inv);
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int32_t* block, const int32_t* qpos, void* out, int b,
                   int t, int hq, int hkv, int d, int page_size, int maxp,
                   int num_pages, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kKeys * (d + 1) +
                                       (size_t)kKeys * d + (size_t)kWarps * d);
  auto kernel = paged_decode_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = (hq / hkv) * t;
  const dim3 grid(b * hkv, (rows + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), block, qpos, static_cast<T*>(out), t, hq, hkv,
      d, page_size, maxp, num_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* pk, const void* pv,
                     const int32_t* block, const int32_t* qpos, void* out,
                     int b, int t, int hq, int hkv, int d, int page_size,
                     int maxp, int num_pages, float scale,
                     cudaStream_t stream) {
  switch ((d + 31) / 32) {
#define DL4J_CASE(N)                                                        \
  case N:                                                                   \
    return launch<T, N>(q, pk, pv, block, qpos, out, b, t, hq, hkv, d,      \
                        page_size, maxp, num_pages, scale, stream);
    DL4J_CASE(1) DL4J_CASE(2) DL4J_CASE(3) DL4J_CASE(4)
    DL4J_CASE(5) DL4J_CASE(6) DL4J_CASE(7) DL4J_CASE(8)
#undef DL4J_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// Returns the cudaError_t of the launch (0 on success).  The caller
// validates shapes, strides, alignment and dtypes beforehand.
extern "C" int dl4j_paged_decode_attention(
    const void* q, const void* pk, const void* pv, const void* block,
    const void* qpos, void* out, int dtype, int b, int t, int hq, int hkv,
    int d, int page_size, int maxp, int num_pages, float scale,
    void* stream) {
  if (d < 8 || d > 256 || d % 8 || hkv < 1 || hq % hkv || num_pages < 1)
    return (int)cudaErrorInvalidValue;
  const int32_t* blk = static_cast<const int32_t*>(block);
  const int32_t* qp = static_cast<const int32_t*>(qpos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, pk, pv, blk, qp, out, b, t, hq, hkv, d,
                          page_size, maxp, num_pages, scale, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, pk, pv, blk, qp, out, b, t, hq, hkv, d,
                                  page_size, maxp, num_pages, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
