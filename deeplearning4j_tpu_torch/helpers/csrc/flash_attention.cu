// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the TPU kernels of deeplearning4j_tpu/helpers/flash_attention.py:
// `_fwd_kernel` (launched by `_fwd_call`), `_dq_kernel` and `_dkv_kernel`
// (both launched by `_bwd_call`).  q, k, v, dout, o and the gradients are
// [B, T, H, D] in the layer layout (no [B*H, T, D -> 128] relayout and no
// lane padding: D is taken as it is, a multiple of 8 up to 256); lse and
// delta are [B, H, T] float32.
//
//   forward: o = softmax(q k^T * scale) v per (b, h), online softmax over
//            key tiles; lse = m + log(l).  A row that sees no key writes 0.
//   dQ:      q-major, recomputes p = exp(s - lse);
//            ds = p * (dout v^T - delta); dq = ds k * scale.
//   dK/dV:   k-major, the same p and ds; dv = p^T dout; dk = ds^T q * scale.
// delta = rowsum(dout * o) [B, H, T] float32: on the wgmma and tf32x3
// routes the dQ kernel computes it from the o and dout rows it reads and
// writes it for dK/dV, which runs after it; on the other routes the caller
// computes it (a torch reduction, as the reference leaves it to XLA) and
// dQ reads it.
// Neither backward kernel uses atomics: each block owns its output rows,
// so gradients are the same run to run.
//
// Mask, as the reference's `_causal_mask`: keep kpos <= qpos and, with a
// window, kpos > qpos - window.  Key (or query) tiles outside that band are
// never loaded, as `_block_live`/`_kv_index`/`_q_index` skip them; the
// ragged tail (T not a multiple of the tile) is masked, so any T >= 1 works.
// The reference's casts are kept: p is rounded to v's type before p v, and
// ds to q's type before ds k and ds^T q; every product accumulates in f32.
//
// What bounds it: operations.  At T = 2048, D = 128 a causal forward does
// about 4 * D flops per live (query, key) pair against 2 * D * 2 bytes of
// q/k/v read once per tile pair from L2, far above the ~295 flops a byte at
// which the H100's memory stops being the limit.  So the products go to the
// tensor cores, by three routes, and the rest to the CUDA cores (`path`,
// queried by dl4j_flash_path):
//
// - wgmma (bfloat16 and float16 with D in {64, 128}: all three kernels of
//   the main path).  Per block a producer warpgroup whose one thread
//   keeps TMA loads in flight into a two-stage ring guarded by mbarriers,
//   and two consumer warpgroups of 64 rows each on wgmma m64nNk16: q k^T
//   and the other score products with both operands in shared memory, p v
//   (and p^T do, ds^T q, ds k) with p or ds taken straight from the
//   accumulators as the register A operand and the shared-memory tile
//   read transposed.  Forward: one block per (b, h, tile of 128 queries),
//   128-key tiles.  dQ: the same blocks, 64-key steps.  dK/dV: one block
//   per (b, h, tile of 128 keys), 64-query steps, dK and dV summed in
//   registers.  The tensor maps zero-fill rows past T.
// - mma.sync m16n8k16 (the same types with D in {16, 32}): one block of
//   4 warps per (b, h, tile of 64 rows),
//   each warp 16 rows; the score tile, p and ds stay in the accumulator
//   registers, whose layout is also the A operand of the next product.
//   Tiles are staged in shared memory with synchronous loads.
// - tf32x3 (float32 with D in {64, 128}: all three kernels): mma.sync
//   m16n8k8 in TF32, three products per pair of fragments so that the
//   result keeps float32 accuracy; see the section before `prepare`.
// - f32 kernels on the CUDA cores (every kernel at other head dims): one
//   block of 256 threads (16 x 16) per
//   (b, h, tile of BM rows), a BM x BM score tile held as R x R (R = BM /
//   16) per thread, row statistics reduced across the 16 threads of a row
//   with warp shuffles, tiles staged in shared memory as f32 with rows
//   padded to an odd stride.  BM is 64 for D <= 128 and 32 above, to keep
//   a block's shared memory under the 227 KB a block may use.
//
// In every route, m, l and the output sums are f32 registers, and the
// TPU's sequential key grid axis with its VMEM scratch becomes a loop
// inside the block.  No route falls back to another: a failed tensor-map
// encode or launch is returned as an error.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}
// the value after the reference's `.astype(T)` ahead of a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// sum / max over the 16 lanes that share a row (lane bits 0..3)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Shape {
  int t, h, d;
  int causal;
  int window;  // 0: no window
  float scale;
};

__device__ __forceinline__ bool live(int q, int k, const Shape& s) {
  if (q >= s.t || k >= s.t) return false;
  if (!s.causal) return true;
  return k <= q && (s.window == 0 || k > q - s.window);
}

// Key tiles [k_lo, k_hi) that a query tile [q0, q0 + bm) sees, walked in
// steps of `step` keys (k_lo a multiple of it).
__device__ __forceinline__ void key_range(int q0, int bm, const Shape& s,
                                          int* k_lo, int* k_hi,
                                          int step = 0) {
  if (step == 0) step = bm;
  int lo = 0, hi = s.t;
  if (s.causal) {
    hi = min(s.t, q0 + bm);
    if (s.window) lo = max(0, q0 - s.window + 1);
  }
  *k_lo = (lo / step) * step;
  *k_hi = hi;
}

// Query tiles [q_lo, q_hi) that a key tile [k0, k0 + bm) is seen by.
__device__ __forceinline__ void query_range(int k0, int bm, const Shape& s,
                                            int* q_lo, int* q_hi) {
  int lo = 0, hi = s.t;
  if (s.causal) {
    lo = k0;
    if (s.window) hi = min(s.t, k0 + bm - 1 + s.window);
  }
  *q_lo = (lo / bm) * bm;
  *q_hi = hi;
}

// Rows [row0, row0 + BM) of head (b, h) of a [B, T, H, D] tensor into shared
// memory as f32, row stride `ld`; rows at or past T read as 0.
template <typename T, int BM>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src, int b,
                                          int h, int row0, const Shape& s) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = s.d / kVec;
  for (int idx = threadIdx.x; idx < BM * vpr; idx += kThreads) {
    const int r = idx / vpr;
    const int c = (idx % vpr) * kVec;
    const int t = row0 + r;
    float* out = dst + r * ld + c;
    if (t < s.t) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * s.t + t) * s.h + h) * s.d + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = to_f32(v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = 0.f;
    }
  }
}

// One BM x BM product tile: acc[i][j] += sum_d a[ty + 16 i][d] * b[tx + 16 j][d]
template <int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][R],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int ld,
                                         int d, int ty, int tx) {
#pragma unroll 4
  for (int dd = 0; dd < d; ++dd) {
    float av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty + 16 * i) * ld + dd];
#pragma unroll
    for (int j = 0; j < R; ++j) bv[j] = b[(tx + 16 * j) * ld + dd];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T, int BM, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape s) {
  constexpr int R = BM / 16;
  extern __shared__ float smem[];
  const int ld = s.d + 1;
  float* qs = smem;           // [BM][d + 1]
  float* ks = qs + BM * ld;   // [BM][d + 1]
  float* vs = ks + BM * ld;   // [BM][d]
  float* ps = vs + BM * s.d;  // [BM][BM + 1]

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest rows first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, BM>(qs, ld, q, b, h, q0, s);

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int k_lo, k_hi;
  key_range(q0, BM, s, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BM) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T, BM>(ks, ld, k, b, h, k0, s);
    load_tile<T, BM>(vs, s.d, v, b, h, k0, s);
    __syncthreads();

    float sc[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) sc[i][j] = 0.f;
    tile_dot<R>(sc, qs, ks, ld, s.d, ty, tx);

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        sc[i][j] = live(qi, k0 + tx + 16 * j, s) ? sc[i][j] * s.scale
                                                  : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = live(qi, k0 + tx + 16 * j, s)
                            ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        ps[(ty + 16 * i) * (BM + 1) + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BM; ++kk) {
      float pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = ps[(ty + 16 * i) * (BM + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < s.d ? vs[kk * s.d + col] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s.t) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + (((size_t)b * s.t + qi) * s.h + h) * s.d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < s.d) orow[col] = from_f32<T>(acc[i][c] * inv);
    }
    if (tx == 0)
      lse[(size_t)bh * s.t + qi] = m[i] + logf(l[i] > 0.f ? l[i] : 1.f);
  }
}

template <typename T, int BM, int DC>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                Shape s) {
  constexpr int R = BM / 16;
  extern __shared__ float smem[];
  const int ld = s.d + 1;
  float* qs = smem;           // [BM][d + 1]
  float* dos = qs + BM * ld;  // [BM][d + 1]
  float* ks = dos + BM * ld;  // [BM][d + 1]
  float* vs = ks + BM * ld;   // [BM][d + 1]
  float* dss = vs + BM * ld;  // [BM][BM + 1]

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, BM>(qs, ld, q, b, h, q0, s);
  load_tile<T, BM>(dos, ld, dout, b, h, q0, s);

  float lse_r[R], del_r[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse_r[i] = qi < s.t ? lse[(size_t)bh * s.t + qi] : 0.f;
    del_r[i] = qi < s.t ? delta[(size_t)bh * s.t + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int k_lo, k_hi;
  key_range(q0, BM, s, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BM) {
    __syncthreads();
    load_tile<T, BM>(ks, ld, k, b, h, k0, s);
    load_tile<T, BM>(vs, ld, v, b, h, k0, s);
    __syncthreads();

    float sc[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) sc[i][j] = dp[i][j] = 0.f;
    tile_dot<R>(sc, qs, ks, ld, s.d, ty, tx);
    tile_dot<R>(dp, dos, vs, ld, s.d, ty, tx);

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float ds = 0.f;
        if (live(qi, k0 + tx + 16 * j, s)) {
          const float p = expf(sc[i][j] * s.scale - lse_r[i]);
          ds = p * (dp[i][j] - del_r[i]);
        }
        dss[(ty + 16 * i) * (BM + 1) + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BM; ++kk) {
      float dv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dv[i] = dss[(ty + 16 * i) * (BM + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        const float kv = col < s.d ? ks[kk * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(dv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s.t) continue;
    T* row = dq + (((size_t)b * s.t + qi) * s.h + h) * s.d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < s.d) row[col] = from_f32<T>(acc[i][c] * s.scale);
    }
  }
}

template <typename T, int BM, int DC>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Shape s) {
  constexpr int R = BM / 16;
  extern __shared__ float smem[];
  const int ld = s.d + 1;
  float* ks = smem;                   // [BM][d + 1]
  float* vs = ks + BM * ld;           // [BM][d + 1]
  float* qs = vs + BM * ld;           // [BM][d + 1]
  float* dos = qs + BM * ld;          // [BM][d + 1]
  float* pss = dos + BM * ld;         // [BM keys][BM + 1 queries]
  float* dss = pss + BM * (BM + 1);   // [BM keys][BM + 1 queries]
  float* lses = dss + BM * (BM + 1);  // [BM]
  float* dels = lses + BM;            // [BM]

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int k0 = blockIdx.x * BM;  // longest columns (small k0) first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, BM>(ks, ld, k, b, h, k0, s);
  load_tile<T, BM>(vs, ld, v, b, h, k0, s);

  float dk_acc[R][DC], dv_acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int q_lo, q_hi;
  query_range(k0, BM, s, &q_lo, &q_hi);
  for (int q0 = q_lo; q0 < q_hi; q0 += BM) {
    __syncthreads();
    load_tile<T, BM>(qs, ld, q, b, h, q0, s);
    load_tile<T, BM>(dos, ld, dout, b, h, q0, s);
    if (threadIdx.x < BM) {
      const int qi = q0 + threadIdx.x;
      lses[threadIdx.x] = qi < s.t ? lse[(size_t)bh * s.t + qi] : 0.f;
      dels[threadIdx.x] = qi < s.t ? delta[(size_t)bh * s.t + qi] : 0.f;
    }
    __syncthreads();

    // this thread's tile: key rows ty + 16 i, query columns tx + 16 j
    float st[R][R], dpt[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) st[i][j] = dpt[i][j] = 0.f;
    tile_dot<R>(st, ks, qs, ld, s.d, ty, tx);
    tile_dot<R>(dpt, vs, dos, ld, s.d, ty, tx);

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qc = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (live(q0 + qc, kj, s)) {
          p = expf(st[i][j] * s.scale - lses[qc]);
          ds = p * (dpt[i][j] - dels[qc]);
        }
        pss[(ty + 16 * i) * (BM + 1) + qc] = round_to<T>(p);
        dss[(ty + 16 * i) * (BM + 1) + qc] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BM; ++qq) {
      float pv[R], dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = pss[(ty + 16 * i) * (BM + 1) + qq];
        dsv[i] = dss[(ty + 16 * i) * (BM + 1) + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        const bool in = col < s.d;
        const float dov = in ? dos[qq * ld + col] : 0.f;
        const float qv = in ? qs[qq * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= s.t) continue;
    const size_t off = (((size_t)b * s.t + kj) * s.h + h) * s.d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < s.d) {
        dk[off + col] = from_f32<T>(dk_acc[i][c] * s.scale);
        dv[off + col] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// mma.sync path: bfloat16 or float16 (the element type E) with D in
// {16, 32} (at 64 and 128 all three kernels take the wgmma path below).
// The same tiles,
// masks, casts and loops as above, with
// every product on mma.sync m16n8k16 (E in, f32 accumulate).  Each warp
// owns 16 rows of the block's tile; the fragment layouts are PTX's (the
// same for both types): for lane = 4 g + t, an f32 accumulator holds
// (row g, cols 2t, 2t+1) and (row g + 8, same cols), which is also the
// A-operand layout of the next product once packed to E pairs, so p and ds
// never leave registers.  Tiles sit in shared memory as raw 16-bit E with
// rows padded by 8 elements (conflict-free fragment reads).
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows
constexpr int kMmaRows = 64;

template <typename E>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two E, `lo` in the low half
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// elements (r, c) and (r, c + 1) of a [rows][ld] 16-bit tile
__device__ __forceinline__ uint32_t ld_pair(const uint16_t* tile, int ld,
                                            int r, int c) {
  return *reinterpret_cast<const uint32_t*>(tile + r * ld + c);
}

// elements (r, c) and (r + 1, c): a B operand along the tile's rows
__device__ __forceinline__ uint32_t ld_col_pair(const uint16_t* tile, int ld,
                                                int r, int c) {
  return (uint32_t)tile[r * ld + c] | ((uint32_t)tile[(r + 1) * ld + c] << 16);
}

// A operand (16 rows from r0, k columns [c0, c0 + 16)) of a row-major tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const uint16_t* tile,
                                     int ld, int r0, int c0, int g, int t) {
  a[0] = ld_pair(tile, ld, r0 + g, c0 + 2 * t);
  a[1] = ld_pair(tile, ld, r0 + g + 8, c0 + 2 * t);
  a[2] = ld_pair(tile, ld, r0 + g, c0 + 8 + 2 * t);
  a[3] = ld_pair(tile, ld, r0 + g + 8, c0 + 8 + 2 * t);
}

// A operand from accumulators: k columns [16 kk, 16 kk + 16) of a 16-row
// tile held as n-tiles of 8 (the f32 values rounded to E here)
template <typename E, int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&acc)[NT][4], int kk) {
  a[0] = pack2<E>(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack2<E>(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack2<E>(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack2<E>(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// acc[j] (16 x 8 n-tiles) += A-tile rows [r0, r0 + 16) x B-tile rows^T, both
// row-major over D: the q k^T, do v^T, k q^T and v do^T products
template <typename E, int NT, int KT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const uint16_t* at, const uint16_t* bt,
                                        int ld, int r0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    ld_a(a, at, ld, r0, kk * 16, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma16816<E>(acc[j], a, ld_pair(bt, ld, j * 8 + g, kk * 16 + 2 * t),
               ld_pair(bt, ld, j * 8 + g, kk * 16 + 8 + 2 * t));
  }
}

// out[dt] (16 x 8 n-tiles over D) += P (16 x 8*NT, in accumulators) times
// the B tile's rows [0, 8*NT) x D: the p v, ds k, p^T do and ds^T q products
template <typename E, int NT, int DT>
__device__ __forceinline__ void mma_pb(float (&out)[DT][4],
                                       const float (&p)[NT][4],
                                       const uint16_t* bt, int ld, int g,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t a[4];
    acc_to_a<E, NT>(a, p, kk);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      mma16816<E>(out[dt], a,
                  ld_col_pair(bt, ld, kk * 16 + 2 * t, dt * 8 + g),
               ld_col_pair(bt, ld, kk * 16 + 8 + 2 * t, dt * 8 + g));
  }
}

// rows [row0, row0 + rows) of head (b, h) into a raw 16-bit tile, zero
// past T
template <int ROWS>
__device__ __forceinline__ void load_raw(uint16_t* dst, int ld,
                                         const uint16_t* __restrict__ src,
                                         int b, int h, int row0,
                                         const Shape& s) {
  const int vpr = s.d / 8;
  for (int idx = threadIdx.x; idx < ROWS * vpr; idx += kMmaThreads) {
    const int r = idx / vpr;
    const int c = (idx % vpr) * 8;
    const int t = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < s.t)
      v = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * s.t + t) * s.h + h) * s.d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// every (query, key) of the tile pair is live: no per-element mask needed
__device__ __forceinline__ bool tile_full(int q0, int bq, int k0, int bk,
                                          const Shape& s) {
  if (q0 + bq > s.t || k0 + bk > s.t) return false;
  if (!s.causal) return true;
  return k0 + bk - 1 <= q0 && (s.window == 0 || k0 > q0 + bq - 1 - s.window);
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// 2^x in one MUFU instruction; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One key tile of the forward's online softmax, for a thread's two rows:
// sc (raw scores q k^T of this tile) becomes p, m (the running max of the
// raw scores) and l advance, and alpha is the factor by which the output
// sums must shrink.  p = 2^((s - m) * scale * log2 e), one FMA and one
// MUFU an element; masking runs only on tiles that are not `full`.  A row
// that has seen no key keeps m = kNegInf, and its p are 0.
template <int NT>
__device__ __forceinline__ void softmax_step(float (&sc)[NT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const int (&rows)[2], int k0,
                                             bool full, const Shape& s) {
  const int t = threadIdx.x % 4;
  if (!full) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!live(rows[e >> 1], k0 + j * 8 + 2 * t + (e & 1), s))
          sc[j][e] = kNegInf;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
  const float sl2 = s.scale * kLog2e;
  float mu[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = ex2((m[r] - mx[r]) * sl2);
    m[r] = mx[r];
    // masked scores hold kNegInf; real ones are far above half of it
    mu[r] = mx[r] > 0.5f * kNegInf ? mx[r] * sl2 : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sc[j][e], sl2, -mu[e >> 1]));
      sc[j][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
}

template <int DT>
__device__ __forceinline__ void rescale(float (&acc)[DT][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];
}

// dK/dV's p for a thread's two key rows over a query step starting at q0:
// st (raw k q^T) becomes p = 2^(s * scale * log2 e - lse), 0 where masked.
// lses (log2 units) holds the step's queries by column.
template <int NQ>
__device__ __forceinline__ void probs(float (&st)[NQ][4], const float* lses,
                                      int q0, const int (&keys)[2], bool full,
                                      const Shape& s) {
  const int t = threadIdx.x % 4;
  const float sl2 = s.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const float2 lz = *reinterpret_cast<const float2*>(lses + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[j][e] = ex2(fmaf(st[j][e], sl2, -(e & 1 ? lz.y : lz.x)));
  }
  if (!full) {
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!live(q0 + j * 8 + 2 * t + (e & 1), keys[e >> 1], s))
          st[j][e] = 0.f;
  }
}

// ... and ds = p (dp - delta): dpt (v do^T) becomes ds, 0 where p is
template <int NQ>
__device__ __forceinline__ void dsoft(const float (&p)[NQ][4],
                                      float (&dpt)[NQ][4], const float* dels) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const float2 dz = *reinterpret_cast<const float2*>(dels + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[j][e] = p[j][e] * (dpt[j][e] - (e & 1 ? dz.y : dz.x));
  }
}

template <typename E, int DT>  // D = 8 * DT
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
              float* __restrict__ lse, Shape s) {
  constexpr int D = DT * 8, KT = D / 16, NT = kMmaRows / 8, LD = D + 8;
  extern __shared__ __align__(16) uint16_t tiles[];
  uint16_t* qs = tiles;
  uint16_t* ks = qs + kMmaRows * LD;
  uint16_t* vs = ks + kMmaRows * LD;

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  load_raw<kMmaRows>(qs, LD, q, b, h, q0, s);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int k_lo, k_hi;
  key_range(q0, kMmaRows, s, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += kMmaRows) {
    __syncthreads();
    load_raw<kMmaRows>(ks, LD, k, b, h, k0, s);
    load_raw<kMmaRows>(vs, LD, v, b, h, k0, s);
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    mma_abt<E, NT, KT>(sc, qs, ks, LD, r0, g, t);

    float alpha[2];
    softmax_step<NT>(sc, m, l, alpha, rows, k0,
                     tile_full(q0, kMmaRows, k0, kMmaRows, s), s);
    rescale<DT>(acc, alpha);
    mma_pb<E, NT, DT>(acc, sc, vs, LD, g, t);  // p rounded to E here
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= s.t) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    uint16_t* orow = o + (((size_t)b * s.t + rows[r]) * s.h + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack2<E>(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    if (t == 0)
      lse[(size_t)bh * s.t + rows[r]] =
          m[r] * s.scale + logf(l[r] > 0.f ? l[r] : 1.f);
  }
}

template <typename E, int DT>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             uint16_t* __restrict__ dq, Shape s) {
  constexpr int D = DT * 8, KT = D / 16, NT = kMmaRows / 8, LD = D + 8;
  extern __shared__ __align__(16) uint16_t tiles[];
  uint16_t* qs = tiles;
  uint16_t* dos = qs + kMmaRows * LD;
  uint16_t* ks = dos + kMmaRows * LD;
  uint16_t* vs = ks + kMmaRows * LD;

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  load_raw<kMmaRows>(qs, LD, q, b, h, q0, s);
  load_raw<kMmaRows>(dos, LD, dout, b, h, q0, s);
  const float sl2 = s.scale * kLog2e;
  float lse_r[2], del_r[2];  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = rows[r] < s.t ? lse[(size_t)bh * s.t + rows[r]] * kLog2e : 0.f;
    del_r[r] = rows[r] < s.t ? delta[(size_t)bh * s.t + rows[r]] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int k_lo, k_hi;
  key_range(q0, kMmaRows, s, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += kMmaRows) {
    __syncthreads();
    load_raw<kMmaRows>(ks, LD, k, b, h, k0, s);
    load_raw<kMmaRows>(vs, LD, v, b, h, k0, s);
    __syncthreads();

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_abt<E, NT, KT>(sc, qs, ks, LD, r0, g, t);
    mma_abt<E, NT, KT>(dp, dos, vs, LD, r0, g, t);
    const bool full = tile_full(q0, kMmaRows, k0, kMmaRows, s);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (full || live(rows[r], col, s)) {
          const float p = exp2f(sc[j][e] * sl2 - lse_r[r]);
          ds = p * (dp[j][e] - del_r[r]);
        }
        sc[j][e] = ds;
      }
    mma_pb<E, NT, DT>(acc, sc, ks, LD, g, t);  // ds rounded to E here
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= s.t) continue;
    uint16_t* row = dq + (((size_t)b * s.t + rows[r]) * s.h + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + 2 * t) =
          pack2<E>(acc[dt][2 * r] * s.scale, acc[dt][2 * r + 1] * s.scale);
  }
}

constexpr int kMmaQRows = 32;  // query rows per step of the k-major loop

template <typename E, int DT>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v,
              const uint16_t* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, Shape s) {
  constexpr int D = DT * 8, KT = D / 16, NQ = kMmaQRows / 8, LD = D + 8;
  extern __shared__ __align__(16) uint16_t tiles[];
  uint16_t* ks = tiles;
  uint16_t* vs = ks + kMmaRows * LD;
  uint16_t* qs = vs + kMmaRows * LD;
  uint16_t* dos = qs + kMmaQRows * LD;
  float* lses = reinterpret_cast<float*>(dos + kMmaQRows * LD);
  float* dels = lses + kMmaQRows;

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int k0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  load_raw<kMmaRows>(ks, LD, k, b, h, k0, s);
  load_raw<kMmaRows>(vs, LD, v, b, h, k0, s);
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  int q_lo, q_hi;
  query_range(k0, kMmaRows, s, &q_lo, &q_hi);
  q_lo = (q_lo / kMmaQRows) * kMmaQRows;
  for (int q0 = q_lo; q0 < q_hi; q0 += kMmaQRows) {
    __syncthreads();
    load_raw<kMmaQRows>(qs, LD, q, b, h, q0, s);
    load_raw<kMmaQRows>(dos, LD, dout, b, h, q0, s);
    if (threadIdx.x < kMmaQRows) {  // lse in log2 units
      const int qi = q0 + threadIdx.x;
      lses[threadIdx.x] =
          qi < s.t ? lse[(size_t)bh * s.t + qi] * kLog2e : 0.f;
      dels[threadIdx.x] = qi < s.t ? delta[(size_t)bh * s.t + qi] : 0.f;
    }
    __syncthreads();

    // rows: this warp's 16 keys; columns: the step's 32 queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    mma_abt<E, NQ, KT>(st, ks, qs, LD, r0, g, t);
    mma_abt<E, NQ, KT>(dpt, vs, dos, LD, r0, g, t);
    probs<NQ>(st, lses, q0, keys, tile_full(q0, kMmaQRows, k0, kMmaRows, s),
              s);
    dsoft<NQ>(st, dpt, dels);
    mma_pb<E, NQ, DT>(dv_acc, st, dos, LD, g, t);   // p rounded to E here
    mma_pb<E, NQ, DT>(dk_acc, dpt, qs, LD, g, t);   // ds rounded to E here
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= s.t) continue;
    const size_t off = (((size_t)b * s.t + keys[r]) * s.h + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + 2 * t) = pack2<E>(
          dk_acc[dt][2 * r] * s.scale, dk_acc[dt][2 * r + 1] * s.scale);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + 2 * t) =
          pack2<E>(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma path: bfloat16 and float16 with D in {64, 128}, forward, dQ and
// dK/dV.  A block is three warpgroups: warpgroup 0 is the
// producer, and one thread of it issues every TMA load into a ring of
// kStages shared-memory stages, each guarded by a `full` mbarrier (TMA
// bytes arrived) and an `empty` one (both consumers done with it);
// warpgroups 1 and 2 are consumers, 64 rows each, on wgmma.  setmaxnreg
// gives the producer 24 registers a thread and each consumer 240.  The
// tile walk is the mma.sync kernels' with 128-row tiles, and each
// consumer skips a tile or step in which its 64 rows see no key
// (`band_hit`), releasing the stage all the same.  dK/dV's lse and delta
// rows for a step are written into its stage by the producer warp's 32
// lanes (plain loads, zero past T), each lane arriving on `full` after its
// stores: a bulk copy needs 16-byte-aligned rows, and a row of [B, H, T]
// float32 starts aligned only when T is a multiple of 4.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // producer + two consumer warpgroups
constexpr int kTile = 128;       // rows of a query tile (fwd), key tile (both)
constexpr int kStep = 64;        // query rows a dK/dV step, keys a dQ step
constexpr int kStages = 2;
constexpr int kConsumerWarps = 8;
constexpr int kBoxRow = 128;     // bytes of a box row: 64 16-bit values

// any live (query, key) pair in [q0, q1) x [k0, k1)
__device__ __forceinline__ bool band_hit(int q0, int q1, int k0, int k1,
                                         const Shape& s) {
  q1 = min(q1, s.t);
  k1 = min(k1, s.t);
  if (q0 >= q1 || k0 >= k1) return false;
  if (!s.causal) return true;
  return q1 - 1 >= k0 && (s.window == 0 || q0 - (k1 - 1) < s.window);
}

// the 1024-byte-aligned start of dynamic shared memory
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
}

// K-major descriptor of a tile of `rows` x D (boxes of rows x 64) at
// `addr`, k step kk of 16 values along D
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int kk) {
  return hopper::desc128(addr + (kk / 4) * ROWS * kBoxRow + (kk % 4) * 32,
                         16, 1024);
}

// MN-major (transposed B) descriptor of the same tile, k step kk of 16 rows
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int kk) {
  return hopper::desc128(addr + kk * 16 * kBoxRow, ROWS * kBoxRow, 1024);
}

// all D / 64 boxes of rows [row0, row0 + rows) of head (b, h)
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, int box_bytes,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int b, int h,
                                         int row0) {
#pragma unroll
  for (int bx = 0; bx < D / 64; ++bx)
    hopper::tma_load_4d(dst + bx * box_bytes, map, bar, bx * 64, h, row0, b);
}

template <typename E, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(__grid_constant__ const CUtensorMap qmap,
                __grid_constant__ const CUtensorMap kmap,
                __grid_constant__ const CUtensorMap vmap,
                uint16_t* __restrict__ o, float* __restrict__ lse, Shape s) {
  constexpr int DT = D / 8, NT = kTile / 8;
  constexpr int BOX = kTile * kBoxRow, TILE = (D / 64) * BOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = aligned_smem(smem_raw);
  uint8_t* kv = qs + TILE;  // stage st: K at kv + 2 st TILE, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv + 2 * kStages * TILE);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  int k_lo, k_hi;
  key_range(q0, kTile, s, &k_lo, &k_hi);
  const int n_tiles = (k_hi - k_lo + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {  // producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, TILE);
      tma_tile<D>(qs, BOX, &qmap, q_full, b, h, q0);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) hopper::mbar_wait(&empty[st], (i / kStages - 1) & 1);
        uint8_t* kt = kv + 2 * st * TILE;
        const int k0 = k_lo + i * kTile;
        hopper::mbar_arrive_expect_tx(&full[st], 2 * TILE);
        tma_tile<D>(kt, BOX, &kmap, &full[st], b, h, k0);
        tma_tile<D>(kt + TILE, BOX, &vmap, &full[st], b, h, k0);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int wg = warp / 4 - 1;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * wg;  // this warpgroup's 64 rows
  const int rows[2] = {r0 + (warp % 4) * 16 + g, r0 + (warp % 4) * 16 + g + 8};
  const uint32_t q_addr = hopper::smem_addr(qs) + 64 * wg * kBoxRow;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int k0 = k_lo + i * kTile;
    hopper::mbar_wait(&full[st], (i / kStages) & 1);
    if (band_hit(r0, r0 + 64, k0, k0 + kTile, s)) {
      const uint32_t k_addr = hopper::smem_addr(kv + 2 * st * TILE);
      float sc[NT][4];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<E>(sc, kmajor<kTile>(q_addr, kk),
                            kmajor<kTile>(k_addr, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(sc);

      float alpha[2];
      softmax_step<NT>(sc, m, l, alpha, rows, k0,
                       tile_full(r0, 64, k0, kTile, s), s);
      rescale<DT>(acc, alpha);
      uint32_t pa[NT / 2][4];  // p rounded to E
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) acc_to_a<E, NT>(pa[kk], sc, kk);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        hopper::wgmma_rs<E>(acc, pa[kk], mnmajor<kTile>(k_addr + TILE, kk),
                            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= s.t) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    uint16_t* orow = o + (((size_t)b * s.t + rows[r]) * s.h + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack2<E>(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    if (t == 0)
      lse[(size_t)bh * s.t + rows[r]] =
          m[r] * s.scale + logf(l[r] > 0.f ? l[r] : 1.f);
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_wgmma(__grid_constant__ const CUtensorMap qmap,
                __grid_constant__ const CUtensorMap kmap,
                __grid_constant__ const CUtensorMap vmap,
                __grid_constant__ const CUtensorMap dmap,
                const float* __restrict__ lse,
                const float* __restrict__ delta, uint16_t* __restrict__ dk,
                uint16_t* __restrict__ dv, Shape s) {
  constexpr int DT = D / 8, NQ = kStep / 8;
  constexpr int KBOX = kTile * kBoxRow, KTILE = (D / 64) * KBOX;
  constexpr int QBOX = kStep * kBoxRow, QTILE = (D / 64) * QBOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = aligned_smem(smem_raw);
  uint8_t* vs = ks + KTILE;
  uint8_t* qd = vs + KTILE;  // stage st: q at qd + 2 st QTILE, dO after it
  float* stats = reinterpret_cast<float*>(qd + 2 * kStages * QTILE);
  // stage st: lse (log2 units) at stats + 2 st kStep, delta after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 2 * kStages * kStep);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int k0 = blockIdx.x * kTile;  // longest columns (small k0) first
  int q_lo, q_hi;
  query_range(k0, kTile, s, &q_lo, &q_hi);
  q_lo = (q_lo / kStep) * kStep;
  const int n_steps = (q_hi - q_lo + kStep - 1) / kStep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[st], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {  // producer: warp 0 loads, lane 0 issues the TMA
    hopper::setmaxnreg_dec<24>();
    if (warp != 0) return;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * KTILE);
      tma_tile<D>(ks, KBOX, &kmap, kv_full, b, h, k0);
      tma_tile<D>(vs, KBOX, &vmap, kv_full, b, h, k0);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % kStages;
      if (i >= kStages) hopper::mbar_wait(&empty[st], (i / kStages - 1) & 1);
      const int q0 = q_lo + i * kStep;
      // the step's lse and delta rows, zero past T; each lane's stores
      // precede its arrival, which releases them to the consumers
      float* ls = stats + 2 * st * kStep;
      for (int r = lane; r < kStep; r += 32) {
        const bool in = q0 + r < s.t;
        const size_t at = (size_t)bh * s.t + q0 + r;
        ls[r] = in ? lse[at] * kLog2e : 0.f;
        ls[kStep + r] = in ? delta[at] : 0.f;
      }
      if (lane == 0) {
        uint8_t* qt = qd + 2 * st * QTILE;
        hopper::mbar_arrive_expect_tx(&full[st], 2 * QTILE);
        tma_tile<D>(qt, QBOX, &qmap, &full[st], b, h, q0);
        tma_tile<D>(qt + QTILE, QBOX, &dmap, &full[st], b, h, q0);
      } else {
        hopper::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int wg = warp / 4 - 1;
  const int g = lane / 4, t = lane % 4;
  const int kb = k0 + 64 * wg;  // this warpgroup's 64 keys
  const int keys[2] = {kb + (warp % 4) * 16 + g, kb + (warp % 4) * 16 + g + 8};
  const uint32_t k_addr = hopper::smem_addr(ks) + 64 * wg * kBoxRow;
  const uint32_t v_addr = hopper::smem_addr(vs) + 64 * wg * kBoxRow;
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages;
    const int q0 = q_lo + i * kStep;
    hopper::mbar_wait(&full[st], (i / kStages) & 1);
    if (band_hit(q0, q0 + kStep, kb, kb + 64, s)) {
      const uint32_t q_addr = hopper::smem_addr(qd + 2 * st * QTILE);
      const uint32_t do_addr = q_addr + QTILE;
      // rows: this warpgroup's 64 keys; columns: the step's 64 queries.
      // p is taken while v do^T runs, and ds while p^T do runs.
      float sc[NQ][4], dp[NQ][4];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<E>(sc, kmajor<kTile>(k_addr, kk),
                            kmajor<kStep>(q_addr, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<E>(dp, kmajor<kTile>(v_addr, kk),
                            kmajor<kStep>(do_addr, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_acc(sc);

      const float* ls = stats + 2 * st * kStep;
      probs<NQ>(sc, ls, q0, keys, tile_full(q0, kStep, kb, 64, s), s);
      uint32_t pa[NQ / 2][4], da[NQ / 2][4];  // p, ds rounded to E
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) acc_to_a<E, NQ>(pa[kk], sc, kk);
      hopper::wgmma_wait<0>();
      hopper::fence_acc(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk)
        hopper::wgmma_rs<E>(dv_acc, pa[kk], mnmajor<kStep>(do_addr, kk), 1);
      hopper::wgmma_commit();

      dsoft<NQ>(sc, dp, ls + kStep);
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) acc_to_a<E, NQ>(da[kk], dp, kk);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk)
        hopper::wgmma_rs<E>(dk_acc, da[kk], mnmajor<kStep>(q_addr, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(dv_acc);
      hopper::fence_acc(dk_acc);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= s.t) continue;
    const size_t off = (((size_t)b * s.t + keys[r]) * s.h + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + 2 * t) = pack2<E>(
          dk_acc[dt][2 * r] * s.scale, dk_acc[dt][2 * r + 1] * s.scale);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + 2 * t) =
          pack2<E>(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// dQ, q-major: one block per (b, h, tile of 128 queries), heaviest first.
// The producer's one thread loads the query tile's Q, dO and O once, then
// streams 64-key K and V steps through the ring.  Each consumer first
// takes delta = rowsum(dO * O) for its 64 rows from the dO and O tiles:
// the four lanes that share a row (the accumulators' layout) each sum a
// quarter of it and combine by shuffles, reading the swizzled tiles at
// the same offset in both (a row's chunks are permuted alike in the two,
// so the products pair up), and lane t = 0 writes it for dK/dV.  A step is
// S = Q K^T and dP = dO V^T (SS, both K-major; p taken while dP runs),
// ds = p (dP - delta) rounded to E in registers, and dQ += ds K (RS, the
// K tile read MN-major).  At 64-key steps S and dP are 32 accumulators
// each beside dQ's 64 (D = 128).
template <typename E, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_wgmma(__grid_constant__ const CUtensorMap qmap,
               __grid_constant__ const CUtensorMap kmap,
               __grid_constant__ const CUtensorMap vmap,
               __grid_constant__ const CUtensorMap dmap,
               __grid_constant__ const CUtensorMap omap,
               const float* __restrict__ lse, float* __restrict__ delta,
               uint16_t* __restrict__ dq, Shape s) {
  constexpr int DT = D / 8, NK = kStep / 8;
  constexpr int QBOX = kTile * kBoxRow, QTILE = (D / 64) * QBOX;
  constexpr int KBOX = kStep * kBoxRow, KTILE = (D / 64) * KBOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = aligned_smem(smem_raw);
  uint8_t* dos = qs + QTILE;
  uint8_t* os = dos + QTILE;
  uint8_t* kv = os + QTILE;  // stage st: K at kv + 2 st KTILE, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv + 2 * kStages * KTILE);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  int k_lo, k_hi;
  key_range(q0, kTile, s, &k_lo, &k_hi, kStep);
  const int n_steps = (k_hi - k_lo + kStep - 1) / kStep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {  // producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, 3 * QTILE);
      tma_tile<D>(qs, QBOX, &qmap, q_full, b, h, q0);
      tma_tile<D>(dos, QBOX, &dmap, q_full, b, h, q0);
      tma_tile<D>(os, QBOX, &omap, q_full, b, h, q0);
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % kStages;
        if (i >= kStages) hopper::mbar_wait(&empty[st], (i / kStages - 1) & 1);
        uint8_t* kt = kv + 2 * st * KTILE;
        const int k0 = k_lo + i * kStep;
        hopper::mbar_arrive_expect_tx(&full[st], 2 * KTILE);
        tma_tile<D>(kt, KBOX, &kmap, &full[st], b, h, k0);
        tma_tile<D>(kt + KTILE, KBOX, &vmap, &full[st], b, h, k0);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int wg = warp / 4 - 1;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * wg;  // this warpgroup's 64 rows
  const int lr[2] = {64 * wg + (warp % 4) * 16 + g,
                     64 * wg + (warp % 4) * 16 + g + 8};  // rows in the tile
  const int rows[2] = {q0 + lr[0], q0 + lr[1]};
  const uint32_t q_addr = hopper::smem_addr(qs) + 64 * wg * kBoxRow;
  const uint32_t do_addr = hopper::smem_addr(dos) + 64 * wg * kBoxRow;
  const float sl2 = s.scale * kLog2e;
  float lse_r[2], del_r[2];  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse_r[r] = rows[r] < s.t ? lse[(size_t)bh * s.t + rows[r]] * kLog2e : 0.f;

  hopper::mbar_wait(q_full, 0);
  // delta: lane t takes 16-byte chunks t and t + 4 of each box row, the
  // order swapped for odd g so that a quarter warp's 8 loads hit 8
  // distinct chunks of the 128-byte rows (no bank conflict)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int bx = 0; bx < D / 64; ++bx)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int off = bx * QBOX + lr[r] * kBoxRow + (t + 4 * (u ^ (g & 1))) * 16;
        const uint4 ov = *reinterpret_cast<const uint4*>(os + off);
        const uint4 dv = *reinterpret_cast<const uint4*>(dos + off);
        const E* oe = reinterpret_cast<const E*>(&ov);
        const E* de = reinterpret_cast<const E*>(&dv);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum = fmaf(to_f32(oe[j]), to_f32(de[j]), sum);
      }
    del_r[r] = quad_sum(sum);
    if (t == 0 && rows[r] < s.t) delta[(size_t)bh * s.t + rows[r]] = del_r[r];
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages;
    const int k0 = k_lo + i * kStep;
    hopper::mbar_wait(&full[st], (i / kStages) & 1);
    if (band_hit(r0, r0 + 64, k0, k0 + kStep, s)) {
      const uint32_t k_addr = hopper::smem_addr(kv + 2 * st * KTILE);
      const uint32_t v_addr = k_addr + KTILE;
      float sc[NK][4], dp[NK][4];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<E>(sc, kmajor<kTile>(q_addr, kk),
                            kmajor<kStep>(k_addr, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<E>(dp, kmajor<kTile>(do_addr, kk),
                            kmajor<kStep>(v_addr, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_acc(sc);

      // p = 2^(s * scale * log2 e - lse), 0 where masked
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = ex2(fmaf(sc[j][e], sl2, -lse_r[e >> 1]));
      if (!tile_full(r0, 64, k0, kStep, s)) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!live(rows[e >> 1], k0 + j * 8 + 2 * t + (e & 1), s))
              sc[j][e] = 0.f;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_acc(dp);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = sc[j][e] * (dp[j][e] - del_r[e >> 1]);
      uint32_t da[NK / 2][4];  // ds rounded to E
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) acc_to_a<E, NK>(da[kk], dp, kk);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk)
        hopper::wgmma_rs<E>(acc, da[kk], mnmajor<kStep>(k_addr, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= s.t) continue;
    uint16_t* row = dq + (((size_t)b * s.t + rows[r]) * s.h + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + 2 * t) =
          pack2<E>(acc[dt][2 * r] * s.scale, acc[dt][2 * r + 1] * s.scale);
  }
}

// ---------------------------------------------------------------------------
// tf32x3 path: the float32 forward, dQ and dK/dV with D in {64, 128} on
// the tensor cores.  One TF32 product (10-bit mantissa) misses the float32 budget by
// an order of magnitude, so every product is three: each operand x is
// split as big = tf32(x), small = tf32(x - big) (round to nearest, ties
// away: cvt.rna's rounding), and c += small·big + big·small + big·big on
// mma.sync m16n8k8 with f32 accumulators (the small products first).  The
// bound is then the operations at a third of the TF32 rate.
//
// A block is 8 warps of 16 rows each.  Forward and dQ: one block per
// (b, h, tile of 128 queries), heaviest first; Q (and dO) are copied into
// shared memory once and K and V stream in 32-key steps.  dK/dV: one block per (b, h,
// tile of 128 keys), K and V once, Q, dO, lse and delta in 32-query steps;
// dK and dV are summed in registers (no atomics).
//
// What the design does about the cost of the split.  `cvt.rna.tf32.f32`
// runs on the conversion pipe, a fraction of the ALU rate, and with every
// warp splitting every operand it read, the conversions, not the tensor
// cores, set the time.  So the rounding is done with an integer add and a
// mask (the same result), the resident tile of a warp's own rows (Q, and
// dO in dQ; K and V in dK/dV) is split in registers as its fragments are
// read, and each streamed step is split once for all 8 warps: cp.async
// lands the raw step in a staging buffer while the previous step computes,
// then the block writes its big and small halves into shared tiles that
// the warps read as B fragments.  The resident tiles are stored unpadded
// with their 16-byte chunks XOR-swizzled by row (conflict-free ldmatrix);
// the split tiles' rows are padded to D + 4 floats, which makes both the
// ldmatrix rows and the relabelled scalar reads below conflict-free.  At
// D = 128 that is 231,936 bytes of the 232,448 a block may use in dQ and
// dK/dV, and 165,888 in the forward (one resident tile).  What
// holds the kernels now is shared-memory traffic rather than the tensor
// cores: each warp reads a step's big and small tiles for its own 16
// rows, about 190 bytes per mma.sync.
//
// Fragments, for lane = 4 g + t (PTX's tf32 layouts): A (16 x 8) holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, k x n) holds
// (t, g), (t + 4, g); an accumulator holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).  The products over D (S = Q K^T,
// dP = dO V^T, and their transposes in dK/dV) read both operands as
// stored rows with ldmatrix: an 8 x 8 matrix of 16-bit pairs is 8 rows of
// 4 floats, lane (g, t) receiving float (g, t), which is the tf32 A and B
// layout.  The products over tokens (O += P V, dQ += dS K, dV += P^T dO,
// dK += dS^T Q) take p or ds straight from the accumulators as A, whose
// lane holds columns 2t and 2t + 1 where A wants t and t + 4: the sum is
// order-free, so k is relabelled (k = t is token 2t, k = t + 4 is token
// 2t + 1) and the B fragment is read from token rows 2t and 2t + 1.
// ---------------------------------------------------------------------------

constexpr int kTfThreads = 256;  // 8 warps x 16 rows
constexpr int kTfRows = 128;     // queries of a dQ block, keys of a dK/dV block
constexpr int kTfStep = 32;      // keys a dQ step, queries a dK/dV step

// tf32(x) as cvt.rna.tf32.f32 gives it (finite x): the low 13 bits
// rounded off, ties away from zero, on the integer pipe
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about 2^-22 |x|, both tf32 values
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment split in two
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ void split_a(FragA& f, float a0, float a1,
                                        float a2, float a3) {
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
}

// c += a b in 3xTF32, b's fragment given as its big and small halves
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     uint32_t bb0, uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma1688(c, a.small, bb0, bb1);
  mma1688(c, a.big, bs0, bs1);
  mma1688(c, a.big, bb0, bb1);
}

// four 8 x 4-float matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(row))
      : "memory");
}

// float 4 ch + e of row r of an unpadded [rows][D] tile whose 16-byte
// chunks are XOR-swizzled by the row's low three bits
template <int D>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * D + ((ch ^ (r & 7)) << 2);
}

// the A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 8) of a
// swizzled resident tile, split
template <int D>
__device__ __forceinline__ void load_a(FragA& f, const float* tile, int r0,
                                       int c0, int lane) {
  const int m = lane / 8, row = r0 + lane % 8 + 8 * (m & 1);
  uint32_t r[4];
  ldsm4(r, tile + swz<D>(row, c0 / 4 + (m >> 1)));
  split_a(f, __uint_as_float(r[0]), __uint_as_float(r[1]),
          __uint_as_float(r[2]), __uint_as_float(r[3]));
}

// acc[j] (16 x 8 n-tiles) += A rows [r0, r0 + 16) of the resident tile
// `at` times rows [8j, 8j + 8) of the split step tile (big, small)
// transposed, over D
template <int NT, int D>
__device__ __forceinline__ void mma3_abt(float (&acc)[NT][4], const float* at,
                                         const float* bbig,
                                         const float* bsmall, int r0,
                                         int lane) {
  constexpr int LD = D + 4;
  const int m = lane / 8;
  // matrices: (n-tile j, k 0-3), (j, k 4-7), (j + 1, 0-3), (j + 1, 4-7)
  const int boff = (8 * (m >> 1) + lane % 8) * LD + 4 * (m & 1);
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 8) {
    FragA a;
    load_a<D>(a, at, r0, c0, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bb[4], bs[4];
      ldsm4(bb, bbig + boff + 8 * j * LD + c0);
      ldsm4(bs, bsmall + boff + 8 * j * LD + c0);
      mma3(acc[j], a, bb[0], bb[1], bs[0], bs[1]);
      mma3(acc[j + 1], a, bb[2], bb[3], bs[2], bs[3]);
    }
  }
}

// out[dt] (16 x 8 n-tiles over D) += P (16 x 8 NT, in accumulators) times
// rows [0, 8 NT) of the split step tile, k relabelled as above
template <int NT, int D>
__device__ __forceinline__ void mma3_pb(float (&out)[D / 8][4],
                                        const float (&p)[NT][4],
                                        const float* bbig,
                                        const float* bsmall, int g, int t) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    FragA a;
    split_a(a, p[j][0], p[j][2], p[j][1], p[j][3]);
    const int off = (8 * j + 2 * t) * LD + g;
    const uint32_t* hb = reinterpret_cast<const uint32_t*>(bbig) + off;
    const uint32_t* hs = reinterpret_cast<const uint32_t*>(bsmall) + off;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      mma3(out[dt], a, hb[8 * dt], hb[LD + 8 * dt], hs[8 * dt],
           hs[LD + 8 * dt]);
  }
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of head (b, h) of a [B, T, H, D] float tensor
// into an unpadded [ROWS][D] tile by 16-byte asynchronous copies, swizzled
// (SWZ) or as they are; rows at or past T are zero-filled
template <int ROWS, int D, bool SWZ>
__device__ __forceinline__ void cp_tile(float* dst, const float* src, int b,
                                        int h, int row0, const Shape& s) {
  constexpr int VPR = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += kTfThreads) {
    const int r = idx / VPR, ch = idx % VPR;
    const int t = row0 + r;
    const bool in = t < s.t;
    cp16(dst + (SWZ ? swz<D>(r, ch) : r * D + 4 * ch),
         in ? src + (((size_t)b * s.t + t) * s.h + h) * D + 4 * ch : src, in);
  }
}

// a staged [ROWS][D] step tile into its big and small halves, rows padded
// to D + 4
template <int ROWS, int D>
__device__ __forceinline__ void split_tile(float* big, float* small,
                                           const float* raw) {
  constexpr int VPR = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += kTfThreads) {
    const int r = idx / VPR, c = (idx % VPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * D + c);
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(big + r * (D + 4) + c) = hi;
    *reinterpret_cast<uint4*>(small + r * (D + 4) + c) = lo;
  }
}

// Shared memory of both kernels, in floats: the two resident tiles, the
// four split step tiles, the staged step, and (dK/dV) the step's lse and
// delta, staged and in use
template <int D>
struct TfSmem {
  static constexpr int kResident = kTfRows * D;
  static constexpr int kSplit = kTfStep * (D + 4);
  static constexpr int kStage = kTfStep * D;
  static constexpr int kFloats =
      2 * kResident + 4 * kSplit + 2 * kStage + 4 * kTfStep;
  // the forward: Q resident, the split K and V tiles, their staging
  static constexpr int kFwdFloats = kResident + 4 * kSplit + 2 * kStage;
};

// Forward, q-major: dQ's schedule without dP.  A step is S = Q K^T, the
// online softmax on the accumulators (`softmax_step`: one FMA and one
// ex2 per p, masks only on steps that are not full), the output sums
// rescaled by alpha, and O += P V with p split in registers (k relabelled
// as in dQ's dS K).  The rescale is skipped when no row of the warp moved
// its max: alpha is then exactly 1, so the sums are the same bits either
// way.  lse = m * scale + log(l), natural log, as the tf32x3 backward
// reads it.  Per thread at D = 128: O 64 accumulators, S 16.
template <int D>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, Shape s) {
  using M = TfSmem<D>;
  constexpr int DT = D / 8, NK = kTfStep / 8;
  extern __shared__ __align__(16) float tf_smem[];
  float* qs = tf_smem;              // [128][D], swizzled
  float* kb = qs + M::kResident;    // K big, K small, V big, V small:
  float* ksm = kb + M::kSplit;      // [32][D + 4] each
  float* vb = ksm + M::kSplit;
  float* vsm = vb + M::kSplit;
  float* stage = vsm + M::kSplit;   // the next step's K, V [32][D] each

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTfRows;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;  // the warp's rows in the tile
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  int k_lo, k_hi;
  key_range(q0, kTfRows, s, &k_lo, &k_hi, kTfStep);
  const int n_steps = (k_hi - k_lo + kTfStep - 1) / kTfStep;

  cp_tile<kTfRows, D, true>(qs, q, b, h, q0, s);
  cp_tile<kTfStep, D, false>(stage, k, b, h, k_lo, s);
  cp_tile<kTfStep, D, false>(stage + M::kStage, v, b, h, k_lo, s);
  cp_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int k0 = k_lo + i * kTfStep;
    cp_wait<0>();     // Q, and this step's K and V, are staged
    __syncthreads();  // ... for every thread, and the split tiles are free
    split_tile<kTfStep, D>(kb, ksm, stage);
    split_tile<kTfStep, D>(vb, vsm, stage + M::kStage);
    __syncthreads();  // the split tiles are written, the stage is free
    if (i + 1 < n_steps) {
      cp_tile<kTfStep, D, false>(stage, k, b, h, k0 + kTfStep, s);
      cp_tile<kTfStep, D, false>(stage + M::kStage, v, b, h, k0 + kTfStep, s);
    }
    cp_commit();
    if (band_hit(q0 + r0, q0 + r0 + 16, k0, k0 + kTfStep, s)) {
      float sc[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      mma3_abt<NK, D>(sc, qs, kb, ksm, r0, lane);
      float alpha[2];
      softmax_step<NK>(sc, m, l, alpha, rows, k0,
                       tile_full(q0 + r0, 16, k0, kTfStep, s), s);
      if (!__all_sync(kFull, alpha[0] == 1.f && alpha[1] == 1.f))
        rescale<DT>(acc, alpha);
      mma3_pb<NK, D>(acc, sc, vb, vsm, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= s.t) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* row = o + (((size_t)b * s.t + rows[r]) * s.h + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(row + 8 * dt + 2 * t) =
          make_float2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    if (t == 0)  // a row that saw no key: kNegInf, as the CUDA cores'
      lse[(size_t)bh * s.t + rows[r]] =
          l[r] > 0.f ? m[r] * s.scale + logf(l[r]) : kNegInf;
  }
}

// dQ, q-major.  Each warp first takes delta = rowsum(dO * O) for its 16
// rows, dO from the shared tile and O from device memory (read once), and
// writes it for dK/dV.  A step is S = Q K^T and dP = dO V^T, p =
// 2^(s * scale * log2 e - lse * log2 e) masked on steps that are not
// full, ds = p (dP - delta), dQ += ds K.  Per thread at D = 128: dQ 64
// accumulators, S and dP 16 each.
template <int D>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ o, const float* __restrict__ lse,
              float* __restrict__ delta, float* __restrict__ dq, Shape s) {
  using M = TfSmem<D>;
  constexpr int DT = D / 8, NK = kTfStep / 8;
  extern __shared__ __align__(16) float tf_smem[];
  float* qs = tf_smem;              // [128][D], swizzled
  float* dos = qs + M::kResident;   // [128][D], swizzled
  float* kb = dos + M::kResident;   // K big, K small, V big, V small:
  float* ksm = kb + M::kSplit;      // [32][D + 4] each
  float* vb = ksm + M::kSplit;
  float* vsm = vb + M::kSplit;
  float* stage = vsm + M::kSplit;   // the next step's K, V [32][D] each

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTfRows;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;  // the warp's rows in the tile
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  int k_lo, k_hi;
  key_range(q0, kTfRows, s, &k_lo, &k_hi, kTfStep);
  const int n_steps = (k_hi - k_lo + kTfStep - 1) / kTfStep;

  cp_tile<kTfRows, D, true>(qs, q, b, h, q0, s);
  cp_tile<kTfRows, D, true>(dos, dout, b, h, q0, s);
  cp_commit();
  cp_tile<kTfStep, D, false>(stage, k, b, h, k_lo, s);
  cp_tile<kTfStep, D, false>(stage + M::kStage, v, b, h, k_lo, s);
  cp_commit();

  const float sl2 = s.scale * kLog2e;
  float lse_r[2], del_r[2] = {0.f, 0.f};  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse_r[r] = rows[r] < s.t ? lse[(size_t)bh * s.t + rows[r]] * kLog2e : 0.f;

  cp_wait<1>();  // Q and dO
  __syncthreads();
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + r0 + r;
    if (row >= s.t) break;  // uniform across the warp
    const float* orow = o + (((size_t)b * s.t + row) * s.h + h) * D;
    float sum = 0.f;
    for (int ch = lane; ch < D / 4; ch += 32) {
      const float4 ov = *reinterpret_cast<const float4*>(orow + 4 * ch);
      const float4 dv =
          *reinterpret_cast<const float4*>(dos + swz<D>(r0 + r, ch));
      sum = fmaf(ov.x, dv.x, sum);
      sum = fmaf(ov.y, dv.y, sum);
      sum = fmaf(ov.z, dv.z, sum);
      sum = fmaf(ov.w, dv.w, sum);
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (r == g) del_r[0] = sum;
    if (r == g + 8) del_r[1] = sum;
    if (lane == 0) delta[(size_t)bh * s.t + row] = sum;
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int k0 = k_lo + i * kTfStep;
    cp_wait<0>();     // this step's K and V are staged
    __syncthreads();  // ... for every thread, and the split tiles are free
    split_tile<kTfStep, D>(kb, ksm, stage);
    split_tile<kTfStep, D>(vb, vsm, stage + M::kStage);
    __syncthreads();  // the split tiles are written, the stage is free
    if (i + 1 < n_steps) {
      cp_tile<kTfStep, D, false>(stage, k, b, h, k0 + kTfStep, s);
      cp_tile<kTfStep, D, false>(stage + M::kStage, v, b, h, k0 + kTfStep, s);
    }
    cp_commit();
    if (band_hit(q0 + r0, q0 + r0 + 16, k0, k0 + kTfStep, s)) {
      float sc[NK][4], dp[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      mma3_abt<NK, D>(sc, qs, kb, ksm, r0, lane);
      mma3_abt<NK, D>(dp, dos, vb, vsm, r0, lane);
      const bool full = tile_full(q0 + r0, 16, k0, kTfStep, s);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[j][e], sl2, -lse_r[e >> 1]));
          if (!full && !live(rows[e >> 1], k0 + 8 * j + 2 * t + (e & 1), s))
            p = 0.f;
          sc[j][e] = p * (dp[j][e] - del_r[e >> 1]);
        }
      mma3_pb<NK, D>(acc, sc, kb, ksm, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= s.t) continue;
    float* row = dq + (((size_t)b * s.t + rows[r]) * s.h + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(row + 8 * dt + 2 * t) = make_float2(
          acc[dt][2 * r] * s.scale, acc[dt][2 * r + 1] * s.scale);
  }
}

// dK/dV, k-major.  A step's lse and delta are staged by 4-byte copies
// beside its Q and dO, and moved (lse scaled to log2 units) beside the
// split tiles.  Per warp: S^T = K Q^T and dP^T = V dO^T (16 keys x 32
// queries), p and ds as in dQ, dV += P^T dO and dK += dS^T Q.  Per thread
// at D = 128: dK and dV 64 accumulators each, S^T and dP^T 16 each.
template <int D>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, Shape s) {
  using M = TfSmem<D>;
  constexpr int DT = D / 8, NQ = kTfStep / 8;
  extern __shared__ __align__(16) float tf_smem[];
  float* ks = tf_smem;              // [128][D], swizzled
  float* vs = ks + M::kResident;    // [128][D], swizzled
  float* qb = vs + M::kResident;    // Q big, Q small, dO big, dO small:
  float* qsm = qb + M::kSplit;      // [32][D + 4] each
  float* dob = qsm + M::kSplit;
  float* dosm = dob + M::kSplit;
  float* stage = dosm + M::kSplit;  // the next step's Q, dO [32][D] each
  float* stats = stage + 2 * M::kStage;  // staged lse, delta; in use

  const int bh = blockIdx.y;
  const int b = bh / s.h, h = bh % s.h;
  const int k0 = blockIdx.x * kTfRows;  // longest columns (small k0) first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;  // the warp's keys in the tile
  const int kb = k0 + r0;
  const int keys[2] = {kb + g, kb + g + 8};
  int q_lo, q_hi;
  query_range(k0, kTfRows, s, &q_lo, &q_hi);
  q_lo = (q_lo / kTfStep) * kTfStep;
  const int n_steps = (q_hi - q_lo + kTfStep - 1) / kTfStep;

  auto stage_step = [&](int qs0) {
    cp_tile<kTfStep, D, false>(stage, q, b, h, qs0, s);
    cp_tile<kTfStep, D, false>(stage + M::kStage, dout, b, h, qs0, s);
    if (threadIdx.x < 2 * kTfStep) {
      const int r = threadIdx.x % kTfStep;
      const bool in = qs0 + r < s.t;
      const float* src = threadIdx.x < kTfStep ? lse : delta;
      cp4(stats + threadIdx.x, in ? src + (size_t)bh * s.t + qs0 + r : src,
          in);
    }
  };

  cp_tile<kTfRows, D, true>(ks, k, b, h, k0, s);
  cp_tile<kTfRows, D, true>(vs, v, b, h, k0, s);
  if (n_steps > 0) stage_step(q_lo);
  cp_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  const float sl2 = s.scale * kLog2e;
  const float* ls = stats + 2 * kTfStep;  // the step's lse (log2), delta

  for (int i = 0; i < n_steps; ++i) {
    const int q0 = q_lo + i * kTfStep;
    cp_wait<0>();     // K and V, and this step's Q, dO, lse and delta
    __syncthreads();  // ... for every thread, and the split tiles are free
    split_tile<kTfStep, D>(qb, qsm, stage);
    split_tile<kTfStep, D>(dob, dosm, stage + M::kStage);
    if (threadIdx.x < 2 * kTfStep)
      stats[2 * kTfStep + threadIdx.x] =
          stats[threadIdx.x] * (threadIdx.x < kTfStep ? kLog2e : 1.f);
    __syncthreads();  // the split tiles are written, the stage is free
    if (i + 1 < n_steps) stage_step(q0 + kTfStep);
    cp_commit();
    if (band_hit(q0, q0 + kTfStep, kb, kb + 16, s)) {
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma3_abt<NQ, D>(st, ks, qb, qsm, r0, lane);
      mma3_abt<NQ, D>(dpt, vs, dob, dosm, r0, lane);
      const bool full = tile_full(q0, kTfStep, kb, 16, s);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 lz = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
        const float2 dz =
            *reinterpret_cast<const float2*>(ls + kTfStep + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(st[j][e], sl2, -(e & 1 ? lz.y : lz.x)));
          if (!full && !live(q0 + 8 * j + 2 * t + (e & 1), keys[e >> 1], s))
            p = 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - (e & 1 ? dz.y : dz.x));
        }
      }
      mma3_pb<NQ, D>(dv_acc, st, dob, dosm, g, t);
      mma3_pb<NQ, D>(dk_acc, dpt, qb, qsm, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= s.t) continue;
    const size_t off = (((size_t)b * s.t + keys[r]) * s.h + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<float2*>(dk + off + 8 * dt + 2 * t) = make_float2(
          dk_acc[dt][2 * r] * s.scale, dk_acc[dt][2 * r + 1] * s.scale);
      *reinterpret_cast<float2*>(dv + off + 8 * dt + 2 * t) =
          make_float2(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

// o is the forward's output and dQ's input; delta is dQ's output on the
// wgmma route and an input everywhere else
struct Args {
  const void *q, *k, *v, *dout, *lse;
  void *o, *out_lse, *delta, *dq, *dk, *dv;
  int b;
  Shape s;
  cudaStream_t stream;
};

template <typename T, int BM, int DC>
cudaError_t run_fwd(const Args& a) {
  const size_t ld = a.s.d + 1;
  const size_t smem =
      sizeof(float) * (2 * BM * ld + (size_t)BM * a.s.d + BM * (BM + 1));
  auto kernel = flash_fwd_kernel<T, BM, DC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s.t + BM - 1) / BM, a.b * a.s.h);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.out_lse), a.s);
  return cudaGetLastError();
}

template <typename T, int BM, int DC>
cudaError_t run_dq(const Args& a) {
  const size_t ld = a.s.d + 1;
  const size_t smem = sizeof(float) * (4 * BM * ld + BM * (BM + 1));
  auto kernel = flash_dq_kernel<T, BM, DC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s.t + BM - 1) / BM, a.b * a.s.h);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.s);
  return cudaGetLastError();
}

template <typename T, int BM, int DC>
cudaError_t run_dkv(const Args& a) {
  const size_t ld = a.s.d + 1;
  const size_t smem =
      sizeof(float) * (4 * BM * ld + 2 * BM * (BM + 1) + 2 * BM);
  auto kernel = flash_dkv_kernel<T, BM, DC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s.t + BM - 1) / BM, a.b * a.s.h);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s);
  return cudaGetLastError();
}

// which: 0 forward, 1 dQ, 2 dK/dV.  BM and DC (output columns per thread,
// ceil(D / 16) rounded up to a power of two) follow from D.
template <typename T, int BM, int DC>
cudaError_t run(int which, const Args& a) {
  if (which == 0) return run_fwd<T, BM, DC>(a);
  if (which == 1) return run_dq<T, BM, DC>(a);
  return run_dkv<T, BM, DC>(a);
}

template <typename T>
cudaError_t dispatch(int which, const Args& a) {
  const int d = a.s.d;
  if (d <= 32) return run<T, 64, 2>(which, a);
  if (d <= 64) return run<T, 64, 4>(which, a);
  if (d <= 128) return run<T, 64, 8>(which, a);
  return run<T, 32, 16>(which, a);
}

template <typename E, int DT>  // D = 8 * DT in {16, 32}
cudaError_t run_mma(int which, const Args& a) {
  constexpr int ld = DT * 8 + 8;
  const dim3 grid((a.s.t + kMmaRows - 1) / kMmaRows, a.b * a.s.h);
  const uint16_t* q = static_cast<const uint16_t*>(a.q);
  const uint16_t* k = static_cast<const uint16_t*>(a.k);
  const uint16_t* v = static_cast<const uint16_t*>(a.v);
  cudaError_t err;
  if (which == 0) {
    const size_t smem = sizeof(uint16_t) * 3 * kMmaRows * ld;
    auto kernel = flash_fwd_mma<E, DT>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, a.stream>>>(
        q, k, v, static_cast<uint16_t*>(a.o),
        static_cast<float*>(a.out_lse), a.s);
  } else if (which == 1) {
    const size_t smem = sizeof(uint16_t) * 4 * kMmaRows * ld;
    auto kernel = flash_dq_mma<E, DT>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, a.stream>>>(
        q, k, v, static_cast<const uint16_t*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<uint16_t*>(a.dq), a.s);
  } else {
    const size_t smem = sizeof(uint16_t) * 2 * (kMmaRows + kMmaQRows) * ld +
                        sizeof(float) * 2 * kMmaQRows;
    auto kernel = flash_dkv_mma<E, DT>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, a.stream>>>(
        q, k, v, static_cast<const uint16_t*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<uint16_t*>(a.dk), static_cast<uint16_t*>(a.dv), a.s);
  }
  return cudaGetLastError();
}

// Tensor-map encoding: cuTensorMapEncodeTiled is a driver call, fetched
// through the runtime so that the library needs no -lcuda.  A failed
// encode returns kMapError + its CUresult, so the wrapper can tell it from
// a CUDA launch error.
constexpr int kMapError = 10000;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, T, H, D] as dims {D, H, T, B}; boxes of {64, 1, rows, 1}, 128-byte
// swizzle; rows at or past T load as zeros
template <typename E>
int encode(CUtensorMap* map, const void* ptr, int b, const Shape& s,
           int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)s.d, (cuuint64_t)s.h,
                              (cuuint64_t)s.t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {2ull * s.d, 2ull * s.h * s.d,
                                 2ull * s.t * s.h * s.d};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      std::is_same<E, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

template <typename E, int D>
int run_wgmma(int which, const Args& a) {
  const dim3 grid((a.s.t + kTile - 1) / kTile, a.b * a.s.h);
  const size_t tile = (size_t)kTile * D * 2, step = (size_t)kStep * D * 2;
  CUtensorMap qm, km, vm, dm;
  int rc;
  cudaError_t err;
  if (which == 0) {
    if ((rc = encode<E>(&qm, a.q, a.b, a.s, kTile)) ||
        (rc = encode<E>(&km, a.k, a.b, a.s, kTile)) ||
        (rc = encode<E>(&vm, a.v, a.b, a.s, kTile)))
      return rc;
    const size_t smem = 1024 + (1 + 2 * kStages) * tile +
                        sizeof(uint64_t) * (1 + 2 * kStages);
    auto kernel = flash_fwd_wgmma<E, D>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, kWgThreads, smem, a.stream>>>(
        qm, km, vm, static_cast<uint16_t*>(a.o),
        static_cast<float*>(a.out_lse), a.s);
  } else if (which == 1) {
    CUtensorMap om;
    if ((rc = encode<E>(&qm, a.q, a.b, a.s, kTile)) ||
        (rc = encode<E>(&km, a.k, a.b, a.s, kStep)) ||
        (rc = encode<E>(&vm, a.v, a.b, a.s, kStep)) ||
        (rc = encode<E>(&dm, a.dout, a.b, a.s, kTile)) ||
        (rc = encode<E>(&om, a.o, a.b, a.s, kTile)))
      return rc;
    const size_t smem = 1024 + 3 * tile + 2 * kStages * step +
                        sizeof(uint64_t) * (1 + 2 * kStages);
    auto kernel = flash_dq_wgmma<E, D>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, kWgThreads, smem, a.stream>>>(
        qm, km, vm, dm, om, static_cast<const float*>(a.lse),
        static_cast<float*>(a.delta), static_cast<uint16_t*>(a.dq), a.s);
  } else {
    if ((rc = encode<E>(&qm, a.q, a.b, a.s, kStep)) ||
        (rc = encode<E>(&km, a.k, a.b, a.s, kTile)) ||
        (rc = encode<E>(&vm, a.v, a.b, a.s, kTile)) ||
        (rc = encode<E>(&dm, a.dout, a.b, a.s, kStep)))
      return rc;
    const size_t smem = 1024 + 2 * tile + 2 * kStages * step +
                        sizeof(float) * 2 * kStages * kStep +
                        sizeof(uint64_t) * (1 + 2 * kStages);
    auto kernel = flash_dkv_wgmma<E, D>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, kWgThreads, smem, a.stream>>>(
        qm, km, vm, dm, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<uint16_t*>(a.dk),
        static_cast<uint16_t*>(a.dv), a.s);
  }
  return (int)cudaGetLastError();
}

// the float32 forward (which 0), dQ (1) or dK/dV (2) on the tf32x3 path
template <int D>
cudaError_t run_tf32(int which, const Args& a) {
  const dim3 grid((a.s.t + kTfRows - 1) / kTfRows, a.b * a.s.h);
  const size_t smem = sizeof(float) * TfSmem<D>::kFloats;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  cudaError_t err;
  if (which == 0) {
    const size_t fwd_smem = sizeof(float) * TfSmem<D>::kFwdFloats;
    auto kernel = flash_fwd_tf32<D>;
    if ((err = prepare(kernel, fwd_smem)) != cudaSuccess) return err;
    kernel<<<grid, kTfThreads, fwd_smem, a.stream>>>(
        q, k, v, static_cast<float*>(a.o), static_cast<float*>(a.out_lse),
        a.s);
  } else if (which == 1) {
    auto kernel = flash_dq_tf32<D>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kTfThreads, smem, a.stream>>>(
        q, k, v, dout, static_cast<const float*>(a.o), lse,
        static_cast<float*>(a.delta), static_cast<float*>(a.dq), a.s);
  } else {
    auto kernel = flash_dkv_tf32<D>;
    if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kTfThreads, smem, a.stream>>>(
        q, k, v, dout, lse, static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.s);
  }
  return cudaGetLastError();
}

// Which kernel a call takes (which: 0 forward, 1 dQ, 2 dK/dV; dtype as
// the launchers'): 3 tf32x3 (float32 with D in {64, 128}), 2 the wgmma
// path (bfloat16 and float16, D in {64, 128}), 1 mma.sync (the same types
// with D in {16, 32}), 0 the f32 CUDA-core kernels (float32 or 16-bit
// types at any other D).  The three kernels of a call take one route.
int path(int which, int dtype, int d) {
  if (dtype == 0) return d == 64 || d == 128 ? 3 : 0;
  if (dtype != 1 && dtype != 2) return 0;
  if (d == 64 || d == 128) return 2;
  return d == 16 || d == 32 ? 1 : 0;
}

template <typename E>
int dispatch_16bit(int which, const Args& a) {
  switch (path(which, std::is_same<E, __half>::value ? 2 : 1, a.s.d)) {
    case 2:
      return a.s.d == 64 ? run_wgmma<E, 64>(which, a)
                         : run_wgmma<E, 128>(which, a);
    case 1:
      return a.s.d == 16 ? (int)run_mma<E, 2>(which, a)
                         : (int)run_mma<E, 4>(which, a);
    default:
      return (int)dispatch<E>(which, a);
  }
}

int launch(int which, int dtype, Args& a, int t, int h, int d, int causal,
           int window, float scale, void* stream) {
  if (d < 8 || d > 256 || d % 8 || t < 1 || h < 1 || a.b < 1 ||
      a.b * h > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  a.s = Shape{t, h, d, causal ? 1 : 0, causal ? window : 0, scale};
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (path(which, 0, d) == 3)
      return (int)(d == 64 ? run_tf32<64>(which, a) : run_tf32<128>(which, a));
    return (int)dispatch<float>(which, a);
  }
  if (dtype == 1) return dispatch_16bit<__nv_bfloat16>(which, a);
  if (dtype == 2) return dispatch_16bit<__half>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (every [B, T, H, D] tensor
// shares it).
// window: 0 for none.  Each launcher returns the cudaError_t of its launch
// (0 on success), or kMapError + the CUresult of a failed tensor-map
// encode; the caller validates shapes, contiguity and alignment.
// dl4j_flash_path says which kernels a call takes (see `path`).  dQ
// writes delta [B, H, T] float32 on the wgmma and tf32x3 routes (paths 2
// and 3) and reads it on the others.
extern "C" int dl4j_flash_path(int which, int dtype, int d) {
  return path(which, dtype, d);
}

extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int dtype, int b, int t,
                              int h, int d, int causal, int window,
                              float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.out_lse = lse;
  a.b = b;
  return launch(0, dtype, a, t, h, d, causal, window, scale, stream);
}

extern "C" int dl4j_flash_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* o,
                             const void* lse, void* delta, void* dq,
                             int dtype, int b, int t, int h, int d,
                             int causal, int window, float scale,
                             void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.o = const_cast<void*>(o);
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.b = b;
  return launch(1, dtype, a, t, h, d, causal, window, scale, stream);
}

extern "C" int dl4j_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              int dtype, int b, int t, int h, int d,
                              int causal, int window, float scale,
                              void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = const_cast<void*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.b = b;
  return launch(2, dtype, a, t, h, d, causal, window, scale, stream);
}
