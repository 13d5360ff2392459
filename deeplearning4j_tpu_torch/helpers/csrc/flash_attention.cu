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
// delta = rowsum(dout * o) is computed by the caller (a torch reduction, as
// the reference leaves it to XLA).  Neither backward kernel uses atomics:
// each block owns its output rows, so gradients are the same run to run.
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
// tensor cores: for bfloat16 (the main path) and float16 with D in
// {16, 32, 64, 128} every product is an mma.sync m16n8k16 (bf16 or f16 in,
// f32 accumulate), one block of 4 warps per (b, h, tile of 64 rows), each
// warp 16 rows; the score tile, p and ds stay in the accumulator registers,
// whose layout is also the A operand of the next product, and m, l and the
// output sums are f32 registers.  Tiles are staged in shared memory with synchronous loads
// (no TMA, no cp.async double buffering, no wgmma: later work).  float32
// and other head dims run f32 kernels on the CUDA cores (the reference
// multiplies float32 in f32, which the tensor cores do not): one block of
// 256 threads (16 x 16) per (b, h, tile of BM rows), a BM x BM score tile
// held as R x R (R = BM / 16) per thread, row statistics reduced across the
// 16 threads of a row with warp shuffles, tiles staged in shared memory as
// f32 with rows padded to an odd stride.  BM is 64 for D <= 128 and 32
// above, to keep a block's shared memory under the 227 KB a block may use.
// In both, the TPU's sequential key grid axis with its VMEM scratch becomes
// a loop inside the block.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Key tiles [k_lo, k_hi) that a query tile [q0, q0 + bm) sees.
__device__ __forceinline__ void key_range(int q0, int bm, const Shape& s,
                                          int* k_lo, int* k_hi) {
  int lo = 0, hi = s.t;
  if (s.causal) {
    hi = min(s.t, q0 + bm);
    if (s.window) lo = max(0, q0 - s.window + 1);
  }
  *k_lo = (lo / bm) * bm;
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
// Tensor-core path: bfloat16 or float16 (the element type E) with D in
// {16, 32, 64, 128}.  The same tiles, masks, casts and loops as above, with
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
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
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

  // scores in log2 units: p = 2^(s * scale * log2 e - m)
  const float sl2 = s.scale * kLog2e;
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

    const bool full = tile_full(q0, kMmaRows, k0, kMmaRows, s);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        sc[j][e] = full || live(rows[e >> 1], col, s) ? sc[j][e] * sl2
                                                      : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new[r]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked scores hold kNegInf; real ones are far above half of it
        const float p = sc[j][e] > 0.5f * kNegInf
                            ? exp2f(sc[j][e] - m_new[e >> 1]) : 0.f;
        sc[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];
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
          m[r] * kLn2 + logf(l[r] > 0.f ? l[r] : 1.f);
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
  const float sl2 = s.scale * kLog2e;

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
    const bool full = tile_full(q0, kMmaQRows, k0, kMmaRows, s);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        float p = 0.f, ds = 0.f;
        if (full || live(q0 + qc, keys[e >> 1], s)) {
          p = exp2f(st[j][e] * sl2 - lses[qc]);
          ds = p * (dpt[j][e] - dels[qc]);
        }
        st[j][e] = p;
        dpt[j][e] = ds;
      }
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

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *out_lse, *dq, *dk, *dv;
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

template <typename E, int DT>
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
        q, k, v, static_cast<uint16_t*>(a.o), static_cast<float*>(a.out_lse),
        a.s);
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

// bfloat16 and float16 with D a power of two in [16, 128] take the tensor
// cores; any other D (and float32, whose products the reference keeps in
// f32) runs the f32 CUDA-core kernels
template <typename E>
cudaError_t dispatch_16bit(int which, const Args& a) {
  switch (a.s.d) {
    case 16: return run_mma<E, 2>(which, a);
    case 32: return run_mma<E, 4>(which, a);
    case 64: return run_mma<E, 8>(which, a);
    case 128: return run_mma<E, 16>(which, a);
    default: return dispatch<E>(which, a);
  }
}

int launch(int which, int dtype, Args& a, int t, int h, int d, int causal,
           int window, float scale, void* stream) {
  if (d < 8 || d > 256 || d % 8 || t < 1 || h < 1 || a.b < 1 ||
      a.b * h > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  a.s = Shape{t, h, d, causal ? 1 : 0, causal ? window : 0, scale};
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(which, a);
  if (dtype == 1) return (int)dispatch_16bit<__nv_bfloat16>(which, a);
  if (dtype == 2) return (int)dispatch_16bit<__half>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (every [B, T, H, D] tensor
// shares it).
// window: 0 for none.  Each returns the cudaError_t of its launch (0 on
// success); the caller validates shapes, contiguity and alignment.
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
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int dtype, int b,
                             int t, int h, int d, int causal, int window,
                             float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
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
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.b = b;
  return launch(2, dtype, a, t, h, d, causal, window, scale, stream);
}
