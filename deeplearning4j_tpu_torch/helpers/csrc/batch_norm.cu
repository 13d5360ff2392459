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
// any M >= 1 and any C.  A training forward or backward is two launches:
//   - a reduction over a 2-D grid of channel slices x row chunks (sized
//     by the caller to one wave of the card, ``chunking`` in
//     batch_norm.py).  A thread owns V adjacent channels (V = 16 /
//     sizeof(T), or 1 for a C that is not whole vectors or an unaligned
//     pointer) and reads them as one 16-byte load a row, eight rows of x
//     (four of x and g) in flight at once; a warp reads four 128-byte row
//     segments.  The block merges its threads in a fixed order (warp
//     shuffles, then one exchange through shared memory) and writes one
//     float32 partial per channel and chunk (the chunk's mean and M2, or
//     its sums of g and g*xhat).  The last block of a channel slice to
//     arrive (an integer counter per slice, after __threadfence) merges
//     every chunk's partial in a fixed order and writes the per-channel
//     coefficients of the elementwise pass; it resets its counter, so the
//     counters are zero between calls;
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

constexpr int kRedThreads = 512;  // threads of a reduction block
constexpr int kThreads = 256;     // threads of an elementwise block, at most

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

// ------------------------------------------------------------- reductions
// Both reductions run on the grid the caller sized (``chunking``): block
// (bx, kRedThreads / bx) with bx a power of two, at most 8 vectors (32
// scalar channels), so a warp holds whole rows; grid (channel slices of
// bx vectors, row chunks of rpc rows), about one block an SM.  Thread
// (tx, ty) of slice sx owns the V channels of vector column sx * bx + tx
// and walks rows ty, ty + by, ... of its chunk.  A thread's partial is an
// accumulator: the moments (n, mean, M2) of its V channels, or the sums
// (g, g * xhat).  The block merges its threads' partials in a fixed order:
// a butterfly over the rows of each warp (shuffles), the 16 warps through
// shared memory, taken by warp 0's lanes in order and merged in a
// butterfly.  The last block of a slice to arrive merges the chunks'
// partials (lanes of one channel in one warp, each taking chunks lane,
// lane + L, ... in order, then a butterfly) and writes the coefficients.
constexpr int kWarps = kRedThreads / 32;

template <int V>
struct Moments {
  static constexpr int kFloats = 1 + 2 * V;
  float n, mean[V], m2[V];
  __device__ __forceinline__ void zero() {
    n = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
  }
  // Chan et al.: merge b in (its V channels share one row count)
  __device__ __forceinline__ void merge(const Moments& b) {
    if (b.n == 0.f) return;
    const float nn = n + b.n;
    const float f = b.n / nn;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = b.mean[j] - mean[j];
      mean[j] += d * f;
      m2[j] += b.m2[j] + d * d * n * f;
    }
    n = nn;
  }
  __device__ __forceinline__ Moments shfl_xor(int o) const {
    Moments r;
    r.n = __shfl_xor_sync(0xffffffffu, n, o);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      r.mean[j] = __shfl_xor_sync(0xffffffffu, mean[j], o);
      r.m2[j] = __shfl_xor_sync(0xffffffffu, m2[j], o);
    }
    return r;
  }
  // shared memory as kFloats rows of `slots` (no bank conflicts)
  __device__ __forceinline__ void put(float* sm, int slot, int slots) const {
    sm[slot] = n;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sm[(1 + j) * slots + slot] = mean[j];
      sm[(1 + V + j) * slots + slot] = m2[j];
    }
  }
  __device__ __forceinline__ void get(const float* sm, int slot, int slots) {
    n = sm[slot];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mean[j] = sm[(1 + j) * slots + slot];
      m2[j] = sm[(1 + V + j) * slots + slot];
    }
  }
};

template <int V>
struct Sums {
  static constexpr int kFloats = 2 * V;
  float g[V], gx[V];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] = gx[j] = 0.f;
  }
  __device__ __forceinline__ void merge(const Sums& b) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      g[j] += b.g[j];
      gx[j] += b.gx[j];
    }
  }
  __device__ __forceinline__ Sums shfl_xor(int o) const {
    Sums r;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      r.g[j] = __shfl_xor_sync(0xffffffffu, g[j], o);
      r.gx[j] = __shfl_xor_sync(0xffffffffu, gx[j], o);
    }
    return r;
  }
  __device__ __forceinline__ void put(float* sm, int slot, int slots) const {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sm[j * slots + slot] = g[j];
      sm[(V + j) * slots + slot] = gx[j];
    }
  }
  __device__ __forceinline__ void get(const float* sm, int slot, int slots) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      g[j] = sm[j * slots + slot];
      gx[j] = sm[(V + j) * slots + slot];
    }
  }
};

// Butterfly over the lanes i ^ o for o = from, 2 from, ... below `to`
// (powers of two): every lane of the warp takes part; lane i ends with
// its group merged in a fixed order.
template <class Acc>
__device__ __forceinline__ void butterfly(Acc& a, int from, int to) {
  for (int o = from; o < to; o <<= 1) a.merge(a.shfl_xor(o));
}

// The block's partial, in warp 0's lanes 0 .. bx - 1 (lane tx holding
// vector column tx).  `sm` holds Acc::kFloats * kWarps * bx floats.
template <class Acc>
__device__ __forceinline__ void block_merge(Acc& a, float* sm, int bx) {
  const int tid = threadIdx.y * bx + threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int slots = kWarps * bx;
  butterfly(a, bx, 32);                   // the warp's rows
  if (lane < bx) a.put(sm, warp * bx + lane, slots);
  __syncthreads();
  if (warp == 0) {                        // the warps, parts p of 32 / bx
    const int parts = 32 / bx, p = lane / bx, tx = lane % bx;
    Acc r;
    r.zero();
    for (int w = p; w < kWarps; w += parts) {
      Acc b;
      b.get(sm, w * bx + tx, slots);
      r.merge(b);
    }
    butterfly(r, bx, 32);
    a = r;
  }
}

// After warp 0's lanes wrote the block's partials: true in the last block
// of its channel slice to arrive.  That block finds every other block's
// partials in memory (each fenced them before its arrival) and resets the
// slice's counter, so the counters are zero again when the kernel ends.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n_chunks) {
  __shared__ int last;
  if (threadIdx.y * blockDim.x + threadIdx.x < 32) {
    __threadfence();
    __syncwarp();
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      const bool is_last = atomicAdd(counter, 1) == n_chunks - 1;
      if (is_last) {
        *counter = 0;
        __threadfence();
      }
      last = is_last;
    }
  }
  __syncthreads();
  return last;
}

// rows of chunk k
__device__ __forceinline__ float chunk_rows(int k, long long m, int rpc) {
  return (float)min((long long)rpc, m - (long long)k * rpc);
}

// The slice's last block: channel `ch` of the slice's W = bx * V in lanes
// tid % L of L = min(32, kRedThreads / W) consecutive threads; lane l
// takes chunks l, l + L, ... in order (8 loads in flight), then the L
// lanes merge in a butterfly.  Every thread calls it; the result is in
// lane 0 of an active channel.  `part` gives chunk k's two partials.
template <class Acc1, class Part>
__device__ __forceinline__ Acc1 merge_chunks(int lanes, int fl, bool active,
                                             int n_chunks, Part part) {
  Acc1 r;
  r.zero();
  if (active) {
    int k = fl;
    for (; k + 7 * lanes < n_chunks; k += 8 * lanes) {
      Acc1 b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) b[u] = part(k + u * lanes);
#pragma unroll
      for (int u = 0; u < 8; ++u) r.merge(b[u]);
    }
    for (; k < n_chunks; k += lanes) r.merge(part(k));
  }
  butterfly(r, 1, lanes);
  return r;
}

// What the moments' last block writes: stats rows 0..4 = mean, var, inv,
// gamma*inv, beta.
struct MomentsOut {
  const void* gamma;  // in type `adt`
  const void* beta;
  int adt;
  float eps;
  float* stats;       // [5, c]
};

// ---------------------------------------------------------------- moments
// Each thread sums its rows shifted by its first value (so the sum of
// squares does not cancel), eight 16-byte rows in flight (sixteen rows on
// the scalar path); the block merges its threads (Chan) and writes the
// chunk's mean and M2 per channel; the slice's last block merges the
// chunks, with gamma and beta read at the start.
template <typename T, int V>
__global__ void __launch_bounds__(kRedThreads, 1)
bn_moments_kernel(const T* __restrict__ x, float* __restrict__ part_mean,
                  float* __restrict__ part_m2, int* __restrict__ arrivals,
                  MomentsOut o, long long m, int c, int rpc) {
  constexpr int U = V * sizeof(T) == 16 ? 8 : 16;
  __shared__ float sm[Moments<V>::kFloats * kWarps * (V > 1 ? 8 : 32)];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int tid = ty * bx + tx;
  // the channel this thread would write if its block merges the chunks
  const int w = bx * V, lanes = min(32, kRedThreads / w);
  const int cl = tid / lanes, fl = tid % lanes;
  const int ch = blockIdx.x * w + cl;
  const bool active = cl < w && ch < c;
  float gam = 0.f, bet = 0.f;
  if (active && fl == 0) {
    gam = chan(o.gamma, o.adt, ch);
    bet = chan(o.beta, o.adt, ch);
  }
  const int c0 = (blockIdx.x * bx + tx) * V;
  const bool live = c0 < c;       // V > 1 only when c is whole vectors
  const long long r0 = (long long)blockIdx.y * rpc;
  const long long r1 = min(r0 + rpc, m);
  Moments<V> a;
  a.zero();
  if (live && r0 + ty < r1) {
    const T* col = x + c0;
    float shift[V], s[V], q[V];
    load_vec<T, V>(col + (size_t)(r0 + ty) * c, shift);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
    long long r = r0 + ty;
    for (; r + (U - 1) * by < r1; r += U * by) {
      float v[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_vec<T, V>(col + (size_t)(r + u * by) * c, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[u][j] - shift[j];
          s[j] += d;
          q[j] += d * d;
        }
      a.n += (float)U;
    }
    for (; r < r1; r += by) {
      float v[V];
      load_vec<T, V>(col + (size_t)r * c, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - shift[j];
        s[j] += d;
        q[j] += d * d;
      }
      a.n += 1.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a.mean[j] = shift[j] + s[j] / a.n;
      a.m2[j] = fmaxf(q[j] - s[j] * s[j] / a.n, 0.f);
    }
  }
  block_merge(a, sm, bx);
  if (tid < bx) {
    const int cw = (blockIdx.x * bx + tid) * V;
    if (cw < c) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        part_mean[(size_t)blockIdx.y * c + cw + j] = a.mean[j];
        part_m2[(size_t)blockIdx.y * c + cw + j] = a.m2[j];
      }
    }
  }
  const int n_chunks = gridDim.y;
  if (!last_to_arrive(arrivals + blockIdx.x, n_chunks)) return;

  const Moments<1> r = merge_chunks<Moments<1>>(
      lanes, fl, active, n_chunks, [&](int k) {
        Moments<1> b;
        b.n = chunk_rows(k, m, rpc);
        b.mean[0] = __ldcg(part_mean + (size_t)k * c + ch);
        b.m2[0] = __ldcg(part_m2 + (size_t)k * c + ch);
        return b;
      });
  if (active && fl == 0) {
    const float var = r.m2[0] / (float)m;
    const float inv = rsqrtf(var + o.eps);
    o.stats[ch] = r.mean[0];
    o.stats[c + ch] = var;
    o.stats[2 * c + ch] = inv;
    o.stats[3 * c + ch] = gam * inv;
    o.stats[4 * c + ch] = bet;
  }
}

// What the grad sums' last block writes: dgb rows 0, 1 = dgamma, dbeta;
// coef rows 0..3 = mean, -a*inv*sum_gx/M, -a*sum_g/M, a with a =
// gamma*inv, so that dx = a*g + coef1*(x - mean) + coef2.
struct GradOut {
  const void* gamma;  // in type `adt`
  int adt;
  float* dgb;         // [2, c]
  float* coef;        // [4, c]
};

// ------------------------------------------------------------- grad sums
// Per chunk and channel the sums of g and g * xhat, xhat = (x - mean) *
// inv, each thread's rows in order with four 16-byte rows of x and of g
// in flight (eight on the scalar path); the block merges its threads and
// the slice's last block sums the chunks, with its channels' gamma, mean
// and inv read at the start.
template <typename T, int V>
__global__ void __launch_bounds__(kRedThreads, 1)
bn_grad_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv, float* __restrict__ part_g,
                    float* __restrict__ part_gx, int* __restrict__ arrivals,
                    GradOut o, long long m, int c, int rpc) {
  constexpr int U = V * sizeof(T) == 16 ? 4 : 8;
  __shared__ float sm[Sums<V>::kFloats * kWarps * (V > 1 ? 8 : 32)];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int tid = ty * bx + tx;
  const int w = bx * V, lanes = min(32, kRedThreads / w);
  const int cl = tid / lanes, fl = tid % lanes;
  const int ch = blockIdx.x * w + cl;
  const bool active = cl < w && ch < c;
  float gam = 0.f, mu_ch = 0.f, iv_ch = 0.f;
  if (active && fl == 0) {
    gam = chan(o.gamma, o.adt, ch);
    mu_ch = mean[ch];
    iv_ch = inv[ch];
  }
  const int c0 = (blockIdx.x * bx + tx) * V;
  const bool live = c0 < c;
  const long long r0 = (long long)blockIdx.y * rpc;
  const long long r1 = min(r0 + rpc, m);
  Sums<V> a;
  a.zero();
  if (live) {
    float mu[V], iv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mu[j] = mean[c0 + j];
      iv[j] = inv[c0 + j];
    }
    long long r = r0 + ty;
    for (; r + (U - 1) * by < r1; r += U * by) {
      float xv[U][V], gv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t off = (size_t)(r + u * by) * c + c0;
        load_vec<T, V>(x + off, xv[u]);
        load_vec<T, V>(g + off, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a.g[j] += gv[u][j];
          a.gx[j] += gv[u][j] * ((xv[u][j] - mu[j]) * iv[j]);
        }
    }
    for (; r < r1; r += by) {
      const size_t off = (size_t)r * c + c0;
      float xv[V], gv[V];
      load_vec<T, V>(x + off, xv);
      load_vec<T, V>(g + off, gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a.g[j] += gv[j];
        a.gx[j] += gv[j] * ((xv[j] - mu[j]) * iv[j]);
      }
    }
  }
  block_merge(a, sm, bx);
  if (tid < bx) {
    const int cw = (blockIdx.x * bx + tid) * V;
    if (cw < c) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        part_g[(size_t)blockIdx.y * c + cw + j] = a.g[j];
        part_gx[(size_t)blockIdx.y * c + cw + j] = a.gx[j];
      }
    }
  }
  const int n_chunks = gridDim.y;
  if (!last_to_arrive(arrivals + blockIdx.x, n_chunks)) return;

  const Sums<1> r = merge_chunks<Sums<1>>(
      lanes, fl, active, n_chunks, [&](int k) {
        Sums<1> b;
        b.g[0] = __ldcg(part_g + (size_t)k * c + ch);
        b.gx[0] = __ldcg(part_gx + (size_t)k * c + ch);
        return b;
      });
  if (active && fl == 0) {
    const float iv = iv_ch;
    const float a = gam * iv;
    o.dgb[ch] = r.gx[0];
    o.dgb[c + ch] = r.g[0];
    o.coef[ch] = mu_ch;
    o.coef[c + ch] = -a * iv * (r.gx[0] / (float)m);
    o.coef[2 * c + ch] = -a * (r.g[0] / (float)m);
    o.coef[3 * c + ch] = a;
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
//               reduction's last blocks wrote.
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

// A grid as the caller sized it (``elementwise_grid`` and ``chunking`` in
// batch_norm.py): vec is 1 or 16 / sizeof(T), block (bx, by), rpc rows a
// chunk.
struct Grid {
  int vec, bx, by, rpc;
};

inline bool grid_ok(const Grid& gr, long long m, int c, int kv, int threads) {
  return (gr.vec == 1 || (gr.vec == kv && c % kv == 0)) && gr.bx >= 1 &&
         gr.by >= 1 && gr.bx * gr.by <= threads && gr.rpc >= 1 &&
         (m + gr.rpc - 1) / gr.rpc <= 65535;
}

template <typename T, int kMode>
cudaError_t elementwise(const void* x, const void* g, const Coef& k,
                        void* out, long long m, int c, const Grid& gr,
                        cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (!grid_ok(gr, m, c, kV, kThreads)) return cudaErrorInvalidValue;
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

// The reduction grid (channel slices, row chunks), or an empty one when
// `rg` is not a grid the reductions take: bx a power of two up to 8
// vectors or 32 scalar channels, kRedThreads threads, and a counter for
// every slice.
template <typename T>
dim3 reduction_grid(const Grid& rg, long long m, int c, int n_arrivals) {
  constexpr int kV = 16 / sizeof(T);
  if (!grid_ok(rg, m, c, kV, kRedThreads) || (rg.bx & (rg.bx - 1)) ||
      rg.bx > (rg.vec > 1 ? 8 : 32) || rg.bx * rg.by != kRedThreads)
    return dim3(0);
  const int slices = (c / rg.vec + rg.bx - 1) / rg.bx;
  if (slices > n_arrivals) return dim3(0);
  return dim3(slices, (unsigned)((m + rg.rpc - 1) / rg.rpc));
}

template <typename T>
cudaError_t train_fwd(const void* x, const MomentsOut& o, void* y,
                      float* scratch, int* arrivals, int n_arrivals,
                      long long m, int c, const Grid& rg, const Grid& gr,
                      cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  const dim3 grid = reduction_grid<T>(rg, m, c, n_arrivals);
  if (grid.x == 0) return cudaErrorInvalidValue;
  float* part_mean = scratch;
  float* part_m2 = scratch + (size_t)grid.y * c;
  const dim3 block(rg.bx, rg.by);
  if (rg.vec == kV)
    bn_moments_kernel<T, kV><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), part_mean, part_m2, arrivals, o, m, c,
        rg.rpc);
  else
    bn_moments_kernel<T, 1><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), part_mean, part_m2, arrivals, o, m, c,
        rg.rpc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // y = (x - mean) * (gamma * inv) + beta
  const float* stats = o.stats;
  const Coef k{stats, stats + 3 * c, stats + 4 * c, nullptr,
               nullptr, nullptr, 0, 0.f};
  return elementwise<T, kApply>(x, nullptr, k, y, m, c, gr, s);
}

template <typename T>
cudaError_t train_bwd(const void* x, const void* g, const GradOut& o,
                      const float* mean, const float* inv, void* dx,
                      float* scratch, int* arrivals, int n_arrivals,
                      long long m, int c, const Grid& rg, const Grid& gr,
                      cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  const dim3 grid = reduction_grid<T>(rg, m, c, n_arrivals);
  if (grid.x == 0) return cudaErrorInvalidValue;
  float* part_g = scratch;
  float* part_gx = scratch + (size_t)grid.y * c;
  const dim3 block(rg.bx, rg.by);
  if (rg.vec == kV)
    bn_grad_sums_kernel<T, kV><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), mean, inv,
        part_g, part_gx, arrivals, o, m, c, rg.rpc);
  else
    bn_grad_sums_kernel<T, 1><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), mean, inv,
        part_g, part_gx, arrivals, o, m, c, rg.rpc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dx = (x - mean) * coef1 + coef2 + a * g
  const float* coef = o.coef;
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
// 4*c (backward), n_chunks = ceil(m / rrpc); arrivals n_arrivals int32
// counters, zero on entry (and so on return), at least one a channel
// slice, used by one stream at a time.  The reductions run on the grid
// (vec, rbx, rby, rrpc), the elementwise pass on (vec, bx, by, ew_rpc),
// both as the caller sized them: vec = 16 / sizeof(x's type) only when C
// is whole vectors and x, y, g and dx are 16-byte aligned, else 1.  Each
// returns the cudaError_t of its launches (the forward and backward
// launch two kernels each, the inference one); the caller validates
// shapes, contiguity and alignment.

extern "C" int dl4j_bn_train_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, float* stats,
                                 float* scratch, int* arrivals,
                                 int n_arrivals, int dtype, int adt,
                                 long long m, int c, float eps, int vec,
                                 int rbx, int rby, int rrpc, int bx, int by,
                                 int ew_rpc, void* stream) {
  if (m < 1 || c < 1 || adt < 0 || adt > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid rg{vec, rbx, rby, rrpc}, gr{vec, bx, by, ew_rpc};
  const MomentsOut o{gamma, beta, adt, eps, stats};
  if (dtype == 0)
    return (int)train_fwd<float>(x, o, y, scratch, arrivals, n_arrivals, m,
                                 c, rg, gr, s);
  if (dtype == 1)
    return (int)train_fwd<__nv_bfloat16>(x, o, y, scratch, arrivals,
                                         n_arrivals, m, c, rg, gr, s);
  if (dtype == 2)
    return (int)train_fwd<__half>(x, o, y, scratch, arrivals, n_arrivals, m,
                                  c, rg, gr, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dl4j_bn_train_bwd(const void* x, const void* g,
                                 const void* gamma, const float* mean,
                                 const float* inv, void* dx, float* dgb,
                                 float* scratch, int* arrivals,
                                 int n_arrivals, int dtype, int adt,
                                 long long m, int c, int vec, int rbx,
                                 int rby, int rrpc, int bx, int by,
                                 int ew_rpc, void* stream) {
  if (m < 1 || c < 1 || adt < 0 || adt > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid rg{vec, rbx, rby, rrpc}, gr{vec, bx, by, ew_rpc};
  const long long n_chunks = (m + rrpc - 1) / (rrpc > 0 ? rrpc : 1);
  const GradOut o{gamma, adt, dgb, scratch + 2 * n_chunks * c};
  if (dtype == 0)
    return (int)train_bwd<float>(x, g, o, mean, inv, dx, scratch, arrivals,
                                 n_arrivals, m, c, rg, gr, s);
  if (dtype == 1)
    return (int)train_bwd<__nv_bfloat16>(x, g, o, mean, inv, dx, scratch,
                                         arrivals, n_arrivals, m, c, rg, gr,
                                         s);
  if (dtype == 2)
    return (int)train_bwd<__half>(x, g, o, mean, inv, dx, scratch, arrivals,
                                  n_arrivals, m, c, rg, gr, s);
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
