// Paged decode attention for Hopper (sm_90a), split over the key range.
//
// Replaces the TPU kernel deeplearning4j_tpu/helpers/paged_attention.py
// `_decode_kernel` (launched by `_pallas_paged`): per-row causal attention
// of q [B, T, Hq, D] straight off the flattened K/V page pools
// [P * page_size, Hkv, D] through the int32 block table [B, MAXP], without
// ever gathering the [B, MAXP * page_size, Hkv, D] view.  A key's global
// position is its logical slot p * page_size + i; a query row at position
// q_pos sees the keys with q_pos >= p * page_size + i.  That mask also hides
// the trash page 0 and slots not yet written.  A page index is clamped to
// the pool, as XLA's gather clamps it.  Query head h reads kv head h / G
// (G = Hq / Hkv), the grouping of q.reshape(b, t, hkv, g, d) in the
// reference.  A row that sees no key (l = 0) writes 0.
//
// What bounds it: bytes.  Each (row, kv head) reads the live K and V
// pages once and does 4 * D flops per key, far below the ~295 flops a
// byte at which the H100's tensor cores, not its memory, would become the
// limit.  At decode (T = 1) a (b, kv head) has one query row, and
// B * Hkv = 128 such rows at the serving shape: one block for each would
// fill less than one wave of the 132 SMs and leave most of each block
// idle.  So the design (flash-decoding) is:
//
// - Split the keys across blocks.  The grid is (b, kv head, tile of RB
//   query rows) x splits.  A block takes its rows' live keys, len = the
//   highest position of its rows + 1 (at most MAXP * page_size), cuts them
//   into `n_split` pieces of ceil(len / n_split) keys rounded up to 8, and
//   takes its own piece: the split follows the live context, not the
//   table's capacity.  `n_split` comes from the grid alone (`plan`), so
//   that the decode shapes put about three blocks on every SM.
// - Put every thread to work.  The 4 warps of a block take distinct keys.
//   A key's D is split across LPK lanes as 16-byte vectors and its dot
//   product finished by a shuffle reduction, so a warp scores 32 / LPK
//   keys at once.  Each group of LPK lanes runs its own online softmax
//   (running max m, sum l, and the output sums of its D slice) in
//   registers, with p = 2^(s * scale * log2 e - m'), one FMA and one ex2.
// - Stream.  K and V stay in their own type in shared memory, brought by
//   16-byte cp.async into a two-stage ring of CK-key chunks (the page
//   lookup per key), so the next chunk is in flight while one computes;
//   keys past the split read as zeros.  (A third stage was no faster at
//   the decode shapes.)
// - Merge through the cluster.  The splits of a row tile are one thread
//   block cluster (Hopper): each block writes its float32 partial
//   (m, l, sums[D]) into block 0's shared memory through distributed
//   shared memory, and after one cluster barrier block 0 merges them and
//   writes the output while the others have left.  No workspace in device
//   memory, no atomics, no second kernel.  The merge runs in a fixed
//   order (the lane groups of a warp by a shuffle butterfly, the warps in
//   warp order, the splits' sums l by a butterfly and their output sums
//   in split order), so the output is the same bits from call to call.  A cluster holds at most 8 blocks, which caps
//   the splits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;           // chunks of the cp.async ring
constexpr int kSplitKeys = 8;        // a split's keys are a multiple of this
constexpr int kTargetBlocks = 3 * 132;  // about three blocks an H100 SM
constexpr int kMaxSplits = 8;        // the portable cluster size
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int t_len, hq, hkv, d, page_size, maxp, num_pages;
  int tiles;    // row tiles of one (b, kv head)
  int n_split;  // blocks over one row tile's keys: its cluster
  float scale;
};

// 2^x in one MUFU instruction; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Column c of the merge of a block's kWarps partials laid out
// [m, l, sums[D]] at base + w * stride, in warp order: c = 0 gives the
// max m, c = 1 the sum l, c >= 2 the output sum, each term scaled by
// 2^((m_w - m) scale log2 e).
__device__ __forceinline__ float merged(const float* base, int stride, int c,
                                        float sl2) {
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, base[w * stride]);
  if (c == 0) return mx;
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    sum += base[w * stride + c] * ex2((base[w * stride] - mx) * sl2);
  return sum;
}

// LPK lanes per key, VPL 16-byte vectors per lane, RB query rows a block.
// (A minimum of one block an SM in the launch bounds keeps ptxas from
// capping registers below what the RB = 4 variants need, and spilling.)
template <typename T, int LPK, int VPL, int RB>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                    const T* __restrict__ pv, const int32_t* __restrict__ block,
                    const int32_t* __restrict__ qpos, T* __restrict__ out,
                    Params p) {
  constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int EPL = VPL * kVec;       // elements a lane holds of a key
  constexpr int KPW = 32 / LPK;         // keys a warp scores at once
  constexpr int KPB = kWarps * KPW;     // ... a block
  constexpr int CK = KPB > 32 ? KPB : 32;  // keys of a chunk
  constexpr int NI = CK / KPB;          // keys of a chunk per lane group
  extern __shared__ __align__(16) uint4 smem[];
  const int nvec = p.d / kVec;
  const int cw = p.d + 2;               // a partial: m, l, sums[D]
  uint4* kst = smem;                    // [kStages][CK][nvec]
  uint4* vst = kst + kStages * CK * nvec;
  float* red = reinterpret_cast<float*>(vst + kStages * CK * nvec);
  // red: [kWarps][RB][cw], each warp's sums; parts: [n_split][RB][cw],
  // the cluster's partials, which the blocks write into block 0's
  float* parts = red + kWarps * RB * cw;

  const int g = p.hq / p.hkv;
  const int rows = g * p.t_len;  // query rows of one (b, kv head)
  const int tile = blockIdx.x % p.tiles;
  const int b = blockIdx.x / p.tiles / p.hkv;
  const int h_kv = blockIdx.x / p.tiles % p.hkv;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, sub = lane % LPK;
  const float sl2 = p.scale * kLog2e;
  // that this block has started (block 0's shared memory is written by
  // the others); waited for just before those writes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  bool ok[RB];
  int pos[RB];
  size_t qoff[RB];  // the row's q and out offset
  int top = -1;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int r = tile * RB + i;
    ok[i] = r < rows;
    const int gi = ok[i] ? r / p.t_len : 0, ti = ok[i] ? r % p.t_len : 0;
    qoff[i] = ((size_t)(b * p.t_len + ti) * p.hq + h_kv * g + gi) * p.d;
    pos[i] = ok[i] ? qpos[b * p.t_len + ti] : -1;
    top = max(top, pos[i]);
  }
  const int len = min(top + 1, p.maxp * p.page_size);
  const int per = ((len + p.n_split - 1) / p.n_split + kSplitKeys - 1) /
                  kSplitKeys * kSplitKeys;
  const int k_begin = min(len, split * per);
  const int k_end = min(len, k_begin + per);
  const int n_chunks = (k_end - k_begin + CK - 1) / CK;

  const int32_t* brow = block + (size_t)b * p.maxp;
  const uint4* kg = reinterpret_cast<const uint4*>(pk);
  const uint4* vg = reinterpret_cast<const uint4*>(pv);
  auto fetch = [&](int c) {  // chunk c into stage c % kStages
    uint4* ks = kst + (c % kStages) * CK * nvec;
    uint4* vs = vst + (c % kStages) * CK * nvec;
    const int c0 = k_begin + c * CK;
    for (int idx = threadIdx.x; idx < CK * nvec; idx += kThreads) {
      const int kk = idx / nvec, vec = idx % nvec;
      const int kp = c0 + kk;
      const bool in = kp < k_end;
      size_t src = 0;
      if (in) {
        const int page =
            min(max(brow[kp / p.page_size], 0), p.num_pages - 1);
        src = (((size_t)page * p.page_size + kp % p.page_size) * p.hkv +
               h_kv) * nvec + vec;
      }
      cp16(ks + idx, kg + src, in);
      cp16(vs + idx, vg + src, in);
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) fetch(c);
    cp_commit();
  }

  float qr[RB][EPL];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int vec = sub + v * LPK;
      float* f = qr[i] + v * kVec;
      if (ok[i] && vec < nvec) {
        unpack(*reinterpret_cast<const uint4*>(q + qoff[i] + vec * kVec), f,
               T());
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) f[j] = 0.f;
      }
    }

  float m[RB], l[RB], acc[RB][EPL];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<kStages - 2>();  // chunk c has landed ...
    __syncthreads();  // ... for every thread; chunk c - 1's stage is free
    if (c + kStages - 1 < n_chunks) fetch(c + kStages - 1);
    cp_commit();
    const uint4* ks = kst + (c % kStages) * CK * nvec;
    const uint4* vs = vst + (c % kStages) * CK * nvec;
    const int c0 = k_begin + c * CK;

    float sc[NI][RB];
#pragma unroll
    for (int it = 0; it < NI; ++it) {
      const int kk = (it * kWarps + warp) * KPW + grp;
      float kf[EPL];
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vec = sub + v * LPK;
        if (vec < nvec) {
          unpack(ks[kk * nvec + vec], kf + v * kVec, T());
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) kf[v * kVec + j] = 0.f;
        }
      }
      const int kp = c0 + kk;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[i][e], kf[e], dot);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kFull, dot, o);
        sc[it][i] = kp < k_end && kp <= pos[i] ? dot : kNegInf;
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float mx = m[i];
#pragma unroll
      for (int it = 0; it < NI; ++it) mx = fmaxf(mx, sc[it][i]);
      const float alpha = ex2((m[i] - mx) * sl2);
      // masked scores hold kNegInf; real ones are far above half of it
      const float mu = mx > 0.5f * kNegInf ? mx * sl2 : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int it = 0; it < NI; ++it) {
        sc[it][i] = ex2(fmaf(sc[it][i], sl2, -mu));
        rs += sc[it][i];
      }
      m[i] = mx;
      l[i] = alpha * l[i] + rs;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int it = 0; it < NI; ++it) {
      const int kk = (it * kWarps + warp) * KPW + grp;
      float vf[EPL];
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vec = sub + v * LPK;
        if (vec < nvec) {
          unpack(vs[kk * nvec + vec], vf + v * kVec, T());
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) vf[v * kVec + j] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[i][e] = fmaf(sc[it][i], vf[e], acc[i][e]);
    }
  }
  cp_wait<0>();  // no copy outlives the block (the trailing groups are empty)

  // the lane groups of the warp, by a butterfly over the group bits
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float mo = __shfl_xor_sync(kFull, m[i], off);
      const float lo = __shfl_xor_sync(kFull, l[i], off);
      const float mx = fmaxf(m[i], mo);
      const float a = ex2((m[i] - mx) * sl2), ao = ex2((mo - mx) * sl2);
      l[i] = l[i] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[i][e] = acc[i][e] * a +
                    __shfl_xor_sync(kFull, acc[i][e], off) * ao;
      m[i] = mx;
    }
  // the warps, in shared memory
  if (lane < LPK) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float* mine = red + (warp * RB + i) * cw;
      if (lane == 0) {
        mine[0] = m[i];
        mine[1] = l[i];
      }
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vec = lane + v * LPK;
        if (vec < nvec)
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            mine[2 + vec * kVec + j] = acc[i][v * kVec + j];
      }
    }
  }
  __syncthreads();

  // the block's partial over its keys, into block 0 of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* mine = cluster.map_shared_rank(parts, 0) + split * RB * cw;
  for (int idx = threadIdx.x; idx < RB * cw; idx += kThreads)
    mine[idx] = merged(red + idx / cw * cw, RB * cw, idx % cw, sl2);
  cluster.sync();  // every split's partial is in block 0
  if (split != 0) return;

  // Block 0 merges the splits: warp i takes row i's weights
  // 2^((m_j - m) scale log2 e) and sum l (split j on lane j, the lanes
  // combined by a fixed butterfly), then every thread sums its columns
  // over the splits in split order.
  const int n = p.n_split;
  float* wts = red;  // [RB][kMaxSplits + 1]: the weights, then l
  if (warp < RB) {
    const float* pi = parts + warp * cw;
    const float mj = lane < n ? pi[lane * RB * cw] : kNegInf;
    float mx = mj;
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float w = ex2((mj - mx) * sl2);
    float ls = lane < n ? pi[lane * RB * cw + 1] * w : 0.f;
    for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(kFull, ls, o);
    if (lane < n) wts[warp * (kMaxSplits + 1) + lane] = w;
    if (lane == 0) wts[warp * (kMaxSplits + 1) + kMaxSplits] = ls;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    if (!ok[i]) continue;
    const float* w = wts + i * (kMaxSplits + 1);
    const float ls = w[kMaxSplits];
    for (int c = threadIdx.x; c < p.d; c += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j)
        if (j < n) a += parts[(j * RB + i) * cw + 2 + c] * w[j];
      store_out(out + qoff[i] + c, ls > 0.f ? a / ls : 0.f);
    }
  }
}

struct Plan {
  int rb;       // query rows a block
  int tiles;    // row tiles of one (b, kv head)
  int pairs;    // (b, kv head, row tile) groups: the grid's x
  int n_split;  // the grid's y
};

// The grid of a call.  Decode (one row per (b, kv head)) takes 1 row a
// block, anything else 4; the splits bring the grid to about
// kTargetBlocks, with at least 32 keys of the table's capacity each and
// at most a cluster's 8.
Plan plan(int b, int t, int hq, int hkv, int page_size, int maxp) {
  Plan pl;
  const int rows = hq / hkv * t;
  pl.rb = rows == 1 ? 1 : 4;
  pl.tiles = (rows + pl.rb - 1) / pl.rb;
  pl.pairs = b * hkv * pl.tiles;
  int n = (kTargetBlocks + pl.pairs - 1) / pl.pairs;
  n = min(n, (maxp * page_size + 31) / 32);
  pl.n_split = max(1, min(n, kMaxSplits));
  return pl;
}

struct Args {
  const void *q, *pk, *pv;
  const int32_t *block, *qpos;
  void* out;
  Params p;
  cudaStream_t stream;
};

template <typename T, int LPK, int VPL, int RB>
cudaError_t launch(const Args& a, int pairs) {
  constexpr int KPB = kWarps * 32 / LPK;
  constexpr int CK = KPB > 32 ? KPB : 32;  // as in the kernel
  const int nvec = a.p.d * (int)sizeof(T) / 16;
  const size_t smem =
      sizeof(uint4) * 2 * kStages * CK * nvec +
      sizeof(float) * (kWarps + a.p.n_split) * RB * (a.p.d + 2);
  auto kernel = paged_decode_kernel<T, LPK, VPL, RB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pairs, a.p.n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = a.p.n_split;  // a row tile's splits
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.q),
                            static_cast<const T*>(a.pk),
                            static_cast<const T*>(a.pv), a.block, a.qpos,
                            static_cast<T*>(a.out), a.p);
}

// LPK: the 16-byte vectors of a key row, rounded up to a power of two, at
// most 32; past 32 vectors (float32, D > 128) a lane takes two
template <typename T, int RB>
cudaError_t by_lanes(const Args& a, int pairs) {
  const int nvec = a.p.d * (int)sizeof(T) / 16;
  if constexpr (sizeof(T) == 4) {
    if (nvec > 32) return launch<T, 32, 2, RB>(a, pairs);
  }
  if (nvec > 16) return launch<T, 32, 1, RB>(a, pairs);
  if (nvec > 8) return launch<T, 16, 1, RB>(a, pairs);
  if (nvec > 4) return launch<T, 8, 1, RB>(a, pairs);
  if (nvec > 2) return launch<T, 4, 1, RB>(a, pairs);
  if constexpr (sizeof(T) == 2) {
    if (nvec == 1) return launch<T, 1, 1, RB>(a, pairs);
  }
  return launch<T, 2, 1, RB>(a, pairs);
}

template <typename T>
cudaError_t dispatch(const Args& a, const Plan& pl) {
  return pl.rb == 1 ? by_lanes<T, 1>(a, pl.pairs)
                    : by_lanes<T, 4>(a, pl.pairs);
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
  if (d < 8 || d > 256 || d % 8 || hkv < 1 || hq % hkv || num_pages < 1 ||
      b < 1 || t < 1)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan(b, t, hq, hkv, page_size, maxp);
  Args a{};
  a.q = q;
  a.pk = pk;
  a.pv = pv;
  a.block = static_cast<const int32_t*>(block);
  a.qpos = static_cast<const int32_t*>(qpos);
  a.out = out;
  a.p = Params{t, hq, hkv, d, page_size, maxp, num_pages, pl.tiles,
               pl.n_split, scale};
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, pl);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, pl);
  return (int)cudaErrorInvalidValue;
}
