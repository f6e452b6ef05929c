// Decode attention for Hopper (sm_90a): the paged kernel of the serving
// engine and the fused kernel of lm_generate, behind a plain C interface
// (built with nvcc into a shared library and loaded with ctypes by
// chainermn_tpu_torch/ops/_kernels.py).
//
// Replaces the Pallas TPU kernels of chainermn_tpu/ops/decode_attention.py:
//   cmn_paged_decode_attention <- _paged_kernel  (:196), launched by
//                                 paged_decode_attention (:271)
//   cmn_fused_decode_attention <- _decode_kernel (:101), launched by
//                                 fused_decode_attention (:135)
//
// What bounds it on an H100: the K/V bytes it reads.  Per position it does
// 4 * R * Dh flops (R = query rows sharing one kv head) for 2 * Dh *
// sizeof(KT) bytes, about R flops per byte at bf16: two orders of magnitude
// under the ~295 flops per byte where the tensor cores would become the
// limit, so the products run on CUDA cores.  The least time is (K/V bytes
// the valid positions need) / 3.35 TB/s.  At the serving step's size (8
// slots, ~3 MB of K/V) that is about a microsecond, under one DRAM round
// trip plus a launch, so the design aims at a short dependent chain and
// many bytes in flight rather than at arithmetic.
//
// Design.
//  * Split-KV over a thread-block cluster.  The grid is (splits, slot or
//    batch row, kv head x row block); the `splits` CTAs of one (slot, kv
//    head, row block) form one cluster (cudaLaunchKernelEx with a cluster
//    dimension, at most 8: the portable size).  CTA c owns positions
//    [c * per, (c + 1) * per), cut on the device at its rows' bound, so a
//    CTA past the bound has nothing to read.  The plan (splits, per, the
//    copy size) comes from the wrapper and depends on static shapes only
//    (ops/decode_attention.py `_plan`), never on valid_len or the block
//    tables: the launch reads nothing on the host and can be captured in a
//    CUDA graph.
//  * Bulk asynchronous copies.  A paged block (kh, blk) is BL * Dh
//    contiguous elements, and the fused cache is contiguous along L, so
//    each chunk of positions is one 1-D cp.async.bulk for K and one for V
//    (SASS UBLKCP), completion counted on an mbarrier of its ring stage; no
//    tensor map.  Each warp owns every fourth chunk of its CTA's range and a
//    ring of its own stages: lane 0 reads the chunk's block-table entry
//    (the whole warp fetches 32 entries at a time), issues the two copies,
//    and refills a stage as soon as the warp has consumed it.  K/V stay at
//    storage width in shared memory and convert to fp32 in registers.  The
//    int8 scales (4 bytes per position) are read directly.
//  * Position-parallel math on every warp.  A group of Dh / 8 lanes owns
//    one position (each lane 8 head dims): it loads its slices of K once,
//    takes the dot product for each of the CTA's rows and reduces inside
//    the group with shuffles; each K and V vector serves all of the rows it
//    loads for.  Each warp keeps an online-softmax state (running max,
//    normalizer, fp32 accumulator) per row over the positions it scored;
//    the warps merge in shared memory at the end of the CTA's range, then
//    rank 0 of the cluster reads the other CTAs' partials through
//    distributed shared memory, merges, normalizes and writes the output.
//    A second cluster barrier keeps every CTA alive until rank 0 has read
//    it.  One launch: no global workspace, no atomics.
//  * Rows.  A CTA holds up to 4 rows (R = T * G: the G heads of a GQA
//    group and the T offsets of a verify chunk), 1 in the instantiation for
//    R = 1 (MHA decode, the main path).  Larger R takes ceil(R / 4) row
//    blocks along the grid's z; each row block reads its range's K/V again
//    (the blocks run together, so mostly from L2).  Tensor cores for such
//    verify chunks are left for later work.
//
// Arithmetic of the Pallas kernels, kept: q is pre-scaled by 1/sqrt(Dh);
// int8 scores are multiplied by the k scale, and probabilities by the v
// scale after the normalizer has been summed; row r (query offset r / G)
// of a paged slot attends positions < valid + r / G; masked positions
// contribute exactly 0, and every merge weighs a partial that saw no
// position with 0, never exp(NEG_INF - NEG_INF) = 1, so a fully masked
// row gives exactly 0; the output is acc / max(l, 1e-30).  The fused
// kernel with valid <= 0 reproduces the Pallas one-shot softmax over an
// all-NEG_INF row: every position of the panel scores 0 and weighs
// exp(0) = 1 in every split, so the output is the mean of v_scale * V.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kElems = 8;          // head dims per lane
constexpr int kMaxStages = 4;      // ring stages per warp
constexpr int kRingBytes = 32768;  // the CTA's ring, all warps
constexpr int kBarBytes = kWarps * kMaxStages * 8;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr size_t kSmemDefault = 48 * 1024;
constexpr float kNegInf = -1e30f;  // finite stand-in, as in the Pallas kernels
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Params {
  const void* q;          // paged (S, T, H, Dh); fused (B, H, Dh)
  const void* k;          // paged (KH, NB, BL, Dh); fused (B, KH, L, Dh)
  const void* v;
  const float* k_scale;   // int8 only: paged (KH, NB, BL); fused (B, KH, L)
  const float* v_scale;
  const int* tables;      // paged (S, MB)
  const int* valid;       // (S,) or (B,)
  void* out;              // q's shape and dtype
  int T, H, KH, G, R, Dh;
  int NB, BL, MB;         // paged pool geometry
  int L;                  // fused cache length
  int nrb;                // row blocks per kv head (grid z = KH * nrb)
  int per;                // positions per split
  int chunk;              // positions per bulk copy
  int stages;             // ring stages per warp
  float scale;            // 1 / sqrt(Dh)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_f(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// Eight consecutive elements of a shared-memory row, in fp32.
__device__ __forceinline__ void load8(const float* p, float (&x)[kElems]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kElems]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[kElems]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kElems; ++i) x[i] = static_cast<float>(c[i]);
}

// Shared memory: the mbarriers (kMaxStages per warp), the warps' rings
// (stage = K chunk then V chunk), the warps' partials and the CTA's
// partial, each [m[RB], l[RB], acc[RB][Dh]] in fp32.
__host__ __device__ __forceinline__ size_t ring_offset() { return kBarBytes; }
__host__ __device__ __forceinline__ size_t merge_offset(int stages,
                                                        size_t chunk_bytes) {
  return kBarBytes + (size_t)kWarps * stages * 2 * chunk_bytes;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int stages,
                                                      size_t chunk_bytes,
                                                      int rb, int Dh) {
  return merge_offset(stages, chunk_bytes) +
         (size_t)(kWarps + 1) * rb * (Dh + 2) * sizeof(float);
}

// Sum (or max) over the lanes of one lane group (offsets below lg), or
// across the groups of a warp (offsets lg .. 16): fixed, unrolled offsets,
// each taken or not by a warp-uniform test.
__device__ __forceinline__ float group_sum(float x, int lg) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lg) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ float across_sum(float x, int lg) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    if (o >= lg) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ float across_max(float x, int lg) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    if (o >= lg) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// One warp's view of its CTA's range: it owns every kWarps-th chunk.
struct WarpRange {
  int s, kh, lo, hi, warp, lane, mine;
  __device__ __forceinline__ int start(const Params& p, int j) const {
    return lo + (warp + j * kWarps) * p.chunk;
  }
};

// Warp-wide: fills stage j % stages with the warp's chunk j (one bulk copy
// of K and one of V, issued by lane 0).  Paged: lane i of the warp holds
// the block of chunk tbl_win + i, refetched 32 chunks at a time.  Lane st
// keeps the first pool row of stage st in row_lane.
template <typename KT, bool PAGED>
__device__ __forceinline__ void issue_chunk(const Params& p,
                                            const WarpRange& w, int j,
                                            char* ring, uint64_t* bars,
                                            int& tbl_win, int& tbl_val,
                                            long long& row_lane) {
  const int p0 = w.start(p, j);
  const int n = min(p.chunk, w.hi - p0);
  long long row;
  if (PAGED) {
    if (j >= tbl_win + 32) {
      tbl_win = j & ~31;
      const int jj = tbl_win + w.lane;
      tbl_val = jj < w.mine
                    ? p.tables[(size_t)w.s * p.MB + w.start(p, jj) / p.BL]
                    : 0;
    }
    const int blk = __shfl_sync(kFull, tbl_val, j - tbl_win);
    row = ((long long)w.kh * p.NB + blk) * p.BL + p0 % p.BL;
  } else {
    row = ((long long)w.s * p.KH + w.kh) * p.L + p0;
  }
  const int st = j % p.stages;
  if (w.lane == st) row_lane = row;
  if (w.lane == 0) {
    const uint32_t row_bytes = p.Dh * sizeof(KT);
    const uint32_t chunk_bytes = p.chunk * row_bytes;
    char* dst = ring + (size_t)st * 2 * chunk_bytes;
    const uint32_t bytes = n * row_bytes;
    hopper::mbar_expect_tx(&bars[st], 2 * bytes);
    hopper::bulk_load(dst, static_cast<const KT*>(p.k) + row * p.Dh, bytes,
                      &bars[st]);
    hopper::bulk_load(dst + chunk_bytes,
                      static_cast<const KT*>(p.v) + row * p.Dh, bytes,
                      &bars[st]);
  }
}

// The int8 scales of a lane group's positions i0 + u * ppw of the chunk
// (i0 is the group's first; 1 for float caches and past the chunk's n).
template <bool QUANT, int U>
__device__ __forceinline__ void load_scales(const Params& p, long long row,
                                            int i0, int ppw, int n,
                                            float (&ks)[U], float (&vs)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = i0 + u * ppw;
    ks[u] = QUANT && i < n ? __ldg(p.k_scale + row + i) : 1.f;
    vs[u] = QUANT && i < n ? __ldg(p.v_scale + row + i) : 1.f;
  }
}

template <typename QT, typename KT, bool PAGED, int RB>
__device__ __forceinline__ void decode_body(const Params& p) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int U = 4;  // positions per lane group per step
  extern __shared__ __align__(128) char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int split = blockIdx.x;  // the CTA's rank: the cluster spans x
  const int s = blockIdx.y;
  const int kh = blockIdx.z / p.nrb;
  const int rb0 = (blockIdx.z % p.nrb) * RB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Dh = p.Dh, G = p.G;
  const int lg = Dh / kElems;  // lanes per position
  const int ppw = 32 / lg;     // positions per warp and step
  const int grp = lane / lg, gl = lane % lg;
  const int rows = min(RB, p.R - rb0);
  const int valid = p.valid[s];

  // Row r attends positions < bnd[r]; the CTA reads [lo, hi).  Paged: row
  // r is query offset (rb0 + r) / G (the verify chunk's causality), capped
  // by the table; fused: [0, valid), or the whole panel when valid <= 0.
  int bnd[RB];
  int bound;
  bool uniform = false;
  if (PAGED) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      bnd[r] = r < rows ? valid + (rb0 + r) / G : -1;
    bound = min(valid + (rb0 + rows - 1) / G, p.MB * p.BL);
  } else {
    uniform = valid <= 0;
    bound = uniform ? p.L : min(valid, p.L);
#pragma unroll
    for (int r = 0; r < RB; ++r) bnd[r] = r < rows ? bound : -1;
  }
  const int lo = split * p.per;
  const int hi = min(lo + p.per, bound);
  const int n_chunks = hi > lo ? (hi - lo + p.chunk - 1) / p.chunk : 0;
  const int mine =
      n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;

  const WarpRange wr = {s, kh, lo, hi, warp, lane, mine};
  const uint32_t chunk_bytes = p.chunk * Dh * sizeof(KT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * kMaxStages;
  char* ring =
      smem + ring_offset() + (size_t)warp * p.stages * 2 * chunk_bytes;
  float* merge =
      reinterpret_cast<float*>(smem + merge_offset(p.stages, chunk_bytes));
  const int part = RB * (Dh + 2);

  if (lane < p.stages) hopper::mbar_init(&bars[lane], 1);
  hopper::mbar_init_fence();
  __syncwarp();

  int tbl_win = -32, tbl_val = 0;
  long long row_lane = 0;
  const int depth = min(p.stages, mine);
  for (int j = 0; j < depth; ++j)
    issue_chunk<KT, PAGED>(p, wr, j, ring, bars, tbl_win, tbl_val, row_lane);

  // q * 1/sqrt(Dh): this lane's 8 dims of each row (rows past R are 0).
  const QT* Q = static_cast<const QT*>(p.q);
  float qr[RB][kElems];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int rr = rb0 + r;
    const size_t off =
        ((size_t)(s * p.T + rr / G) * p.H + kh * G + rr % G) * Dh +
        gl * kElems;
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      qr[r][e] = r < rows ? to_f(Q[off + e]) * p.scale : 0.f;
  }
  float m[RB], l[RB], acc[RB][kElems];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[r][e] = 0.f;
  }

  for (int j = 0; j < mine; ++j) {
    const int st = j % p.stages;
    const int p0 = wr.start(p, j);
    const int n = min(p.chunk, hi - p0);
    const long long row = __shfl_sync(kFull, row_lane, st);
    const KT* kc = reinterpret_cast<const KT*>(ring + (size_t)st * 2 *
                                                          chunk_bytes);
    const KT* vc = kc + (size_t)p.chunk * Dh;
    int lim[RB];  // row r takes the chunk's positions i < lim[r]
#pragma unroll
    for (int r = 0; r < RB; ++r) lim[r] = min(bnd[r] - p0, n);
    float ks[U], vs[U];
    // Before the wait: the scales do not need the copy.
    load_scales<kQuant>(p, row, grp, ppw, n, ks, vs);
    hopper::mbar_wait(&bars[st], (j / p.stages) & 1);
    for (int i0 = 0; i0 < n; i0 += ppw * U) {
      if (i0) load_scales<kQuant>(p, row, i0 + grp, ppw, n, ks, vs);
      float sc[U][RB];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * ppw + grp;
        float dot[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) dot[r] = 0.f;
        if (i < n) {
          float kv[kElems];
          load8(kc + (size_t)i * Dh + gl * kElems, kv);
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int e = 0; e < kElems; ++e)
              dot[r] = fmaf(qr[r][e], kv[e], dot[r]);
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) dot[r] = group_sum(dot[r], lg);
#pragma unroll
        for (int r = 0; r < RB; ++r)
          sc[u][r] = i < lim[r] ? (uniform ? 0.f : dot[r] * ks[u]) : kNegInf;
      }
      // One max per row over the warp's positions of this step.
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float mx = sc[0][r];
#pragma unroll
        for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[u][r]);
        mx = across_max(mx, lg);
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[r][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * ppw + grp;
        if (i < n) {
          float vv[kElems];
          load8(vc + (size_t)i * Dh + gl * kElems, vv);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            // Masked positions contribute exactly 0.
            float pr = i < lim[r] ? expf(sc[u][r] - m[r]) : 0.f;
            l[r] += pr;
            pr *= vs[u];
#pragma unroll
            for (int e = 0; e < kElems; ++e)
              acc[r][e] = fmaf(pr, vv[e], acc[r][e]);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with stage st
    if (j + p.stages < mine) {
      if (lane == 0) hopper::fence_proxy_async();
      issue_chunk<KT, PAGED>(p, wr, j + p.stages, ring, bars, tbl_win,
                             tbl_val, row_lane);
    }
  }

  // The warp's groups share m: sum their normalizers and accumulators.
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    l[r] = across_sum(l[r], lg);
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[r][e] = across_sum(acc[r][e], lg);
  }
  float* wp = merge + warp * part;
  if (lane < lg) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        wp[2 * RB + r * Dh + gl * kElems + e] = acc[r][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      wp[r] = m[r];
      wp[RB + r] = l[r];
    }
  }
  __syncthreads();

  // The CTA's partial: the warps' merged.  A warp that saw no position of
  // a row (m = NEG_INF) weighs 0.
  float* cp = merge + kWarps * part;
  for (int idx = threadIdx.x; idx < RB * (Dh + 1); idx += kThreads) {
    const bool is_l = idx >= RB * Dh;
    const int r = is_l ? idx - RB * Dh : idx / Dh;
    const int off = is_l ? RB + r : 2 * RB + idx;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, merge[w * part + r]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = merge[w * part + r];
      if (mw > kNegInf) sum += expf(mw - M) * merge[w * part + off];
    }
    cp[off] = sum;
    if (is_l) cp[r] = M;
  }
  cluster.sync();

  // Rank 0 merges the cluster's partials through distributed shared memory
  // and writes the rows.
  if (split == 0) {
    const int nsplit = gridDim.x;
    QT* O = static_cast<QT*>(p.out);
    for (int idx = threadIdx.x; idx < rows * Dh; idx += kThreads) {
      const int r = idx / Dh, d = idx % Dh;
      float M = kNegInf;
      for (int c = 0; c < nsplit; ++c)
        M = fmaxf(M, cluster.map_shared_rank(cp, c)[r]);
      float lsum = 0.f, a = 0.f;
      for (int c = 0; c < nsplit; ++c) {
        const float* pc = cluster.map_shared_rank(cp, c);
        const float mc = pc[r];
        if (mc > kNegInf) {
          const float w = expf(mc - M);
          lsum += w * pc[RB + r];
          a += w * pc[2 * RB + idx];
        }
      }
      const int rr = rb0 + r;
      const size_t off =
          ((size_t)(s * p.T + rr / G) * p.H + kh * G + rr % G) * Dh + d;
      store_f(a / fmaxf(lsum, 1e-30f), O + off);
    }
  }
  cluster.sync();  // the other CTAs' partials stay until rank 0 has read
}

using KernelFn = void (*)(Params);

// Kernel<QT, KT, PAGED, RB>::get(): the __global__ function of one
// instantiation, named decode_<paged|fused>_q<type>_kv<type>_rb<RB> so that
// the SASS census can tell them apart.  The launch bound's minimum of one
// block per SM leaves ptxas free to take the registers it needs (68-142);
// without it, ptxas held some instantiations to 56 or 128 registers and
// spilled 4-16 bytes.
template <typename QT, typename KT, bool PAGED, int RB>
struct Kernel;

#define CMN_DECODE_KERNEL(KIND, PAGED, QN, QT, KN, KT, RB)             \
  __global__ void __launch_bounds__(kThreads, 1)                       \
      decode_##KIND##_q##QN##_kv##KN##_rb##RB(const Params p) {        \
    decode_body<QT, KT, PAGED, RB>(p);                                 \
  }                                                                    \
  template <>                                                          \
  struct Kernel<QT, KT, PAGED, RB> {                                   \
    static KernelFn get() {                                            \
      return decode_##KIND##_q##QN##_kv##KN##_rb##RB;                  \
    }                                                                  \
  };
#define CMN_DECODE_KV(KIND, PAGED, QN, QT, RB)                         \
  CMN_DECODE_KERNEL(KIND, PAGED, QN, QT, f32, float, RB)               \
  CMN_DECODE_KERNEL(KIND, PAGED, QN, QT, bf16, __nv_bfloat16, RB)      \
  CMN_DECODE_KERNEL(KIND, PAGED, QN, QT, i8, int8_t, RB)
#define CMN_DECODE_Q(KIND, PAGED, RB)                                  \
  CMN_DECODE_KV(KIND, PAGED, f32, float, RB)                           \
  CMN_DECODE_KV(KIND, PAGED, bf16, __nv_bfloat16, RB)

CMN_DECODE_Q(paged, true, 1)
CMN_DECODE_Q(paged, true, 4)
CMN_DECODE_Q(fused, false, 1)
CMN_DECODE_Q(fused, false, 4)

template <typename QT, typename KT, bool PAGED, int RB>
int launch_typed(Params p, int rows_of, int splits, cudaStream_t stream) {
  p.nrb = (p.R + RB - 1) / RB;
  const size_t chunk_bytes = (size_t)p.chunk * p.Dh * sizeof(KT);
  const int per_warp = ((p.per + p.chunk - 1) / p.chunk + kWarps - 1) / kWarps;
  p.stages = std::max(
      1, std::min({kMaxStages, (int)(kRingBytes / (kWarps * 2 * chunk_bytes)),
                   per_warp}));
  const size_t smem = smem_bytes(p.stages, chunk_bytes, RB, p.Dh);
  if (smem > kSmemDefault) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, rows_of, p.KH * p.nrb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, Kernel<QT, KT, PAGED, RB>::get(), p);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

template <bool PAGED, typename QT>
int launch_kv(const Params& p, int rows_of, int splits, int kv_dtype,
              cudaStream_t stream) {
  const bool one = p.R == 1;
  switch (kv_dtype) {
    case kF32:
      return one ? launch_typed<QT, float, PAGED, 1>(p, rows_of, splits, stream)
                 : launch_typed<QT, float, PAGED, 4>(p, rows_of, splits,
                                                     stream);
    case kBF16:
      return one ? launch_typed<QT, __nv_bfloat16, PAGED, 1>(p, rows_of,
                                                             splits, stream)
                 : launch_typed<QT, __nv_bfloat16, PAGED, 4>(p, rows_of,
                                                             splits, stream);
    case kI8:
      return one ? launch_typed<QT, int8_t, PAGED, 1>(p, rows_of, splits,
                                                      stream)
                 : launch_typed<QT, int8_t, PAGED, 4>(p, rows_of, splits,
                                                      stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The plan the wrapper computed, checked against what the kernel assumes:
// lane groups of Dh / 8 that tile a warp, at most kMaxSplits splits that
// cover the n_max positions, whole chunks per split, and (paged) chunks
// inside one block and splits on block boundaries.
bool plan_ok(const Params& p, int splits, int n_max, bool paged) {
  const int lg = p.Dh / kElems;
  if (p.Dh % kElems || lg < 1 || lg > 32 || 32 % lg) return false;
  if (p.KH < 1 || p.H % p.KH) return false;
  if (splits < 1 || splits > kMaxSplits || p.chunk < 1 || p.per < p.chunk ||
      p.per % p.chunk || (long long)splits * p.per < n_max)
    return false;
  return !paged || (p.BL % p.chunk == 0 && p.per % p.BL == 0);
}

template <bool PAGED>
int launch(Params p, int rows_of, int splits, int q_dtype, int kv_dtype,
           cudaStream_t stream) {
  if (!plan_ok(p, splits, PAGED ? p.MB * p.BL : p.L, PAGED))
    return (int)cudaErrorInvalidValue;
  p.G = p.H / p.KH;
  p.R = p.T * p.G;
  p.scale = 1.0f / sqrtf((float)p.Dh);
  switch (q_dtype) {
    case kF32:
      return launch_kv<PAGED, float>(p, rows_of, splits, kv_dtype, stream);
    case kBF16:
      return launch_kv<PAGED, __nv_bfloat16>(p, rows_of, splits, kv_dtype,
                                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns the launch's cudaError_t (0 = launched).  splits, per and chunk
// are the wrapper's plan (ops/decode_attention.py `_plan`).
int cmn_paged_decode_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* valid, void* out, int S, int T,
                               int H, int KH, int Dh, int NB, int BL, int MB,
                               int q_dtype, int kv_dtype, int splits,
                               int per, int chunk, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.valid = static_cast<const int*>(valid);
  p.out = out;
  p.T = T;
  p.H = H;
  p.KH = KH;
  p.Dh = Dh;
  p.NB = NB;
  p.BL = BL;
  p.MB = MB;
  p.per = per;
  p.chunk = chunk;
  return launch<true>(p, S, splits, q_dtype, kv_dtype,
                      static_cast<cudaStream_t>(stream));
}

int cmn_fused_decode_attention(const void* q, const void* kc, const void* vc,
                               const void* k_scale, const void* v_scale,
                               const void* valid, void* out, int B, int H,
                               int KH, int L, int Dh, int q_dtype,
                               int kv_dtype, int splits, int per, int chunk,
                               void* stream) {
  Params p = {};
  p.q = q;
  p.k = kc;
  p.v = vc;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.valid = static_cast<const int*>(valid);
  p.out = out;
  p.T = 1;
  p.H = H;
  p.KH = KH;
  p.Dh = Dh;
  p.BL = 1;
  p.L = L;
  p.per = per;
  p.chunk = chunk;
  return launch<false>(p, B, splits, q_dtype, kv_dtype,
                       static_cast<cudaStream_t>(stream));
}

const char* cmn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
