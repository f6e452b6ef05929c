// Flash attention for Hopper (sm_90a): the forward kernel and its two
// backward kernels, behind one plain C entry point (built with nvcc into a
// shared library and loaded with ctypes by
// chainermn_tpu_torch/ops/_kernels.py).
//
// Replaces the Pallas TPU kernels of chainermn_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     (which = 0) <- _fwd_kernel     (:191), pallas_call :409
//   flash_bwd_dkv_kernel (which = 1) <- _bwd_dkv_kernel (:427), pallas_call :595
//   flash_bwd_dq_kernel  (which = 2) <- _bwd_dq_kernel  (:493), pallas_call :678
//
// What bounds them on an H100: operations.  At the training path's shapes
// (B 8, H = KH 12, T = S 2048, D 64, bf16, causal) one forward launch does
// about 51.5 GFLOP (two T x T x D products over the causal half), the dK/dV
// kernel about 103 (four) and the dQ kernel about 77 (three, the score
// product recomputed): 0.052 / 0.104 / 0.078 ms at 989 TFLOP/s dense bf16.
// Their bytes (about 100 MB per forward launch: q, k, v, o once each) take
// about 0.03 ms at 3.35 TB/s, so the tensor cores, not the memory, are the
// limit.
//
// Design.  Each CTA owns one tile of one (batch, head) and loops over the
// tiles of the other side that the masks admit -- the loop takes the place
// of the TPU's sequential grid axis:
//   * forward: a q tile loops over kv tiles with an online softmax (running
//     max, normalizer, fp32 accumulator); writes O and the per-row
//     logsumexp;
//   * dK/dV: a kv tile loops over the q tiles of every query head of its
//     GQA group, accumulating dV += P^T dO and dK += dS^T q in fp32, and
//     writes per-kv-head gradients rounded once (no fp32 per-query-head
//     partials, no atomics: deterministic);
//   * dQ: a q tile loops over kv tiles accumulating dQ += dS K.
// fp32 inputs run exact fp32 on the CUDA cores over shared-memory tiles of
// 32 rows.  Head dims 32, 64 and 128 are instantiated.  q, k, v and dO are
// read through (batch, seq, head) strides with a contiguous head dim, so
// the model's fused qkv projection needs no copy.
//
// bf16: TMA-fed, warp-specialised wgmma (hopper.cuh), all three kernels.
// What held them back.  On an H100 SXM at 700 W an earlier design (four
// warps of mma.sync fed by ldmatrix from cp.async double buffers, two
// __syncthreads per tile) ran the forward and dK/dV at 11% and 15% of the
// operation bound and dQ at 18%:
// mma.sync cannot reach Hopper's tensor-core rate, and every warp spent its
// issue slots on copies and barriers.  Moving the products to wgmma alone
// gained 5%, because the work around them then set the pace: mask branches
// on every score of every tile, exp2f's denormal fix-ups, each tile's P.V
// waited for before the next tile's scores, and -- worst -- wgmmas that
// ptxas serialized (C7518) because a branch it could not prove
// warp-uniform (a barrier poll, a lane-0 arrive, the mask's short circuit)
// ran while a product was in flight.  The design:
//   * A CTA is three warpgroups.  One producer warp, its warpgroup cut to
//     40 registers by setmaxnreg, keeps a ring of up to four stages of
//     shared-memory tiles filled by TMA: 4-D tensor maps over
//     (D, heads, seq, batch) built from the wrapper's strides, so the
//     fused-qkv views load with no copy, GQA is the head coordinate and
//     rows past T or S arrive as zeros; mbarriers count the bytes.  It
//     copies the per-row segment ids (and, for dK/dV, -lse log2(e) and
//     delta) beside each tile.
//   * Two consumer warpgroups (232 registers each) run wgmma, each on a
//     64-row slice.  Forward: a 128-row q tile against kv tiles of 128
//     rows; S = Q K^T reads both operands from shared memory; P stays in
//     registers as the A operand of O += P V, with V read MN-major
//     (wgmma's transpose bit).  At D = 128 the kv tile stays 128: S (64
//     registers), O (64) and P (32) fit the register budget and three
//     stages of K and V fit shared memory.  K and V stages have barriers
//     of their own: K is released after the tile's softmax, V after its
//     P.V.  dK/dV: a 128-row kv tile against q tiles of 64 rows; S^T = K
//     Q^T and dP^T = V dO^T read shared memory; P^T and dS^T stay in
//     registers as the A operands of dV += P^T dO and dK += dS^T q, with
//     dO and q MN-major; dK and dV stay in fp32 registers and are rounded
//     once at the end.  dQ: K1's structure with one more product -- a
//     128-row q tile, whose q and dO tiles are loaded once, against kv
//     tiles of 128 rows (64 at D = 128, see DqSmem); S = Q K^T and dP = dO
//     V^T read shared memory; dS = P (dP - delta) stays in registers as
//     the A operand of dQ += dS K, with K read MN-major; dQ stays in fp32
//     registers, is scaled once and rounded once at the end; each CTA owns
//     its dQ tile, so there are no atomics.  Per-row lse and delta are read
//     once per consumer thread.
//   * Tile i's P.V (its dV/dK up to D = 64, its dS.K) runs while tile
//     i + 1's scores and elementwise work do.
//   * Only tiles that straddle the causal diagonal, a window edge, a
//     segment boundary or a ragged tail check admitted() per element; the
//     two cases are compiled apart.  The softmax scale folds into one FFMA
//     before ex2.approx.ftz (masked scores give exactly 0).
//   * The two consumer warpgroups take turns to issue their products
//     (named barriers; FlashAttention-3's ping-pong), so that one's softmax
//     runs while the other's products have the tensor cores.
//   * Every branch taken while a wgmma is in flight is warp-uniform (the
//     warpgroup index is broadcast by a shuffle, arrivals are predicated,
//     the mask is bitwise, loads are waited for before products issue, the
//     first tile is peeled off the loop), so ptxas keeps the wgmmas
//     asynchronous.
// Forward and dQ CTAs start with the longest causal rows of their head
// (the grid's x axis runs backwards, as FlashAttention-3's does); dK/dV's
// kv tile 0, which sees the most q tiles, comes first.
//
// One mask definition serves every kernel (admitted() and the tile ranges
// below), as the Pallas kernels share _mask_scores/_k_block_range/
// _q_block_range: causal q >= k, window |q - k| < window, segment equality,
// and the ragged tails q < T, k < S (any T and S; the last tile is masked,
// not required to divide).  The tile ranges are transposes of each other,
// take the q and kv tile sizes separately, and only skip tiles with no
// admitted pair.  Masked pairs contribute p = 0 explicitly; a row with no
// admitted key keeps its max at NEG_INF and writes o = 0 and lse = NEG_INF
// (-1e30, finite on purpose); the backward gives p = 0 on rows whose lse is
// NEG_INF, so exp(NEG_INF - NEG_INF) = 1 never reaches a sum.  The softmax
// scale 1/sqrt(D) multiplies the fp32 scores (and dK, dQ at the end), equal
// to the reference's pre-scaled q up to fp32 rounding.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // finite stand-in, as in the Pallas kernels

enum DType { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* q;       // (B, T, H, D) through q strides
  const void* k;       // (B, S, KH, D) through k strides
  const void* v;
  const void* dout;    // (B, T, H, D) through do strides (backward)
  const float* lse;    // (B, H, T) fp32 (backward)
  const float* delta;  // (B, H, T) fp32: rowsum(dO * O) - dlse (backward)
  const int* seg_q;    // (B, T) or null
  const int* seg_k;    // (B, S) or null (null exactly when seg_q is)
  void* out;           // fwd: o (B, T, H, D); dkv: dk (B, S, KH, D); dq: dq
  void* out2;          // dkv: dv (B, S, KH, D)
  float* lse_out;      // fwd: (B, H, T)
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  int B, T, S, H, KH;
  int causal, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------ the masks
// Whether query position qp may attend key position kp (segment ids sq, sk;
// both 0 when unsegmented).  The one mask definition of all three kernels;
// bitwise, not short-circuit, so that it compiles to predicates and not to
// branches (the wgmma kernels evaluate it while a product is in flight).
__device__ __forceinline__ bool admitted(const Params& p, int qp, int kp,
                                         int sq, int sk) {
  return (qp < p.T) & (kp < p.S) & (!p.causal | (kp <= qp)) &
         ((p.window <= 0) | ((qp - kp < p.window) & (kp - qp < p.window))) &
         (sq == sk);
}

// [lo, hi) kv tiles of bk rows that the q tile of bq rows starting at q0
// can attend (forward and dQ).  The transpose of q_tile_range; both skip
// only tiles in which no pair is admitted.
__device__ __forceinline__ void k_tile_range(const Params& p, int q0, int bq,
                                             int bk, int& lo, int& hi) {
  const int q_last = min(q0 + bq, p.T) - 1;
  int k_first = 0, k_last = p.S - 1;
  if (p.causal) k_last = min(k_last, q_last);
  if (p.window > 0) {
    k_first = max(k_first, q0 - p.window + 1);
    k_last = min(k_last, q_last + p.window - 1);
  }
  lo = k_first / bk;
  hi = k_last < k_first ? lo : k_last / bk + 1;
}

// [lo, hi) q tiles of bq rows that can attend the kv tile of bk rows
// starting at k0 (dK/dV).
__device__ __forceinline__ void q_tile_range(const Params& p, int k0, int bk,
                                             int bq, int& lo, int& hi) {
  const int k_last = min(k0 + bk, p.S) - 1;
  int q_first = 0, q_last = p.T - 1;
  if (p.causal) q_first = max(q_first, k0);
  if (p.window > 0) {
    q_first = max(q_first, k0 - p.window + 1);
    q_last = min(q_last, k_last + p.window - 1);
  }
  lo = q_first / bq;
  hi = q_last < q_first ? lo : q_last / bq + 1;
}

// Whether admitted() holds for every pair of q rows [q0, q0 + bq) and kv
// rows [k0, k0 + bk): then the tile needs no mask work.
__device__ __forceinline__ bool tile_unmasked(const Params& p, int q0, int bq,
                                              int k0, int bk) {
  const int q1 = q0 + bq - 1, k1 = k0 + bk - 1;
  return p.seg_q == nullptr && q1 < p.T && k1 < p.S &&
         (!p.causal || k1 <= q0) &&
         (p.window <= 0 || (q1 - k0 < p.window && k1 - q0 < p.window));
}

// ------------------------------------------------------- shared memory
__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t r = at;
  at += (bytes + 127) / 128 * 128;
  return r;
}

// The fp32 path: tiles of kRows rows on both sides.
constexpr int kRows = 32;

// Byte offsets of one fp32-path kernel's shared-memory buffers; the host
// sizes the launch with the same struct.  which: 0 fwd, 1 dK/dV, 2 dQ.
template <int D>
struct Smem {
  static constexpr int ldt = D + 8;      // operand tiles (q, k, v, dO)
  static constexpr int lds = kRows + 4;  // score tiles (S, dP)
  static constexpr int ldp = kRows + 8;  // probability tiles (P, dS)
  static constexpr int ldo = D + 4;      // accumulators (O, dK, dV, dQ)
  size_t q, k, v, dout, s, dp, p, ds, acc, acc2, r0, r1, r2, sq, sk, total;
  __host__ __device__ explicit Smem(int which) {
    size_t at = 0;
    q = take(at, sizeof(float) * kRows * ldt);
    k = take(at, sizeof(float) * kRows * ldt);
    v = take(at, sizeof(float) * kRows * ldt);
    dout = which ? take(at, sizeof(float) * kRows * ldt) : 0;
    s = take(at, sizeof(float) * kRows * lds);
    dp = which ? take(at, sizeof(float) * kRows * lds) : 0;
    p = take(at, sizeof(float) * kRows * ldp);
    ds = which ? take(at, sizeof(float) * kRows * ldp) : 0;
    acc = take(at, sizeof(float) * kRows * ldo);
    acc2 = which == 1 ? take(at, sizeof(float) * kRows * ldo) : 0;
    r0 = take(at, sizeof(float) * kRows);
    r1 = take(at, sizeof(float) * kRows);
    r2 = take(at, sizeof(float) * kRows);
    sq = take(at, sizeof(int) * kRows);
    sk = take(at, sizeof(int) * kRows);
    total = at;
  }
};

// Rows row0 .. row0 + BT of a (batch, head) slice whose row r starts at
// src + r * s_row, into dst (leading dim ld); rows >= limit become 0.
template <typename T, int BT, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long s_row, int row0,
                                          int limit) {
  constexpr int E = 16 / sizeof(T);
  constexpr int chunks = D / E;
  for (int i = threadIdx.x; i < BT * chunks; i += kThreads) {
    const int r = i / chunks, c = i % chunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * s_row + c * E);
    *reinterpret_cast<uint4*>(dst + r * ld + c * E) = val;
  }
}

__device__ __forceinline__ void load_segments(int* dst, const int* seg,
                                              int row0, int len, int b,
                                              int bt) {
  for (int i = threadIdx.x; i < bt; i += kThreads)
    dst[i] = (seg != nullptr && row0 + i < len)
                 ? seg[(size_t)b * len + row0 + i]
                 : 0;
}

// ------------------------------------------------------------ products
// C[m][n] (+)= sum_k A(m, k) B(k, n) over shared-memory tiles on the CUDA
// cores (the fp32 path), with A(m, k) = AT ? A[k * lda + m] : A[m * lda + k]
// and B(k, n) = BTR ? B[n * ldb + k] : B[k * ldb + n]; each thread owns
// output elements.
template <bool AT, bool BTR, int M, int N, int K>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A,
                                   int lda, const float* B, int ldb,
                                   bool acc) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, n = i % N;
    float s = acc ? C[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = AT ? A[k * lda + m] : A[m * lda + k];
      const float b = BTR ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// ------------------------------------------------------------- forward
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using L = Smem<D>;
  extern __shared__ __align__(128) char smem[];
  const L lay(0);
  float* Qs = reinterpret_cast<float*>(smem + lay.q);
  float* Ks = reinterpret_cast<float*>(smem + lay.k);
  float* Vs = reinterpret_cast<float*>(smem + lay.v);
  float* Ss = reinterpret_cast<float*>(smem + lay.s);
  float* Ps = reinterpret_cast<float*>(smem + lay.p);
  float* Os = reinterpret_cast<float*>(smem + lay.acc);
  float* m_s = reinterpret_cast<float*>(smem + lay.r0);
  float* l_s = reinterpret_cast<float*>(smem + lay.r1);
  float* a_s = reinterpret_cast<float*>(smem + lay.r2);
  int* sq = reinterpret_cast<int*>(smem + lay.sq);
  int* sk = reinterpret_cast<int*>(smem + lay.sk);

  const int nq = (p.T + kRows - 1) / kRows;
  // Longest causal rows first.
  const int q0 = (nq - 1 - (int)blockIdx.x) * kRows;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KH);
  const float* Qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* Kg = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* Vg = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows<float, kRows, D>(Qs, L::ldt, Qg, p.q_st, q0, p.T);
  load_segments(sq, p.seg_q, q0, p.T, b, kRows);
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < kRows * L::ldo; i += kThreads) Os[i] = 0.f;

  int lo, hi;
  k_tile_range(p, q0, kRows, kRows, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();  // the previous tile's P.V is done with K/V/P
    load_rows<float, kRows, D>(Ks, L::ldt, Kg, p.k_st, k0, p.S);
    load_rows<float, kRows, D>(Vs, L::ldt, Vg, p.v_st, k0, p.S);
    load_segments(sk, p.seg_k, k0, p.S, b, kRows);
    __syncthreads();
    mm<false, true, kRows, kRows, D>(Ss, L::lds, Qs, L::ldt, Ks, L::ldt,
                                     false);
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      const int qp = q0 + r;
      float sv[kRows / 32];
      bool ok[kRows / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kRows / 32; ++j) {
        const int c = lane + 32 * j;
        ok[j] = admitted(p, qp, k0 + c, sq[r], sk[c]);
        sv[j] = ok[j] ? Ss[r * L::lds + c] * p.scale : kNegInf;
        mx = fmaxf(mx, sv[j]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows / 32; ++j) {
        const int c = lane + 32 * j;
        const float e = ok[j] ? expf(sv[j] - m_new) : 0.f;
        sum += e;
        Ps[r * L::ldp + c] = e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 1 while nothing admitted
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
      const int r = i / D, d = i % D;
      Os[r * L::ldo + d] *= a_s[r];
    }
    __syncthreads();
    mm<false, false, kRows, D, kRows>(Os, L::ldo, Ps, L::ldp, Vs, L::ldt,
                                      true);
  }
  __syncthreads();

  float* Og = static_cast<float*>(p.out);
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, qp = q0 + r;
    if (qp >= p.T) continue;
    const bool alive = m_s[r] > kNegInf * 0.5f;
    const float l = fmaxf(l_s[r], 1e-30f);
    Og[(((size_t)b * p.T + qp) * p.H + h) * D + d] =
        alive ? Os[r * L::ldo + d] / l : 0.f;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int qp = q0 + r;
    if (qp >= p.T) continue;
    const bool alive = m_s[r] > kNegInf * 0.5f;
    p.lse_out[((size_t)b * p.H + h) * p.T + qp] =
        alive ? m_s[r] + logf(fmaxf(l_s[r], 1e-30f)) : kNegInf;
  }
}

// Scores of the staged q/dO tile against the staged k/v tile -> P and
// dS = P * (dP - delta), rows with lse = NEG_INF and masked pairs 0.
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    const Params& p, int q0, int k0, const float* Ss, const float* dPs,
    const float* lse_s, const float* delta_s, const int* sq, const int* sk,
    float* Ps, float* dSs) {
  using L = Smem<D>;
  for (int i = threadIdx.x; i < kRows * kRows; i += kThreads) {
    const int r = i / kRows, c = i % kRows;
    const float lse = lse_s[r];
    float pv = 0.f;
    if (lse > kNegInf * 0.5f && admitted(p, q0 + r, k0 + c, sq[r], sk[c]))
      pv = expf(Ss[r * L::lds + c] * p.scale - lse);
    const float ds = pv * (dPs[r * L::lds + c] - delta_s[r]);
    Ps[r * L::ldp + c] = pv;
    dSs[r * L::ldp + c] = ds;
  }
}

__device__ __forceinline__ void load_row_stats(const Params& p, int b, int h,
                                               int q0, float* lse_s,
                                               float* delta_s) {
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const int qp = q0 + i;
    const size_t off = ((size_t)b * p.H + h) * p.T + qp;
    lse_s[i] = qp < p.T ? p.lse[off] : kNegInf;
    delta_s[i] = qp < p.T ? p.delta[off] : 0.f;
  }
}

// --------------------------------------------------------- dK/dV kernel
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  using L = Smem<D>;
  extern __shared__ __align__(128) char smem[];
  const L lay(1);
  float* Qs = reinterpret_cast<float*>(smem + lay.q);
  float* Ks = reinterpret_cast<float*>(smem + lay.k);
  float* Vs = reinterpret_cast<float*>(smem + lay.v);
  float* dOs = reinterpret_cast<float*>(smem + lay.dout);
  float* Ss = reinterpret_cast<float*>(smem + lay.s);
  float* dPs = reinterpret_cast<float*>(smem + lay.dp);
  float* Ps = reinterpret_cast<float*>(smem + lay.p);
  float* dSs = reinterpret_cast<float*>(smem + lay.ds);
  float* dKs = reinterpret_cast<float*>(smem + lay.acc);
  float* dVs = reinterpret_cast<float*>(smem + lay.acc2);
  float* lse_s = reinterpret_cast<float*>(smem + lay.r0);
  float* delta_s = reinterpret_cast<float*>(smem + lay.r1);
  int* sq = reinterpret_cast<int*>(smem + lay.sq);
  int* sk = reinterpret_cast<int*>(smem + lay.sk);

  const int k0 = blockIdx.x * kRows;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int G = p.H / p.KH;
  const float* Kg = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* Vg = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;

  load_rows<float, kRows, D>(Ks, L::ldt, Kg, p.k_st, k0, p.S);
  load_rows<float, kRows, D>(Vs, L::ldt, Vg, p.v_st, k0, p.S);
  load_segments(sk, p.seg_k, k0, p.S, b, kRows);
  for (int i = threadIdx.x; i < kRows * L::ldo; i += kThreads) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }

  int lo, hi;
  q_tile_range(p, k0, kRows, kRows, lo, hi);
  // The GQA group's query heads in turn: their sum stays in fp32 and is
  // rounded once at the end.
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* Qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dOg =
        static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();  // the previous tile's products are done
      load_rows<float, kRows, D>(Qs, L::ldt, Qg, p.q_st, q0, p.T);
      load_rows<float, kRows, D>(dOs, L::ldt, dOg, p.do_st, q0, p.T);
      load_segments(sq, p.seg_q, q0, p.T, b, kRows);
      load_row_stats(p, b, h, q0, lse_s, delta_s);
      __syncthreads();
      mm<false, true, kRows, kRows, D>(Ss, L::lds, Qs, L::ldt, Ks, L::ldt,
                                       false);
      mm<false, true, kRows, kRows, D>(dPs, L::lds, dOs, L::ldt, Vs, L::ldt,
                                       false);
      __syncthreads();
      probs_and_dscores<D>(p, q0, k0, Ss, dPs, lse_s, delta_s, sq, sk, Ps,
                           dSs);
      __syncthreads();
      // dV[k][d] += sum_q P[q][k] dO[q][d];  dK[k][d] += sum_q dS[q][k] q[q][d]
      mm<true, false, kRows, D, kRows>(dVs, L::ldo, Ps, L::ldp, dOs, L::ldt,
                                       true);
      mm<true, false, kRows, D, kRows>(dKs, L::ldo, dSs, L::ldp, Qs, L::ldt,
                                       true);
    }
  }
  __syncthreads();

  float* dKg = static_cast<float*>(p.out);
  float* dVg = static_cast<float*>(p.out2);
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, kp = k0 + r;
    if (kp >= p.S) continue;
    const size_t off = (((size_t)b * p.S + kp) * p.KH + kh) * D + d;
    dKg[off] = dKs[r * L::ldo + d] * p.scale;
    dVg[off] = dVs[r * L::ldo + d];
  }
}

// ------------------------------------------------------------ dQ kernel
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  using L = Smem<D>;
  extern __shared__ __align__(128) char smem[];
  const L lay(2);
  float* Qs = reinterpret_cast<float*>(smem + lay.q);
  float* Ks = reinterpret_cast<float*>(smem + lay.k);
  float* Vs = reinterpret_cast<float*>(smem + lay.v);
  float* dOs = reinterpret_cast<float*>(smem + lay.dout);
  float* Ss = reinterpret_cast<float*>(smem + lay.s);
  float* dPs = reinterpret_cast<float*>(smem + lay.dp);
  float* Ps = reinterpret_cast<float*>(smem + lay.p);
  float* dSs = reinterpret_cast<float*>(smem + lay.ds);
  float* dQs = reinterpret_cast<float*>(smem + lay.acc);
  float* lse_s = reinterpret_cast<float*>(smem + lay.r0);
  float* delta_s = reinterpret_cast<float*>(smem + lay.r1);
  int* sq = reinterpret_cast<int*>(smem + lay.sq);
  int* sk = reinterpret_cast<int*>(smem + lay.sk);

  const int nq = (p.T + kRows - 1) / kRows;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kRows;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KH);
  const float* Qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dOg =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* Kg = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* Vg = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;

  load_rows<float, kRows, D>(Qs, L::ldt, Qg, p.q_st, q0, p.T);
  load_rows<float, kRows, D>(dOs, L::ldt, dOg, p.do_st, q0, p.T);
  load_segments(sq, p.seg_q, q0, p.T, b, kRows);
  load_row_stats(p, b, h, q0, lse_s, delta_s);
  for (int i = threadIdx.x; i < kRows * L::ldo; i += kThreads) dQs[i] = 0.f;

  int lo, hi;
  k_tile_range(p, q0, kRows, kRows, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_rows<float, kRows, D>(Ks, L::ldt, Kg, p.k_st, k0, p.S);
    load_rows<float, kRows, D>(Vs, L::ldt, Vg, p.v_st, k0, p.S);
    load_segments(sk, p.seg_k, k0, p.S, b, kRows);
    __syncthreads();
    mm<false, true, kRows, kRows, D>(Ss, L::lds, Qs, L::ldt, Ks, L::ldt,
                                     false);
    mm<false, true, kRows, kRows, D>(dPs, L::lds, dOs, L::ldt, Vs, L::ldt,
                                     false);
    __syncthreads();
    probs_and_dscores<D>(p, q0, k0, Ss, dPs, lse_s, delta_s, sq, sk, Ps,
                         dSs);
    __syncthreads();
    // dQ[q][d] += sum_k dS[q][k] K[k][d]
    mm<false, false, kRows, D, kRows>(dQs, L::ldo, dSs, L::ldp, Ks, L::ldt,
                                      true);
  }
  __syncthreads();

  float* dQg = static_cast<float*>(p.out);
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, qp = q0 + r;
    if (qp >= p.T) continue;
    dQg[(((size_t)b * p.T + qp) * p.H + h) * D + d] =
        dQs[r * L::ldo + d] * p.scale;
  }
}

// =================================================================== bf16
// The tensor-core path: warp-specialised wgmma kernels (see the head of
// this file).  Scores are kept in log2 units so that exp2 does the softmax;
// probabilities and dS are rounded to bf16 where they become the next
// product's A operand, in registers.

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using hopper::align_1024;
using hopper::pack_bf16;
using hopper::RingPos;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A 16 x 16KS tile held as accumulators, as the A operand of the next
// product (its 16KS columns become k), rounded to bf16 (hopper.cuh gives
// the layout).
template <int KS>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KS][4],
                                         const float (&c)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Element e of accumulator tile nt sits at row g (e < 2) or g + 8 and
// column nt * 8 + 2 * tig + (e & 1), g = lane / 4, tig = lane % 4.

// ------------------------------------------ warp-specialised wgmma
constexpr int kConsumers = 2;  // consumer warpgroups, 64 rows each
constexpr int kWsThreads = (kConsumers + 1) * 128;  // + the producer's
using hopper::kAlignSlack;
using hopper::kConsumerRegs;
using hopper::kProducerRegs;
using hopper::kSmemOptIn;

// The depth of a ring of `per_stage`-byte stages beside `fixed` bytes: as
// deep as shared memory allows, up to four.  (On an H100, two stages
// starved dK/dV, which holds one stage for its overlapped dV/dK while the
// next loads -- 35% slower; four and eight timed the same.)
constexpr int ring_depth(size_t fixed, size_t per_stage) {
  return hopper::ring_depth(fixed, per_stage, 4);
}

// How a bf16 tile with head dim D sits in shared memory (hopper.cuh): boxes
// of box_cols columns, each a run of `rows` swizzled rows of row_bytes.
template <int D>
struct Tiles {
  static constexpr int box_cols = D < 64 ? D : 64;
  static constexpr int boxes = D / box_cols;
  static constexpr uint32_t row_bytes = box_cols * sizeof(bf16);
  static constexpr uint32_t atom = 8 * row_bytes;  // eight swizzled rows
  static constexpr uint64_t swizzle =
      D < 64 ? hopper::kSwizzle64 : hopper::kSwizzle128;
};

// Descriptor of the K-major operand formed by the 64 rows from r0 of a
// tile of `rows` rows, at k step kk (columns 16kk .. 16kk + 15).
template <int D>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int rows, int r0,
                                           int kk) {
  using T = Tiles<D>;
  const int col = kk * 16;
  return hopper::make_desc(tile + (col / T::box_cols) * rows * T::box_cols +
                               r0 * T::box_cols + col % T::box_cols,
                           16, T::atom, T::swizzle);
}

// Descriptor of the MN-major operand formed by rows 16kk .. 16kk + 15 (the
// reduction axis) of a tile of `rows` rows, all D columns.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int rows,
                                            int kk) {
  using T = Tiles<D>;
  return hopper::make_desc(tile + kk * 16 * T::box_cols,
                           rows * T::row_bytes, T::atom, T::swizzle);
}

// Rows row0 .. row0 + rows of head `head` of batch b, through `map`, into
// a tile; rows * D * 2 bytes land on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int head,
                                          int row0, int b) {
  using T = Tiles<D>;
#pragma unroll
  for (int j = 0; j < T::boxes; ++j)
    hopper::tma_load_4d(dst + j * rows * T::box_cols, map, bar,
                        j * T::box_cols, head, row0, b);
}

// 2^x, one MUFU.EX2; x far below -126 gives +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The forward's online softmax over one tile of raw scores sc (rows row[],
// kv positions k0 + column): updates the running max m (log2 units) and
// normalizer l, leaves the tile's probabilities in sc and returns the
// factor alpha by which the accumulator must be rescaled.  kMasked: the
// tile straddles a mask edge, so every pair is checked with admitted();
// a masked score becomes exactly kNegInf and its probability exactly 0.
template <bool kMasked, int NS>
__device__ __forceinline__ void online_softmax(
    float (&sc)[NS][4], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const Params& p, const int (&row)[2], const int (&sq)[2], int k0,
    const int* sk, float sl2, int tig) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      if (kMasked) {
        const int c = nt * 8 + 2 * tig + (e & 1);
        if (!admitted(p, row[i], k0 + c, sq[i], sk[c])) sc[nt][e] = kNegInf;
      }
      mx[i] = fmaxf(mx[i], sc[nt][e]);
    }
  }
  float nm[2];  // -(the new max), the exponent's offset
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = quad_max(mx[i]);
    if (kMasked) t = t > kNegInf * 0.5f ? t * sl2 : kNegInf;
    else t *= sl2;
    const float m_new = fmaxf(m[i], t);
    alpha[i] = ex2(m[i] - m_new);  // 1 while nothing is admitted
    m[i] = m_new;
    l[i] *= alpha[i];
    nm[i] = -m_new;
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float pv = ex2(fmaf(sc[nt][e], sl2, nm[i]));
      if (kMasked && sc[nt][e] == kNegInf) pv = 0.f;
      l[i] += pv;
      sc[nt][e] = pv;
    }
  }
}

// dK/dV's elementwise work on one tile: st (S^T, raw) becomes P^T and dpt
// (dP^T) becomes dS^T = P^T * (dP^T - delta).  Columns are the tile's q
// rows, whose stats sit in shared memory: nl2_s holds -lse * log2(e) per
// row (kNegInf for a row whose lse is NEG_INF, so that its p is 0), dl_s
// its delta.
template <bool kMasked, int NS>
__device__ __forceinline__ void probs_and_dscores_t(
    float (&st)[NS][4], float (&dpt)[NS][4], const float* nl2_s,
    const float* dl_s, const Params& p, int q0, const int (&key)[2],
    const int (&sk)[2], const int* sq_s, float sl2, int tig) {
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    const int c0 = nt * 8 + 2 * tig;
    const float2 nl2 = *reinterpret_cast<const float2*>(nl2_s + c0);
    const float2 dl = *reinterpret_cast<const float2*>(dl_s + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, j = e & 1;
      float pv = ex2(fmaf(st[nt][e], sl2, j ? nl2.y : nl2.x));
      if (kMasked && !admitted(p, q0 + c0 + j, key[i], sq_s[c0 + j], sk[i]))
        pv = 0.f;
      dpt[nt][e] = pv * (dpt[nt][e] - (j ? dl.y : dl.x));
      st[nt][e] = pv;
    }
  }
}

// Byte offsets of the forward kernel's shared memory (from a 1024-aligned
// base; the launch adds kAlignSlack bytes for the alignment): the CTA's q
// tile, then a ring of K tiles, of V tiles and of their kv segment ids, and
// the barriers.  K and V have barriers of their own: a K stage is free
// once the tile's scores and softmax are done, its V stage only after
// the P.V product that runs during the next tile.
template <int D>
struct FwdSmem {
  static constexpr int BM = 64 * kConsumers;  // q rows per CTA
  static constexpr int BN = 128;              // kv rows per stage
  static constexpr size_t tile = BN * D * sizeof(bf16);
  static constexpr int stages =
      ring_depth(BM * D * sizeof(bf16) + 8, 2 * tile + BN * sizeof(int) + 32);
  static constexpr size_t q = 0;
  static constexpr size_t k = q + BM * D * sizeof(bf16);
  static constexpr size_t v = k + stages * tile;
  static constexpr size_t seg = v + stages * tile;
  static constexpr size_t bars = seg + stages * BN * sizeof(int);
  // q_full, k_full[stages], v_full[stages], k_empty[stages], v_empty[stages]
  static constexpr size_t total = bars + (1 + 4 * stages) * 8 + kAlignSlack;
  static_assert(stages >= 2 && total <= kSmemOptIn, "ring does not fit");
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = FwdSmem<D>;
  constexpr int BM = L::BM, BN = L::BN, ST = L::stages, KS = D / 16,
                ND = D / 8, NS = BN / 8;
  extern __shared__ char smem_raw[];
  char* smem = align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  int* sks = reinterpret_cast<int*>(smem + L::seg);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int nq = (p.T + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BM;  // longest rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KH);
  int lo, hi;
  k_tile_range(p, q0, BM, BN, lo, hi);
  const int n = hi - lo;
  const int wg = hopper::warpgroup_index(), warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&k_full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * kConsumers);  // consumer warps
      hopper::mbar_init(&v_empty[s], 4 * kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // The producer: one warp issues every load; the warpgroup's registers
    // go to the consumers.
    hopper::regs_release<kProducerRegs>();
    if (warp != 0 || n == 0) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(q_full, BM * D * sizeof(bf16));
      load_tile<D>(Qs, &tq, q_full, BM, h, q0, b);
    }
    RingPos<ST> r;
    for (int it = 0; it < n; ++it, r.next()) {
      const int k0 = (lo + it) * BN;
      hopper::mbar_wait(&k_empty[r.s], r.ph ^ 1);
      int* sk = sks + r.s * BN;
      for (int i = lane; i < BN; i += 32)
        sk[i] = (p.seg_k != nullptr && k0 + i < p.S)
                    ? p.seg_k[(size_t)b * p.S + k0 + i]
                    : 0;
      if (lane == 0) {
        hopper::mbar_expect_tx(&k_full[r.s], L::tile);
        load_tile<D>(Ks + r.s * BN * D, &tk, &k_full[r.s], BN, kh, k0, b);
      } else {
        hopper::mbar_arrive(&k_full[r.s]);  // this lane's segment ids are in
      }
      hopper::mbar_wait(&v_empty[r.s], r.ph ^ 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(&v_full[r.s], L::tile);
        load_tile<D>(Vs + r.s * BN * D, &tv, &v_full[r.s], BN, kh, k0, b);
      }
    }
    return;
  }

  // A consumer warpgroup: rows qw .. qw + 63 of the q tile.
  hopper::regs_claim<kConsumerRegs>();
  const int g = lane >> 2, tig = lane & 3;
  const int qw = q0 + 64 * wg;
  const int row[2] = {qw + warp * 16 + g, qw + warp * 16 + g + 8};
  int sq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    sq[i] = (p.seg_q != nullptr && row[i] < p.T)
                ? p.seg_q[(size_t)b * p.T + row[i]]
                : 0;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
  zero(o);
  const float sl2 = p.scale * kLog2e;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    hopper::mbar_arrive_if(bar, lane == 0);
  };
  // The loop below issues tile i's scores and tile i - 1's P.V together
  // and runs tile i's softmax while P.V does.  Its body has no branch on
  // whether a P.V is pending (tile 0 is peeled off): ptxas's analysis does
  // not see that two such branches agree, and on the path where they would
  // not, the rescale of O would touch a product in flight -- it then
  // serializes every wgmma (C7515).  A slice with no admitted pair in a
  // tile is computed like any other, its probabilities all 0.
  float sc[NS][4], alpha[2];
  uint32_t pa[BN / 16][4];  // P of the tile whose P.V is next
  auto scores = [&](int s) {
    zero(sc);
    hopper::fence_acc(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::wgmma_ss<0, 0>(sc, desc_k<D>(Qs, BM, 64 * wg, kk),
                             desc_k<D>(Ks + s * BN * D, BN, 0, kk), kk);
    hopper::wgmma_commit();
  };
  auto softmax = [&](int k0, int s) {  // S is done
    hopper::fence_acc(sc);
    const int* sk = sks + s * BN;
    if (tile_unmasked(p, qw, 64, k0, BN)) {
      online_softmax<false>(sc, m, l, alpha, p, row, sq, k0, sk, sl2, tig);
    } else {
      online_softmax<true>(sc, m, l, alpha, p, row, sq, k0, sk, sl2, tig);
    }
    release(&k_empty[s]);  // K and its segment ids are read
  };
  auto pv = [&](int s) {  // O += P V, V of stage s
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hopper::wgmma_rs<1>(o, pa[kk], desc_mn<D>(Vs + s * BN * D, BN, kk), 1);
    hopper::wgmma_commit();
  };
  // The two consumer warpgroups take turns to issue their products (named
  // barriers 1 and 2; FlashAttention-3's ping-pong), so that while one
  // runs its softmax the other's products have the tensor cores.
  // Warpgroup 0 goes first; warpgroup 1's last turn hands over to no one.
  auto my_turn = [&]() { hopper::named_sync(1 + wg, 256); };
  auto your_turn = [&]() { hopper::named_arrive(2 - wg, 256); };
  if (n > 0) {
    hopper::mbar_wait(q_full, 0);
    if (wg == 1) your_turn();
    RingPos<ST> r;
    hopper::mbar_wait(&k_full[0], 0);
    my_turn();
    scores(0);
    your_turn();
    hopper::wgmma_wait<0>();
    softmax(lo * BN, 0);  // O is still 0: no rescale
    acc_to_a(pa, sc);
    int prev = 0, prev_ph = 0;
    r.next();
    for (int it = 1; it < n; ++it, r.next()) {
      const int k0 = (lo + it) * BN;
      // Loads are waited for before products issue: a polling loop while
      // a wgmma is in flight is a divergent path.
      hopper::mbar_wait(&k_full[r.s], r.ph);
      hopper::mbar_wait(&v_full[prev], prev_ph);
      my_turn();
      scores(r.s);
      pv(prev);
      your_turn();
      hopper::wgmma_wait<1>();  // S is done; P.V may still run
      softmax(k0, r.s);
      hopper::wgmma_wait<0>();
      hopper::fence_acc(o);
      release(&v_empty[prev]);
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }
      acc_to_a(pa, sc);
      prev = r.s;
      prev_ph = r.ph;
    }
    hopper::mbar_wait(&v_full[prev], prev_ph);
    my_turn();
    pv(prev);
    if (wg == 0) your_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(o);
  }

  bf16* Og = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = fmaxf(quad_sum(l[i]), 1e-30f);
    const bool alive = m[i] > kNegInf * 0.5f;
    const float inv = alive ? 1.f / lt : 0.f;
    if (row[i] >= p.T) continue;
    bf16* orow = Og + (((size_t)b * p.T + row[i]) * p.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * tig) =
          pack_bf16(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    if (tig == 0)
      p.lse_out[((size_t)b * p.H + h) * p.T + row[i]] =
          alive ? m[i] * kLn2 + logf(lt) : kNegInf;
  }
}

// dQ's elementwise work on one tile: s (S, raw) gives P, and dp (dP)
// becomes dS = P * (dP - delta) in place.  Rows are the thread's two q
// rows, whose -lse log2(e) (kNegInf for a row whose lse is NEG_INF, so that
// its p is 0) and delta sit in registers; columns are the tile's kv
// positions, whose segment ids sit in shared memory.
template <bool kMasked, int NS>
__device__ __forceinline__ void probs_and_dscores_q(
    const float (&s)[NS][4], float (&dp)[NS][4], const float (&nl2)[2],
    const float (&dl)[2], const Params& p, const int (&row)[2],
    const int (&sq)[2], int k0, const int* sk, float sl2, int tig) {
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float pv = ex2(fmaf(s[nt][e], sl2, nl2[i]));
      if (kMasked) {
        const int c = nt * 8 + 2 * tig + (e & 1);
        if (!admitted(p, row[i], k0 + c, sq[i], sk[c])) pv = 0.f;
      }
      dp[nt][e] = pv * (dp[nt][e] - dl[i]);
    }
  }
}

// Byte offsets of the dQ kernel's shared memory (from a 1024-aligned base):
// the CTA's q and dO tiles, then a ring of K tiles, of V tiles and of their
// kv segment ids, and the barriers.  As in the forward, K and V stages have
// barriers of their own: a V stage is free once the tile's dP is done, its
// K stage only after the tile's dS.K product.
template <int D>
struct DqSmem {
  static constexpr int BM = 64 * kConsumers;  // q rows per CTA
  // kv rows per stage.  Up to D = 64, 128: S and dP are m64n128 products,
  // and S, dP (64 registers each), dQ (D / 2) and the 32 registers of the
  // dS fragments whose dS.K overlaps the next tile's scores fit the
  // 232-register budget.  At D = 128 dQ alone takes 64 registers; 64-row kv
  // tiles keep S and dP at 32 each and the fragments at 16, so the overlap
  // still fits, where 128-row tiles would need 224 registers of
  // accumulators and fragments alone.
  static constexpr int BN = D <= 64 ? 128 : 64;
  static constexpr size_t qtile = BM * D * sizeof(bf16);
  static constexpr size_t tile = BN * D * sizeof(bf16);
  static constexpr int stages =
      ring_depth(2 * qtile + 8, 2 * tile + BN * sizeof(int) + 32);
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + qtile;
  static constexpr size_t k = dout + qtile;
  static constexpr size_t v = k + stages * tile;
  static constexpr size_t seg = v + stages * tile;
  static constexpr size_t bars = seg + stages * BN * sizeof(int);
  // qd_full, k_full[stages], v_full[stages], k_empty[stages], v_empty[stages]
  static constexpr size_t total = bars + (1 + 4 * stages) * 8 + kAlignSlack;
  static_assert(stages >= 2 && total <= kSmemOptIn, "ring does not fit");
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const Params p) {
  using L = DqSmem<D>;
  constexpr int BM = L::BM, BN = L::BN, ST = L::stages, KS = D / 16,
                ND = D / 8, NS = BN / 8;
  extern __shared__ char smem_raw[];
  char* smem = align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  int* sks = reinterpret_cast<int*>(smem + L::seg);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* k_full = qd_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int nq = (p.T + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BM;  // longest rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KH);
  int lo, hi;
  k_tile_range(p, q0, BM, BN, lo, hi);
  const int n = hi - lo;
  const int wg = hopper::warpgroup_index(), warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&k_full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * kConsumers);  // consumer warps
      hopper::mbar_init(&v_empty[s], 4 * kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // The producer: one warp issues every load; the warpgroup's registers
    // go to the consumers.
    hopper::regs_release<kProducerRegs>();
    if (warp != 0 || n == 0) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(qd_full, 2 * L::qtile);
      load_tile<D>(Qs, &tq, qd_full, BM, h, q0, b);
      load_tile<D>(dOs, &tdo, qd_full, BM, h, q0, b);
    }
    RingPos<ST> r;
    for (int it = 0; it < n; ++it, r.next()) {
      const int k0 = (lo + it) * BN;
      hopper::mbar_wait(&k_empty[r.s], r.ph ^ 1);
      int* sk = sks + r.s * BN;
      for (int i = lane; i < BN; i += 32)
        sk[i] = (p.seg_k != nullptr && k0 + i < p.S)
                    ? p.seg_k[(size_t)b * p.S + k0 + i]
                    : 0;
      if (lane == 0) {
        hopper::mbar_expect_tx(&k_full[r.s], L::tile);
        load_tile<D>(Ks + r.s * BN * D, &tk, &k_full[r.s], BN, kh, k0, b);
      } else {
        hopper::mbar_arrive(&k_full[r.s]);  // this lane's segment ids are in
      }
      hopper::mbar_wait(&v_empty[r.s], r.ph ^ 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(&v_full[r.s], L::tile);
        load_tile<D>(Vs + r.s * BN * D, &tv, &v_full[r.s], BN, kh, k0, b);
      }
    }
    return;
  }

  // A consumer warpgroup: rows qw .. qw + 63 of the q tile.
  hopper::regs_claim<kConsumerRegs>();
  const int g = lane >> 2, tig = lane & 3;
  const int qw = q0 + 64 * wg;
  const int row[2] = {qw + warp * 16 + g, qw + warp * 16 + g + 8};
  int sq[2];
  float nl2[2], dl[2];  // -lse log2(e) (kNegInf on dead rows), delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < p.T;
    const size_t off = ((size_t)b * p.H + h) * p.T + row[i];
    sq[i] = (p.seg_q != nullptr && in) ? p.seg_q[(size_t)b * p.T + row[i]]
                                       : 0;
    const float lse = in ? p.lse[off] : kNegInf;
    nl2[i] = lse > kNegInf * 0.5f ? -lse * kLog2e : kNegInf;
    dl[i] = in ? p.delta[off] : 0.f;
  }
  float dq[ND][4];
  zero(dq);
  const float sl2 = p.scale * kLog2e;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    hopper::mbar_arrive_if(bar, lane == 0);
  };
  // As in the forward: the loop issues tile i's score products and tile
  // i - 1's dS.K together and runs tile i's elementwise work while dS.K
  // does, with no branch on whether a product is pending (tile 0 is peeled
  // off), and a slice with no admitted pair in a tile is computed like any
  // other, its dS all 0.
  float s[NS][4], dp[NS][4];
  uint32_t dsa[BN / 16][4];  // dS of the tile whose dS.K is next
  auto scores = [&](int st) {  // S = Q K^T, dP = dO V^T of stage st
    zero(s);
    zero(dp);
    hopper::fence_acc(s);
    hopper::fence_acc(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::wgmma_ss<0, 0>(s, desc_k<D>(Qs, BM, 64 * wg, kk),
                             desc_k<D>(Ks + st * BN * D, BN, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::wgmma_ss<0, 0>(dp, desc_k<D>(dOs, BM, 64 * wg, kk),
                             desc_k<D>(Vs + st * BN * D, BN, 0, kk), kk);
    hopper::wgmma_commit();
  };
  auto dscores = [&](int k0, int st) {  // the scores are done: dP -> dS
    hopper::fence_acc(s);
    hopper::fence_acc(dp);
    release(&v_empty[st]);  // V is read
    const int* sk = sks + st * BN;
    if (tile_unmasked(p, qw, 64, k0, BN)) {
      probs_and_dscores_q<false>(s, dp, nl2, dl, p, row, sq, k0, sk, sl2,
                                 tig);
    } else {
      probs_and_dscores_q<true>(s, dp, nl2, dl, p, row, sq, k0, sk, sl2,
                                tig);
    }
  };
  auto dsk = [&](int st) {  // dQ += dS K, K of stage st read MN-major
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hopper::wgmma_rs<1>(dq, dsa[kk], desc_mn<D>(Ks + st * BN * D, BN, kk),
                          1);
    hopper::wgmma_commit();
  };
  // The two consumer warpgroups take turns to issue their products (named
  // barriers 1 and 2; FlashAttention-3's ping-pong), so that while one
  // runs its elementwise work the other's products have the tensor cores.
  // Warpgroup 0 goes first; warpgroup 1's last turn hands over to no one.
  auto my_turn = [&]() { hopper::named_sync(1 + wg, 256); };
  auto your_turn = [&]() { hopper::named_arrive(2 - wg, 256); };
  if (n > 0) {
    hopper::mbar_wait(qd_full, 0);
    if (wg == 1) your_turn();
    RingPos<ST> r;
    hopper::mbar_wait(&k_full[0], 0);
    hopper::mbar_wait(&v_full[0], 0);
    my_turn();
    scores(0);
    your_turn();
    hopper::wgmma_wait<0>();
    dscores(lo * BN, 0);
    acc_to_a(dsa, dp);
    int prev = 0;
    r.next();
    for (int it = 1; it < n; ++it, r.next()) {
      const int k0 = (lo + it) * BN;
      // Loads are waited for before products issue: a polling loop while
      // a wgmma is in flight is a divergent path.
      hopper::mbar_wait(&k_full[r.s], r.ph);
      hopper::mbar_wait(&v_full[r.s], r.ph);
      my_turn();
      scores(r.s);
      dsk(prev);
      your_turn();
      hopper::wgmma_wait<1>();  // the scores are done; dS.K may still run
      dscores(k0, r.s);
      hopper::wgmma_wait<0>();
      hopper::fence_acc(dq);
      release(&k_empty[prev]);
      acc_to_a(dsa, dp);
      prev = r.s;
    }
    my_turn();
    dsk(prev);
    if (wg == 0) your_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dq);
  }

  bf16* dQg = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.T) continue;
    bf16* r = dQg + (((size_t)b * p.T + row[i]) * p.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
      *reinterpret_cast<uint32_t*>(r + dt * 8 + 2 * tig) =
          pack_bf16(dq[dt][2 * i] * p.scale, dq[dt][2 * i + 1] * p.scale);
  }
}

// Byte offsets of the dK/dV kernel's shared memory (from a 1024-aligned
// base): the CTA's K and V tiles, then a ring of q and dO tiles with the
// q rows' segment ids and stats, and the barriers.
template <int D>
struct DkvSmem {
  static constexpr int BK = 64 * kConsumers;  // kv rows per CTA
  static constexpr int BQ = 64;               // q rows per stage
  // Up to D = 64 a tile's dV/dK products overlap the next tile's scores
  // and elementwise work, which keeps a second set of P^T/dS^T fragments
  // live and releases each stage one tile later; at D = 128 dK and dV
  // alone take 128 registers and leave none for it.  (128-row q tiles
  // would widen the score products but spill; they ran 14% slower.)
  static constexpr bool overlap = D <= 64;
  static constexpr size_t tile = BQ * D * sizeof(bf16);
  // per stage: q and dO tiles; seg_q[BQ] (int), -lse log2(e)[BQ] and
  // delta[BQ] (fp32); two barriers
  static constexpr int stages =
      ring_depth(2 * BK * D * sizeof(bf16) + 8, 2 * tile + 3 * BQ * 4 + 16);
  static constexpr size_t k = 0;
  static constexpr size_t v = k + BK * D * sizeof(bf16);
  static constexpr size_t q = v + BK * D * sizeof(bf16);
  static constexpr size_t dout = q + stages * tile;
  static constexpr size_t rows = dout + stages * tile;
  static constexpr size_t bars = rows + stages * 3 * BQ * 4;
  // kv_full, full[stages], empty[stages]
  static constexpr size_t total = bars + (1 + 2 * stages) * 8 + kAlignSlack;
  static_assert(stages >= 2 && total <= kSmemOptIn, "ring does not fit");
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const Params p) {
  using L = DkvSmem<D>;
  constexpr int BK = L::BK, BQ = L::BQ, ST = L::stages, KS = D / 16,
                ND = D / 8, NS = BQ / 8;
  extern __shared__ char smem_raw[];
  char* smem = align_1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dout);
  int* rows_s = reinterpret_cast<int*>(smem + L::rows);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int G = p.H / p.KH;
  int lo, hi;
  q_tile_range(p, k0, BK, BQ, lo, hi);
  // Iteration it visits q tile lo + it % nqt of the GQA group's query head
  // it / nqt: the group's heads in turn, their sum kept in fp32 and rounded
  // once at the end.
  const int nqt = hi - lo, total = G * nqt;
  const int wg = hopper::warpgroup_index(), warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], 4 * kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    hopper::regs_release<kProducerRegs>();
    if (warp != 0 || total == 0) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * BK * D * sizeof(bf16));
      load_tile<D>(Ks, &tk, kv_full, BK, kh, k0, b);
      load_tile<D>(Vs, &tv, kv_full, BK, kh, k0, b);
    }
    RingPos<ST> r;
    for (int it = 0; it < total; ++it, r.next()) {
      const int h = kh * G + it / nqt, q0 = (lo + it % nqt) * BQ;
      hopper::mbar_wait(&empty[r.s], r.ph ^ 1);
      int* sq = rows_s + 3 * BQ * r.s;
      float* nl2 = reinterpret_cast<float*>(sq + BQ);
      for (int i = lane; i < BQ; i += 32) {
        const int qp = q0 + i;
        const bool in = qp < p.T;
        const size_t off = ((size_t)b * p.H + h) * p.T + qp;
        const float lse = in ? p.lse[off] : kNegInf;
        sq[i] = (p.seg_q != nullptr && in) ? p.seg_q[(size_t)b * p.T + qp]
                                           : 0;
        nl2[i] = lse > kNegInf * 0.5f ? -lse * kLog2e : kNegInf;
        nl2[BQ + i] = in ? p.delta[off] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[r.s], 2 * L::tile);
        load_tile<D>(Qs + r.s * BQ * D, &tq, &full[r.s], BQ, h, q0, b);
        load_tile<D>(dOs + r.s * BQ * D, &tdo, &full[r.s], BQ, h, q0, b);
      } else {
        hopper::mbar_arrive(&full[r.s]);
      }
    }
    return;
  }

  // A consumer warpgroup: kv rows kw .. kw + 63 of the CTA's tile.
  hopper::regs_claim<kConsumerRegs>();
  const int g = lane >> 2, tig = lane & 3;
  const int kw = k0 + 64 * wg;
  const int key[2] = {kw + warp * 16 + g, kw + warp * 16 + g + 8};
  int sk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    sk[i] = (p.seg_k != nullptr && key[i] < p.S)
                ? p.seg_k[(size_t)b * p.S + key[i]]
                : 0;
  float dk[ND][4], dv[ND][4];
  zero(dk);
  zero(dv);
  const float sl2 = p.scale * kLog2e;
  // As in the forward, the overlapped loop issues tile i's score products
  // and tile i - 1's dV/dK together, with no branch on whether a product
  // is pending (tile 0 is peeled off), and a slice with no admitted pair
  // in a tile is computed like any other.
  // Transposed scores: rows are this warpgroup's 64 keys, columns the
  // tile's q rows.
  float st[NS][4], dpt[NS][4];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T, dS^T of the next dV/dK
  auto scores = [&](int s) {
    zero(st);
    zero(dpt);
    hopper::fence_acc(st);
    hopper::fence_acc(dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)  // S^T = K Q^T
      hopper::wgmma_ss<0, 0>(st, desc_k<D>(Ks, BK, 64 * wg, kk),
                             desc_k<D>(Qs + s * BQ * D, BQ, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)  // dP^T = V dO^T
      hopper::wgmma_ss<0, 0>(dpt, desc_k<D>(Vs, BK, 64 * wg, kk),
                             desc_k<D>(dOs + s * BQ * D, BQ, 0, kk), kk);
    hopper::wgmma_commit();
  };
  auto probs = [&](int it, int s) {  // the scores are done: P^T, dS^T
    hopper::fence_acc(st);
    hopper::fence_acc(dpt);
    const int q0 = (lo + it % nqt) * BQ;
    const int* sq_s = rows_s + 3 * BQ * s;
    const float* nl2_s = reinterpret_cast<const float*>(sq_s + BQ);
    if (tile_unmasked(p, q0, BQ, kw, 64)) {
      probs_and_dscores_t<false>(st, dpt, nl2_s, nl2_s + BQ, p, q0, key, sk,
                                 sq_s, sl2, tig);
    } else {
      probs_and_dscores_t<true>(st, dpt, nl2_s, nl2_s + BQ, p, q0, key, sk,
                                sq_s, sl2, tig);
    }
  };
  auto grads = [&](int s) {  // dV += P^T dO, dK += dS^T q of stage s
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::wgmma_rs<1>(dv, pa[kk], desc_mn<D>(dOs + s * BQ * D, BQ, kk),
                          1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::wgmma_rs<1>(dk, da[kk], desc_mn<D>(Qs + s * BQ * D, BQ, kk), 1);
    hopper::wgmma_commit();
  };
  auto retire = [&](int s) {  // every product is done; stage s is free
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dv);
    hopper::fence_acc(dk);
    __syncwarp();
    hopper::mbar_arrive_if(&empty[s], lane == 0);
  };
  // The two consumer warpgroups take turns to issue their products (named
  // barriers 1 and 2; FlashAttention-3's ping-pong), so that while one
  // runs its softmax the other's products have the tensor cores.
  // Warpgroup 0 goes first; warpgroup 1's last turn hands over to no one.
  auto my_turn = [&]() { hopper::named_sync(1 + wg, 256); };
  auto your_turn = [&]() { hopper::named_arrive(2 - wg, 256); };
  if (total > 0) {
    hopper::mbar_wait(kv_full, 0);
    if (wg == 1) your_turn();
    RingPos<ST> r;
    if constexpr (L::overlap) {
      hopper::mbar_wait(&full[0], 0);
      my_turn();
      scores(0);
      your_turn();
      hopper::wgmma_wait<0>();
      probs(0, 0);
      acc_to_a(pa, st);
      acc_to_a(da, dpt);
      int prev = 0;
      r.next();
      for (int it = 1; it < total; ++it, r.next()) {
        hopper::mbar_wait(&full[r.s], r.ph);
        my_turn();
        scores(r.s);
        grads(prev);
        your_turn();
        hopper::wgmma_wait<1>();  // the scores are done; dV/dK may run
        probs(it, r.s);
        retire(prev);
        acc_to_a(pa, st);
        acc_to_a(da, dpt);
        prev = r.s;
      }
      my_turn();
      grads(prev);
      if (wg == 0) your_turn();
      retire(prev);
    } else {
      for (int it = 0; it < total; ++it, r.next()) {
        hopper::mbar_wait(&full[r.s], r.ph);
        my_turn();
        scores(r.s);
        your_turn();
        hopper::wgmma_wait<0>();
        probs(it, r.s);
        acc_to_a(pa, st);
        acc_to_a(da, dpt);
        my_turn();
        grads(r.s);
        if (wg == 0 || it + 1 < total) your_turn();
        retire(r.s);
      }
    }
  }

  bf16* dKg = static_cast<bf16*>(p.out);
  bf16* dVg = static_cast<bf16*>(p.out2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.S) continue;
    const size_t off = (((size_t)b * p.S + key[i]) * p.KH + kh) * D;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      const int c = dt * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(dKg + off + c) =
          pack_bf16(dk[dt][2 * i] * p.scale, dk[dt][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dVg + off + c) =
          pack_bf16(dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

// -------------------------------------------------------------- launch
// The shared-memory opt-in is set on a kernel's first launch only, so
// later launches (for example inside a CUDA-graph capture) make no call
// but the launch itself.
template <typename K, typename... Args>
int launch_one(K kernel, bool& opted_in, size_t smem, dim3 grid, int threads,
               cudaStream_t stream, const Args&... args) {
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(int which, const Params& p, cudaStream_t stream) {
  static bool opted_in[3] = {false, false, false};
  const size_t smem = Smem<D>(which).total;
  const int nq = (p.T + kRows - 1) / kRows;
  const int nk = (p.S + kRows - 1) / kRows;
  switch (which) {
    case 0:
      return launch_one(flash_fwd_kernel<D>, opted_in[0], smem,
                        dim3(nq, p.B * p.H), kThreads, stream, p);
    case 1:
      return launch_one(flash_bwd_dkv_kernel<D>, opted_in[1], smem,
                        dim3(nk, p.B * p.KH), kThreads, stream, p);
    case 2:
      return launch_one(flash_bwd_dq_kernel<D>, opted_in[2], smem,
                        dim3(nq, p.B * p.H), kThreads, stream, p);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The TMA tensor maps of one launch: 4-D over (D, heads, seq, batch).
struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int D>
int launch_bf16(int which, const Params& p, const Maps& m,
                cudaStream_t stream) {
  static bool opted_in[3] = {false, false, false};
  switch (which) {
    case 0: {
      using L = FwdSmem<D>;
      return launch_one(flash_fwd_bf16<D>, opted_in[0], L::total,
                        dim3((p.T + L::BM - 1) / L::BM, p.B * p.H),
                        kWsThreads, stream, m.q, m.k, m.v, p);
    }
    case 1: {
      using L = DkvSmem<D>;
      return launch_one(flash_bwd_dkv_bf16<D>, opted_in[1], L::total,
                        dim3((p.S + L::BK - 1) / L::BK, p.B * p.KH),
                        kWsThreads, stream, m.q, m.k, m.v, m.dout, p);
    }
    case 2: {
      using L = DqSmem<D>;
      return launch_one(flash_bwd_dq_bf16<D>, opted_in[2], L::total,
                        dim3((p.T + L::BM - 1) / L::BM, p.B * p.H),
                        kWsThreads, stream, m.q, m.k, m.v, m.dout, p);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The map of a bf16 (B, len, heads, D) tensor read through element strides
// (sb, st, sh), in boxes of `rows` rows and min(D, 64) columns, with the
// swizzle that the wgmma descriptors assume (hopper.cuh).  0, or an error
// code.
int encode_map(CUtensorMap* map, const void* base, int D, int heads, int len,
               int B, long long sb, long long st, long long sh, int rows) {
  hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return hopper::kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(D < 64 ? D : 64), 1,
                             (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // rows past len read as 0
  return r == CUDA_SUCCESS ? 0 : hopper::kEncodeError + (int)r;
}

// Encodes the maps that kernel `which` reads, in the boxes of its tiles
// (forward: q in 128-row boxes, k and v in 128; dK/dV: q and dO in 64, k
// and v in 128; dQ: q and dO in 128, k and v in DqSmem<D>::BN).
template <int D>
int encode_maps(int which, const Params& p, Maps& m) {
  const int q_rows = which == 0   ? FwdSmem<D>::BM
                     : which == 1 ? DkvSmem<D>::BQ
                                  : DqSmem<D>::BM;
  const int kv_rows = which == 0   ? FwdSmem<D>::BN
                      : which == 1 ? DkvSmem<D>::BK
                                   : DqSmem<D>::BN;
  int rc = encode_map(&m.q, p.q, D, p.H, p.T, p.B, p.q_sb, p.q_st, p.q_sh,
                      q_rows);
  if (!rc)
    rc = encode_map(&m.k, p.k, D, p.KH, p.S, p.B, p.k_sb, p.k_st, p.k_sh,
                    kv_rows);
  if (!rc)
    rc = encode_map(&m.v, p.v, D, p.KH, p.S, p.B, p.v_sb, p.v_st, p.v_sh,
                    kv_rows);
  if (!rc && which != 0)
    rc = encode_map(&m.dout, p.dout, D, p.H, p.T, p.B, p.do_sb, p.do_st,
                    p.do_sh, q_rows);
  return rc;
}

template <int D>
int launch_dim(int which, const Params& p, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case kF32:
      return launch_f32<D>(which, p, stream);
    case kBF16: {
      if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
      Maps m;
      const int rc = encode_maps<D>(which, p, m);
      if (rc) return rc;
      return launch_bf16<D>(which, p, m, stream);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// which: 0 forward (out = o, lse_out = lse), 1 dK/dV (out = dk, out2 = dv),
// 2 dQ (out = dq).  Strides are in elements; the head dim is contiguous.
// The bf16 kernels read q, k, v and dO through TMA, which takes a base and
// strides that are multiples of 16 bytes (the wrapper makes other inputs
// contiguous).  Returns 0 when launched, else cudaGetLastError() after the
// launch or hopper::kEncodeError + the CUresult of a refused tensor map.
int cmn_flash_attention(int which, const void* q, const void* k,
                        const void* v, const void* dout, const void* lse,
                        const void* delta, const void* seg_q,
                        const void* seg_k, void* out, void* out2,
                        void* lse_out, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_st,
                        long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, long long do_sb, long long do_st,
                        long long do_sh, int B, int T, int S, int H, int KH,
                        int D, int causal, int window, float scale,
                        int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.out = out;
  p.out2 = out2;
  p.lse_out = static_cast<float*>(lse_out);
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.do_sb = do_sb;
  p.do_st = do_st;
  p.do_sh = do_sh;
  p.B = B;
  p.T = T;
  p.S = S;
  p.H = H;
  p.KH = KH;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  if (T <= 0 || S <= 0 || B <= 0) return 0;  // nothing to do
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dim<32>(which, p, dtype, st);
    case 64: return launch_dim<64>(which, p, dtype, st);
    case 128: return launch_dim<128>(which, p, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cmn_flash_error_string(int code) {
  if (code >= hopper::kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - "
           "100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
