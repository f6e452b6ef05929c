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
// Design.  Each CTA (four warps) owns one 64-row tile of one (batch, head)
// and loops over the tiles of the other side that the masks admit -- the
// loop takes the place of the TPU's sequential grid axis:
//   * forward: a q tile loops over kv tiles with an online softmax (running
//     max, normalizer, fp32 accumulator); writes O and the per-row
//     logsumexp;
//   * dK/dV: a kv tile loops over the q tiles of every query head of its
//     GQA group, accumulating dV += P^T dO and dK += dS^T q in fp32, and
//     writes per-kv-head gradients rounded once (no fp32 per-query-head
//     partials, no atomics: deterministic);
//   * dQ: a q tile loops over kv tiles accumulating dQ += dS K.
// bf16 inputs run on the tensor cores with everything about a warp's 16
// rows in registers (see the bf16 section); fp32 inputs run exact fp32 on
// the CUDA cores over shared-memory tiles of 32 rows.  Head dims 32, 64 and
// 128 are instantiated.  q, k, v and dO are read through (batch, seq,
// head) strides with a contiguous head dim, so the model's fused qkv
// projection needs no copy.
//
// One mask definition serves all three kernels (admitted() and the tile
// ranges below), as the Pallas kernels share _mask_scores/_k_block_range/
// _q_block_range: causal q >= k, window |q - k| < window, segment equality,
// and the ragged tails q < T, k < S (any T and S; the last tile is masked,
// not required to divide).  The tile ranges are transposes of each other
// and only skip tiles with no admitted pair.  Masked pairs contribute p = 0
// explicitly; a row with no admitted key keeps its max at NEG_INF and
// writes o = 0 and lse = NEG_INF (-1e30, finite on purpose); the backward
// gives p = 0 on rows whose lse is NEG_INF, so exp(NEG_INF - NEG_INF) = 1
// never reaches a sum.  The softmax scale 1/sqrt(D) multiplies the fp32
// scores (and dK, dQ at the end), equal to the reference's pre-scaled q up
// to fp32 rounding.
//
// Known limits, left for later work: products are mma.sync, not wgmma;
// tiles stream through cp.async double buffers, not TMA; dK/dV and dQ
// recompute the scores separately (two kernels, no atomics) as the
// reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// both 0 when unsegmented).  The one mask definition of all three kernels.
__device__ __forceinline__ bool admitted(const Params& p, int qp, int kp,
                                         int sq, int sk) {
  return qp < p.T && kp < p.S && (!p.causal || kp <= qp) &&
         (p.window <= 0 || (qp - kp < p.window && kp - qp < p.window)) &&
         sq == sk;
}

// [lo, hi) kv tiles that the q tile starting at q0 can attend (forward and
// dQ).  The transpose of q_tile_range; both skip only tiles in which no
// pair is admitted.
__device__ __forceinline__ void k_tile_range(const Params& p, int q0, int bt,
                                             int& lo, int& hi) {
  const int q_last = min(q0 + bt, p.T) - 1;
  int k_first = 0, k_last = p.S - 1;
  if (p.causal) k_last = min(k_last, q_last);
  if (p.window > 0) {
    k_first = max(k_first, q0 - p.window + 1);
    k_last = min(k_last, q_last + p.window - 1);
  }
  lo = k_first / bt;
  hi = k_last < k_first ? lo : k_last / bt + 1;
}

// [lo, hi) q tiles that can attend the kv tile starting at k0 (dK/dV).
__device__ __forceinline__ void q_tile_range(const Params& p, int k0, int bt,
                                             int& lo, int& hi) {
  const int k_last = min(k0 + bt, p.S) - 1;
  int q_first = 0, q_last = p.T - 1;
  if (p.causal) q_first = max(q_first, k0);
  if (p.window > 0) {
    q_first = max(q_first, k0 - p.window + 1);
    q_last = min(q_last, k_last + p.window - 1);
  }
  lo = q_first / bt;
  hi = q_last < q_first ? lo : q_last / bt + 1;
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
  k_tile_range(p, q0, kRows, lo, hi);
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
  q_tile_range(p, k0, kRows, lo, hi);
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
  k_tile_range(p, q0, kRows, lo, hi);
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
// The tensor-core path.  One warp owns 16 rows of its CTA's 64-row tile
// and keeps everything about them in registers: the operand fragments of
// its own rows, the 16 x 64 scores and probabilities, and its fp32
// accumulators (the FlashAttention-2 layout).  Shared memory holds only the
// tiles of the other side, read by ldmatrix; products are mma.sync
// m16n8k16 (bf16 operands, fp32 accumulation).  The score accumulators
// become the next product's A operand in place (probabilities and dS
// rounded to bf16 there).  Scores are kept in log2 units so that exp2 does
// the softmax.

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;  // rows per tile, both sides
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte asynchronous copy global -> shared; bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The asynchronous twin of load_rows for a 64-row bf16 tile.
template <int D>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld,
                                                const bf16* src,
                                                long long s_row, int row0,
                                                int limit) {
  constexpr int chunks = D / 8;
  for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
    const int r = i / chunks, c = i % chunks;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * ld + c * 8, ok ? src + (row0 + r) * s_row + c * 8 : src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A fragments of the 16 rows at `tile` (row-major, leading dim ld), for KS
// k-steps of 16 columns.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* tile,
                                       int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (lane & 15) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// c[16 x 8NT] += a[16 x 16KS] . b^T, where b is a tile of 8NT rows whose k
// axis is contiguous.
template <int KS, int NT>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4],
                                        const uint32_t (&a)[KS][4],
                                        const bf16* b, int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* p =
      b + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t r[4];
      ldsm_x4(r, p + np * 16 * ld + kk * 16);
      mma_bf16(c[2 * np], a[kk], r[0], r[1]);
      mma_bf16(c[2 * np + 1], a[kk], r[2], r[3]);
    }
  }
}

// c[16 x 8NT] += a[16 x 16KS] . b, where b is a tile of 16KS rows (k) whose
// n axis is contiguous.
template <int KS, int NT>
__device__ __forceinline__ void gemm_nn(float (&c)[NT][4],
                                        const uint32_t (&a)[KS][4],
                                        const bf16* b, int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* p = b + (lane & 15) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      ldsm_x4_t(r, p + kk * 16 * ld + np * 16);
      mma_bf16(c[2 * np], a[kk], r[0], r[1]);
      mma_bf16(c[2 * np + 1], a[kk], r[2], r[3]);
    }
  }
}

// A 16 x 64 tile held as accumulators, as the A operand of the next
// product (its 64 columns become k), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
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

// Whether admitted() holds for every pair of q rows [q0, q0 + 64) and kv
// rows [k0, k0 + 64): then the tile needs no mask work.
__device__ __forceinline__ bool tile_unmasked(const Params& p, int q0,
                                              int k0) {
  const int q1 = q0 + kTile - 1, k1 = k0 + kTile - 1;
  return p.seg_q == nullptr && q1 < p.T && k1 < p.S &&
         (!p.causal || k1 <= q0) &&
         (p.window <= 0 || (q1 - k0 < p.window && k1 - q0 < p.window));
}

// Dynamic shared memory of the bf16 kernels: `tiles` operand tiles of
// 64 x (D + 8), then two buffers of three 64-entry per-row arrays.
__host__ __device__ constexpr size_t bf16_smem(int tiles, int D) {
  return (size_t)tiles * kTile * (D + 8) * sizeof(bf16) +
         6 * kTile * sizeof(float);
}

// Element e of accumulator tile nt sits at row g (e < 2) or g + 8 and
// column nt * 8 + 2 * tig + (e & 1), g = lane / 4, tig = lane % 4.

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  constexpr int LD = D + 8, KS = D / 16, ND = D / 8, NS = kTile / 8;
  extern __shared__ __align__(128) char smem[];
  // Q, then two buffers of (K, V) tiles and of kv segment ids: the next
  // kv tile loads while the current one is used.
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + kTile * LD;  // buffer j: K at 2j, V at 2j + 1 tiles
  int* sks = reinterpret_cast<int*>(KVs + 4 * kTile * LD);

  const int nq = (p.T + kTile - 1) / kTile;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;  // longest rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bf16* Qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* Kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* Vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  load_rows<bf16, kTile, D>(Qs, LD, Qg, p.q_st, q0, p.T);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int sq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    sq[i] = (p.seg_q != nullptr && row[i] < p.T)
                ? p.seg_q[(size_t)b * p.T + row[i]]
                : 0;
  __syncthreads();
  uint32_t qa[KS][4];
  load_a<KS>(qa, Qs + warp * 16 * LD, LD);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
  zero(o);
  const float sl2 = p.scale * kLog2e;
  int lo, hi;
  k_tile_range(p, q0, kTile, lo, hi);
  auto stage = [&](int kt, int buf) {
    bf16* dst = KVs + 2 * buf * kTile * LD;
    load_rows_async<D>(dst, LD, Kg, p.k_st, kt * kTile, p.S);
    load_rows_async<D>(dst + kTile * LD, LD, Vg, p.v_st, kt * kTile, p.S);
    load_segments(sks + buf * kTile, p.seg_k, kt * kTile, p.S, b, kTile);
  };
  if (lo < hi) stage(lo, 0);
  cp_async_commit();
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTile, buf = (kt - lo) & 1;
    if (kt + 1 < hi) stage(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();     // ... everyone's
    const bf16* Ks = KVs + 2 * buf * kTile * LD;
    const bf16* Vs = Ks + kTile * LD;
    const int* sk = sks + buf * kTile;
    float s[NS][4];
    zero(s);
    gemm_nt<KS, NS>(s, qa, Ks, LD);
    const bool full = tile_unmasked(p, q0, k0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = nt * 8 + 2 * tig + (e & 1);
        float x = s[nt][e] * sl2;
        if (!full && !admitted(p, row[i], k0 + c, sq[i], sk[c])) x = kNegInf;
        s[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - m_new);  // 1 while nothing is admitted
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float pv =
            s[nt][e] > kNegInf * 0.5f ? exp2f(s[nt][e] - m[i]) : 0.f;
        l[i] += pv;
        s[nt][e] = pv;
      }
    }
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    uint32_t pa[4][4];
    acc_to_a(pa, s);
    gemm_nn<4, ND>(o, pa, Vs, LD);
    __syncthreads();  // every warp is done with this buffer before reuse
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(Params p) {
  constexpr int LD = D + 8, KS = D / 16, ND = D / 8, NS = kTile / 8;
  extern __shared__ __align__(128) char smem[];
  // q and dO, then two buffers of (K, V) tiles and of kv segment ids.
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kTile * LD;
  bf16* KVs = dOs + kTile * LD;
  int* sks = reinterpret_cast<int*>(KVs + 4 * kTile * LD);

  const int nq = (p.T + kTile - 1) / kTile;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bf16* Qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dOg =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* Kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* Vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  load_rows<bf16, kTile, D>(Qs, LD, Qg, p.q_st, q0, p.T);
  load_rows<bf16, kTile, D>(dOs, LD, dOg, p.do_st, q0, p.T);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int sq[2];
  bool live[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < p.T;
    const size_t off = ((size_t)b * p.H + h) * p.T + row[i];
    sq[i] = (p.seg_q != nullptr && in) ? p.seg_q[(size_t)b * p.T + row[i]]
                                       : 0;
    const float lse = in ? p.lse[off] : kNegInf;
    live[i] = lse > kNegInf * 0.5f;
    lse2[i] = lse * kLog2e;
    delta[i] = in ? p.delta[off] : 0.f;
  }
  float dq[ND][4];
  zero(dq);
  const float sl2 = p.scale * kLog2e;
  int lo, hi;
  k_tile_range(p, q0, kTile, lo, hi);
  auto stage = [&](int kt, int buf) {
    bf16* dst = KVs + 2 * buf * kTile * LD;
    load_rows_async<D>(dst, LD, Kg, p.k_st, kt * kTile, p.S);
    load_rows_async<D>(dst + kTile * LD, LD, Vg, p.v_st, kt * kTile, p.S);
    load_segments(sks + buf * kTile, p.seg_k, kt * kTile, p.S, b, kTile);
  };
  if (lo < hi) stage(lo, 0);
  cp_async_commit();
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTile, buf = (kt - lo) & 1;
    if (kt + 1 < hi) stage(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this kv tile (and, first time, q/dO) is in place
    const bf16* Ks = KVs + 2 * buf * kTile * LD;
    const bf16* Vs = Ks + kTile * LD;
    const int* sk = sks + buf * kTile;
    // The warp's q and dO fragments are re-read from shared memory each
    // tile rather than held across the loop (fewer live registers).
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    {
      uint32_t qa[KS][4];
      load_a<KS>(qa, Qs + warp * 16 * LD, LD);
      gemm_nt<KS, NS>(s, qa, Ks, LD);
    }
    {
      uint32_t da[KS][4];
      load_a<KS>(da, dOs + warp * 16 * LD, LD);
      gemm_nt<KS, NS>(dp, da, Vs, LD);
    }
    const bool full = tile_unmasked(p, q0, k0);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = nt * 8 + 2 * tig + (e & 1);
        const bool ok =
            live[i] && (full || admitted(p, row[i], k0 + c, sq[i], sk[c]));
        const float pv = ok ? exp2f(s[nt][e] * sl2 - lse2[i]) : 0.f;
        s[nt][e] = pv * (dp[nt][e] - delta[i]);  // dS
      }
    }
    uint32_t dsa[4][4];
    acc_to_a(dsa, s);
    gemm_nn<4, ND>(dq, dsa, Ks, LD);  // dQ += dS K
    __syncthreads();  // every warp is done with this buffer before reuse
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(Params p) {
  constexpr int LD = D + 8, KS = D / 16, ND = D / 8, NS = kTile / 8;
  extern __shared__ __align__(128) char smem[];
  // K and V, then two buffers of (q, dO) tiles and of the q rows' segment
  // ids, lse and delta: the next q tile loads while the current one is used.
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTile * LD;
  bf16* QDs = Vs + kTile * LD;  // buffer j: q at 2j, dO at 2j + 1 tiles
  int* rows_s = reinterpret_cast<int*>(QDs + 4 * kTile * LD);

  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int G = p.H / p.KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bf16* Kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* Vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  load_rows<bf16, kTile, D>(Ks, LD, Kg, p.k_st, k0, p.S);
  load_rows<bf16, kTile, D>(Vs, LD, Vg, p.v_st, k0, p.S);
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
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
  int lo, hi;
  q_tile_range(p, k0, kTile, lo, hi);
  // Iteration it visits q tile lo + it % nqt of the GQA group's query head
  // it / nqt: the group's heads in turn, their sum kept in fp32 and rounded
  // once at the end.
  const int nqt = hi - lo, total = G * nqt;
  auto stage = [&](int it, int buf) {
    const int h = kh * G + it / nqt, q0 = (lo + it % nqt) * kTile;
    bf16* dst = QDs + 2 * buf * kTile * LD;
    load_rows_async<D>(dst, LD,
                       static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
                       p.q_st, q0, p.T);
    load_rows_async<D>(dst + kTile * LD, LD,
                       static_cast<const bf16*>(p.dout) + b * p.do_sb +
                           h * p.do_sh,
                       p.do_st, q0, p.T);
    int* sq = rows_s + 3 * buf * kTile;
    float* lse = reinterpret_cast<float*>(sq + kTile);
    load_segments(sq, p.seg_q, q0, p.T, b, kTile);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int qp = q0 + i;
      const size_t off = ((size_t)b * p.H + h) * p.T + qp;
      lse[i] = qp < p.T ? p.lse[off] : kNegInf;
      lse[kTile + i] = qp < p.T ? p.delta[off] : 0.f;
    }
  };
  if (total > 0) stage(0, 0);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    const int q0 = (lo + it % nqt) * kTile, buf = it & 1;
    if (it + 1 < total) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this q tile is in place
    const bf16* Qs = QDs + 2 * buf * kTile * LD;
    const bf16* dOs = Qs + kTile * LD;
    const int* sq_s = rows_s + 3 * buf * kTile;
    const float* lse_s = reinterpret_cast<const float*>(sq_s + kTile);
    const float* delta_s = lse_s + kTile;
    // Transposed scores: rows are this warp's 16 keys, columns the 64 q.
    float st[NS][4], dpt[NS][4];
    zero(st);
    zero(dpt);
    {
      uint32_t ka[KS][4];
      load_a<KS>(ka, Ks + warp * 16 * LD, LD);
      gemm_nt<KS, NS>(st, ka, Qs, LD);   // S^T = K Q^T
    }
    {
      uint32_t va[KS][4];
      load_a<KS>(va, Vs + warp * 16 * LD, LD);
      gemm_nt<KS, NS>(dpt, va, dOs, LD);  // dP^T = V dO^T
    }
    const bool full = tile_unmasked(p, q0, k0);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = nt * 8 + 2 * tig + (e & 1);
        const float lse = lse_s[c];
        const bool ok =
            lse > kNegInf * 0.5f &&
            (full || admitted(p, q0 + c, key[i], sq_s[c], sk[i]));
        const float pv = ok ? exp2f(st[nt][e] * sl2 - lse * kLog2e) : 0.f;
        dpt[nt][e] = pv * (dpt[nt][e] - delta_s[c]);  // dS^T
        st[nt][e] = pv;                               // P^T
      }
    }
    uint32_t a[4][4];
    acc_to_a(a, st);
    gemm_nn<4, ND>(dv, a, dOs, LD);  // dV += P^T dO
    acc_to_a(a, dpt);
    gemm_nn<4, ND>(dk, a, Qs, LD);   // dK += dS^T q
    __syncthreads();  // every warp is done with this buffer before reuse
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
template <typename K>
int launch_one(K kernel, bool& opted_in, size_t smem, dim3 grid,
               const Params& p, cudaStream_t stream) {
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
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
                        dim3(nq, p.B * p.H), p, stream);
    case 1:
      return launch_one(flash_bwd_dkv_kernel<D>, opted_in[1], smem,
                        dim3(nk, p.B * p.KH), p, stream);
    case 2:
      return launch_one(flash_bwd_dq_kernel<D>, opted_in[2], smem,
                        dim3(nq, p.B * p.H), p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_bf16(int which, const Params& p, cudaStream_t stream) {
  static bool opted_in[3] = {false, false, false};
  const int nq = (p.T + kTile - 1) / kTile;
  const int nk = (p.S + kTile - 1) / kTile;
  switch (which) {
    case 0:
      return launch_one(flash_fwd_bf16<D>, opted_in[0], bf16_smem(5, D),
                        dim3(nq, p.B * p.H), p, stream);
    case 1:
      return launch_one(flash_bwd_dkv_bf16<D>, opted_in[1], bf16_smem(6, D),
                        dim3(nk, p.B * p.KH), p, stream);
    case 2:
      return launch_one(flash_bwd_dq_bf16<D>, opted_in[2], bf16_smem(6, D),
                        dim3(nq, p.B * p.H), p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_dim(int which, const Params& p, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case kF32: return launch_f32<D>(which, p, stream);
    case kBF16: return launch_bf16<D>(which, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// which: 0 forward (out = o, lse_out = lse), 1 dK/dV (out = dk, out2 = dv),
// 2 dQ (out = dq).  Strides are in elements; the head dim is contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
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
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
