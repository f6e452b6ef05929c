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
// sizeof(KT) bytes, i.e. about R flops per byte at bf16 -- two orders of
// magnitude under the ~295 flops/byte where the tensor cores would become
// the limit.  The least time is (K/V bytes the valid positions need) /
// 3.35 TB/s.
//
// Design.  One CTA per (slot or batch row, kv head), four warps.  The CTA
// walks only the positions its rows can attend (paged: through the last
// query row's causal bound valid + T - 1, capped at the block table; fused:
// [0, valid)), in tiles of 32 positions.  Each tile's K and V rows are read
// once with 16-byte loads at storage width (fp32, bf16 or int8), converted
// to fp32 in shared memory together with the int8 scales, and shared by all
// R = T * G query rows of the kv head: the G grouped heads (GQA) and the T
// offsets of a speculative verify chunk cost no extra K/V traffic.  Each
// warp owns up to four rows and folds each tile into their online-softmax
// state (running max, normalizer, fp32 accumulator) in registers; lane j
// scores position j of the tile, and each lane accumulates Dh / 32 output
// dims.  Block tables are read by the CTA itself (Hopper has no scalar
// prefetch).  Arithmetic follows the Pallas kernels: q is pre-scaled by
// 1/sqrt(Dh); int8 scores are multiplied by the k scale, and probabilities
// by the v scale after the normalizer has been summed; masked positions
// contribute exactly 0 (a fully masked row gives 0, never the
// exp(NEG_INF - NEG_INF) = 1 leak); the output is acc / max(l, 1e-30).
// The fused kernel with valid <= 0 reproduces the Pallas one-shot softmax
// over an all-NEG_INF row: every position weighs exp(0) = 1, so the output
// is the mean of v_scale * V over the whole panel.
//
// Known limits, left for later work: at the serving width (8 slots x 12 kv
// heads) the grid is 96 CTAs, fewer than the card's 132 SMs, and nothing
// splits a long sequence across CTAs (split-KV / flash-decoding); tile
// loads are not pipelined (no cp.async or TMA), so each tile waits for its
// loads; rows beyond 16 per CTA re-read the panel in a second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;
constexpr int kTile = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDimsPerLane = 4;  // Dh <= 128
constexpr float kNegInf = -1e30f;   // finite stand-in, as in the Pallas kernels

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
  int T, H, KH, Dh;
  int NB, BL, MB;         // paged pool geometry
  int L;                  // fused cache length
  float scale;            // 1 / sqrt(Dh)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_f(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename QT, typename KT, bool PAGED>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int Dh = p.Dh;
  const int ld = Dh + 1;  // padded row: lane j reading row j hits bank j
  float* k_sh = smem;
  float* v_sh = k_sh + kTile * ld;
  float* q_sh = v_sh + kTile * ld;
  float* ks_sh = q_sh + kRowsPerPass * Dh;
  float* vs_sh = ks_sh + kTile;

  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = p.H / p.KH;
  const int R = p.T * G;
  const int valid = p.valid[s];
  const bool quant = p.k_scale != nullptr;

  int n_pos;
  bool uniform = false;
  if (PAGED) {
    n_pos = min(valid + p.T - 1, p.MB * p.BL);
  } else {
    uniform = valid <= 0;
    n_pos = uniform ? p.L : min(valid, p.L);
  }
  n_pos = max(n_pos, 0);

  const QT* Q = static_cast<const QT*>(p.q);
  const KT* K = static_cast<const KT*>(p.k);
  const KT* V = static_cast<const KT*>(p.v);
  QT* O = static_cast<QT*>(p.out);
  constexpr int kElems = 16 / sizeof(KT);  // elements per 16-byte load
  const int chunks = Dh / kElems;

  for (int r0 = 0; r0 < R; r0 += kRowsPerPass) {
    for (int i = threadIdx.x; i < kRowsPerPass * Dh; i += kThreads) {
      const int r = r0 + i / Dh;
      float x = 0.f;
      if (r < R) {
        const int t = r / G, g = r % G;
        const size_t off =
            ((size_t)(s * p.T + t) * p.H + kh * G + g) * Dh + i % Dh;
        x = to_f(Q[off]) * p.scale;
      }
      q_sh[i] = x;
    }
    float m[kRowsPerWarp], l[kRowsPerWarp];
    float acc[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      m[rr] = kNegInf;
      l[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) acc[rr][i] = 0.f;
    }

    for (int p0 = 0; p0 < n_pos; p0 += kTile) {
      const int n = min(kTile, n_pos - p0);
      __syncthreads();  // q staged; the previous tile fully consumed
      for (int c = threadIdx.x; c < n * chunks; c += kThreads) {
        const int j = c / chunks, cc = c % chunks, pos = p0 + j;
        size_t row;
        if (PAGED) {
          const int blk = p.tables[s * p.MB + pos / p.BL];
          row = ((size_t)kh * p.NB + blk) * p.BL + pos % p.BL;
        } else {
          row = ((size_t)s * p.KH + kh) * p.L + pos;
        }
        const uint4 kraw = reinterpret_cast<const uint4*>(K + row * Dh)[cc];
        const uint4 vraw = reinterpret_cast<const uint4*>(V + row * Dh)[cc];
        const KT* ke = reinterpret_cast<const KT*>(&kraw);
        const KT* ve = reinterpret_cast<const KT*>(&vraw);
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          k_sh[j * ld + cc * kElems + e] = to_f(ke[e]);
          v_sh[j * ld + cc * kElems + e] = to_f(ve[e]);
        }
        if (cc == 0) {
          ks_sh[j] = quant ? p.k_scale[row] : 1.f;
          vs_sh[j] = quant ? p.v_scale[row] : 1.f;
        }
      }
      __syncthreads();

#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int rl = rr * kWarps + warp;
        const int r = r0 + rl;
        if (r >= R) break;  // uniform across the warp
        // Row r is query offset r / G: it attends positions < valid + r / G
        // (the verify chunk's causality; T == 1 is the plain decode bound).
        const bool ok =
            lane < n && (!PAGED || p0 + lane < valid + r / G);
        float sc = kNegInf;
        if (ok) {
          if (uniform) {
            sc = 0.f;
          } else {
            const float* qr = q_sh + rl * Dh;
            const float* kr = k_sh + lane * ld;
            float dot = 0.f;
            for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kr[d], dot);
            sc = dot * ks_sh[lane];
          }
        }
        const float m_new = fmaxf(m[rr], warp_max(sc));
        const float alpha = expf(m[rr] - m_new);
        float pr = ok ? expf(sc - m_new) : 0.f;
        l[rr] = alpha * l[rr] + warp_sum(pr);
        if (ok) pr *= vs_sh[lane];
#pragma unroll
        for (int i = 0; i < kMaxDimsPerLane; ++i) acc[rr][i] *= alpha;
        for (int j = 0; j < n; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pr, j);
          const float* vr = v_sh + j * ld;
#pragma unroll
          for (int i = 0; i < kMaxDimsPerLane; ++i) {
            const int d = lane + 32 * i;
            if (d < Dh) acc[rr][i] = fmaf(pj, vr[d], acc[rr][i]);
          }
        }
        m[rr] = m_new;
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = r0 + rr * kWarps + warp;
      if (r >= R) break;
      const int t = r / G, g = r % G;
      const float den = fmaxf(l[rr], 1e-30f);
      const size_t off = ((size_t)(s * p.T + t) * p.H + kh * G + g) * Dh;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) store_f(acc[rr][i] / den, O + off + d);
      }
    }
    __syncthreads();  // q_sh is restaged by the next pass
  }
}

template <bool PAGED, typename QT, typename KT>
void launch_typed(const Params& p, int grid_x, cudaStream_t stream) {
  const size_t smem =
      (2 * kTile * (p.Dh + 1) + kRowsPerPass * p.Dh + 2 * kTile) *
      sizeof(float);
  const dim3 grid(grid_x, p.KH);
  decode_attention_kernel<QT, KT, PAGED>
      <<<grid, kThreads, smem, stream>>>(p);
}

template <bool PAGED, typename QT>
int launch_kv(const Params& p, int grid_x, int kv_dtype,
              cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: launch_typed<PAGED, QT, float>(p, grid_x, stream); break;
    case kBF16:
      launch_typed<PAGED, QT, __nv_bfloat16>(p, grid_x, stream);
      break;
    case kI8: launch_typed<PAGED, QT, int8_t>(p, grid_x, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool PAGED>
int launch(const Params& p, int grid_x, int q_dtype, int kv_dtype,
           cudaStream_t stream) {
  if (p.Dh > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  switch (q_dtype) {
    case kF32: return launch_kv<PAGED, float>(p, grid_x, kv_dtype, stream);
    case kBF16:
      return launch_kv<PAGED, __nv_bfloat16>(p, grid_x, kv_dtype, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int cmn_paged_decode_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* valid, void* out, int S, int T,
                               int H, int KH, int Dh, int NB, int BL, int MB,
                               int q_dtype, int kv_dtype, void* stream) {
  Params p;
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
  p.L = 0;
  p.scale = 1.0f / sqrtf((float)Dh);
  return launch<true>(p, S, q_dtype, kv_dtype,
                      static_cast<cudaStream_t>(stream));
}

int cmn_fused_decode_attention(const void* q, const void* kc, const void* vc,
                               const void* k_scale, const void* v_scale,
                               const void* valid, void* out, int B, int H,
                               int KH, int L, int Dh, int q_dtype,
                               int kv_dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = kc;
  p.v = vc;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = nullptr;
  p.valid = static_cast<const int*>(valid);
  p.out = out;
  p.T = 1;
  p.H = H;
  p.KH = KH;
  p.Dh = Dh;
  p.NB = 0;
  p.BL = 1;
  p.MB = 0;
  p.L = L;
  p.scale = 1.0f / sqrtf((float)Dh);
  return launch<false>(p, B, q_dtype, kv_dtype,
                       static_cast<cudaStream_t>(stream));
}

const char* cmn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
