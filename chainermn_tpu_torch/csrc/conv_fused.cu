// Fused 1x1-conv + per-channel affine (+ ReLU) for Hopper (sm_90a), behind
// one plain C entry point (built with nvcc into a shared library and loaded
// with ctypes by chainermn_tpu_torch/ops/_kernels.py).
//
// Replaces the Pallas TPU kernel of chainermn_tpu/ops/conv_fused.py:
//   matmul_affine_bf16 / matmul_affine_f32 <- _fused_kernel (:42),
//   pallas_call :66 (launched by _matmul_affine_fwd_pallas :52).
//
// Computes out = relu?((x @ w) * scale + bias) for x (N, K) and w (K, C) in
// the compute dtype, scale and bias (C,) fp32, out (N, C) in the compute
// dtype: an NHWC 1x1 convolution seen as a (B*H*W, Cin) x (Cin, Cout)
// product, with the frozen-BN affine and the ReLU applied to the fp32
// accumulator before the one rounding to the output dtype -- exactly the
// Pallas body.
//
// What bounds it on an H100.  At the ResNet-50 shapes of the main path (N
// from 802,816 down to 12,544; K and C from 64 to 2048; bf16) the stage-1
// and stage-2 launches are bound by bytes (x read once and out written once
// dominate: e.g. (802816, 64, 256) moves 0.51 GB, 0.153 ms at 3.35 TB/s,
// against 0.027 ms of operations) and the stage-4 launches by operations
// (e.g. (12544, 2048, 512): 26 GFLOP, 0.027 ms at 989 TFLOP/s).  The design
// therefore (a) never writes the fp32 accumulator or an un-activated
// intermediate to device memory -- the epilogue runs on the registers -- and
// (b) stages the rounded output tile through shared memory so that every
// store to device memory is a coalesced 16-byte vector.
//
// Design.  bf16: each CTA (8 warps) owns a 128 x 128 output tile and walks
// K in steps of 32 through a 3-stage cp.async ring in shared memory; each
// warp computes 64 x 32 of the tile with mma.sync m16n8k16 (bf16 operands
// from ldmatrix, fp32 accumulators in registers).  fp32 (the agreement
// path): a 64 x 64 tile on the CUDA cores, exact fp32 fmaf, element loads.
// The TPU's (bm <= 512, bn <= 256) blocks were a VMEM answer and are not
// copied.  Ragged edges: tiles load zeros past N, K and C and stores are
// masked, so no dimension has to divide a tile.  Where a row of x or w is
// not 16-byte aligned (K or C not a multiple of 8, or an odd row stride)
// the loads fall back to element loads; the products are the same.
//
// Known limits, left for later work: mma.sync rather than wgmma, cp.async
// rather than TMA, one output tile per CTA (no persistent scheduling).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum DType { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* x;       // (N, K), row stride lda elements, unit column stride
  const void* w;       // (K, C) contiguous
  const float* scale;  // (C,)
  const float* bias;   // (C,)
  void* out;           // (N, C) contiguous
  long long N, lda;
  int K, C, relu;
  int a_vec, b_vec, o_vec;  // 16-byte vector access allowed for x, w, out
};

// ==================================================================== bf16
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kThreads = 256;             // 8 warps: 2 (rows) x 4 (columns)
constexpr int kLdA = kBK + 8;             // padded rows: ldmatrix without
constexpr int kLdB = kBN + 8;             // bank conflicts
constexpr int kLdC = kBN + 8;
constexpr int kStageA = kBM * kLdA;       // elements
constexpr int kStageB = kBK * kLdB;
constexpr size_t kSmemBf16 = sizeof(bf16) * kStages * (kStageA + kStageB);
static_assert(sizeof(bf16) * kBM * kLdC <= kSmemBf16,
              "the epilogue tile reuses the ring");

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

// Eight consecutive elements of row `row` starting at column `col` of a
// (rows, cols) matrix with row stride ld, into shared memory at dst; zeros
// past either edge.  vec: the row starts and col are 16-byte aligned and
// cols is a multiple of 8, so a chunk is wholly inside or wholly outside.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           long long row, long long rows,
                                           int col, int cols, long long ld,
                                           bool vec) {
  if (vec) {
    const bool ok = row < rows && col < cols;
    cp_async16(dst, ok ? src + row * ld + col : src, ok ? 16 : 0);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = (row < rows && col + e < cols) ? src[row * ld + col + e]
                                            : __float2bfloat16(0.f);
}

// K tile kt of the CTA's x rows [m0, m0 + 128) and w columns [n0, n0 + 128)
// into ring slot `slot`.
__device__ __forceinline__ void load_stage(const Params& p, bf16* As,
                                           bf16* Bs, long long m0, int n0,
                                           int kt) {
  const bf16* X = static_cast<const bf16*>(p.x);
  const bf16* W = static_cast<const bf16*>(p.w);
  const int k0 = kt * kBK;
#pragma unroll
  for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    load_chunk(As + r * kLdA + c, X, m0 + r, p.N, k0 + c, p.K, p.lda,
               p.a_vec);
  }
#pragma unroll
  for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    load_chunk(Bs + r * kLdB + c, W, k0 + r, p.K, n0 + c, p.C, p.C,
               p.b_vec);
  }
}

__global__ void __launch_bounds__(kThreads) matmul_affine_bf16(Params p) {
  extern __shared__ __align__(128) char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * kStageA;

  const int n_tiles = (p.C + kBN - 1) / kBN;
  // Column tiles of one row tile are neighbours in launch order, so the
  // x rows they share are still in L2.
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp's 64 x 32 sub-tile

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  const int KT = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(p, As + s * kStageA, Bs + s * kStageB, m0, n0, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; slot kt-1 is free
    const int nt = kt + kStages - 1;
    if (nt < KT) {
      const int s = nt % kStages;
      load_stage(p, As + s * kStageA, Bs + s * kStageB, m0, n0, nt);
    }
    cp_async_commit();
    const bf16* A = As + (kt % kStages) * kStageA;
    const bf16* B = Bs + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], A + (wm * 64 + mi * 16 + (lane & 15)) * kLdA +
                           kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, B + (kk * 16 + (lane & 15)) * kLdB + wn * 32 +
                         np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it

  // Epilogue on the accumulators: affine, ReLU, one rounding to bf16, into
  // a shared-memory tile.  Accumulator (r, c) of an m16n8 tile: c[0..1] at
  // row lane / 4, columns 2 (lane % 4) + {0, 1}; c[2..3] eight rows lower.
  bf16* Cs = As;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int cl = wn * 32 + ni * 8 + (lane & 3) * 2;
    const int gc = n0 + cl;
    const float s0 = gc < p.C ? p.scale[gc] : 0.f;
    const float s1 = gc + 1 < p.C ? p.scale[gc + 1] : 0.f;
    const float b0 = gc < p.C ? p.bias[gc] : 0.f;
    const float b1 = gc + 1 < p.C ? p.bias[gc + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int rl = wm * 64 + mi * 16 + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = acc[mi][ni][2 * h] * s0 + b0;
        float y1 = acc[mi][ni][2 * h + 1] * s1 + b1;
        if (p.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(Cs + (rl + 8 * h) * kLdC + cl) =
            pack_bf16(y0, y1);
      }
    }
  }
  __syncthreads();
  bf16* O = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = threadIdx.x; i < kBM * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const long long row = m0 + r;
    const int col = n0 + c;
    if (row >= p.N || col >= p.C) continue;
    const bf16* src = Cs + r * kLdC + c;
    bf16* dst = O + row * p.C + col;
    if (p.o_vec && col + 8 <= p.C) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && col + e < p.C; ++e) dst[e] = src[e];
    }
  }
}

// ==================================================================== fp32
// Exact fp32 on the CUDA cores: a 64 x 64 tile per CTA, 4 x 4 outputs per
// thread, K in steps of 16 through shared memory (A stored transposed so
// that a thread's four rows are one broadcast read).
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads) matmul_affine_f32(Params p) {
  __shared__ float As[kFK][kFM + 4];
  __shared__ float Bs[kFK][kFN + 4];
  const float* X = static_cast<const float*>(p.x);
  const float* W = static_cast<const float*>(p.w);
  const int n_tiles = (p.C + kFN - 1) / kFN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kFM;
  const int n0 = (blockIdx.x % n_tiles) * kFN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kFK) {
    for (int i = threadIdx.x; i < kFM * kFK; i += kThreads) {
      const int r = i / kFK, c = i % kFK;
      const long long row = m0 + r;
      As[c][r] = (row < p.N && k0 + c < p.K) ? X[row * p.lda + k0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kFK * kFN; i += kThreads) {
      const int r = i / kFN, c = i % kFN;
      Bs[r][c] = (k0 + r < p.K && n0 + c < p.C)
                     ? W[(long long)(k0 + r) * p.C + n0 + c]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* O = static_cast<float*>(p.out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    if (col >= p.C) continue;
    const float s = p.scale[col], b = p.bias[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = m0 + ty * 4 + i;
      if (row >= p.N) continue;
      float y = acc[i][j] * s + b;
      if (p.relu) y = fmaxf(y, 0.f);
      O[row * p.C + col] = y;
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" {

// out = relu?((x @ w) * scale + bias); dtype 0 fp32, 1 bf16 (x, w and out
// share it; scale and bias are fp32).  lda is x's row stride in elements.
// Returns cudaGetLastError() after the launch (0 = launched).
int cmn_matmul_affine(const void* x, const void* w, const void* scale,
                      const void* bias, void* out, long long N, int K, int C,
                      long long lda, int relu, int dtype, void* stream) {
  if (N <= 0 || C <= 0) return 0;  // nothing to write
  Params p;
  p.x = x;
  p.w = w;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.N = N;
  p.lda = lda;
  p.K = K;
  p.C = C;
  p.relu = relu;
  p.a_vec = aligned16(x) && lda % 8 == 0 && K % 8 == 0;
  p.b_vec = aligned16(w) && C % 8 == 0;
  p.o_vec = aligned16(out) && C % 8 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    // The shared-memory opt-in is made on the first launch only, so later
    // launches (inside a CUDA-graph capture, say) make no other call.
    static bool opted_in = false;
    if (!opted_in) {
      cudaError_t err = cudaFuncSetAttribute(
          matmul_affine_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kSmemBf16);
      if (err != cudaSuccess) return (int)err;
      opted_in = true;
    }
    const long long tiles = ((N + kBM - 1) / kBM) * ((C + kBN - 1) / kBN);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    matmul_affine_bf16<<<(unsigned)tiles, kThreads, kSmemBf16, st>>>(p);
  } else if (dtype == kF32) {
    const long long tiles = ((N + kFM - 1) / kFM) * ((C + kFN - 1) / kFN);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    matmul_affine_f32<<<(unsigned)tiles, kThreads, 0, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cmn_conv_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
