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
// (e.g. (12544, 2048, 512): 26 GFLOP, 0.027 ms at 989 TFLOP/s).  So the
// kernel never writes the fp32 accumulator or an un-activated intermediate
// to device memory -- the epilogue runs on the registers -- and keeps loads
// in flight while it computes and stores.
//
// What held the earlier design back (one 128 x 128 tile per CTA of eight
// mma.sync warps fed by ldmatrix from a 3-stage cp.async ring): 52-65% of
// the byte bound at 56 x 56, 20-33% of the operation bound at 14 x 14 and
// 7 x 7 on an H100 SXM at 700 W.  At Cin = 64 the whole reduction is one
// step, so a CTA paid its load latency and its store once per tile with
// nothing to overlap them; at the large Cin mma.sync cannot reach Hopper's
// tensor-core rate.
//
// Design (bf16):
//   * Persistent CTAs, one per SM, walk the output tiles of 128 rows by BN
//     columns in a static order (tile t = row block t / ncol, column tile
//     t % ncol): the column tiles of one row block run side by side on
//     neighbouring CTAs, so x is read from device memory once.
//   * One producer warp (its warpgroup cut to 40 registers by setmaxnreg)
//     keeps a ring of up to six stages filled by TMA: per stage 64 columns
//     of the reduction -- a 128 x 64 tile of x (K-major: 2-D tensor map over
//     (Cin, N) with x's row stride) and a 64 x BN tile of w (MN-major, in
//     boxes of 64 columns).  It runs on into the next tiles' loads while
//     the consumers finish a tile, so at Cin = 64 (one stage per tile) the
//     loads of the following tiles are in flight during each epilogue.
//     Rows past N and columns past Cin or Cout arrive as zeros.
//   * Two consumer warpgroups (232 registers each) each own 64 rows of the
//     tile: wgmma m64nBNk16 from shared memory, fp32 accumulators in
//     registers (BN / 2 per thread).  Every load is waited for with no
//     product in flight, so ptxas keeps the wgmmas asynchronous.
//   * Epilogue on the accumulators: scale and bias per column, the ReLU,
//     one rounding to bf16 into a 128-byte-swizzled shared-memory tile per
//     warpgroup (conflict-free 4-byte writes), stored by TMA (rows past N
//     and columns past Cout are clipped).  Before a warpgroup rewrites its
//     tile it waits only until the previous store has read it.
//   * Column tile BN: 64 at Cout <= 64 (ResNet-50's stage-1 fc1), else 128.
//     A wider tile would read x fewer times from L2, but x is served from
//     L2 for every column tile after the first, and 128 leaves room for six
//     ring stages beside the output tile (a 256-column tile would take 64
//     KB of output tile and 48 KB a stage).
// The TPU's (bm <= 512, bn <= 256) blocks were a VMEM answer and are not
// copied.  TMA takes bases and row strides that are multiples of 16 bytes,
// so the wrapper pads other inputs (a Cin or Cout that is not a multiple of
// 8, an unaligned view); no main-path shape needs it.
//
// fp32 (the agreement path): a 64 x 64 tile on the CUDA cores, exact fp32
// fmaf, element loads, any shape.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
};

// ==================================================================== bf16
constexpr int kBM = 128;  // output rows per tile: 64 per consumer warpgroup
constexpr int kBK = 64;   // reduction columns per stage: one 128-byte row
constexpr int kBox = 64;  // columns per TMA box of w and out (128 bytes)
constexpr int kConsumers = 2;
constexpr int kWsThreads = (kConsumers + 1) * 128;  // + the producer's
constexpr uint32_t kAtom = 8 * 128;  // eight 128-byte swizzled rows
using hopper::align_1024;
using hopper::kAlignSlack;
using hopper::pack_bf16;
using hopper::RingPos;

// Byte offsets of the kernel's shared memory (from a 1024-aligned base):
// a ring of x tiles and of w tiles, the output tile (two 64-row halves of
// BN / 64 boxes of 64 x 64), and the barriers.
template <int BN>
struct GemmSmem {
  static constexpr uint32_t a_bytes = kBM * kBK * sizeof(bf16);
  static constexpr uint32_t b_bytes = kBK * BN * sizeof(bf16);
  static constexpr size_t c_bytes = kBM * BN * sizeof(bf16);
  static constexpr int stages =
      hopper::ring_depth(c_bytes, a_bytes + b_bytes + 16, 6);
  static constexpr size_t a = 0;
  static constexpr size_t b = a + stages * a_bytes;
  static constexpr size_t c = b + stages * b_bytes;
  static constexpr size_t bars = c + c_bytes;
  // full[stages], empty[stages]
  static constexpr size_t total = bars + 2 * stages * 8 + kAlignSlack;
  static_assert(stages >= 2 && total <= hopper::kSmemOptIn,
                "ring does not fit");
};

// The output tile's rows are 128-byte swizzled rows of the TMA store's
// boxes: column c of row r (0..63 in the warpgroup's half) sits in box
// c / 64, at 16-byte chunk (c % 64) / 8 XOR r % 8.
template <int BN>
__global__ void __launch_bounds__(kWsThreads, 1)
    matmul_affine_bf16(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap tout,
                       const Params p) {
  using L = GemmSmem<BN>;
  constexpr int ST = L::stages, NT = BN / 8, NB = BN / kBox;
  extern __shared__ char smem_raw[];
  char* smem = align_1024(smem_raw);
  bf16* As = reinterpret_cast<bf16*>(smem + L::a);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L::b);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + ST;

  const int ncol = (p.C + BN - 1) / BN;
  const int tiles = (int)((p.N + kBM - 1) / kBM) * ncol;
  const int KT = (p.K + kBK - 1) / kBK;
  const int wg = hopper::warpgroup_index(), warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kConsumers);  // consumer warps
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // The producer: one thread issues every load; the warpgroup's
    // registers go to the consumers.
    hopper::regs_release<hopper::kProducerRegs>();
    if (warp != 0 || lane != 0) return;
    RingPos<ST> r;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / ncol * kBM, n0 = t % ncol * BN;
      for (int kt = 0; kt < KT; ++kt, r.next()) {
        hopper::mbar_wait(&empty[r.s], r.ph ^ 1);
        hopper::mbar_expect_tx(&full[r.s], L::a_bytes + L::b_bytes);
        hopper::tma_load_2d(As + r.s * kBM * kBK, &tx, &full[r.s], kt * kBK,
                            m0);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          hopper::tma_load_2d(Bs + r.s * kBK * BN + j * kBK * kBox, &tw,
                              &full[r.s], n0 + j * kBox, kt * kBK);
      }
    }
    return;
  }

  // A consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile.
  hopper::regs_claim<hopper::kConsumerRegs>();
  const int g = lane >> 2, tig = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  char* Cw = smem + L::c + wg * (L::c_bytes / 2);
  float acc[NT][4];
  RingPos<ST> r;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / ncol * kBM, n0 = t % ncol * BN;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kt = 0; kt < KT; ++kt, r.next()) {
      hopper::mbar_wait(&full[r.s], r.ph);
      hopper::fence_acc(acc);
      hopper::wgmma_fence();
      const bf16* A = As + r.s * kBM * kBK + 64 * wg * kBK;
      const bf16* B = Bs + r.s * kBK * BN;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hopper::wgmma_ss<0, 1>(
            acc, hopper::make_desc(A + kk * 16, 16, kAtom, hopper::kSwizzle128),
            hopper::make_desc(B + kk * 16 * kBox, kBK * kBox * sizeof(bf16),
                              kAtom, hopper::kSwizzle128),
            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
      __syncwarp();
      hopper::mbar_arrive_if(&empty[r.s], lane == 0);
    }

    // Epilogue: the warpgroup's previous store has read its tile.
    if (leader) hopper::bulk_wait_read<0>();
    hopper::named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int gc = n0 + 8 * j + 2 * tig;  // C is a multiple of 8
      float2 sc = make_float2(0.f, 0.f), bi = make_float2(0.f, 0.f);
      if (gc < p.C) {
        sc = *reinterpret_cast<const float2*>(p.scale + gc);
        bi = *reinterpret_cast<const float2*>(p.bias + gc);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = warp * 16 + g + 8 * i;
        float y0 = fmaf(acc[j][2 * i], sc.x, bi.x);
        float y1 = fmaf(acc[j][2 * i + 1], sc.y, bi.y);
        if (p.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(
            Cw + (j / 8) * (64 * 128) + rr * 128 +
            (((j % 8) ^ (rr & 7)) * 16) + tig * 4) = pack_bf16(y0, y1);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, 128);
    if (leader) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        hopper::tma_store_2d(&tout, Cw + j * 64 * 128, n0 + j * kBox,
                             m0 + 64 * wg);
      hopper::bulk_commit();
    }
  }
  if (leader) hopper::bulk_wait<0>();
}

// The map of a bf16 row-major (rows, cols) matrix with row stride ld
// elements, in boxes of box_cols x box_rows with the 128-byte swizzle.  0,
// or an error code.
int encode_2d(CUtensorMap* map, const void* base, long long cols,
              long long rows, long long ld, int box_cols, int box_rows) {
  hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return hopper::kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // past the edges: zeros
  return r == CUDA_SUCCESS ? 0 : hopper::kEncodeError + (int)r;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <int BN>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using L = GemmSmem<BN>;
  CUtensorMap tx, tw, tout;
  int rc = encode_2d(&tx, p.x, p.K, p.N, p.lda, kBK, kBM);
  if (!rc) rc = encode_2d(&tw, p.w, p.C, p.K, p.C, kBox, kBK);
  if (!rc) rc = encode_2d(&tout, p.out, p.C, p.N, p.C, kBox, 64);
  if (rc) return rc;
  const long long tiles =
      ((p.N + kBM - 1) / kBM) * (long long)((p.C + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // The shared-memory opt-in is made on the first launch only, so later
  // launches (inside a CUDA-graph capture, say) make no other call.
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        matmul_affine_bf16<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::total);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int grid = tiles < sms ? (int)tiles : sms;
  matmul_affine_bf16<BN><<<grid, kWsThreads, L::total, stream>>>(tx, tw, tout,
                                                                  p);
  return (int)cudaGetLastError();
}

// ==================================================================== fp32
// Exact fp32 on the CUDA cores: a 64 x 64 tile per CTA, 4 x 4 outputs per
// thread, K in steps of 16 through shared memory (A stored transposed so
// that a thread's four rows are one broadcast read).
constexpr int kThreads = 256;
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
// bf16 reads x and w and writes out through TMA tensor maps: their bases
// (and those of scale and bias) 16-byte aligned, lda and C multiples of 8
// and K > 0, else cudaErrorMisalignedAddress / cudaErrorInvalidValue (the
// wrapper pads other inputs).  Returns 0 when launched, else
// cudaGetLastError() after the launch or hopper::kEncodeError + the
// CUresult of a refused tensor map.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (K <= 0) return (int)cudaErrorInvalidValue;
    if (!aligned16(x) || !aligned16(w) || !aligned16(out) ||
        !aligned16(scale) || !aligned16(bias) || lda % 8 || C % 8)
      return (int)cudaErrorMisalignedAddress;
    return C <= 64 ? launch_bf16<64>(p, st) : launch_bf16<128>(p, st);
  }
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  const long long tiles = ((N + kFM - 1) / kFM) * ((C + kFN - 1) / kFN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  matmul_affine_f32<<<(unsigned)tiles, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

const char* cmn_conv_fused_error_string(int code) {
  if (code >= hopper::kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - "
           "100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
