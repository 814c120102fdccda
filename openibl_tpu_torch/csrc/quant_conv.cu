// Int8 3x3 convolution with a fused requantize epilogue, for Hopper
// (sm_90a), CUDA C++ with a plain C entry (kernel K3).
//
// Replaces no Pallas kernel: openibl_tpu/ops/quant.py:203-216 is XLA's int8
// convolution (lax.conv_general_dilated, preferred_element_type=int32)
// followed by one fused elementwise op. For x (N, H, W, Cin) int8 NHWC and
// wq (Cout, 3, 3, Cin) int8 it computes the 3x3 SAME convolution, stride 1,
// into an exact int32 accumulator (|acc| <= 128 * 127 * 9 * Cin < 2^31 for
// Cin <= 8192), then one of two epilogues per output (pixel p, channel o):
//   requant (conv2_1..conv5_2): y = (float)acc * m[o] + bq[o], rounded half
//     to even (rintf) and clamped to [relu ? 0 : -128, 127], written int8:
//     dequantize, bias, ReLU and the next layer's quantize in one pass;
//   dequant (conv5_3): y = (float)acc * sxsw[o] + b[o], written f32 or bf16
//     (round to nearest even), with an optional ReLU.
// The multiply and the add are __fmul_rn / __fadd_rn: nvcc would contract
// a * b + c into one FMA, whose single rounding differs from the reference's
// two at rounding ties. ops/quant_kernel.py:int8_conv_plain (an exact f64
// convolution, then the same f32 epilogue) gives the same bits.
//
// Design. An implicit GEMM: M = N*H*W pixels, N = Cout, K = 9*Cin in
// (kh, kw, cin) order, the order of wq's rows, so a weight row is K
// contiguous bytes. A block owns 128 pixels x BN channels (BN = 128, or 64
// when Cout is not a multiple of 128) and walks K in stages of 32 bytes:
// one tap and 32 input channels. Each stage copies the pixels' 32 bytes at
// that tap (zero-filled past the border, cp.async with a source size of 0)
// and the BN weight rows' 32 bytes into shared memory with 16-byte cp.async,
// four stages in flight. Warps own 64 x 32 tiles and run the int8 tensor
// cores through mma.sync m16n8k32 (s8 x s8 -> s32), fragments by ldmatrix
// (rows padded to 48 bytes: conflict-free). The epilogue works on the
// accumulators in registers and writes two channels per thread and row.
// Takes Cin a multiple of 32 (the wrapper pads Cin = 3 with zeros, which is
// exact) and Cout a multiple of 64.
//
// What bounds it on the H100 SXM (700 W): operations, 2 * M * K * Cout int8
// ops at 1,979 TOPS dense; at batch 16 and 480x640 the ten layers do 2.63 T
// of them (1.33 ms), conv2_2 alone 0.362 T (0.183 ms) against 0.094 ms for
// its 315 MB of input and output at 3.35 TB/s. mma.sync reaches only part of
// the dense rate (wgmma is the full-rate path); TMA, wgmma and the 2x2 pool
// in the epilogue are later designs. Its times on the card are in PERF.md
// (chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // output pixels a block
constexpr int kBK = 32;      // bytes of K a stage: one tap, 32 channels
constexpr int kRow = 48;     // a staged row's stride in shared memory
constexpr int kStages = 4;   // stages in flight
constexpr int kMaxCin = 8192; // keeps |acc| < 2^31

enum Mode { kRequant = 0, kDequantF32 = 1, kDequantBF16 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8 s32) += a (16 x 32 s8, row) * b (32 x 8 s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two neighbouring channels of one pixel through the epilogue
template <int MODE>
__device__ __forceinline__ void store2(void* out, long long at, int acc0,
                                       int acc1, float s0, float s1,
                                       float c0, float c1, int relu) {
  float y0 = __fadd_rn(__fmul_rn(__int2float_rn(acc0), s0), c0);
  float y1 = __fadd_rn(__fmul_rn(__int2float_rn(acc1), s1), c1);
  if (MODE == kRequant) {
    const float lo = relu ? 0.f : -128.f;
    char2 q;
    q.x = static_cast<signed char>(fminf(fmaxf(rintf(y0), lo), 127.f));
    q.y = static_cast<signed char>(fminf(fmaxf(rintf(y1), lo), 127.f));
    *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + at) = q;
    return;
  }
  if (relu) {
    y0 = fmaxf(y0, 0.f);
    y1 = fmaxf(y1, 0.f);
  }
  if (MODE == kDequantF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
        make_float2(y0, y1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       at) = __floats2bfloat162_rn(y0, y1);
  }
}

template <int BN, int MODE>
__global__ void __launch_bounds__(2 * BN, 512 / (2 * BN))
conv3x3_s8(const int8_t* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ scale, const float* __restrict__ bias,
           void* __restrict__ out, int h, int w, int cin, int cout,
           int m_total, int relu) {
  constexpr int kThreads = 2 * BN;
  constexpr int kWarpsN = BN / 32;
  constexpr int kAPieces = kBM * 2 / kThreads;  // 16-byte pieces a thread
  __shared__ __align__(128) int8_t smem[kStages][(kBM + BN) * kRow];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int chunks = cin / kBK;
  const int k_steps = 9 * chunks;
  const long long k_row = 9LL * cin;

  // the pixel rows this thread stages: its (y, x), its 16 bytes at the
  // centre tap and where they go
  int a_y[kAPieces], a_x[kAPieces];
  const int8_t* a_src[kAPieces];
  uint32_t a_dst[kAPieces];
#pragma unroll
  for (int i = 0; i < kAPieces; ++i) {
    const int piece = tid + i * kThreads;
    const int row = piece >> 1, half = piece & 1;
    const int m = m0 + row;
    if (m < m_total) {
      const int rem = m % (h * w);
      a_y[i] = rem / w;
      a_x[i] = rem - a_y[i] * w;
    } else {
      a_y[i] = -4;  // every tap falls outside: zeros
      a_x[i] = 0;
    }
    a_src[i] = x + static_cast<long long>(min(m, m_total - 1)) * cin +
               half * 16;
    a_dst[i] = row * kRow + half * 16;
  }
  // the weight row this thread stages (kThreads = 2 * BN pieces)
  const int8_t* b_src =
      wq + static_cast<long long>(n0 + (tid >> 1)) * k_row + (tid & 1) * 16;
  const uint32_t b_dst = (kBM + (tid >> 1)) * kRow + (tid & 1) * 16;

  auto stage_in = [&](int stage, int k) {
    const int tap = k / chunks;
    const int c0 = (k - tap * chunks) * kBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint32_t base = smem_addr(smem[stage]);
#pragma unroll
    for (int i = 0; i < kAPieces; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool inside = static_cast<unsigned>(yy) < static_cast<unsigned>(h)
                          && static_cast<unsigned>(xx) <
                                 static_cast<unsigned>(w);
      const int8_t* src =
          inside ? a_src[i] + (static_cast<long long>(dy) * w + dx) * cin + c0
                 : x;
      cp_async16(base + a_dst[i], src, inside ? 16 : 0);
    }
    cp_async16(base + b_dst, b_src + static_cast<long long>(k) * kBK, 16);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp / kWarpsN) * 64, wn = (warp % kWarpsN) * 32;
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8. A's four
  // matrices of a 16 x 32 tile: (rows 0-7 | 8-15) x (bytes 0-15 | 16-31),
  // rows first; B's: two n8 blocks x (bytes 0-15 | 16-31), bytes first
  const int lr = lane & 7, lj = lane >> 3;
  const uint32_t a_off = (wm + lr + (lj & 1) * 8) * kRow + (lj >> 1) * 16;
  const uint32_t b_off =
      (kBM + wn + lr + (lj >> 1) * 8) * kRow + (lj & 1) * 16;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_steps) stage_in(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < k_steps; ++k) {
    cp_async_wait<kStages - 2>();  // stage k has landed
    __syncthreads();               // and every warp is done with k - 1
    if (k + kStages - 1 < k_steps) {
      stage_in((k + kStages - 1) % kStages, k + kStages - 1);
    }
    cp_async_commit();
    const uint32_t base = smem_addr(smem[k % kStages]);
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], base + a_off + i * 16 * kRow);
#pragma unroll
    for (int j = 0; j < 2; ++j) ldmatrix_x4(b[j], base + b_off + j * 16 * kRow);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_s8(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
               b[j >> 1][(j & 1) * 2 + 1]);
  }
  cp_async_wait<0>();

  // accumulator (i, j, r): row wm + 16 i + lane / 4 + 8 (r / 2), channel
  // wn + 8 j + 2 (lane % 4) + r % 2
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = n0 + wn + j * 8 + t * 2;
    const float s0 = scale[o], s1 = scale[o + 1];
    const float c0 = bias[o], c1 = bias[o + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + i * 16 + g + half * 8;
        if (m < m_total) {
          store2<MODE>(out, static_cast<long long>(m) * cout + o,
                       acc[i][j][half * 2], acc[i][j][half * 2 + 1], s0, s1,
                       c0, c1, relu);
        }
      }
    }
  }
}

template <int BN>
cudaError_t dispatch(const int8_t* x, const int8_t* wq, const float* scale,
                     const float* bias, void* out, int h, int w, int cin,
                     int cout, int m_total, int mode, int relu,
                     cudaStream_t stream) {
  const dim3 grid((m_total + kBM - 1) / kBM, cout / BN);
  const dim3 block(2 * BN);
  switch (mode) {
    case kRequant:
      conv3x3_s8<BN, kRequant><<<grid, block, 0, stream>>>(
          x, wq, scale, bias, out, h, w, cin, cout, m_total, relu);
      break;
    case kDequantF32:
      conv3x3_s8<BN, kDequantF32><<<grid, block, 0, stream>>>(
          x, wq, scale, bias, out, h, w, cin, cout, m_total, relu);
      break;
    default:
      conv3x3_s8<BN, kDequantBF16><<<grid, block, 0, stream>>>(
          x, wq, scale, bias, out, h, w, cin, cout, m_total, relu);
  }
  return cudaGetLastError();
}

}  // namespace

// x (n, h, w, cin) int8, wq (cout, 3, 3, cin) int8, scale and bias (cout,)
// f32, out (n, h, w, cout): int8 (mode 0), f32 (1) or bf16 (2). All
// contiguous, 16-byte aligned, on the current device. Returns a cudaError_t.
extern "C" int int8_conv3x3_forward(const int8_t* x, const int8_t* wq,
                                    const float* scale, const float* bias,
                                    void* out, int n, int h, int w, int cin,
                                    int cout, int mode, int relu,
                                    void* stream) {
  const long long m_total = static_cast<long long>(n) * h * w;
  if (n < 1 || h < 1 || w < 1 || cin < kBK || cin % kBK != 0 ||
      cin > kMaxCin || cout < 64 || cout % 64 != 0 || mode < kRequant ||
      mode > kDequantBF16 || m_total >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(m_total);
  return cout % 128 == 0
             ? dispatch<128>(x, wq, scale, bias, out, h, w, cin, cout, m,
                             mode, relu, s)
             : dispatch<64>(x, wq, scale, bias, out, h, w, cin, cout, m,
                            mode, relu, s);
}
