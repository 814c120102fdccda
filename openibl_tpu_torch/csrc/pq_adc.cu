// PQ ADC tile scorer for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel openibl_tpu/ops/pq_kernel.py:_kernel,
// launched by adc_tile (its pl.pallas_call). For a lookup table
// lut[j][q][c] = ||q_j - codebook[j][c]||^2, (m, Q, ksub) f32, and codes
// (T, m) uint8 (the index's own row-major rows):
//   out[q][t] = sum_{j < m} lut[j][q][codes[t][j]]        (Q, T) f32,
// summed in f32 in subspace order j = 0..m-1. With bf16 set the LUT entries
// are rounded to bf16 (round to nearest even) first; the sum stays f32.
//
// Design. The TPU kernel builds a one-hot per subspace and feeds the MXU,
// because Mosaic cannot index the lane dimension. On Hopper a lookup in
// shared memory is the natural form:
//   * grid (X, ceil(Q / qpb)): a block owns a group of qpb <= 8 queries and
//     stages their LUTs in dynamic shared memory, laid out [q][j][256] so
//     every byte value is in bounds (slots c >= ksub hold NaN: a code past
//     ksub gives NaN, never a read out of the table). f32 when precise
//     (64 KB a query at m = 64), bf16 otherwise (32 KB);
//   * X is what stays resident on the SMs (occupancy), so each block stages
//     its LUTs once and then walks code rows grid-stride: one thread per
//     row, the row's m bytes in kVec-byte vector loads (16 when m and the
//     tile's address allow), then m lookups per query into per-thread f32
//     accumulators, in order j = 0..m-1;
//   * out[q][t] is written by consecutive threads at consecutive t
//     (coalesced). No atomics: the result is deterministic, and bit-equal to
//     the plain version (one gather per subspace, added in the same order).
// The top-k over the tile stays outside, in torch.topk, as the JAX package
// leaves it to XLA.
//
// What bounds it on the H100: at Q = 1 the code bytes, 64 B a row at
// m = 64 (64 MB per million rows, ~20 us at 3.35 TB/s), plus the LUT staged
// once per resident block from L2. At Q = 16 the shared-memory lookups:
// m * Q random 2- or 4-byte reads per row, with bank conflicts among a
// warp's 32 random codes, and each query group re-reads the codes
// (ceil(16 / 7) = 3 groups in bf16, 6 in f32). A wgmma formulation or a
// fused per-tile top-k is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxQ = 8;      // queries per block (accumulators per thread)
constexpr int kSlots = 256;   // LUT slots per subspace (every uint8 code)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// kVec code bytes of one row as 32-bit words (one byte for kVec = 1)
template <int kVec>
struct Codes {
  static constexpr int kWords = kVec >= 4 ? kVec / 4 : 1;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (kVec == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (kVec == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(p);
    }
  }
  __device__ __forceinline__ int byte(int b) const {
    return (w[b >> 2] >> (8 * (b & 3))) & 0xff;
  }
};

template <int kVec, typename LutT>
__global__ void __launch_bounds__(kThreads) adc_kernel(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    float* __restrict__ out, int m, int q_total, int ksub, long long t_total,
    int qpb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LutT* s_lut = reinterpret_cast<LutT*>(smem_raw);
  const int q0 = blockIdx.y * qpb;
  const int nq = min(qpb, q_total - q0);
  const int per_q = m * kSlots;

  // stage this group's LUTs: s_lut[qq][j][c] <- lut[j][q0 + qq][c]
  const float nan = __int_as_float(0x7fc00000);
  for (int i = threadIdx.x; i < nq * per_q; i += kThreads) {
    const int qq = i / per_q;
    const int r = i - qq * per_q;
    const int j = r / kSlots;
    const int c = r - j * kSlots;
    const float v = c < ksub
        ? lut[(static_cast<size_t>(j) * q_total + q0 + qq) * ksub + c]
        : nan;
    store(&s_lut[i], v);
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < t_total; t += stride) {
    const uint8_t* row = codes + t * m;
    float acc[kMaxQ];
#pragma unroll
    for (int qq = 0; qq < kMaxQ; ++qq) acc[qq] = 0.0f;
    for (int c0 = 0; c0 < m; c0 += kVec) {
      Codes<kVec> v;
      v.load(row + c0);
#pragma unroll
      for (int b = 0; b < kVec; ++b) {
        const LutT* slot = s_lut + (c0 + b) * kSlots + v.byte(b);
#pragma unroll
        for (int qq = 0; qq < kMaxQ; ++qq) {
          if (qq < nq) acc[qq] += to_f32(slot[qq * per_q]);
        }
      }
    }
#pragma unroll
    for (int qq = 0; qq < kMaxQ; ++qq) {
      if (qq < nq) out[static_cast<size_t>(q0 + qq) * t_total + t] = acc[qq];
    }
  }
}

template <int kVec, typename LutT>
cudaError_t launch(const float* lut, const uint8_t* codes, float* out, int m,
                   int q, int ksub, long long t, int qpb,
                   cudaStream_t stream) {
  auto kernel = adc_kernel<kVec, LutT>;
  const size_t smem = static_cast<size_t>(qpb) * m * kSlots * sizeof(LutT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int groups = (q + qpb - 1) / qpb;
  const long long row_blocks = (t + kThreads - 1) / kThreads;
  long long x = (static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) +
                 groups - 1) / groups;
  if (x > row_blocks) x = row_blocks;
  if (x < 1) x = 1;
  kernel<<<dim3(static_cast<unsigned>(x), groups), kThreads, smem, stream>>>(
      lut, codes, out, m, q, ksub, t, qpb);
  return cudaGetLastError();
}

template <typename LutT>
cudaError_t dispatch(const float* lut, const uint8_t* codes, float* out,
                     int m, int q, int ksub, long long t, int qpb, int vec,
                     cudaStream_t stream) {
  switch (vec) {
    case 16:
      return launch<16, LutT>(lut, codes, out, m, q, ksub, t, qpb, stream);
    case 4:
      return launch<4, LutT>(lut, codes, out, m, q, ksub, t, qpb, stream);
    case 1:
      return launch<1, LutT>(lut, codes, out, m, q, ksub, t, qpb, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// lut (m, q, ksub) f32, codes (t, m) uint8 row-major, out (q, t) f32, all
// contiguous on the current device; qpb in 1..8 queries per block, vec in
// {16, 4, 1} dividing m and the codes' address; bf16 = round the LUT.
// Launches on ``stream`` and returns the launch's cudaError_t (0 = ok).
extern "C" int pq_adc_forward(const float* lut, const uint8_t* codes,
                              float* out, int m, int q, int ksub,
                              long long t, int qpb, int vec, int bf16,
                              void* stream) {
  if (m < 1 || q < 1 || ksub < 1 || ksub > kSlots || t < 1 || qpb < 1 ||
      qpb > kMaxQ) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(lut, codes, out, m, q, ksub, t, qpb,
                                        vec, s)
              : dispatch<float>(lut, codes, out, m, q, ksub, t, qpb, vec, s);
}
