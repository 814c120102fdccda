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
//   * a persistent grid: one block of 512 threads per SM for each pass of
//     up to 32 queries (grid.y = passes). A block owns one contiguous range
//     of ~T / SMs code rows and walks it in batches of R rows a thread, R =
//     8, 4 or 2 as the query count grows (R x queries accumulators in
//     registers);
//   * the pass's LUTs live in dynamic shared memory query-innermost,
//     [j][c][q] with q padded to QP in {1, 2, 4, 8, 16, 24, 32}: one code's
//     lookup reads all the pass's queries as one contiguous vector (32 B at
//     16 queries in bf16), so bank conflicts fall per code, not per (code,
//     query). All 256 slots of a subspace are kept; slots c >= ksub hold NaN,
//     so a code past ksub gives NaN, never a read out of the table;
//   * staging: 16-byte loads of 4 slots of one (j, q) LUT row, consecutive
//     threads on consecutive slots; no division per element. Each thread
//     rounds to bf16 while staging and stores up to 8 queries of a slot as
//     one vector, its four slots in a lane-rotated order to spread banks;
//   * when the pass's LUTs do not fit (16 queries x m = 64 in bf16 take
//     512 KB), the subspaces go in chunks, in order j = 0..m-1, with the
//     (row, query) accumulators kept in registers across chunks: each code
//     is read once per pass and the order of the sum does not change. The
//     LUT is then staged once per chunk and row batch; with one chunk, once
//     per block;
//   * a row's codes of a chunk come in 16-byte loads (4-byte or single
//     bytes where m or the tile's address do not allow it); out[q][t] is
//     written by consecutive threads at consecutive t (coalesced). No
//     atomics: the result is deterministic, and bit-equal to the plain
//     version (one gather per subspace, added in the same order).
// The top-k over the tile stays outside, in torch.topk, as the JAX package
// leaves it to XLA. The geometry (passes, QP, subspaces per chunk, blocks,
// rows per block and shared memory) comes from ops/pq_kernel.py:adc_geometry
// and is checked here, not worked out again; the shared-memory opt-in is
// done once per device and instance (launch_cache.cuh).
//
// What bounds it on the H100 SXM (700 W): at Q = 1 the code bytes, 64 B a
// row at m = 64 (6.4 MB at the served 100k rows, 0.002 ms at 3.35 TB/s),
// plus the LUT staged once per block from L2 (64 KB of f32 per SM). At
// Q = 16 the shared-memory lookups: 16 queries x m x T values, 2 bytes each
// in bf16 (2 GB at 1M rows), with bank conflicts among a warp's 32 random
// codes, and the LUT staged once per chunk and batch of 2,048 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_cache.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSlots = 256;          // LUT slots per subspace (every uint8)
constexpr int kMaxQ = 32;            // queries per pass
constexpr size_t kMaxSmem = 232448;  // a Hopper block's opt-in 227 KB

// rows a thread scores at once: R x QP accumulators, at most 64
template <int QP>
__host__ __device__ constexpr int rows_per_thread() {
  return QP <= 8 ? 8 : QP <= 16 ? 4 : 2;
}

__device__ __forceinline__ uint32_t ldg32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// up to 16 code bytes of a row (n valid), as one 16-byte value
__device__ __forceinline__ uint4 load_codes(const uint8_t* p, int n, bool v16,
                                            bool v4) {
  if (v16 && n >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (v4) {  // n is a multiple of 4 here
    w.x = ldg32(p);
    if (n > 4) w.y = ldg32(p + 4);
    if (n > 8) w.z = ldg32(p + 8);
    if (n > 12) w.w = ldg32(p + 12);
    return w;
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < n) v[b >> 2] |= (uint32_t)__ldg(p + b) << (8 * (b & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ int code_byte(const uint4& w, int b) {
  const uint32_t word = b < 4 ? w.x : b < 8 ? w.y : b < 12 ? w.z : w.w;
  return (word >> (8 * (b & 3))) & 0xff;
}

__device__ __forceinline__ void add_bf16x2(float* acc, uint32_t v) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  acc[0] += f.x;
  acc[1] += f.y;
}

// acc[q] += slot[q] for q < QP, one vector read of the slot's queries
template <int QP, typename LutT>
__device__ __forceinline__ void add_slot(float* acc, const LutT* slot) {
  if constexpr (std::is_same<LutT, float>::value) {
    if constexpr (QP % 4 == 0) {
#pragma unroll
      for (int i = 0; i < QP / 4; ++i) {
        const float4 v = reinterpret_cast<const float4*>(slot)[i];
        acc[4 * i] += v.x;
        acc[4 * i + 1] += v.y;
        acc[4 * i + 2] += v.z;
        acc[4 * i + 3] += v.w;
      }
    } else if constexpr (QP == 2) {
      const float2 v = *reinterpret_cast<const float2*>(slot);
      acc[0] += v.x;
      acc[1] += v.y;
    } else {
      acc[0] += slot[0];
    }
  } else {
    if constexpr (QP % 8 == 0) {
#pragma unroll
      for (int i = 0; i < QP / 8; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(slot)[i];
        add_bf16x2(acc + 8 * i, v.x);
        add_bf16x2(acc + 8 * i + 2, v.y);
        add_bf16x2(acc + 8 * i + 4, v.z);
        add_bf16x2(acc + 8 * i + 6, v.w);
      }
    } else if constexpr (QP == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(slot);
      add_bf16x2(acc, v.x);
      add_bf16x2(acc + 2, v.y);
    } else if constexpr (QP == 2) {
      add_bf16x2(acc, *reinterpret_cast<const uint32_t*>(slot));
    } else {
      acc[0] += __bfloat162float(slot[0]);
    }
  }
}

// store G values as one vector (G x sizeof(LutT) <= 16 bytes)
template <int G, typename LutT>
__device__ __forceinline__ void store_slot(LutT* p, const float (&v)[G]) {
  if constexpr (std::is_same<LutT, float>::value) {
    if constexpr (G == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else if constexpr (G == 2)
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    else
      p[0] = v[0];
  } else {
    uint32_t u[(G + 1) / 2];
#pragma unroll
    for (int i = 0; i < G / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (G == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    else if constexpr (G == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    else if constexpr (G == 2)
      *reinterpret_cast<uint32_t*>(p) = u[0];
    else
      p[0] = __float2bfloat16_rn(v[0]);
  }
}

// s[jl][c][q] <- lut[j0 + jl][q0 + q][c] for jl < len, all 256 slots and
// the QP query slots (NaN for c >= ksub, 0 for q >= nq)
template <int QP, typename LutT>
__device__ void stage(LutT* __restrict__ s, const float* __restrict__ lut,
                      int j0, int len, int Q, int q0, int nq, int ksub) {
  constexpr int G = sizeof(LutT) == 2 ? (QP < 8 ? QP : 8) : (QP < 4 ? QP : 4);
  constexpr int kGroups = QP / G;
  const float nan = __int_as_float(0x7fc00000);
  const bool vec = (ksub & 3) == 0;
  const int items = len * (kSlots / 4) * kGroups;
#pragma unroll 4
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int c4 = i & 63, rest = i >> 6;
    const int qg = rest % kGroups, jl = rest / kGroups;  // constant divisor
    const int c = 4 * c4;
    float v[G][4];
#pragma unroll
    for (int gq = 0; gq < G; ++gq) {
      const int q = qg * G + gq;
      if (q >= nq) {
        v[gq][0] = v[gq][1] = v[gq][2] = v[gq][3] = 0.f;
        continue;
      }
      const float* src = lut + ((size_t)(j0 + jl) * Q + q0 + q) * ksub + c;
      if (vec && c + 4 <= ksub) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src));
        v[gq][0] = f.x;
        v[gq][1] = f.y;
        v[gq][2] = f.z;
        v[gq][3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[gq][e] = c + e < ksub ? __ldg(src + e) : nan;
      }
    }
    LutT* dst = s + ((size_t)jl * kSlots + c) * QP + qg * G;
#pragma unroll
    for (int e0 = 0; e0 < 4; ++e0) {
      const int e = (e0 + c4) & 3;  // rotate the slot order across lanes
      float col[G];
#pragma unroll
      for (int gq = 0; gq < G; ++gq)
        col[gq] = e == 0 ? v[gq][0] : e == 1 ? v[gq][1]
                : e == 2 ? v[gq][2] : v[gq][3];
      store_slot<G, LutT>(dst + e * QP, col);
    }
  }
}

template <int QP, typename LutT>
__global__ void __launch_bounds__(kThreads, 1)
adc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
           float* __restrict__ out, int m, int Q, int ksub, long long T,
           int qpb, int mc, long long per_block) {
  constexpr int R = rows_per_thread<QP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LutT* s = reinterpret_cast<LutT*>(smem_raw);
  const int q0 = blockIdx.y * qpb, nq = min(qpb, Q - q0);
  const long long r0 = (long long)blockIdx.x * per_block;
  const long long r1 = min(T, r0 + per_block);
  const bool one_chunk = mc >= m;
  const uintptr_t base_addr = reinterpret_cast<uintptr_t>(codes);
  const bool v16 = (m & 15) == 0 && (base_addr & 15) == 0;
  const bool v4 = (m & 3) == 0 && (base_addr & 3) == 0;

  if (one_chunk) {
    stage<QP, LutT>(s, lut, 0, m, Q, q0, nq, ksub);
    __syncthreads();
  }
  for (long long base = r0; base < r1; base += (long long)R * kThreads) {
    float acc[R][QP];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < QP; ++q) acc[r][q] = 0.f;
    for (int j0 = 0; j0 < m; j0 += mc) {
      const int len = min(mc, m - j0);
      if (!one_chunk) {
        __syncthreads();  // every thread is done with the last chunk
        stage<QP, LutT>(s, lut, j0, len, Q, q0, nq, ksub);
        __syncthreads();
      }
      const bool c16 = v16 && (j0 & 15) == 0;
      const bool c4 = v4 && (j0 & 3) == 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long row = base + (long long)r * kThreads + threadIdx.x;
        if (row < r1) {
          const uint8_t* rp = codes + row * m + j0;
          for (int jl = 0; jl < len; jl += 16) {
            const uint4 w = load_codes(rp + jl, len - jl, c16, c4);
            const LutT* sj = s + (size_t)jl * kSlots * QP;
#pragma unroll
            for (int b = 0; b < 16; ++b) {
              if (jl + b < len) {
                const int c = code_byte(w, b);  // b is unrolled
                add_slot<QP, LutT>(acc[r],
                                   sj + ((size_t)b * kSlots + c) * QP);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + (long long)r * kThreads + threadIdx.x;
      if (row < r1) {
#pragma unroll
        for (int q = 0; q < QP; ++q)
          if (q < nq) out[(size_t)(q0 + q) * T + row] = acc[r][q];
      }
    }
  }
}

template <int QP, typename LutT>
cudaError_t launch(const float* lut, const uint8_t* codes, float* out, int m,
                   int q, int ksub, long long t, int qpb, int mc, int blocks,
                   long long per_block, size_t smem, int device,
                   cudaStream_t stream) {
  const auto kernel = adc_kernel<QP, LutT>;
  // the caller's shared-memory size must be the chunk's LUTs exactly
  if (smem != (size_t)(mc < m ? mc : m) * kSlots * QP * sizeof(LutT) ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaError_t err = launch_cache::launch_setup(
      device, reinterpret_cast<const void*>(kernel), kMaxSmem);
  if (err != cudaSuccess) return err;
  const int passes = (q + qpb - 1) / qpb;
  kernel<<<dim3(blocks, passes), kThreads, smem, stream>>>(
      lut, codes, out, m, q, ksub, t, qpb, mc, per_block);
  return cudaGetLastError();
}

template <typename LutT>
cudaError_t dispatch(const float* lut, const uint8_t* codes, float* out,
                     int m, int q, int ksub, long long t, int qpb, int qp,
                     int mc, int blocks, long long per_block, size_t smem,
                     int device, cudaStream_t s) {
  switch (qp) {
#define ADC_CASE(QP)                                                     \
  case QP:                                                               \
    return launch<QP, LutT>(lut, codes, out, m, q, ksub, t, qpb, mc,     \
                            blocks, per_block, smem, device, s);
    ADC_CASE(1)
    ADC_CASE(2)
    ADC_CASE(4)
    ADC_CASE(8)
    ADC_CASE(16)
    ADC_CASE(24)
    ADC_CASE(32)
#undef ADC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// lut (m, q, ksub) f32, codes (t, m) uint8 row-major, out (q, t) f32, all
// contiguous on the current device (index `device`); qpb queries per pass
// (1..32), their slots qp >= qpb in {1, 2, 4, 8, 16, 24, 32}, mc subspaces
// per chunk (a multiple of 4 when below m), `blocks` blocks per pass, each
// on a contiguous range of `per_block` rows, and `smem` bytes of shared
// memory (the chunk's LUTs); bf16 = round the LUT. The geometry is
// ops/pq_kernel.py:adc_geometry's; a value that does not fit is refused.
// Launches on `stream` and returns the launch's cudaError_t (0 = ok).
extern "C" int pq_adc_forward(const float* lut, const uint8_t* codes,
                              float* out, int m, int q, int ksub,
                              long long t, int qpb, int qp, int mc,
                              int blocks, long long per_block, long long smem,
                              int bf16, int device, void* stream) {
  if (m < 1 || q < 1 || ksub < 1 || ksub > kSlots || t < 1 || qpb < 1 ||
      qpb > kMaxQ || qp < qpb || mc < 1 || (mc < m && mc % 4 != 0) ||
      blocks < 1 || per_block < 1 || (long long)blocks * per_block < t ||
      smem < 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  return bf16 ? dispatch<__nv_bfloat16>(lut, codes, out, m, q, ksub, t, qpb,
                                        qp, mc, blocks, per_block, sm,
                                        device, s)
              : dispatch<float>(lut, codes, out, m, q, ksub, t, qpb, qp, mc,
                                blocks, per_block, sm, device, s);
}
