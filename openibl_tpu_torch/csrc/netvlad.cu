// Fused NetVLAD head for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel openibl_tpu/ops/netvlad_kernel.py:_kernel,
// launched by _netvlad_fused (its pl.pallas_call). Per image, x = the conv5_3
// map as (P, C) rows:
//   1. optional row L2-norm;
//   2. logits = x @ assign_w (P, K); softmax over K;
//   3. vlad = a^T x - (sum_p a) * centroids (K, C);
//   4. optional intra-norm per cluster, then global L2 (eps 1e-12).
//
// Design. Both products run on the tensor cores (mma.sync), with the row
// norm folded into a per-row scale d_p = max(||x_p||, eps):
//   logits_p = (x_p . W) / d_p,    a^T x^ = sum_p (a_p / d_p) x_p.
// One TF32 or bf16 pass on an f32 operand keeps ~3 digits, which misses the
// head's gate (rtol 1e-4 / atol 1e-5), so each f32 operand is split:
//   * f32 fmap: TF32 m16n8k8, both operands split v = hi + lo (hi = v
//     rounded to TF32, to nearest; lo = the rest with its low 13 mantissa
//     bits masked off); three products lo.hi + hi.lo + hi.hi (lo.lo
//     dropped);
//   * bf16 fmap: bf16 m16n8k16. The fmap is exact in bf16, so only the f32
//     operand (W, then a / d) is split, into three bf16 parts (~24 bits):
//     three products. With two parts (~16 bits) the small-C cases, whose
//     sums cancel, miss the gate.
// Each stage's products go to zeroed accumulators that are then added to
// the running f32 sums, so no tensor-core sum spans more than one stage.
// ops/netvlad_kernel.py:netvlad_split_emulation is this arithmetic in plain
// PyTorch; the CPU tests hold it to the plain and JAX heads and to f64, a
// test on the card holds the kernel to it.
//
//   assign pass, grid (ceil(P/64), N), 128 threads: 64 rows of one image
//     per block, 16 per warp. x and W stream through shared memory in
//     32-channel chunks (cp.async, three in flight); the same chunks give
//     each row's sum of squares. Logits for 64 clusters a sweep, softmax,
//     then a (N, P, KA) f32 and d (N, P) f32 go to scratch (KA = K rounded
//     up to 4, zero-padded);
//   aggregate pass, grid (ceil(C/64), ceil(K/64), N), 512 threads: one
//     (64 clusters x 64 channels) tile of one image per block, 16 warps of
//     16 x 16, walking all P rows in 64-row chunks (cp.async, three in
//     flight), the sums in registers across the whole walk: no partials.
//     Then sum_p a (same chunks), vlad = acc - (sum_p a) * centroid,
//     written once, and with postprocess each cluster's sum of squares over
//     the tile's channels (N, K, ceil(C/64));
//   norm pass (postprocess only), grid (K, N): intra-norm and global L2 from
//     those sums, in a fixed order.
// No atomics and fixed reduction orders: one image gives the same descriptor
// bits on every run, which a serving index relies on. The shared-memory
// opt-in is set once per device (launch_cache.cuh).
//
// Shared memory per block: assign 3 x 64 x 36 x 4 (f32 x; bf16 3 x 64 x 40
// x 2) + 3 x 32 x 72 x 4 (W; bf16 path 68) + 64 x (ceil(K/64)*64 + 8) x 4
// (logits) + 512 bytes: 74,240 at K = 64 in f32, 123,392 at K = 256.
// Aggregate: 3 x 64 x (72 x 4 + 72 x 4 + 4) = 111,360 bytes in f32 (80,640
// in bf16) plus 3 KB static. Scratch at (16,30,40,512), K = 64: a 4.9 MB +
// d 77 KB + 32 KB of sums, against the 80 MB of per-tile partials of the
// CUDA-core design this replaces. Takes C a multiple of 4 and K <= 256.
//
// What bounds it on the H100 SXM (700 W), at N = 16 images of the main path:
// bytes, x once (39 MB f32, 20 MB bf16) plus W, centroids and the (N, K, C)
// output: 0.0124 ms at 3.35 TB/s in f32, 0.0066 ms in bf16; operations, two
// products of 2*N*P*C*K = 1.26 GFLOP each, run 3 times at the dense
// tensor-core rate (495 TFLOP/s TF32, 989 bf16): 0.0153 ms in f32, 0.0076 ms
// in bf16. The scratch and the second read of x in the aggregate pass
// (mostly from the 50 MB L2) are the design's own bytes on top. Its times
// on the card are in PERF.md (chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "launch_cache.cuh"

namespace {

using bf16_mma::mma_bf16;
using bf16_mma::split_bf16;

constexpr int kWarpsA = 4;      // assign: warps a block, 16 rows each
constexpr int kThreadsA = 32 * kWarpsA;
constexpr int kRowsA = 16 * kWarpsA;  // assign: P rows per block
constexpr int kChunkC = 32;     // assign: channels per stage
constexpr int kStagesA = 3;     // assign: chunks in flight
constexpr int kSweepK = 64;     // assign: clusters per logits sweep
// aggregate: a block of kWarpsK x kWarpsC warps, each kMI m16 (cluster)
// tiles by kNI n8 (channel) tiles
constexpr int kWarpsK = 4, kWarpsC = 4, kMI = 1, kNI = 2;
constexpr int kThreadsG = 32 * kWarpsK * kWarpsC;
constexpr int kTileK = 16 * kMI * kWarpsK;  // clusters per block
constexpr int kTileC = 64;                  // channels per block
static_assert(kTileC == 8 * kNI * kWarpsC, "a block's warps cover kTileC");
constexpr int kChunkP = 64;     // aggregate: P rows per stage
constexpr int kStagesG = 3;     // aggregate: chunks in flight
constexpr int kMaxK = 256;
constexpr int kNormThreads = 128;
static_assert(kThreadsG % kTileK == 0 && kChunkP % (kThreadsG / kTileK) == 0,
              "the a / d step gives each thread whole rows of one column");
constexpr float kEps = 1e-12f;

// Row strides (elements) of the shared tiles, padded so that the fragment
// loads of a warp hit 32 distinct banks (or share words).
template <typename T>
struct Layout;
template <>
struct Layout<float> {          // TF32 m16n8k8, 3 products
  static constexpr int kX = kChunkC + 4;  // assign x chunk: 4 mod 32
  static constexpr int kW = 72;   // assign W chunk: 8 mod 32
  static constexpr int kA = 72;   // aggregate a chunk
  static constexpr int kXB = 72;  // aggregate x chunk
};
template <>
struct Layout<__nv_bfloat16> {  // bf16 m16n8k16, 3 products
  static constexpr int kX = kChunkC + 8;  // words: 4 mod 32 in pairs
  static constexpr int kW = 68;   // rows 2t apart: 8t mod 32
  static constexpr int kA = 68;
  static constexpr int kXB = 72;  // rows 2t apart: 8t mod 32 words
};

template <typename T>
__host__ __device__ constexpr size_t assign_smem(int k) {
  return (size_t)kStagesA * kRowsA * Layout<T>::kX * sizeof(T) +
         (size_t)kStagesA * kChunkC * Layout<T>::kW * sizeof(float) +
         (size_t)kRowsA * ((k + kSweepK - 1) / kSweepK * kSweepK + 8) *
             sizeof(float) +
         (size_t)kThreadsA * sizeof(float);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// asynchronous copy global -> shared of kBytes; ok = false writes zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0));
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// v = hi + lo in TF32: hi rounded to nearest, ties away from zero (as
// cvt.rna.tf32.f32, in two integer operations), lo the rest with its low 13
// mantissa bits masked off, as the tensor core reads it
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 v0,
                                              __nv_bfloat16 v1) {
  return (uint32_t)__bfloat16_as_ushort(v0) |
         ((uint32_t)__bfloat16_as_ushort(v1) << 16);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block in a fixed order (warp shuffles, then warp 0's partials
// in index order), returned to every thread.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < nwarps; ++i) s += red[i];
    red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// One 32-channel chunk of the logits of a warp's 16 rows x 64 clusters:
// acc[ni] is the m16n8 tile of clusters 8 ni .. 8 ni + 7. xw: the warp's
// first row in the x chunk; wb: the W chunk (32 channels x 64 clusters).
template <typename T>
__device__ __forceinline__ void mma_logits(float (&acc)[8][4], const T* xw,
                                           const float* wb, int g, int t) {
  constexpr int kX = Layout<T>::kX, kW = Layout<T>::kW;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int ks = 0; ks < kChunkC; ks += 8) {
      uint32_t ah[4], al[4];
      split_tf32(xw[g * kX + ks + t], ah[0], al[0]);
      split_tf32(xw[(g + 8) * kX + ks + t], ah[1], al[1]);
      split_tf32(xw[g * kX + ks + t + 4], ah[2], al[2]);
      split_tf32(xw[(g + 8) * kX + ks + t + 4], ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        uint32_t bh[2], bl[2];
        split_tf32(wb[(ks + t) * kW + ni * 8 + g], bh[0], bl[0]);
        split_tf32(wb[(ks + t + 4) * kW + ni * 8 + g], bh[1], bl[1]);
        mma_tf32(acc[ni], al, bh);
        mma_tf32(acc[ni], ah, bl);
        mma_tf32(acc[ni], ah, bh);
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kChunkC; ks += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(xw + g * kX + ks + 2 * t);
      a[1] = *reinterpret_cast<const uint32_t*>(xw + (g + 8) * kX + ks + 2 * t);
      a[2] = *reinterpret_cast<const uint32_t*>(xw + g * kX + ks + 2 * t + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(xw + (g + 8) * kX + ks +
                                                2 * t + 8);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const float* wc = wb + ni * 8 + g;
        uint32_t b0[3], b1[3];
        split_bf16(wc[(ks + 2 * t) * kW], wc[(ks + 2 * t + 1) * kW], b0);
        split_bf16(wc[(ks + 2 * t + 8) * kW], wc[(ks + 2 * t + 9) * kW], b1);
#pragma unroll
        for (int i = 2; i >= 0; --i) {  // smallest part first
          const uint32_t b[2] = {b0[i], b1[i]};
          mma_bf16(acc[ni], a, b);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsA)
vlad_assign_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ a, float* __restrict__ dnorm, int P,
                   int C, int K, int KA, int normalize) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // kStagesA x (kRowsA, kX)
  float* ws = reinterpret_cast<float*>(xs + kStagesA * kRowsA * L::kX);
  float* ls = ws + kStagesA * kChunkC * L::kW;  // (kRowsA, KL) logits
  const int KL = (K + kSweepK - 1) / kSweepK * kSweepK + 8;
  float* ss = ls + kRowsA * KL;  // (kThreadsA) sums of squares

  const int n = blockIdx.y, p0 = blockIdx.x * kRowsA;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* xn = x + (size_t)n * P * C;
  const int nch = (C + kChunkC - 1) / kChunkC;

  // x rows p0.. (4 elements a copy) and W[c0.., kb..] into buffer buf, one
  // commit group; rows past P, channels past C and clusters past K read as
  // zero. Past the last chunk: an empty group, so the counts stay uniform
  auto stage = [&](int ci, int kb) {
    if (ci < nch) {
      const int buf = ci % kStagesA, c0 = ci * kChunkC;
      T* xb = xs + buf * kRowsA * L::kX;
      for (int i = tid; i < kRowsA * (kChunkC / 4); i += kThreadsA) {
        const int r = i / (kChunkC / 4), u = i % (kChunkC / 4), c = c0 + 4 * u;
        const bool ok = p0 + r < P && c < C;
        cp_async<4 * sizeof(T)>(xb + r * L::kX + 4 * u,
                                ok ? xn + (size_t)(p0 + r) * C + c : xn, ok);
      }
      float* wb = ws + buf * kChunkC * L::kW;
      if ((K & 3) == 0) {
        for (int i = tid; i < kChunkC * (kSweepK / 4); i += kThreadsA) {
          const int cc = i >> 4, u = i & 15, k = kb + 4 * u;
          const bool ok = c0 + cc < C && k < K;
          cp_async<16>(wb + cc * L::kW + 4 * u,
                       ok ? w + (size_t)(c0 + cc) * K + k : w, ok);
        }
      } else {
        for (int i = tid; i < kChunkC * kSweepK; i += kThreadsA) {
          const int cc = i >> 6, kk = i & 63, k = kb + kk;
          const bool ok = c0 + cc < C && k < K;
          cp_async<4>(wb + cc * L::kW + kk,
                      ok ? w + (size_t)(c0 + cc) * K + k : w, ok);
        }
      }
    }
    cp_commit();
  };

  float sq = 0.f;  // row tid/2, half tid%2 of the channels of every chunk
  for (int kb = 0; kb < K; kb += kSweepK) {
    float acc[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      acc[ni][0] = acc[ni][1] = acc[ni][2] = acc[ni][3] = 0.f;
    __syncthreads();  // the last sweep is done with every buffer
#pragma unroll
    for (int s = 0; s < kStagesA - 1; ++s) stage(s, kb);
    for (int ci = 0; ci < nch; ++ci) {
      cp_wait<kStagesA - 2>();
      __syncthreads();  // chunk ci has landed; chunk ci - 1 is consumed
      stage(ci + kStagesA - 1, kb);
      const T* xb = xs + (ci % kStagesA) * kRowsA * L::kX;
      const float* wb = ws + (ci % kStagesA) * kChunkC * L::kW;
      if (kb == 0 && normalize) {
        const T* xr = xb + (tid >> 1) * L::kX + (tid & 1) * (kChunkC / 2);
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kChunkC / 2; ++e) {
          const float v = to_f32(xr[e]);
          s = fmaf(v, v, s);
        }
        sq += s;
      }
      float part[8][4];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        part[ni][0] = part[ni][1] = part[ni][2] = part[ni][3] = 0.f;
      mma_logits<T>(part, xb + warp * 16 * L::kX, wb, g, t);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] += part[ni][e];
    }
    const int row = warp * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = kb + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(ls + row * KL + col) =
          make_float2(acc[ni][0], acc[ni][1]);
      *reinterpret_cast<float2*>(ls + (row + 8) * KL + col) =
          make_float2(acc[ni][2], acc[ni][3]);
    }
  }
  ss[tid] = sq;
  __syncthreads();

  // softmax of the warp's 16 rows; a and d to scratch
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i, p = p0 + r;
    if (p >= P) break;
    const float d =
        normalize ? fmaxf(sqrtf(ss[2 * r] + ss[2 * r + 1]), kEps) : 1.f;
    float* lr = ls + r * KL;
    float mx = -INFINITY;
    for (int k = lane; k < K; k += 32) {
      const float v = lr[k] / d;
      lr[k] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float s = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float e = expf(lr[k] - mx);
      lr[k] = e;
      s += e;
    }
    s = warp_sum(s);
    float* ar = a + ((size_t)n * P + p) * KA;
    for (int k = lane; k < KA; k += 32) ar[k] = k < K ? lr[k] / s : 0.f;
    if (lane == 0) dnorm[(size_t)n * P + p] = d;
  }
}

// One kChunkP-row chunk of a warp's (16 kMI clusters x 8 kNI channels) of
// a^T x: acc[mi][ni] is the m16n8 tile of clusters km + 16 mi.. and
// channels cn + 8 ni... A holds a / d (kChunkP x kTileK), X the x chunk
// (kChunkP x kTileC).
// dynamic shared memory of the aggregate pass: kStagesG buffers of a, x, d
template <typename T>
__host__ __device__ constexpr size_t aggregate_smem() {
  return (size_t)kStagesG * kChunkP *
         (Layout<T>::kA * sizeof(float) + Layout<T>::kXB * sizeof(T) +
          sizeof(float));
}

template <typename T>
__device__ __forceinline__ void mma_aggregate(float (&acc)[kMI][kNI][4],
                                              const float* A, const T* X,
                                              int km, int cn, int g, int t) {
  constexpr int kA = Layout<T>::kA, kX = Layout<T>::kXB;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int ks = 0; ks < kChunkP; ks += 8) {
      uint32_t ah[kMI][4], al[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const float* am = A + km + mi * 16 + g;
        split_tf32(am[(ks + t) * kA], ah[mi][0], al[mi][0]);
        split_tf32(am[(ks + t) * kA + 8], ah[mi][1], al[mi][1]);
        split_tf32(am[(ks + t + 4) * kA], ah[mi][2], al[mi][2]);
        split_tf32(am[(ks + t + 4) * kA + 8], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const T* xc = X + cn + ni * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(xc[(ks + t) * kX], bh[0], bl[0]);
        split_tf32(xc[(ks + t + 4) * kX], bh[1], bl[1]);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          mma_tf32(acc[mi][ni], al[mi], bh);
          mma_tf32(acc[mi][ni], ah[mi], bl);
          mma_tf32(acc[mi][ni], ah[mi], bh);
        }
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kChunkP; ks += 16) {
      uint32_t ap[kMI][4][3];  // [mi][fragment register][part]
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const float* am = A + km + mi * 16 + g;
        const int r0 = (ks + 2 * t) * kA, r8 = (ks + 2 * t + 8) * kA;
        split_bf16(am[r0], am[r0 + kA], ap[mi][0]);
        split_bf16(am[r0 + 8], am[r0 + kA + 8], ap[mi][1]);
        split_bf16(am[r8], am[r8 + kA], ap[mi][2]);
        split_bf16(am[r8 + 8], am[r8 + kA + 8], ap[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const T* xc = X + cn + ni * 8 + g;
        uint32_t b[2];
        b[0] = pack_bf16(xc[(ks + 2 * t) * kX], xc[(ks + 2 * t + 1) * kX]);
        b[1] = pack_bf16(xc[(ks + 2 * t + 8) * kX],
                         xc[(ks + 2 * t + 9) * kX]);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int i = 2; i >= 0; --i) {  // smallest part first
            const uint32_t a[4] = {ap[mi][0][i], ap[mi][1][i], ap[mi][2][i],
                                   ap[mi][3][i]};
            mma_bf16(acc[mi][ni], a, b);
          }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsG)
vlad_aggregate_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ dnorm,
                      const float* __restrict__ cent, float* __restrict__ out,
                      float* __restrict__ sq, int P, int C, int K, int KA,
                      int postprocess) {
  using L = Layout<T>;
  constexpr int kGroups = kThreadsG / kTileK;   // threads per a column
  constexpr int kGroupRows = kChunkP / kGroups;  // rows each of them scales
  extern __shared__ __align__(16) unsigned char smem[];
  auto as = reinterpret_cast<float(*)[kChunkP][L::kA]>(smem);
  auto xs = reinterpret_cast<T(*)[kChunkP][L::kXB]>(as + kStagesG);
  auto ds = reinterpret_cast<float(*)[kChunkP]>(xs + kStagesG);
  __shared__ float asum_s[kGroups][kTileK];
  __shared__ float sq_s[kWarpsC][kTileK];

  const int c0 = blockIdx.x * kTileC, k0 = blockIdx.y * kTileK;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp % kWarpsC;
  const int km = (warp / kWarpsC) * 16 * kMI, cn = wc * 8 * kNI;
  const T* xn = x + (size_t)n * P * C;
  const float* an = a + (size_t)n * P * KA;
  const float* dn = dnorm + (size_t)n * P;
  const int nch = (P + kChunkP - 1) / kChunkP;

  // rows p0.. of a (clusters k0..), x (channels c0..) and d into chunk ci's
  // buffer, one commit group; past P, KA or C they read as zero. Past the
  // last chunk: an empty group
  auto stage = [&](int ci) {
    if (ci < nch) {
      const int buf = ci % kStagesG, p0 = ci * kChunkP;
      for (int i = tid; i < kChunkP * (kTileK / 4); i += kThreadsG) {
        const int r = i / (kTileK / 4), u = i % (kTileK / 4), k = k0 + 4 * u;
        const bool ok = p0 + r < P && k < KA;
        cp_async<16>(&as[buf][r][4 * u],
                     ok ? an + (size_t)(p0 + r) * KA + k : an, ok);
      }
      for (int i = tid; i < kChunkP * (kTileC / 4); i += kThreadsG) {
        const int r = i / (kTileC / 4), u = i % (kTileC / 4), c = c0 + 4 * u;
        const bool ok = p0 + r < P && c < C;
        cp_async<4 * sizeof(T)>(&xs[buf][r][4 * u],
                                ok ? xn + (size_t)(p0 + r) * C + c : xn, ok);
      }
      if (tid < kChunkP) {
        const bool ok = p0 + tid < P;
        cp_async<4>(&ds[buf][tid], ok ? dn + p0 + tid : dn, ok);
      }
    }
    cp_commit();
  };

  float acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
  // sum_p a of cluster k0 + col, over rows grp * kGroupRows.. of each chunk
  const int col = tid % kTileK, grp = tid / kTileK;
  float asum = 0.f;
#pragma unroll
  for (int s = 0; s < kStagesG - 1; ++s) stage(s);
  for (int ci = 0; ci < nch; ++ci) {
    const int buf = ci % kStagesG;
    cp_wait<kStagesG - 2>();
    __syncthreads();  // chunk ci has landed; chunk ci - 1 is consumed
    stage(ci + kStagesG - 1);
    {
      // sum_p a, then a / d in place (rows past P have a = 0 and d = 0)
      float s = 0.f;
#pragma unroll
      for (int r = grp * kGroupRows; r < (grp + 1) * kGroupRows; ++r) {
        const float v = as[buf][r][col];
        s += v;
        as[buf][r][col] = v == 0.f ? 0.f : v / ds[buf][r];
      }
      asum += s;
    }
    __syncthreads();
    float part[kMI][kNI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
        part[mi][ni][0] = part[mi][ni][1] = part[mi][ni][2] =
            part[mi][ni][3] = 0.f;
    mma_aggregate<T>(part, &as[buf][0][0], &xs[buf][0][0], km, cn, g, t);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  asum_s[grp][col] = asum;
  __syncthreads();

  // vlad = acc - (sum_p a) * centroid; each cluster's sum of squares over
  // this tile's channels
  float rsq[kMI][2];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsq[mi][h] = 0.f;
      const int kl = km + mi * 16 + g + 8 * h, k = k0 + kl;
      if (k >= K) continue;
      float as_k = 0.f;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) as_k += asum_s[gi][kl];
      const float* ck = cent + (size_t)k * C;
      float* ok = out + ((size_t)n * K + k) * C;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int c = c0 + cn + ni * 8 + 2 * t;
        if (c >= C) continue;
        const float v0 = acc[mi][ni][2 * h] - as_k * ck[c];
        const float v1 = acc[mi][ni][2 * h + 1] - as_k * ck[c + 1];
        *reinterpret_cast<float2*>(ok + c) = make_float2(v0, v1);
        rsq[mi][h] += v0 * v0 + v1 * v1;
      }
    }
  }
  if (!postprocess) return;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rsq[mi][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) sq_s[wc][km + mi * 16 + g + 8 * h] = v;
    }
  __syncthreads();
  if (tid < kTileK && k0 + tid < K) {
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarpsC; ++wi) v += sq_s[wi][tid];
    sq[((size_t)n * K + k0 + tid) * gridDim.x + blockIdx.x] = v;
  }
}

// intra-norm and global L2 of cluster k of image n from the per-tile sums
// of squares sq (N, K, CB)
__global__ void __launch_bounds__(kNormThreads)
vlad_norm_kernel(float* __restrict__ out, const float* __restrict__ sq, int K,
                 int C, int CB) {
  __shared__ float red[33];
  const int k = blockIdx.x, n = blockIdx.y;
  const float* sn = sq + (size_t)n * K * CB;
  float gs = 0.f;  // sum of squares of the intra-normalized rows
  for (int kk = threadIdx.x; kk < K; kk += blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < CB; ++b) s += sn[kk * CB + b];
    const float d = fmaxf(sqrtf(s), kEps);
    gs += s / (d * d);
  }
  const float dg = fmaxf(sqrtf(block_sum(gs, red)), kEps);
  float s = 0.f;
  for (int b = 0; b < CB; ++b) s += sn[k * CB + b];
  const float dk = fmaxf(sqrtf(s), kEps);
  float* o = out + ((size_t)n * K + k) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) o[c] = o[c] / dk / dg;
}

template <typename T>
cudaError_t forward(const void* x, const float* w, const float* cent,
                    float* out, float* a, float* dnorm, float* sq, int n,
                    int p, int c, int k, int ka, int cb, int normalize,
                    int postprocess, int device, cudaStream_t s) {
  const size_t smem = assign_smem<T>(k);
  cudaError_t e = launch_cache::launch_setup(
      device, reinterpret_cast<const void*>(vlad_assign_kernel<T>),
      assign_smem<T>(kMaxK));
  if (e != cudaSuccess) return e;
  e = launch_cache::launch_setup(
      device, reinterpret_cast<const void*>(vlad_aggregate_kernel<T>),
      aggregate_smem<T>());
  if (e != cudaSuccess) return e;
  const T* xt = static_cast<const T*>(x);
  vlad_assign_kernel<T><<<dim3((p + kRowsA - 1) / kRowsA, n), kThreadsA,
                          smem, s>>>(xt, w, a, dnorm, p, c, k, ka, normalize);
  vlad_aggregate_kernel<T>
      <<<dim3(cb, (k + kTileK - 1) / kTileK, n), kThreadsG,
         aggregate_smem<T>(), s>>>(
          xt, a, dnorm, cent, out, sq, p, c, k, ka, postprocess);
  if (postprocess)
    vlad_norm_kernel<<<dim3(k, n), kNormThreads, 0, s>>>(out, sq, k, c, cb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, p, c) f32 or bf16 (x_bf16 = 1); w: (c, k) f32; cent: (k, c) f32;
// out: (n, k, c) f32. Scratch, f32: a (n, p, ka), dnorm (n, p), sq (n, k,
// cb), with ka = k rounded up to 4 and cb = ceil(c / 64). device: the index
// of the current device (the launch set-up is cached per device). Returns a
// cudaError_t (0 = launched).
int netvlad_fused_forward(const void* x, int x_bf16, const void* w,
                          const void* cent, void* out, void* a, void* dnorm,
                          void* sq, int n, int p, int c, int k, int ka, int cb,
                          int normalize, int postprocess, int device,
                          void* stream) {
  if (n <= 0 || p <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxK || c < 4 || c % 4 != 0 || ka != (k + 3) / 4 * 4 ||
      cb != (c + kTileC - 1) / kTileC)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* cf = static_cast<const float*>(cent);
  float* of = static_cast<float*>(out);
  float* af = static_cast<float*>(a);
  float* df = static_cast<float*>(dnorm);
  float* sf = static_cast<float*>(sq);
  return x_bf16 ? forward<__nv_bfloat16>(x, wf, cf, of, af, df, sf, n, p, c,
                                         k, ka, cb, normalize, postprocess,
                                         device, s)
                : forward<float>(x, wf, cf, of, af, df, sf, n, p, c, k, ka, cb,
                                 normalize, postprocess, device, s);
}

}  // extern "C"
