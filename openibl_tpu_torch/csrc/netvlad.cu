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
// Design. The TPU kernel keeps a whole image in VMEM; at the main-path shape
// (P = 30*40 = 1200, C = 512, K = 64) x alone is 2.4 MB in f32, ten times a
// block's 227 KB of shared memory. The softmax is per location, so the P
// axis splits into independent tiles of kTile = 32 rows:
//   pass 1, grid (ceil(P/32), N), 256 threads: load the tile upcast to f32
//     into shared memory (16-byte loads, several in flight); each warp then
//     owns 4 rows: row norms, logits (a lane holds 2 clusters x 4 rows,
//     assign_w streamed through two shared buffers by cp.async) and
//     the softmax; then the tile's partial a^T x (K, C), each warp 8
//     clusters and each lane 8 channels (64 accumulators in registers), and
//     sum_p a (K), written to scratch. Both products are register-blocked so
//     shared-memory reads are broadcasts or contiguous 512-byte warp rows,
//     and fewer than one per four FMAs;
//   pass 2, grid (K, N): sum the T partials of one cluster in a fixed order,
//     subtract (sum a) * centroid, and with postprocess intra-normalize and
//     write the cluster's share of the global sum of squares;
//   pass 3 (postprocess only), grid (K, N): divide by the global norm.
// No atomics and fixed reduction orders: one image gives the same descriptor
// bits on every run, which a serving index relies on.
//
// Shared memory of pass 1: (32 * C + 32 * KP + 2 * kChunk * 64) * 4 bytes,
// KP = K rounded up to 16. At C = 512, K = 64: 106,496 bytes (opted in
// above the 48 KB default), two blocks per SM within the 227 KB budget. Takes C a
// multiple of 4 and K <= 256.
//
// What bounds it on the H100, at N = 16 images of the main path: 2.5 GFLOP
// (two products of 2*N*P*C*K) on f32 CUDA cores (67 TFLOP/s peak: >= 37 us),
// and bytes: x once (39 MB f32, 20 MB bf16) plus the pass-1 scratch written
// and read once (N * T * K * C * 4 = 80 MB each way), about 200 MB or
// >= 60 us at 3.35 TB/s. The scratch is the largest byte term; in-block
// accumulation across tiles would cut it, and tensor cores (TF32 / bf16
// wgmma) and TMA are later work. This version is plain f32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;                        // pass-1 block
constexpr int kTile = 32;                            // pass-1 rows (P tile)
constexpr int kWarpRows = kTile / (kThreads / 32);   // rows per warp
constexpr int kChunk = 64;           // logits: channels of assign_w per stage
constexpr int kPad = 16;             // K is padded to a multiple of this
constexpr int kReduceThreads = 128;  // passes 2 and 3
static_assert(kWarpRows == 4, "the logits loop holds 4 rows per warp");
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 4-byte asynchronous copy global -> shared; ok = false writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// Stage assign_w[c0 : c0+kChunk, kb : kb+64] into buf, zero past C and K.
__device__ __forceinline__ void stage_w(float* buf, const float* w, int c0,
                                        int kb, int C, int K) {
  for (int i = threadIdx.x; i < kChunk * 64; i += blockDim.x) {
    const int cc = c0 + (i >> 6), kk = kb + (i & 63);
    const bool ok = cc < C && kk < K;
    cp_async4(buf + i, ok ? w + (size_t)cc * K + kk : w, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
vlad_partial_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ part, float* __restrict__ asum_part,
                    int P, int C, int K, int KP, int normalize) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // (kTile, C)
  float* as = xs + kTile * C;                   // (kTile, KP)
  float* ws = as + kTile * KP;                  // 2 x (kChunk, 64)
  const float4* xs4 = smem4;
  const float4* as4 = reinterpret_cast<const float4*>(as);
  const int t = blockIdx.x, n = blockIdx.y, T_ = gridDim.x;
  const int rows = min(kTile, P - t * kTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C4 = C >> 2;

  // tile load, 4 channels a thread a step; rows past the image are zero
  const T* xg = x + ((size_t)n * P + (size_t)t * kTile) * C;
#pragma unroll 4
  for (int i = tid; i < kTile * C4; i += kThreads) {
    const int r = i / C4;
    reinterpret_cast<float4*>(xs)[i] =
        r < rows ? load4(xg + (size_t)i * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // warp w owns rows 4w..4w+3 for the norm, the logits and the softmax
  const int r0 = warp * kWarpRows;
  if (normalize) {
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      float4* row = reinterpret_cast<float4*>(xs + (r0 + i) * C);
      float ss = 0.f;
      for (int c = lane; c < C4; c += 32) {
        const float4 v = row[c];
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
      const float d = fmaxf(sqrtf(warp_sum(ss)), kEps);
      for (int c = lane; c < C4; c += 32) {
        float4 v = row[c];
        v.x /= d; v.y /= d; v.z /= d; v.w /= d;
        row[c] = v;
      }
    }
  }

  // logits, 64 clusters at a time: lane owns clusters kb+lane and
  // kb+lane+32 of the warp's 4 rows. assign_w streams through two shared
  // buffers of kChunk channels: the copy of chunk i+1 is in flight while
  // chunk i is multiplied. Rows past the image give logits of zero rows.
  const int nch = (C + kChunk - 1) / kChunk;
  for (int kb = 0; kb < K; kb += 64) {
    float acc[kWarpRows][2];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) acc[i][0] = acc[i][1] = 0.f;
    stage_w(ws, w, 0, kb, C, K);
    for (int ci = 0; ci < nch; ++ci) {
      if (ci + 1 < nch) {
        stage_w(ws + ((ci + 1) & 1) * kChunk * 64, w, (ci + 1) * kChunk, kb,
                C, K);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();  // chunk ci has landed for every thread
      const float* wbuf = ws + (ci & 1) * kChunk * 64;
      const int c0 = ci * kChunk, nc = min(kChunk, C - c0);
      for (int cc = 0; cc < nc; cc += 4) {
        float4 xv[kWarpRows];
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i)
          xv[i] = xs4[((r0 + i) * C + c0 + cc) >> 2];  // broadcast
        const float* wc = wbuf + cc * 64;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float w0 = wc[u * 64 + lane], w1 = wc[u * 64 + lane + 32];
#pragma unroll
          for (int i = 0; i < kWarpRows; ++i) {
            const float xu = u == 0 ? xv[i].x : u == 1 ? xv[i].y
                           : u == 2 ? xv[i].z : xv[i].w;
            acc[i][0] = fmaf(xu, w0, acc[i][0]);
            acc[i][1] = fmaf(xu, w1, acc[i][1]);
          }
        }
      }
      __syncthreads();  // buffer ci & 1 is free for chunk ci + 2
    }
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      if (kb + lane < KP) as[(r0 + i) * KP + kb + lane] = acc[i][0];
      if (kb + lane + 32 < KP) as[(r0 + i) * KP + kb + lane + 32] = acc[i][1];
    }
  }
  __syncwarp();

  // softmax over K of the warp's rows; rows past the image and the K..KP
  // pad get weight 0
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const int r = r0 + i;
    float* row = as + r * KP;
    if (r >= rows) {
      for (int kk = lane; kk < KP; kk += 32) row[kk] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int kk = lane; kk < K; kk += 32) m = fmaxf(m, row[kk]);
    m = warp_max(m);
    float s = 0.f;
    for (int kk = lane; kk < K; kk += 32) {
      const float e = expf(row[kk] - m);
      row[kk] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int kk = lane; kk < KP; kk += 32) row[kk] = kk < K ? row[kk] / s : 0.f;
  }
  __syncthreads();

  // partial a^T x: warp owns clusters 8kg..8kg+7, lane owns channels
  // cb + 4 lane + {0..3} and cb + 128 + 4 lane + {0..3}
  float* pg = part + ((size_t)n * T_ + t) * K * C;
  for (int kg = warp; kg < KP / 8; kg += kThreads / 32) {
    for (int cb = 0; cb < C; cb += 256) {
      const int ca = cb + 4 * lane, cz = ca + 128;
      const bool va = ca < C, vz = cz < C;
      float4 acc[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j][0] = acc[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < rows; ++r) {
        const float4 a0 = as4[(r * KP + 8 * kg) >> 2];  // broadcast
        const float4 a1 = as4[((r * KP + 8 * kg) >> 2) + 1];
        const float4 xa = va ? xs4[(r * C + ca) >> 2]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 xz = vz ? xs4[(r * C + cz) >> 2]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          fma4(acc[j][0], av[j], xa);
          fma4(acc[j][1], av[j], xz);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = 8 * kg + j;
        if (k < K) {
          if (va) *reinterpret_cast<float4*>(pg + (size_t)k * C + ca) = acc[j][0];
          if (vz) *reinterpret_cast<float4*>(pg + (size_t)k * C + cz) = acc[j][1];
        }
      }
    }
  }
  if (tid < K) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += as[r * KP + tid];
    asum_part[((size_t)n * T_ + t) * K + tid] = s;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
vlad_reduce_kernel(const float* __restrict__ part,
                   const float* __restrict__ asum_part,
                   const float* __restrict__ cent, float* __restrict__ out,
                   float* __restrict__ sq, int T, int K, int C,
                   int postprocess) {
  __shared__ float red[33];
  const int k = blockIdx.x, n = blockIdx.y;
  float asum = 0.f;
  for (int t = 0; t < T; ++t) asum += asum_part[((size_t)n * T + t) * K + k];
  const float* pk = part + ((size_t)n * T * K + k) * C;
  const size_t tstride = (size_t)K * C;
  float* o = out + ((size_t)n * K + k) * C;
  float ss = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float v = 0.f;
    for (int t = 0; t < T; ++t) v += __ldg(pk + t * tstride + c);
    v -= asum * cent[(size_t)k * C + c];
    o[c] = v;
    ss += v * v;
  }
  if (!postprocess) return;
  const float d = fmaxf(sqrtf(block_sum(ss, red)), kEps);
  float s2 = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float v = o[c] / d;  // the value this thread wrote above
    o[c] = v;
    s2 += v * v;
  }
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) sq[(size_t)n * K + k] = s2;
}

__global__ void __launch_bounds__(kReduceThreads)
vlad_global_norm_kernel(float* __restrict__ out, const float* __restrict__ sq,
                        int K, int C) {
  const int k = blockIdx.x, n = blockIdx.y;
  float g = 0.f;
  for (int kk = 0; kk < K; ++kk) g += sq[(size_t)n * K + kk];
  const float d = fmaxf(sqrtf(g), kEps);
  float* o = out + ((size_t)n * K + k) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) o[c] = o[c] / d;
}

template <typename T>
cudaError_t launch_partial(const void* x, const float* w, float* part,
                           float* asum_part, int n, int p, int c, int k,
                           int kp, int normalize, cudaStream_t s) {
  const int tiles = (p + kTile - 1) / kTile;
  const size_t smem =
      ((size_t)kTile * c + (size_t)kTile * kp + (size_t)2 * kChunk * 64) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      vlad_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  vlad_partial_kernel<T><<<dim3(tiles, n), kThreads, smem, s>>>(
      static_cast<const T*>(x), w, part, asum_part, p, c, k, kp, normalize);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, p, c) f32 or bf16 (x_bf16 = 1); w: (c, k) f32; cent: (k, c) f32;
// out: (n, k, c) f32; part: (n, T, k, c) f32; asum_part: (n, T, k) f32;
// sq: (n, k) f32; tp must be 32, T = ceil(p / 32). Returns a cudaError_t (0 = launched).
int netvlad_fused_forward(const void* x, int x_bf16, const void* w,
                          const void* cent, void* out, void* part,
                          void* asum_part, void* sq, int n, int p, int c,
                          int k, int tp, int normalize, int postprocess,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  if (k < 1 || k > 256 || c % 4 != 0 || tp != kTile)
    return cudaErrorInvalidValue;
  const int kp = (k + kPad - 1) / kPad * kPad;
  const int tiles = (p + kTile - 1) / kTile;
  const float* wf = static_cast<const float*>(w);
  float* partf = static_cast<float*>(part);
  float* asumf = static_cast<float*>(asum_part);
  cudaError_t e =
      x_bf16 ? launch_partial<__nv_bfloat16>(x, wf, partf, asumf, n, p, c, k,
                                             kp, normalize, s)
             : launch_partial<float>(x, wf, partf, asumf, n, p, c, k, kp,
                                     normalize, s);
  if (e != cudaSuccess) return e;
  vlad_reduce_kernel<<<dim3(k, n), kReduceThreads, 0, s>>>(
      partf, asumf, static_cast<const float*>(cent), static_cast<float*>(out),
      static_cast<float*>(sq), tiles, k, c, postprocess);
  if (postprocess)
    vlad_global_norm_kernel<<<dim3(k, n), kReduceThreads, 0, s>>>(
        static_cast<float*>(out), static_cast<const float*>(sq), k, c);
  return cudaGetLastError();
}

}  // extern "C"
