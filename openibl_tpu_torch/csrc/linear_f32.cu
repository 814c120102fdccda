// F32 linear layer y = x W^T + b on the tensor cores in split TF32 (3xTF32),
// with the bias fused, for Hopper (sm_90a), CUDA C++ with a plain C entry
// (kernel K5).
//
// Replaces no Pallas kernel: the JAX package has no ViT, and the port left
// AnyLoc's DINOv2 linears (models/dinov2.py: qkv, proj, w12, w3 in each
// block and the facet's value rows) to cuBLAS, whose f32 GEMM runs on the
// CUDA cores (sm80_xmma_gemm_f32f32_f32f32_f32_tn_n..._ffma). For x (M, K)
// f32 row-major and W (N, K) f32 (nn.Linear's layout) it computes, per
// output (row r, column o),
//   y = sum over k of x[r, k] * W[o, k], then + b[o],
// written f32 row-major (M, N). Each product is taken in split precision,
// as K4 (csrc/conv_f32.cu) does: an operand v = hi + lo with hi = v rounded
// to the nearest TF32 (cvt.rna.tf32.f32) and lo = tf32(v - hi) (the
// subtraction is exact); the three TF32 products lo_x * hi_w, hi_x * lo_w,
// then hi_x * hi_w are summed, small terms first, and lo_x * lo_w (below
// 2^-22 of the product) is dropped. Each operand keeps ~22 of f32's 24
// mantissa bits. The sums are f32: each K step's 12 wgmma products (32
// columns of K, three terms) go to a zeroed tensor-core accumulator, which
// is then added to the running sum in registers with __fadd_rn. One
// tensor-core accumulator over a long K errs far more (K4 read 4.8e-6 of
// the sum of |x * w| over 4608 terms on the H100, against ~1e-7 flushed a
// step): its additions do not round to nearest. K5 reads 0.8-1.1e-7 at the
// ViT's shapes, cuBLAS's f32 GEMM 4.2-4.7e-7. A flush every 64 columns was
// no faster in the AnyLoc build, which holds the card at its 700 W limit,
// and lifted the build's descriptor gap 1.7x (PERF.md). The bias add is
// __fadd_rn after the full sum. ops/linear_kernel.py's linear_split_emulation is this
// arithmetic in plain PyTorch.
//
// Design: K4's consumer loop on a plain GEMM.
// - A block owns an output tile of 128 rows (two consumer warpgroups, 64
//   rows each) by 128 columns, and walks K in steps of BK = 32 (128 bytes,
//   the 128B swizzle). Tiles of 64 rows (one consumer warpgroup, a producer
//   warp) ran 1.05-1.35x slower at every ViT shape, batch 1 included
//   (PERF.md), and went.
// - Operands by TMA (cuTensorMapEncodeTiled through the runtime's driver
//   entry point: no -lcuda): x is a 2-D map over (K, M), box (32, 128);
//   the weights' TF32 parts hi and lo are 2-D maps over (K, N), box (32,
//   128): both K-major, as TF32 wgmma requires and as nn.Linear stores W.
//   Rows past M are TMA's zero fill; their outputs are not stored. The
//   split of the weights is made once per weight version by the wrapper.
// - The activations are split on chip, in registers: each consumer thread
//   loads its two rows' eight columns of the stage from shared memory (four
//   16-byte loads, conflict-free through the swizzle), splits them and
//   issues register-A wgmma.mma_async m64n128k8 .f32.tf32.tf32, B from the
//   stage's shared-memory descriptors: 3 products x 4 k8 steps a stage. The
//   wrapper permutes each 32-column chunk of the weights' K (K4's
//   ``K_ORDER``) so that a thread's fragment columns are the columns 8t ..
//   8t + 7 of the chunk, two 16-byte vectors a row.
// - A ring of 4 stages (A tile, B hi, B lo: 48 KB; 1024-byte aligned), each
//   with a full and an empty mbarrier. One producer thread (of the last
//   warpgroup, whose registers setmaxnreg hands to the consumers: 232 a
//   consumer thread, against the 168 that 384 threads get at launch and
//   224 that the loop takes without spilling; setmaxnreg moves registers
//   only inside the block's allocation, so a producer warp alone frees too
//   few) issues a stage's three loads on its full barrier with the stage's
//   byte count.
//   A consumer warpgroup keeps one commit group in flight: it loads the next
//   stage's A from shared memory while the last group runs, waits for that
//   group, adds its accumulator to the running sum, gives its stage back
//   (lane 0 of each warp arrives on the empty barrier), splits and issues.
//   One consumer warpgroup's split and adds overlap the other's products
//   on the SM's tensor cores, and a B tile serves 128 rows, so a stage
//   brings 48 KB for 3 * 128 * 128 * 32 multiply-adds.
// - The epilogue adds the bias to the running sums on wgmma's accumulator
//   layout (PTX ISA, m64nNk8 .f32 D fragment: warp v of the warpgroup holds
//   rows 16 v + lane / 4 and + 8, d[4 i + j] at column 8 i + 2 (lane % 4) +
//   j % 2, row + 8 for j >= 2) and stores them straight from registers:
//   each store instruction of a warp fills eight whole 32-byte sectors.
//   Rows past M are not stored. No shared memory is kept for the output, so
//   the ring takes it all.
// - Persistent blocks: at most one an SM, each walking the tiles in a static
//   stride, so the producer loads the next tile's stages while the
//   consumers finish this one. Tiles go in groups of kGroupM row tiles, the
//   row tile fastest, so that the tiles in flight at once (132 on the H100)
//   share a few row and column panels in L2.
// - A barrier wait that spins for ~2^34 cycles traps.
//
// What bounds it on the H100 SXM (700 W): operations. The three TF32
// products of 2 * M * K * N f32 operations run at 495 TFLOP/s dense, a 165
// TFLOP/s ceiling for the f32 work. At AnyLoc's batch 16 (24,496 token rows;
// the facet 24,480) the 125 linears of a forward hold 43.11 TFLOP: 87.1 ms
// at the TF32 peak that the benchmark's yardstick counts once, 261 ms at the
// split ceiling, against cuBLAS's ~0.88 s on the CUDA cores. Shared memory
// is next: at full rate the wgmma B reads take 64 bytes a clock an SM, the
// stage fill 32, the A loads 11, of the 128 an SM has. In the AnyLoc build
// the card runs at its power limit, below full clocks. Times on the card
// are in PERF.md (chip_smoke.py).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace {

constexpr int kBK = 32;            // K a step: K a multiple of it
constexpr int kBM = 128;           // rows a tile: 64 a consumer warpgroup
constexpr int kBN = 128;           // output columns a tile: N a multiple
constexpr int kRowBytes = 128;     // kBK f32: a row of a tile, one swizzle span
constexpr int kStages = 4;         // stages in the ring
constexpr int kThreads = 384;      // two consumer warpgroups, one producer
constexpr int kSmemAlign = 1024;   // every buffer on the 128B swizzle's period
constexpr int kBarBytes = 16;      // a stage's full and empty mbarriers
constexpr int kGroupM = 16;        // row tiles a group of the tile walk
constexpr int kConsumerRegs = 232; // a consumer thread's registers
constexpr int kProducerRegs = 40;  // a producer thread's
constexpr long long kWatchdogCycles = 1LL << 34;

constexpr uint32_t kABytes = kBM * kRowBytes;
constexpr uint32_t kBBytes = kBN * kRowBytes;
constexpr uint32_t kStageBytes = kABytes + 2 * kBBytes;
// alignment slack, the stages (A tile, B hi, B lo), the barriers
constexpr int kSmemBytes = kSmemAlign + kStages * (kStageBytes + kBarBytes);
static_assert(kSmemBytes <= 232448, "over a block's dynamic shared memory");

struct Params {
  const float* bias;
  float* out;
  int m, n, k, m_tiles, n_tiles, tiles;
};

// tile t of the walk: groups of kGroupM row tiles (the last group smaller),
// the row tile fastest inside a group
__device__ __forceinline__ void tile_of(int t, const Params& p, int& mt,
                                        int& nt) {
  const int group = kGroupM * p.n_tiles;
  const int first = (t / group) * kGroupM;
  const int rows = min(kGroupM, p.m_tiles - first);
  const int local = t - (t / group) * group;
  mt = first + local % rows;
  nt = local / rows;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) {
      start = now;
    } else if (now - start > kWatchdogCycles) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// K-major operand of 128-byte rows in the 128B swizzle, 8-row groups 1024
// bytes apart: start address, leading byte offset 16 (unused: K fits the
// atom), stride byte offset 1024, layout type 1 (128B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// v rounded to the nearest TF32, ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32: hi to nearest, lo the exact rest to nearest
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128 f32) = [d +] a (64 x 8 tf32, registers) * b (128 x 8 tf32,
// K-major in shared memory)^T
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// one tile's sums + bias, stored from registers as the PTX D fragment
// places them: rows `row` and row + 8 (those below m), columns 8 i + q2
// and + 1 of `out` (the tile's first column). Each column group starts
// from copies of the row offsets that an empty asm makes opaque, and ends
// with a memory clobber, so the compiler does not load every group's bias
// at once
__device__ __forceinline__ void store_out(const float (&sum)[64], float* out,
                                          int row, int m, int n, int q2,
                                          const float* bias) {
  const unsigned long long off0 =
      static_cast<unsigned long long>(row) * n + q2;
  const unsigned long long off1 = off0 + static_cast<unsigned long long>(8) * n;
  const bool ok0 = row < m, ok1 = row + 8 < m;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    unsigned long long o0 = off0, o1 = off1;
    asm volatile("" : "+l"(o0), "+l"(o1));
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * i));
    if (ok0) {
      *reinterpret_cast<float2*>(out + o0 + 8 * i) = make_float2(
          __fadd_rn(sum[4 * i], b.x), __fadd_rn(sum[4 * i + 1], b.y));
    }
    if (ok1) {
      *reinterpret_cast<float2*>(out + o1 + 8 * i) = make_float2(
          __fadd_rn(sum[4 * i + 2], b.x), __fadd_rn(sum[4 * i + 3], b.y));
    }
    asm volatile("" ::: "memory");
  }
}

// a 128 x 128 output tile a step of the walk: two consumer warpgroups (64
// rows of the tile each) and a producer warpgroup
__global__ void __launch_bounds__(kThreads, 1)
linear_f32x3(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap hmap,
             const __grid_constant__ CUtensorMap lmap, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + kSmemAlign - 1) & ~uint32_t(kSmemAlign - 1);
  const uint32_t bars = ring + kStages * kStageBytes;
  const int k_steps = p.k / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + s * kBarBytes, 1);      // full: the producer
      mbar_init(bars + s * kBarBytes + 8, 8);  // empty: the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&xmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&hmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&lmap)) : "memory");
  }
  __syncthreads();

  // the block is three warpgroups, launched at 168 registers a thread (an
  // SM's 65,536 over 384): the producer warpgroup gives 128 of each
  // thread's back and the consumers take 64 each (one branch each, never
  // rejoined)
  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    // one thread issues every load, the tiles' steps in order
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        int mt, nt;
        tile_of(t, p, mt, nt);
        for (int k = 0; k < k_steps; ++k) {
          const uint32_t full = bars + stage * kBarBytes;
          const uint32_t dst = ring + stage * kStageBytes;
          mbar_wait(full + 8, phase ^ 1);  // the consumers released it
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(dst, &xmap, full, k * kBK, mt * kBM);
          tma_load_2d(dst + kABytes, &hmap, full, k * kBK, nt * kBN);
          tma_load_2d(dst + kABytes + kBBytes, &lmap, full, k * kBK,
                      nt * kBN);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = tid / 128, lane = tid % 32;
    const int g = lane / 4, q = lane % 4;
    // this thread's rows of the tile: A and D fragments, row0 and row0 + 8
    const int row0 = 64 * wg + 16 * ((tid % 128) / 32) + g;
    float sum[kBN / 2];  // the running f32 sums
    float acc[kBN / 2];  // one K step's tensor-core sums
    uint32_t hi[4][4], lo[4][4];  // [k8 step][a0..a3]
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sum[i] = 0.f;
      int prev = -1;  // the stage whose wgmma group may still run
      for (int k = 0; k < k_steps; ++k) {
        mbar_wait(bars + stage * kBarBytes, phase);
        // columns 8q .. 8q + 7 of rows row0 and row0 + 8 (row0 % 8 == g)
        const uint8_t* a = smem_raw + (ring + stage * kStageBytes - raw);
        float4 v[2][2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            v[half][c] = *reinterpret_cast<const float4*>(
                a + (row0 + 8 * half) * kRowBytes + (((2 * q + c) ^ g) << 4));
          }
        }
        // the last group reads hi and lo and writes acc: wait for it, add
        // its sums, then free its stage
        wgmma_wait0();
        fence_acc(acc);
        if (prev >= 0) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
          if (lane == 0) mbar_arrive(bars + prev * kBarBytes + 8);
        }
        // k8 step kk: columns q and q + 4 are the chunk's columns 8q + 2kk
        // and 8q + 2kk + 1 (the weights' k order), a0/a2 row0, a1/a3 + 8
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int c = kk / 2;
          const float r0a = (kk % 2) ? v[0][c].z : v[0][c].x;
          const float r1a = (kk % 2) ? v[1][c].z : v[1][c].x;
          const float r0b = (kk % 2) ? v[0][c].w : v[0][c].y;
          const float r1b = (kk % 2) ? v[1][c].w : v[1][c].y;
          split_tf32(r0a, hi[kk][0], lo[kk][0]);
          split_tf32(r1a, hi[kk][1], lo[kk][1]);
          split_tf32(r0b, hi[kk][2], lo[kk][2]);
          split_tf32(r1b, hi[kk][3], lo[kk][3]);
        }
        const uint32_t b = ring + stage * kStageBytes + kABytes;
        wgmma_fence();
        fence_acc(acc);
        // the small terms of the four k8 steps first, into a zeroed
        // accumulator, then the large ones
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32(acc, lo[kk], smem_desc(b + 32 * kk), kk > 0);
          wgmma_tf32(acc, hi[kk], smem_desc(b + kBBytes + 32 * kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32(acc, hi[kk], smem_desc(b + 32 * kk), 1);
        }
        wgmma_commit();
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait0();
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      if (lane == 0 && prev >= 0) mbar_arrive(bars + prev * kBarBytes + 8);

      int mt, nt;
      tile_of(t, p, mt, nt);
      store_out(sum, p.out + nt * kBN, mt * kBM + row0, p.m, p.n, 2 * q,
                p.bias + nt * kBN + 2 * q);
    }
  }
}

// --------------------------------------------------------------------------
// host side: tensor maps and the launch

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// -lcuda), looked up once
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(sym)
               : nullptr;
  }();
  return fn;
}

// an f32 2-D tiled map over (k, rows), row stride k * 4 bytes, box (32,
// box_rows) in the 128B swizzle, zero fill outside the tensor
bool encode(CUtensorMap* map, const void* ptr, int k, int rows,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(k), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(k) * 4};
  const cuuint32_t box[2] = {cuuint32_t(kBK), cuuint32_t(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x (m, k) f32; w_hi and w_lo (n, k) f32, the weights' TF32 parts with each
// 32-column chunk of k in the kernel's k order
// (ops/linear_kernel.py:split_weight); bias (n,) f32; out (m, n) f32. All
// contiguous, 16-byte aligned, on device `device` (current). `blocks`
// blocks walk the 128 x 128 tiles (ops/linear_kernel.py:linear_blocks: at
// most one an SM). Returns a cudaError_t: cudaErrorInvalidValue for a shape
// the kernel does not take or a grid of no block or of more blocks than
// tiles, cudaErrorNotSupported when the driver has no
// cuTensorMapEncodeTiled or refuses a map.
extern "C" int f32_linear_forward(const float* x, const float* w_hi,
                                  const float* w_lo, const float* bias,
                                  float* out, int m, int n, int k, int blocks,
                                  int device, void* stream) {
  if (m < 1 || k < kBK || k % kBK != 0 || n < kBN || n % kBN != 0) {
    return cudaErrorInvalidValue;
  }
  const int m_tiles = (m + kBM - 1) / kBM;
  const long long tiles = static_cast<long long>(m_tiles) * (n / kBN);
  if (tiles >= (1LL << 31) || blocks < 1 || blocks > tiles) {
    return cudaErrorInvalidValue;
  }

  CUtensorMap xmap, hmap, lmap;
  if (!encode(&xmap, x, k, m, kBM) || !encode(&hmap, w_hi, k, n, kBN) ||
      !encode(&lmap, w_lo, k, n, kBN)) {
    return cudaErrorNotSupported;
  }

  Params p;
  p.bias = bias;
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.m_tiles = m_tiles;
  p.n_tiles = n / kBN;
  p.tiles = static_cast<int>(tiles);
  const void* kernel = reinterpret_cast<const void*>(&linear_f32x3);
  const cudaError_t e = launch_cache::launch_setup(device, kernel, kSmemBytes);
  if (e != cudaSuccess) return e;
  linear_f32x3<<<blocks, kThreads, kSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(xmap, hmap, lmap, p);
  return cudaGetLastError();
}
