// F32 3x3 convolution on the tensor cores in split TF32 (3xTF32), with the
// bias and ReLU fused, for Hopper (sm_90a), CUDA C++ with a plain C entry
// (kernel K4).
//
// Replaces no Pallas kernel: the JAX package leaves VGG16's convolutions to
// XLA (openibl_tpu/models/vgg.py, lax.conv_general_dilated), and the port
// left them to cuDNN, whose f32 forward runs on the CUDA cores
// (sm80_xmma_fprop_implicit_gemm_f32f32..., behind NHWC<->NCHW transposes),
// followed by separate bias and ReLU passes. For x (N, H, W, Cin) f32 NHWC
// and w (Cout, 3, 3, Cin) f32 it computes, per output (pixel p, channel o),
//   y = sum over the 9 * Cin taps of x * w, then + b[o], then ReLU if asked,
// written f32 NHWC. Each product is taken in split precision: an operand
// v = hi + lo with hi = v rounded to the nearest TF32 (cvt.rna.tf32.f32)
// and lo = tf32(v - hi) (the subtraction is exact), and three TF32
// products are summed, small terms first: lo_x * hi_w, hi_x * lo_w, then
// hi_x * hi_w; lo_x * lo_w (below 2^-22 of the product) is dropped. Each
// operand keeps ~22 of f32's 24 mantissa bits; plain TF32 (one product)
// errs ~2^-11 a product, ~1000x more. No bf16 anywhere. The sums are f32:
// each K step's 12 wgmma products (32 channels of one tap, three terms)
// go to a zeroed tensor-core accumulator, which is then added to the
// running sum in registers with __fadd_rn, as K1 does. One tensor-core
// accumulator over the whole 9 * Cin reduction read up to 4.8e-6 of the
// sum of |x * w| on the H100 at Cin 512 (its additions do not round to
// nearest, so their errors pile up); a fresh one a step keeps each
// tensor-core sum short. The bias add is __fadd_rn after the full sum.
// ops/conv_kernel.py's conv3x3_split_emulation is this arithmetic in
// plain PyTorch.
//
// Design: K3's skeleton (csrc/quant_conv.cu), re-typed.
// - A block owns an output tile of TH x TW pixels of one image by BN output
//   channels, in one of two shapes: 64 pixels (one consumer warpgroup) by
//   BN 128, or 128 pixels (two consumer warpgroups) by BN 64, the only
//   pairs the chooser picks at VGG16's shapes (Cout 64 takes the second).
//   It walks K = 9 * Cin in steps of one tap and BK = 32 channels (128
//   bytes, the 128B swizzle): chunk outer, tap inner, 144 steps at Cin =
//   512.
// - Operands by TMA (cuTensorMapEncodeTiled through the runtime's driver
//   entry point: no -lcuda). x is a 4-D tiled map over (Cin, W, H, N), box
//   (32, TW, TH, 1); tap (dy, dx) of tile (y0, x0) loads at (c0, x0 + dx -
//   1, y0 + dy - 1, n), and TMA's zero fill of every element outside the
//   tensor is the SAME padding. The weights' hi and lo parts are 2-D maps
//   over (9 * Cin, Cout), box (32, BN) at (tap * Cin + c0, n0): K-major B
//   tiles. All in the 128B swizzle. The split of the weights is made once
//   per weight version by the wrapper, not per call.
// - The activations are split on chip, in registers: each consumer thread
//   loads its rows' channels of the stage from shared memory (four 16-byte
//   loads, conflict-free through the swizzle), splits them, and issues
//   register-A wgmma.mma_async m64nBNk8 .f32.tf32.tf32 (TF32 takes both
//   operands K-major; NHWC x and (Cout, 3, 3, Cin) w are K-major as
//   stored), B from the stage's shared-memory descriptors: 3 products x 4
//   k8 steps a stage. A register-A fragment gives thread (lane % 4) the
//   columns t and t + 4 of each k8 step; the wrapper permutes each 32-
//   channel chunk of the weights (``k_order``) so that those columns are
//   the channels 8t .. 8t + 7 of the chunk, which a thread then reads as
//   two 16-byte vectors a row. Chosen over a transform stage that would
//   write hi and lo tiles of x back to shared memory: that doubles the A
//   tile's shared-memory bytes and adds a barrier a stage, while the split
//   in registers costs ~50 ALU instructions a thread a stage against ~768
//   tensor-core clocks of its warpgroup's wgmma (not measured against each
//   other on the card).
// - A ring of S stages (A tile, B hi, B lo; 1024-byte aligned), each with
//   a full and an empty mbarrier. One producer thread (the last warp)
//   issues a stage's three loads on its full barrier with the stage's byte
//   count. A consumer warpgroup keeps one commit group in flight: it loads
//   the next stage's A from shared memory while the last group runs, waits
//   for that group (its A registers and its tensor-core accumulator are
//   then free), adds that accumulator to the running sum, gives its stage
//   back (lane 0 of each warp arrives on the empty barrier), splits and
//   issues. With two consumer warpgroups, one's split and adds overlap the
//   other's products on the SM's tensor cores. The producer is one warp,
//   not a warpgroup, so that the consumer threads have the registers for
//   both accumulators (at BN 128: 2 x 64 a thread).
// - The epilogue adds the bias and applies ReLU on wgmma's accumulator
//   layout (PTX ISA, m64nNk8 .f32 D fragment: warp v of the warpgroup holds
//   rows 16 v + lane / 4 and + 8, d[4 i + j] at column 8 i + 2 (lane % 4) +
//   j % 2, row + 8 for j >= 2), stages the tile in shared memory in slabs
//   of 32 channels (128 bytes a pixel, TMA's swizzle: no bank conflicts),
//   issues fence.proxy.async and writes each slab with a TMA store through
//   a 4-D map on out (Cout, W, H, N), which clips the pixels past H or W.
// - Blocks walk tiles in a static stride, the N tile fastest; the grid is
//   at most one block an SM (persistent: the producer loads the next
//   tile's stages while the consumers store this one), or one block a
//   tile. The geometry (tile, BN, stages, grid, shared memory) is chosen in
//   Python (ops/conv_kernel.py:conv_geometry, by shape and SM count); the C
//   entry runs it as given and refuses one that does not cover the shape
//   or does not fit.
// - A barrier wait that spins for ~2^34 cycles traps.
//
// What bounds it on the H100 SXM (700 W): operations. The three TF32
// products of 2 * M * 9 * Cin * Cout f32 operations run at 495 TFLOP/s
// dense, a 165 TFLOP/s ceiling for the f32 work; at batch 16 and 480x640
// conv1_2..conv5_3 hold 2.99 TFLOP (18.1 ms at that ceiling, 6.04 ms at
// the TF32 peak that the benchmark's yardstick counts once) against 44.6
// ms of f32 CUDA-core time at 67 TFLOP/s. conv1_1 (Cin 3) runs as Cin 32,
// the wrapper padding x with zero channels: 10.7x its work, still faster
// than cuDNN's f32 conv1_1 and its ReLU pass. L2 is next: a stage brings
// (TH * TW + 2 * BN) * 128 bytes for 3 * TH * TW * BN * 32 multiply-adds,
// at full rate 53 bytes a clock an SM on a 64-pixel tile at BN 128 (32 on
// a 128-pixel one). Measured at batch 16: 86-104 TFLOP/s of f32 work at
// conv1_2..conv5_3, 52-63% of the split ceiling, with 64-pixel tiles (one
// consumer warpgroup, 4 stages) at BN 128 1.3-1.6x faster than 128-pixel
// ones (two, 3 stages) at conv2_1..conv5_3, and 128-pixel tiles fastest at
// conv1_x (Cout 64): hence the two tile shapes. Pingpong, two commit groups in flight, split-K for
// small grids, clusters with the weights multicast and the 2x2 pool in the
// epilogue are later designs. Times on the card are in PERF.md
// (chip_smoke.py).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace {

constexpr int kBK = 32;            // channels a K step: Cin a multiple of it
constexpr int kRowBytes = 128;     // kBK f32: a row of a tile, one swizzle span
constexpr int kMaxCin = 8192;      // keeps tap * Cin + c0 small
constexpr int kMinStages = 3;      // stages in the ring, at least
constexpr int kMaxStages = 8;      // stages in the ring, at most
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block can opt in
constexpr int kSmemAlign = 1024;   // every buffer on the 128B swizzle's period
constexpr int kBarBytes = 16;      // a stage's full and empty mbarriers
constexpr long long kWatchdogCycles = 1LL << 34;
constexpr int kEpilogueBar = 1;    // the consumers' named barrier

struct Params {
  const float* bias;
  int cin, th, tw, tiles_y, tiles_x, n_tiles, tiles, stages, relu;
};

// shared memory of a geometry: alignment slack, the stages (A tile, B hi,
// B lo), the staged f32 output tile, the barriers
__host__ __device__ constexpr int smem_bytes_of(int rows, int bn,
                                                int stages) {
  return kSmemAlign + stages * (rows + 2 * bn) * kRowBytes + rows * bn * 4 +
         stages * kBarBytes;
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
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

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

// K-major operand of 128-byte rows in the 128B swizzle, 8-row groups 1024
// bytes apart: start address, leading byte offset 16 (unused: K fits the
// atom), stride byte offset 1024, layout type 1 (128B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// TMA's 128B swizzle of a byte offset inside a region of 128-byte rows
// (1024-byte aligned): the 16-byte chunk XORed with the row mod 8
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x N f32) = [d +] a (64 x 8 tf32, registers) * b (N x 8 tf32,
// K-major in shared memory)^T
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
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

// one tile's accumulators + bias, ReLU'd if asked, into the staging buffer
// (slabs of 32 channels, 128 bytes a pixel, swizzled), as the PTX D
// fragment places them. Each column group starts from copies of row0 and
// q2 that an empty asm makes opaque, and ends with a memory clobber, so the
// compiler does not load every group's bias at once
template <int BN>
__device__ __forceinline__ void stage_out(const float (&acc)[BN / 2],
                                          uint8_t* stg, int rows, int row0,
                                          int q2, const float* bias,
                                          int relu) {
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    int r0 = row0, q = q2;
    asm volatile("" : "+r"(r0), "+r"(q));
    const int col = 8 * i + q;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
    const uint32_t slab = (col / kBK) * rows * kRowBytes;
    const uint32_t within = (col % kBK) * 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      float y0 = __fadd_rn(acc[4 * i + 2 * half], b.x);
      float y1 = __fadd_rn(acc[4 * i + 2 * half + 1], b.y);
      if (relu) {  // as torch.relu: a NaN stays NaN
        y0 = y0 < 0.f ? 0.f : y0;
        y1 = y1 < 0.f ? 0.f : y1;
      }
      *reinterpret_cast<float2*>(stg + slab +
                                 swizzle(r * kRowBytes + within)) =
          make_float2(y0, y1);
    }
    asm volatile("" ::: "memory");
  }
}

// BN output channels a tile of 64 * C pixels, C consumer warpgroups (each
// 64 pixel rows of the tile) and one producer warp
template <int BN, int C>
__global__ void __launch_bounds__(128 * C + 32, 1)
conv3x3_f32x3(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap hmap,
              const __grid_constant__ CUtensorMap lmap,
              const __grid_constant__ CUtensorMap omap, const Params p) {
  constexpr int kRows = 64 * C;
  constexpr uint32_t kABytes = kRows * kRowBytes;
  constexpr uint32_t kBBytes = BN * kRowBytes;
  constexpr uint32_t kStageBytes = kABytes + 2 * kBBytes;
  constexpr uint32_t kStaged = kRows * BN * 4;  // one f32 output tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSmemAlign - 1) & ~uint32_t(kSmemAlign - 1);
  const uint32_t ring = base;
  const uint32_t staging = ring + p.stages * kStageBytes;
  const uint32_t bars = staging + kStaged;
  const int k_steps = 9 * (p.cin / kBK);  // chunk outer, tap inner
  const int per_image = p.tiles_y * p.tiles_x;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + s * kBarBytes, 1);          // full: the producer
      mbar_init(bars + s * kBarBytes + 8, 4 * C);  // empty: consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&xmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&hmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&lmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&omap)) : "memory");
  }
  __syncthreads();

  if (tid >= 128 * C) {
    // the producer warp: one thread issues every load, the tiles' steps in
    // order
    if (tid == 128 * C) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int n0 = (t % p.n_tiles) * BN;
        const int mt = t / p.n_tiles;
        const int img = mt / per_image, rem = mt - img * per_image;
        const int ty = rem / p.tiles_x;
        const int y0 = ty * p.th, x0 = (rem - ty * p.tiles_x) * p.tw;
        for (int k = 0; k < k_steps; ++k) {
          const int chunk = k / 9, tap = k - 9 * chunk;
          const int c0 = chunk * kBK;
          const uint32_t full = bars + stage * kBarBytes;
          const uint32_t dst = ring + stage * kStageBytes;
          mbar_wait(full + 8, phase ^ 1);  // the consumers released it
          mbar_expect_tx(full, kStageBytes);
          tma_load_4d(dst, &xmap, full, c0, x0 + tap % 3 - 1,
                      y0 + tap / 3 - 1, img);
          tma_load_2d(dst + kABytes, &hmap, full, tap * p.cin + c0, n0);
          tma_load_2d(dst + kABytes + kBBytes, &lmap, full,
                      tap * p.cin + c0, n0);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    const int wg = tid / 128, lane = tid % 32;
    const int g = lane / 4, q = lane % 4;
    // this thread's rows of the tile: A and D fragments, row0 and row0 + 8
    const int row0 = 64 * wg + 16 * ((tid % 128) / 32) + g;
    uint8_t* stg = smem_raw + (staging - raw);
    float sum[BN / 2];  // the running f32 sums
    float acc[BN / 2];  // one K step's tensor-core sums
    uint32_t hi[4][4], lo[4][4];  // [k8 step][a0..a3]
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
      int prev = -1;  // the stage whose wgmma group may still run
      for (int k = 0; k < k_steps; ++k) {
        mbar_wait(bars + stage * kBarBytes, phase);
        // channels 8q .. 8q + 7 of rows row0 and row0 + 8 (row0 % 8 == g)
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
        wgmma_wait<0>();
        fence_acc(acc);
        if (prev >= 0) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
          if (lane == 0) mbar_arrive(bars + prev * kBarBytes + 8);
        }
        // k8 step kk: columns q and q + 4 are the chunk's channels 8q + 2kk
        // and 8q + 2kk + 1 (the weights' k_order), a0/a2 row0, a1/a3 + 8
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
          wgmma_tf32<BN>(acc, lo[kk], smem_desc(b + 32 * kk), kk > 0);
          wgmma_tf32<BN>(acc, hi[kk], smem_desc(b + kBBytes + 32 * kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32<BN>(acc, hi[kk], smem_desc(b + 32 * kk), 1);
        }
        wgmma_commit();
        prev = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      if (lane == 0 && prev >= 0) mbar_arrive(bars + prev * kBarBytes + 8);

      const int n0 = (t % p.n_tiles) * BN;
      const int mt = t / p.n_tiles;
      const int img = mt / per_image, rem = mt - img * per_image;
      const int ty = rem / p.tiles_x;
      const int y0 = ty * p.th, x0 = (rem - ty * p.tiles_x) * p.tw;
      // the previous tile's store has read the staging buffer
      if (tid == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      asm volatile("bar.sync %0, %1;\n" :: "n"(kEpilogueBar), "n"(128 * C)
                   : "memory");
      stage_out<BN>(sum, stg, kRows, row0, 2 * q, p.bias + n0, p.relu);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, %1;\n" :: "n"(kEpilogueBar), "n"(128 * C)
                   : "memory");
      if (tid == 0) {
        for (int s = 0; s < BN / kBK; ++s) {
          tma_store_4d(&omap, staging + s * kRows * kRowBytes, n0 + s * kBK,
                       x0, y0, img);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) {
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// an f32 tiled map over `rank` dims (innermost first; `strides` in bytes
// for dims 1..), box `box` (its inner width 32 f32, the 128B swizzle), zero
// fill outside the tensor
bool encode(CUtensorMap* map, int rank, const void* ptr,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int C>
cudaError_t run(const CUtensorMap& xmap, const CUtensorMap& hmap,
                const CUtensorMap& lmap, const CUtensorMap& omap,
                const Params& p, int blocks, int smem, int device,
                cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&conv3x3_f32x3<BN, C>);
  const cudaError_t e = launch_cache::launch_setup(device, kernel, kMaxSmem);
  if (e != cudaSuccess) return e;
  conv3x3_f32x3<BN, C><<<blocks, 128 * C + 32, smem, stream>>>(
      xmap, hmap, lmap, omap, p);
  return cudaGetLastError();
}

}  // namespace

// x (n, h, w, cin) f32; w_hi and w_lo (cout, 9 * cin) f32, the weights'
// TF32 parts in (Cout, 3, 3, Cin) order with each 32-channel chunk in the
// kernel's k order (ops/conv_kernel.py:split_weight); bias (cout,) f32; out
// (n, h, w, cout) f32. All contiguous, 16-byte aligned, on device `device`
// (current). The geometry (ops/conv_kernel.py:conv_geometry): tiles of th x
// tw pixels (64 or 128), tiles_y x tiles_x of them an image, bn output
// channels a tile, `stages` stages, `blocks` blocks, `smem_bytes` of
// dynamic shared memory. Returns a cudaError_t: cudaErrorInvalidValue for a
// shape or a geometry the kernel does not take (one that does not cover the
// shape or does not fit shared memory), cudaErrorNotSupported when the
// driver has no cuTensorMapEncodeTiled or refuses a map.
extern "C" int f32_conv3x3_forward(
    const float* x, const float* w_hi, const float* w_lo, const float* bias,
    float* out, int n, int h, int w, int cin, int cout, int relu, int th,
    int tw, int tiles_y, int tiles_x, int bn, int stages, int blocks,
    int smem_bytes, int device, void* stream) {
  const long long m_total = static_cast<long long>(n) * h * w;
  if (n < 1 || h < 1 || w < 1 || cin < kBK || cin % kBK != 0 ||
      cin > kMaxCin || cout < 64 || cout % 64 != 0 ||
      m_total >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const int rows = th * tw;
  if ((rows != 64 && rows != 128) || th < 1 || tw < 1 || th > 256 ||
      tw > 256 || tiles_y < 1 || tiles_x < 1 ||
      static_cast<long long>(tiles_y) * th < h || (tiles_y - 1) * th >= h ||
      static_cast<long long>(tiles_x) * tw < w || (tiles_x - 1) * tw >= w ||
      bn != (rows == 64 ? 128 : 64) || cout % bn != 0 || stages < kMinStages ||
      stages > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  const long long tiles =
      static_cast<long long>(n) * tiles_y * tiles_x * (cout / bn);
  if (tiles >= (1LL << 31) || blocks < 1 || blocks > tiles ||
      smem_bytes != smem_bytes_of(rows, bn, stages) ||
      smem_bytes > kMaxSmem) {
    return cudaErrorInvalidValue;
  }

  CUtensorMap xmap, hmap, lmap, omap;
  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u64 xdims[4] = {u64(cin), u64(w), u64(h), u64(n)};
  const u64 xstrides[3] = {u64(cin) * 4, u64(w) * cin * 4,
                           u64(h) * w * cin * 4};
  const u32 xbox[4] = {u32(kBK), u32(tw), u32(th), 1};
  const u64 wdims[2] = {9 * u64(cin), u64(cout)};
  const u64 wstrides[1] = {9 * u64(cin) * 4};
  const u32 wbox[2] = {u32(kBK), u32(bn)};
  const u64 odims[4] = {u64(cout), u64(w), u64(h), u64(n)};
  const u64 ostrides[3] = {u64(cout) * 4, u64(w) * cout * 4,
                           u64(h) * w * cout * 4};
  const u32 obox[4] = {u32(kBK), u32(tw), u32(th), 1};
  if (!encode(&xmap, 4, x, xdims, xstrides, xbox) ||
      !encode(&hmap, 2, w_hi, wdims, wstrides, wbox) ||
      !encode(&lmap, 2, w_lo, wdims, wstrides, wbox) ||
      !encode(&omap, 4, out, odims, ostrides, obox)) {
    return cudaErrorNotSupported;
  }

  Params p;
  p.bias = bias;
  p.cin = cin;
  p.th = th;
  p.tw = tw;
  p.tiles_y = tiles_y;
  p.tiles_x = tiles_x;
  p.n_tiles = cout / bn;
  p.tiles = static_cast<int>(tiles);
  p.stages = stages;
  p.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows == 128
             ? run<64, 2>(xmap, hmap, lmap, omap, p, blocks, smem_bytes,
                          device, s)
             : run<128, 1>(xmap, hmap, lmap, omap, p, blocks, smem_bytes,
                           device, s);
}
