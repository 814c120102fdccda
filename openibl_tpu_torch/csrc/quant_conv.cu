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
// convolution, then the same f32 epilogue) gives the same bits: int32 sums
// of int8 products are exact in any order, so only the epilogue's mapping
// of accumulators to (pixel, channel) could break them.
//
// Design: an implicit GEMM on wgmma, fed by TMA, warp-specialised.
// - A block owns an output tile of TH x TW pixels of one image (128 pixels
//   as 8x16, 16x8 or 4x32; or 64 as 8x8, 4x16 or 16x4) by BN output
//   channels (64, 128 or 256), and walks K = 9 * Cin in steps of one tap
//   and BK channels (BK = 128, 64 or 32 bytes, the largest that divides
//   Cin): 36 steps at Cin = 512.
// - Operands by TMA (cuTensorMapEncodeTiled, reached through the runtime's
//   driver entry point: no -lcuda). x is a 4-D tiled map over (Cin, W, H,
//   N), box (BK, TW, TH, 1); tap (dy, dx) of tile (y0, x0) loads at
//   (c0, x0 + dx - 1, y0 + dy - 1, n). TMA zero-fills every element outside
//   the tensor, negative coordinates included: that is SAME padding with
//   no predicate code, and a tile never mixes two images. The box lands as
//   TH * TW rows of BK bytes, row r = pixel (y0 + r / TW, x0 + r % TW):
//   the K-major A tile. wq is a 2-D map over (9 * Cin, Cout), box (BK, BN)
//   at (tap * Cin + c0, n0): the K-major B tile. Both use the swizzle of
//   BK's width (128B, 64B or 32B), the one wgmma's descriptors name.
// - A ring of S stages in dynamic shared memory (each 1024-byte aligned),
//   each with a full and an empty mbarrier. One producer thread (the last
//   warpgroup; at BN 256 setmaxnreg takes it down to 40 registers and the
//   consumers up to 232) issues a stage's loads on its full barrier with
//   the stage's byte count; TH * TW / 64 consumer warpgroups each own 64
//   pixel rows x BN and run wgmma.mma_async m64nBNk32 .s32.s8.s8 from
//   shared-memory descriptors, BK / 32 of them a stage (the start address
//   advances 32 bytes inside the swizzle atom), keep two commit groups in
//   flight when S >= 4 (wgmma.wait_group 2: 3-5% faster at BN 128 on the
//   H100) or one (a BN 256 ring holds only 3 stages, and two in flight
//   starved its producer: 10-20% slower), and release the stage behind
//   them (lane 0 of each consumer warp arrives on its empty barrier). Int8
//   wgmma takes both operands K-major: NHWC x and (Cout, 3, 3, Cin) wq are
//   K-major as stored.
// - Halo mode (TW 8, BK 128; the geometry takes it at BN 256): one TMA box
//   of (TH + 2) x 10 pixels a channel chunk, at (c0, x0 - 1, y0 - 1, n), in
//   two slots with their own barriers, and only the weights in the ring.
//   Tap (dy, dx) of a warpgroup's 8 pixel rows is the descriptor that
//   starts (8 wg + dy) * 10 + dx rows into the box, 8-row groups 10 rows
//   (1280 bytes) apart: A is read from L2 once a chunk, not once a tap.
//   Those starts and strides are off the 1024-byte swizzle period; wgmma
//   reads them right because it swizzles on the address, as TMA wrote
//   them (see smem_desc).
// - Pingpong (a geometry choice: 128-pixel tiles at BN 128 or 64, taken
//   where a block walks many tiles): each consumer warpgroup
//   takes every other tile of the block whole, as two m64 row blocks (at
//   BN 128 that is 128 accumulators a thread: setmaxnreg as at BN 256),
//   with its own staging buffer, scales and named barrier, so that one
//   warpgroup's epilogue overlaps the other's wgmma. The producer loads
//   the tiles' steps in order either way; a warpgroup finds its tile's
//   place in the ring from the tile's index, and starts a tile only once
//   the other has passed the last wait of the tile before (two named
//   barriers): a wait on a barrier two phases ahead would pass at once,
//   since mbarrier waits compare parity only. At BN 256 the two
//   warpgroups split each tile's rows (the accumulators of two row blocks
//   would not fit), as they do at BN 128 and 64 without pingpong.
// - The epilogue runs the arithmetic above on wgmma's accumulator layout
//   (PTX ISA, m64nNk32 .s32 D fragment: warp v of the warpgroup holds rows
//   16 v + lane / 4 and + 8, and d[4 i + j] sits at column 8 i +
//   2 (lane % 4) + j % 2, row + 8 for j >= 2), stages the tile in shared
//   memory in slabs of up to 128 bytes a pixel in TMA's swizzle (the
//   16-byte chunk XORed with the row: no bank conflicts), issues
//   fence.proxy.async and writes each slab with a TMA store through a 4-D
//   map on out (Cout, W, H, N): the store clips the pixels past H or W.
//   The staging buffer is its own region (conv5_3's f32 tile takes BN 128:
//   at BN 256 its 128 KB leaves too little room for three stages).
// - Blocks walk tiles in a static stride (tile t, t + gridDim.x, ...), the
//   N tile fastest so the blocks that share an x tile run together. The
//   grid is at most one block an SM (persistent: the producer loads the
//   next tile's stages while the consumers store this one), or one block
//   a tile. The geometry (tile, BN, BK, halo mode, stages, grid, shared
//   memory) is chosen in Python (ops/quant_kernel.py:conv_geometry); the
//   C entry runs it as given and refuses one that does not cover the shape
//   or does not fit.
// - A barrier wait that spins for ~2^34 cycles traps (a kernel error, not
//   a hung card).
//
// What bounds it on the H100 SXM (700 W): operations, 2 * M * K * Cout int8
// ops at 1,979 TOPS dense; at batch 16 and 480x640 the eleven layers do
// 2.63 T of them (1.33 ms), conv2_2 alone 0.362 T (0.183 ms) against 0.094
// ms for its 315 MB of input and output at 3.35 TB/s. What holds it below
// that is L2: in tap mode a block reads (TH * TW + BN) * BK bytes from L2
// per 2 * TH * TW * BN * BK operations (the halo again for every tap, the
// weights for every tile), ~25-30 bytes a clock an SM at the rates
// measured; halo mode cuts the pixels' share. Clusters with the weights
// multicast, and the 2x2 pool in the epilogue, are later designs.
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a; chip_smoke.py prints it): no
// static shared memory (the geometry's dynamic size, at most 227 KB); BN 64
// 72-77 registers, BN 64 pingpong 139-144, BN 128 99-105, BN 256 168, no
// spills; BN 128 pingpong 168 registers with ~630 bytes of spill stores
// (two row blocks' 128 accumulators under the 384-thread launch's cap),
// still 13% faster than without pingpong at conv2_1. Times on the card
// are in PERF.md (chip_smoke.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace {

constexpr int kMinCin = 32;      // the narrowest BK: Cin a multiple of it
constexpr int kMaxCin = 8192;    // keeps |acc| < 2^31
constexpr int kMinStages = 3;    // stages in the ring, at least
constexpr int kMaxStages = 8;    // stages in the ring, at most
constexpr int kMaxSmem = 232448; // dynamic shared memory a block can opt in
constexpr int kSmemAlign = 1024; // every buffer on the 128B swizzle's period
constexpr int kBarBytes = 16;    // a stage's full and empty mbarriers
constexpr int kScaleBytes = 8;   // a channel's scale and bias, staged
constexpr int kHaloW = 10;       // halo mode: pixels a halo row (TW + 2)
constexpr int kHaloSlots = 2;    // halo mode: halo boxes in flight
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr long long kWatchdogCycles = 1LL << 34;
constexpr int kOrderBar = 3;  // pingpong's turn barriers 3, 4 (epilogue: 1, 2)

enum Mode { kRequant = 0, kDequantF32 = 1, kDequantBF16 = 2 };

struct Params {
  const float* scale;
  const float* bias;
  int cin, th, tw, tiles_y, tiles_x, n_tiles, tiles, bk, stages, relu, mode;
};

__host__ __device__ constexpr int out_bytes(int mode) {
  return mode == kRequant ? 1 : mode == kDequantF32 ? 4 : 2;
}

// the staged tile's bytes a pixel a slab: TMA's swizzle spans 128 at most
__host__ __device__ constexpr int slab_span(int bn, int mode) {
  return bn * out_bytes(mode) < 128 ? bn * out_bytes(mode) : 128;
}

// halo mode: a slot holds a (TH + 2) x kHaloW-pixel box of BK bytes a
// pixel, rounded up to the swizzle period
__host__ __device__ constexpr int halo_slot_bytes(int th, int bk) {
  return (kHaloW * (th + 2) * bk + kSmemAlign - 1) / kSmemAlign * kSmemAlign;
}

// shared memory of a geometry: alignment slack, the halo slots (halo
// mode), the stages, the staged output tile and the tile's scale and bias
// (a float4 a channel pair; two of each in pingpong), the barriers
__host__ __device__ constexpr int smem_bytes_of(int th, int tw, int bn,
                                                int bk, int halo, int pp,
                                                int stages, int mode) {
  return kSmemAlign + halo * kHaloSlots * halo_slot_bytes(th, bk) +
         stages * ((1 - halo) * th * tw + bn) * bk +
         (1 + pp) * (th * tw * bn * out_bytes(mode) + bn * kScaleBytes) +
         (stages + halo * kHaloSlots) * kBarBytes;
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

// K-major operand of rows of `span` bytes (128, 64 or 32) in the swizzle of
// that width, 8-row groups `stride` bytes apart: start address, leading
// byte offset 16 (unused when K fits the atom), stride byte offset, layout
// type 1/2/3 = 128B/64B/32B. The base offset stays 0 even where a halo tap
// starts dx rows into the 1024-byte swizzle period: wgmma swizzles on the
// shared-memory address itself, as TMA does (on the H100, a base offset of
// dx broke every tap with dx != 0; 0 gives the same bits as the plain
// version)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int span,
                                              int stride) {
  const uint64_t layout = span == 128 ? 1 : span == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (layout << 62);
}

// TMA's swizzle of a byte offset inside a region of rows of `span` bytes
// (1024-byte aligned): the 16-byte chunk XORed with bits 7.. of the offset
__device__ __forceinline__ uint32_t swizzle(uint32_t off, int span) {
  return off ^ (((off >> 7) & (span / 16 - 1)) << 4);
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
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x N s32) = [d +] a (64 x 32 s8, K-major) * b (N x 32 s8, K-major)^T
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

// one tile's accumulators through the epilogue into the staging buffer
// (slabs of `span` bytes a pixel, swizzled), as the PTX D fragment places
// them. `sb` holds the tile's (scale, scale, bias, bias) of each channel
// pair. Each column group starts from copies of row0 and q2 that an empty
// asm makes opaque, and ends with a memory clobber: the compiler neither
// hoists the groups' offsets out of the tile loop nor loads every group's
// scales at once (registers: the accumulators hold most of them)
template <int BN, int MODE>
__device__ __forceinline__ void stage_out(const int (&acc)[BN / 2],
                                          uint8_t* stg, int rows, int row0,
                                          int q2, const float4* sb,
                                          int relu) {
  constexpr int kOut = out_bytes(MODE);
  constexpr int kSpan = slab_span(BN, MODE);
  constexpr int kPerSlab = kSpan / kOut;  // channels a slab
  const float lo = (MODE == kRequant && relu) ? 0.f : -128.f;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    int r0 = row0, q = q2;
    asm volatile("" : "+r"(r0), "+r"(q));
    const int col = 8 * i + q;
    const float4 sc = sb[col / 2];
    const uint32_t slab = (col / kPerSlab) * rows * kSpan;
    const uint32_t within = (col % kPerSlab) * kOut;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      float y0 = __fadd_rn(
          __fmul_rn(__int2float_rn(acc[4 * i + 2 * half]), sc.x), sc.z);
      float y1 = __fadd_rn(
          __fmul_rn(__int2float_rn(acc[4 * i + 2 * half + 1]), sc.y), sc.w);
      uint8_t* dst = stg + slab + swizzle(r * kSpan + within, kSpan);
      if (MODE == kRequant) {
        char2 v;
        v.x = static_cast<signed char>(fminf(fmaxf(rintf(y0), lo), 127.f));
        v.y = static_cast<signed char>(fminf(fmaxf(rintf(y1), lo), 127.f));
        *reinterpret_cast<char2*>(dst) = v;
      } else {
        if (relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        if (MODE == kDequantF32) {
          *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
    asm volatile("" ::: "memory");
  }
}

// a K step a consumer has issued: its stage and, after a chunk's last tap
// in halo mode, its halo slot (-1: none)
struct Step {
  int stage, slot;
};

// BN output channels a tile of 128 pixels (C = 2) or 64 (C = 1), HALO: the
// A operand from one halo box a channel chunk (TW = 8, BK = 128) instead of
// one box a tap, PP (pingpong, C = 2 and BN <= 128): each consumer
// warpgroup takes every other tile whole (two m64 row blocks), so one's
// epilogue overlaps the other's wgmma; else the C warpgroups split each
// tile's rows
template <int BN, int C, bool HALO, bool PP>
__global__ void __launch_bounds__(384, 1)
conv3x3_s8(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap omap, const Params p) {
  constexpr int kRows = 64 * C;
  constexpr int kTileWGs = PP ? 1 : C;  // consumer warpgroups on a tile
  constexpr int kBlocks = PP ? 2 : 1;   // m64 row blocks a warpgroup runs
  constexpr int kCopies = PP ? 2 : 1;   // staging buffers and scale slots
  // 128 accumulators a consumer thread (BN 256, or BN 128 in pingpong):
  // registers move from the producer warpgroup (40) to the consumers (232);
  // the others fit the launch's 168
  constexpr bool kRebalance = BN * kBlocks >= 256;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSmemAlign - 1) & ~uint32_t(kSmemAlign - 1);
  const int bk = p.bk;
  // halo mode: two slots of (TH + 2) x kHaloW pixels x BK bytes, then the
  // ring of weight stages; else a ring of (pixels + weights) stages
  const uint32_t halo_bytes = HALO ? halo_slot_bytes(p.th, bk) : 0;
  const uint32_t halo_box = kHaloW * (p.th + 2) * bk;  // what TMA writes
  const uint32_t a_bytes = HALO ? 0 : kRows * bk;
  const uint32_t stage_bytes = a_bytes + BN * bk;
  const uint32_t ring = base + kHaloSlots * halo_bytes;
  const uint32_t staging = ring + p.stages * stage_bytes;
  const uint32_t staged = kRows * BN * out_bytes(p.mode);  // one tile
  const uint32_t sb_at = staging + kCopies * staged;
  const uint32_t bars = sb_at + kCopies * BN * kScaleBytes;
  const uint32_t halo_bars = bars + p.stages * kBarBytes;
  const int chunks = p.cin / bk;
  const int k_steps = 9 * chunks;  // chunk outer, tap inner
  const int per_image = p.tiles_y * p.tiles_x;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < p.stages + (HALO ? kHaloSlots : 0); ++s) {
      mbar_init(bars + s * kBarBytes, 1);  // full: the producer
      mbar_init(bars + s * kBarBytes + 8, 4 * kTileWGs);  // empty: warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&xmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&wmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(
                     reinterpret_cast<uint64_t>(&omap)) : "memory");
  }
  __syncthreads();

  if (tid >= 128 * C) {
    // the producer warpgroup: one thread issues every load, the tiles'
    // steps in order
    if (kRebalance) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(kProducerRegs));
    }
    if (tid == 128 * C) {
      int stage = 0, slot = 0;
      uint32_t phase = 0, slot_phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int n0 = (t % p.n_tiles) * BN;
        const int mt = t / p.n_tiles;
        const int img = mt / per_image, rem = mt - img * per_image;
        const int ty = rem / p.tiles_x;
        const int y0 = ty * p.th, x0 = (rem - ty * p.tiles_x) * p.tw;
        for (int k = 0; k < k_steps; ++k) {
          const int chunk = k / 9, tap = k - 9 * chunk;
          const int c0 = chunk * bk;
          if (HALO && tap == 0) {
            const uint32_t full = halo_bars + slot * kBarBytes;
            mbar_wait(full + 8, slot_phase ^ 1);
            mbar_expect_tx(full, halo_box);
            tma_load_4d(base + slot * halo_bytes, &xmap, full, c0, x0 - 1,
                        y0 - 1, img);
            if (++slot == kHaloSlots) {
              slot = 0;
              slot_phase ^= 1;
            }
          }
          const uint32_t full = bars + stage * kBarBytes;
          const uint32_t dst = ring + stage * stage_bytes;
          mbar_wait(full + 8, phase ^ 1);  // the consumers released it
          mbar_expect_tx(full, stage_bytes);
          if (!HALO) {
            tma_load_4d(dst, &xmap, full, c0, x0 + tap % 3 - 1,
                        y0 + tap / 3 - 1, img);
          }
          tma_load_2d(dst + a_bytes, &wmap, full, tap * p.cin + c0, n0);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    if (kRebalance) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(kConsumerRegs));
    }
    const int wg = tid / 128, lane = tid % 32;
    // the tile's warpgroups: their first thread (which stores the tile),
    // their named barrier, their staging buffer and scale slots
    const int leader = PP ? 128 * wg : 0;
    const int group = PP ? wg : 0;
    const int bar_id = 1 + group;
    const int row0 =
        (PP ? 0 : 64 * wg) + 16 * ((tid % 128) / 32) + lane / 4;
    const int q2 = 2 * (lane % 4);
    const uint32_t my_staging = staging + group * staged;
    uint8_t* stg = smem_raw + (my_staging - raw);
    float4* sb = reinterpret_cast<float4*>(
        smem_raw + (sb_at + group * BN * kScaleBytes - raw));
    const int span = slab_span(BN, p.mode);
    const int per_slab = span / out_bytes(p.mode);
    const int slabs = BN / per_slab;
    // the A operand's 8-row groups: 8 pixels of one row, 8 (tap mode) or
    // kHaloW (halo mode: the halo box's pixel pitch) rows apart
    const int a_stride = (HALO ? kHaloW : 8) * bk;
    // two commit groups in flight where the ring stays deep enough to load
    // behind them (4 stages or more), else one
    const bool two_in_flight = p.stages >= 4;
    // lane 0 of each warp gives back a finished step's stage and, after a
    // chunk's last tap, its halo slot
    auto release = [&](const Step& done) {
      if (lane == 0 && done.stage >= 0) {
        mbar_arrive(bars + done.stage * kBarBytes + 8);
        if (done.slot >= 0) mbar_arrive(halo_bars + done.slot * kBarBytes + 8);
      }
    };
    int acc[kBlocks][BN / 2];
#pragma unroll
    for (int r = 0; r < kBlocks; ++r) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0;
    }
    // this warpgroup's tiles: every tile of the block, or every other one
    for (int j = PP ? wg : 0;; j += PP ? C : 1) {
      const int t = blockIdx.x + j * gridDim.x;
      if (t >= p.tiles) break;
      // pingpong: start only once the other warpgroup has passed the last
      // full-barrier wait of the tile before, so that every barrier this
      // one waits on is at most one phase ahead (a parity wait cannot tell
      // further) and the two mainloops take turns
      if (PP && j > 0) {
        asm volatile("bar.sync %0, 256;\n" :: "r"(kOrderBar + wg)
                     : "memory");
      }
      // where the producer put this tile's steps in the ring
      const long long first = static_cast<long long>(j) * k_steps;
      const long long first_chunk = static_cast<long long>(j) * chunks;
      int stage = static_cast<int>(first % p.stages);
      uint32_t phase = static_cast<uint32_t>(first / p.stages) & 1;
      int slot = static_cast<int>(first_chunk % kHaloSlots);
      uint32_t slot_phase =
          static_cast<uint32_t>(first_chunk / kHaloSlots) & 1;
      // the steps whose wgmma groups may still run, newest first
      Step last = {-1, -1}, older = {-1, -1};
      for (int k = 0; k < k_steps; ++k) {
        const int tap = k % 9;
        if (HALO && tap == 0) mbar_wait(halo_bars + slot * kBarBytes,
                                        slot_phase);
        mbar_wait(bars + stage * kBarBytes, phase);
        const uint32_t b = ring + stage * stage_bytes + a_bytes;
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < kBlocks; ++r) fence_acc(acc[r]);
        for (int kk = 0; kk < bk / 32; ++kk) {
#pragma unroll
          for (int r = 0; r < kBlocks; ++r) {
            // row block rb: tap mode, its 64 rows of the stage; halo mode,
            // tap (dy, dx) of its 8 pixel rows starts at halo row
            // (8 rb + dy) * kHaloW + dx (TW = 8)
            const int rb = PP ? r : wg;
            const uint32_t a =
                HALO ? base + slot * halo_bytes +
                           ((8 * rb + tap / 3) * kHaloW + tap % 3) * bk
                     : ring + stage * stage_bytes + rb * 64 * bk;
            wgmma_s8<BN>(acc[r], smem_desc(a + 32 * kk, bk, a_stride),
                         smem_desc(b + 32 * kk, bk, 8 * bk),
                         k > 0 || kk > 0);
          }
        }
        wgmma_commit();
        const Step now = {stage, (HALO && tap == 8) ? slot : -1};
        // with two groups in flight the step two back is done, else the
        // one before this one
        if (two_in_flight) {
          wgmma_wait<2>();
          release(older);
          older = last;
        } else {
          wgmma_wait<1>();
          release(last);
        }
        last = now;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
        if (HALO && tap == 8 && ++slot == kHaloSlots) {
          slot = 0;
          slot_phase ^= 1;
        }
      }
      // pingpong: the next tile, the other warpgroup's, may start
      if (PP && t + gridDim.x < p.tiles) {
        asm volatile("bar.arrive %0, 256;\n" :: "r"(kOrderBar + 1 - wg)
                     : "memory");
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < kBlocks; ++r) fence_acc(acc[r]);
      release(older);
      release(last);

      const int n0 = (t % p.n_tiles) * BN;
      const int mt = t / p.n_tiles;
      const int img = mt / per_image, rem = mt - img * per_image;
      const int ty = rem / p.tiles_x;
      const int y0 = ty * p.th, x0 = (rem - ty * p.tiles_x) * p.tw;
      // the warpgroups' previous store has read their staging buffer (and
      // every thread has read the previous scales, before its second
      // bar.sync)
      if (tid == leader) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      if (tid - leader < BN / 2) {
        const int c = tid - leader;
        const float2 s2 = *reinterpret_cast<const float2*>(p.scale + n0 +
                                                           2 * c);
        const float2 c2 = *reinterpret_cast<const float2*>(p.bias + n0 +
                                                           2 * c);
        sb[c] = make_float4(s2.x, s2.y, c2.x, c2.y);
      }
      asm volatile("bar.sync %0, %1;\n" :: "r"(bar_id), "n"(128 * kTileWGs)
                   : "memory");
#pragma unroll
      for (int r = 0; r < kBlocks; ++r) {
        if (p.mode == kRequant) {
          stage_out<BN, kRequant>(acc[r], stg, kRows, row0 + 64 * r, q2, sb,
                                  p.relu);
        } else if (p.mode == kDequantF32) {
          stage_out<BN, kDequantF32>(acc[r], stg, kRows, row0 + 64 * r, q2,
                                     sb, p.relu);
        } else {
          stage_out<BN, kDequantBF16>(acc[r], stg, kRows, row0 + 64 * r, q2,
                                      sb, p.relu);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, %1;\n" :: "r"(bar_id), "n"(128 * kTileWGs)
                   : "memory");
      if (tid == leader) {
        for (int s = 0; s < slabs; ++s) {
          tma_store_4d(&omap, my_staging + s * kRows * span,
                       n0 + s * per_slab, x0, y0, img);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == leader) {
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

// a tiled map over `rank` dims (innermost first; `strides` in bytes for
// dims 1..), box `box`, in the swizzle of `span` bytes (the box's inner
// width), zero fill outside the tensor
bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
            const void* ptr, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, int span) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int C, bool HALO, bool PP>
cudaError_t run(const CUtensorMap& xmap, const CUtensorMap& wmap,
                const CUtensorMap& omap, const Params& p, int blocks,
                int smem, int device, cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(&conv3x3_s8<BN, C, HALO, PP>);
  const cudaError_t e = launch_cache::launch_setup(device, kernel, kMaxSmem);
  if (e != cudaSuccess) return e;
  conv3x3_s8<BN, C, HALO, PP><<<blocks, 128 * (C + 1), smem, stream>>>(
      xmap, wmap, omap, p);
  return cudaGetLastError();
}

// the instance for (rows, halo, pp): pingpong only on 128-pixel tiles at
// BN 128 or 64
template <int BN>
cudaError_t run_bn(const CUtensorMap& xmap, const CUtensorMap& wmap,
                   const CUtensorMap& omap, const Params& p, int rows,
                   int halo, int pp, int blocks, int smem, int device,
                   cudaStream_t s) {
  constexpr bool kPP = BN <= 128;
  if (rows == 128 && pp) {
    return halo ? run<BN, 2, true, kPP>(xmap, wmap, omap, p, blocks, smem,
                                        device, s)
                : run<BN, 2, false, kPP>(xmap, wmap, omap, p, blocks, smem,
                                         device, s);
  }
  if (rows == 128) {
    return halo ? run<BN, 2, true, false>(xmap, wmap, omap, p, blocks, smem,
                                          device, s)
                : run<BN, 2, false, false>(xmap, wmap, omap, p, blocks,
                                           smem, device, s);
  }
  return halo ? run<BN, 1, true, false>(xmap, wmap, omap, p, blocks, smem,
                                        device, s)
              : run<BN, 1, false, false>(xmap, wmap, omap, p, blocks, smem,
                                         device, s);
}

bool one_of(int v, int a, int b, int c) { return v == a || v == b || v == c; }

}  // namespace

// x (n, h, w, cin) int8, wq (cout, 3, 3, cin) int8, scale and bias (cout,)
// f32, out (n, h, w, cout): int8 (mode 0), f32 (1) or bf16 (2). All
// contiguous, 16-byte aligned, on device `device` (current). The geometry
// (ops/quant_kernel.py:conv_geometry): tiles of th x tw pixels, tiles_y x
// tiles_x of them an image, bn output channels and K steps of bk bytes a
// tile, halo mode (1: tw 8 and bk 128) or not, pingpong (1: 128-pixel
// tiles at bn 128 or 64) or not, `stages` stages, `blocks` blocks,
// `smem_bytes` of dynamic shared memory. Returns a cudaError_t:
// cudaErrorInvalidValue for a shape or a geometry the kernel does not take
// (one that does not cover the shape or does not fit shared memory),
// cudaErrorNotSupported when the driver has no cuTensorMapEncodeTiled or
// refuses a map.
extern "C" int int8_conv3x3_forward(
    const int8_t* x, const int8_t* wq, const float* scale, const float* bias,
    void* out, int n, int h, int w, int cin, int cout, int mode, int relu,
    int th, int tw, int tiles_y, int tiles_x, int bn, int bk, int halo,
    int pp, int stages, int blocks, int smem_bytes, int device,
    void* stream) {
  const long long m_total = static_cast<long long>(n) * h * w;
  if (n < 1 || h < 1 || w < 1 || cin < kMinCin || cin % kMinCin != 0 ||
      cin > kMaxCin || cout < 64 || cout % 64 != 0 || mode < kRequant ||
      mode > kDequantBF16 || m_total >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const int rows = th * tw;
  if ((rows != 64 && rows != 128) || th < 1 || tw < 1 || th > 256 ||
      tw > 256 || tiles_y < 1 || tiles_x < 1 ||
      static_cast<long long>(tiles_y) * th < h || (tiles_y - 1) * th >= h ||
      static_cast<long long>(tiles_x) * tw < w || (tiles_x - 1) * tw >= w ||
      !one_of(bn, 64, 128, 256) || cout % bn != 0 ||
      !one_of(bk, 32, 64, 128) || cin % bk != 0 || (halo != 0 && halo != 1)
      || (halo && (tw != 8 || bk != 128)) || (pp != 0 && pp != 1) ||
      (pp && (rows != 128 || bn > 128)) || stages < kMinStages ||
      stages > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  const long long tiles =
      static_cast<long long>(n) * tiles_y * tiles_x * (cout / bn);
  if (tiles >= (1LL << 31) || blocks < 1 || blocks > tiles ||
      smem_bytes != smem_bytes_of(th, tw, bn, bk, halo, pp, stages, mode) ||
      smem_bytes > kMaxSmem) {
    return cudaErrorInvalidValue;
  }

  const int ob = out_bytes(mode);
  const int span = slab_span(bn, mode);
  CUtensorMap xmap, wmap, omap;
  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u64 xdims[4] = {u64(cin), u64(w), u64(h), u64(n)};
  const u64 xstrides[3] = {u64(cin), u64(w) * cin, u64(h) * w * cin};
  // halo mode: (TH + 2) x kHaloW pixels a channel chunk; else TH x TW a tap
  const u32 xbox[4] = {u32(bk), u32(halo ? kHaloW : tw),
                       u32(halo ? th + 2 : th), 1};
  const u64 wdims[2] = {9 * u64(cin), u64(cout)};
  const u64 wstrides[1] = {9 * u64(cin)};
  const u32 wbox[2] = {u32(bk), u32(bn)};
  const u64 odims[4] = {u64(cout), u64(w), u64(h), u64(n)};
  const u64 ostrides[3] = {u64(cout) * ob, u64(w) * cout * ob,
                           u64(h) * w * cout * ob};
  const u32 obox[4] = {u32(span / ob), u32(tw), u32(th), 1};
  const CUtensorMapDataType otype =
      mode == kRequant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : mode == kDequantF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, x, xdims, xstrides,
              xbox, bk) ||
      !encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, wdims, wstrides,
              wbox, bk) ||
      !encode(&omap, otype, 4, out, odims, ostrides, obox, span)) {
    return cudaErrorNotSupported;
  }

  Params p;
  p.scale = scale;
  p.bias = bias;
  p.cin = cin;
  p.th = th;
  p.tw = tw;
  p.tiles_y = tiles_y;
  p.tiles_x = tiles_x;
  p.n_tiles = cout / bn;
  p.tiles = static_cast<int>(tiles);
  p.bk = bk;
  p.stages = stages;
  p.relu = relu;
  p.mode = mode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256) {
    return run_bn<256>(xmap, wmap, omap, p, rows, halo, pp, blocks,
                       smem_bytes, device, s);
  }
  if (bn == 128) {
    return run_bn<128>(xmap, wmap, omap, p, rows, halo, pp, blocks,
                       smem_bytes, device, s);
  }
  return run_bn<64>(xmap, wmap, omap, p, rows, halo, pp, blocks, smem_bytes,
                    device, s);
}
