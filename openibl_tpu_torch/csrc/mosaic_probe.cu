// The layout probes of scripts/mosaic_probe.py for Hopper (sm_90a), CUDA C++
// with plain C entries.
//
// The TPU script asks, one tiny pallas_call each, which layout patterns the
// Mosaic compiler lowers (lane concat, sublane halo and stride-2 slices, a
// K=3 product, a LUT gather, an on-chip one-hot product). Each entry below
// asks the same question of Hopper with a kernel written for it. All of
// them run at the script's sizes, a few KB in and out, so every one is
// bound by its launch (the launch floor: mosaic_empty's device time, a
// microsecond or so), not by bytes or operations: their times there say
// nothing of speed at real sizes. P6 and P7, the two candidate inner loops
// of the PQ ADC scorer (csrc/pq_adc.cu), are also timed at a K2-sized
// shape by chip_smoke.py.
//
// Every entry takes contiguous row-major device pointers, launches on
// ``stream``, and returns the launch's cudaError_t (0 = ok): a launch the
// card refuses never runs, and only cudaGetLastError() reports it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using bf16_mma::mma_bf16;
using bf16_mma::split_bf16;

constexpr int kThreads = 256;

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

// P1/P2: out[r][i*width + j] = x[r][(pieces-1-i)*width + j], one thread per
// output element, consecutive threads on consecutive columns.
__global__ void concat_kernel(const float* __restrict__ x,
                              float* __restrict__ out, int rows, int width,
                              int pieces) {
  const int cols = width * pieces;
  const long long n = static_cast<long long>(rows) * cols;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(e / cols);
    const int c = static_cast<int>(e - static_cast<long long>(r) * cols);
    const int i = c / width;
    const int j = c - i * width;
    out[e] = x[static_cast<long long>(r) * cols + (pieces - 1 - i) * width +
               j];
  }
}

// P3: a block owns kTileRows output rows x 32 columns and stages the band of
// kTileRows + 2 input rows (the halo of a 3-tap) in shared memory; each
// staged row is read by up to three threads.
constexpr int kTileRows = 16;
constexpr int kTileCols = 32;

__global__ void sublane_offsets_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int rows_out,
                                       int cols) {
  __shared__ float band[kTileRows + 2][kTileCols];
  const int c = blockIdx.x * kTileCols + threadIdx.x;
  const int r0 = blockIdx.y * kTileRows;
  const int rows_in = rows_out + 2;
  for (int rr = threadIdx.y; rr < kTileRows + 2; rr += kTileRows) {
    const int r = r0 + rr;
    band[rr][threadIdx.x] =
        (r < rows_in && c < cols) ? x[static_cast<long long>(r) * cols + c]
                                  : 0.0f;
  }
  __syncthreads();
  const int r = r0 + threadIdx.y;
  if (r < rows_out && c < cols) {
    // (x[r] + x[r+1]) + x[r+2]: numpy's order, so the sum is the same bits
    const float s = band[threadIdx.y][threadIdx.x] +
                    band[threadIdx.y + 1][threadIdx.x];
    out[static_cast<long long>(r) * cols + c] =
        s + band[threadIdx.y + 2][threadIdx.x];
  }
}

// P4: out[r][c] = max(x[2r][c], x[2r+1][c]); NaN propagates, as in
// torch.maximum and np.maximum.
__global__ void sublane_stride2_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int rows_out,
                                       int cols) {
  const long long n = static_cast<long long>(rows_out) * cols;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / cols;
    const long long c = e - r * cols;
    const float a = x[2 * r * cols + c];
    const float b = x[(2 * r + 1) * cols + c];
    out[e] = (a != a || a >= b) ? a : b;
  }
}

// P5: out[m][n] = sum_k x[m][k] * w[k][n], f32 FMAs on the CUDA cores in
// k order (no TF32: its ~1e-3 rounding would miss the probe's 1e-4).
__global__ void k3_dot_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              float* __restrict__ out, int m, int k, int n) {
  const long long total = static_cast<long long>(m) * n;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = e / n;
    const int col = static_cast<int>(e - row * n);
    float acc = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      acc = fmaf(x[row * k + kk], w[static_cast<long long>(kk) * n + col],
                 acc);
    }
    out[e] = acc;
  }
}

// P6: out[r][c] = lut[r][idx[r][c]], K2's inner access pattern (a lookup in
// a table staged on chip). A block owns one LUT row and one contiguous range
// of its columns: it stages that row only (<= 1 KB, 16-byte loads where the
// row allows), then each thread reads 4 indices as one int4 and writes 4
// outputs as one float4, striding the range by the block. The int4 units of
// a row start at its first 16-byte boundary (``shift`` columns in); block 0
// of a row also does the <= 3 columns before it and the <= 3 after the last
// unit. Without 16-byte-aligned idx and out the same ranges go one column a
// thread. No division: the loops add and compare. An index outside
// [0, slots) gives NaN, never a read outside the table.
constexpr int kMaxSlots = 256;
constexpr int kGatherThreads = 256;

__device__ __forceinline__ float lut_at(const float* s_lut, int s,
                                        int slots) {
  return static_cast<unsigned>(s) < static_cast<unsigned>(slots)
             ? s_lut[s]
             : quiet_nan();
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kGatherThreads)
take_lut_kernel(const float* __restrict__ lut, const int* __restrict__ idx,
                float* __restrict__ out, int slots, int cols,
                int units_per_block) {
  __shared__ __align__(16) float s_lut[kMaxSlots];
  const long long e0 = static_cast<long long>(blockIdx.x) * cols;
  const float* row = lut + static_cast<long long>(blockIdx.x) * slots;
  const int* irow = idx + e0;
  float* orow = out + e0;
  const int vec_idx = aligned16(idx) && aligned16(out);
  const int head = vec_idx ? min(static_cast<int>((4 - (e0 & 3)) & 3), cols)
                           : 0;
  const int units = vec_idx ? (cols - head) >> 2 : 0;
  const int u0 = blockIdx.y * units_per_block;
  const int u1 = min(u0 + units_per_block, units);
  // the first unit's indices are in flight while the row is staged
  int u = u0 + threadIdx.x;
  int4 s = make_int4(0, 0, 0, 0);
  const int4* iv = reinterpret_cast<const int4*>(irow + head);
  if (u < u1) s = __ldg(iv + u);
  if ((slots & 3) == 0 && aligned16(row)) {
    for (int i = threadIdx.x; i < slots >> 2; i += blockDim.x) {
      reinterpret_cast<float4*>(s_lut)[i] =
          __ldg(reinterpret_cast<const float4*>(row) + i);
    }
  } else {
    for (int i = threadIdx.x; i < slots; i += blockDim.x) s_lut[i] = row[i];
  }
  __syncthreads();
  float4* ov = reinterpret_cast<float4*>(orow + head);
  while (u < u1) {
    ov[u] = make_float4(lut_at(s_lut, s.x, slots), lut_at(s_lut, s.y, slots),
                        lut_at(s_lut, s.z, slots), lut_at(s_lut, s.w, slots));
    u += blockDim.x;
    if (u < u1) s = __ldg(iv + u);
  }
  if (vec_idx) {
    if (blockIdx.y == 0) {  // the row's head and tail columns
      const int tail = head + 4 * units, n = head + cols - tail;
      if (threadIdx.x < n) {
        const int c = threadIdx.x < head ? threadIdx.x
                                         : tail + threadIdx.x - head;
        orow[c] = lut_at(s_lut, irow[c], slots);
      }
    }
  } else {  // one column a thread over the block's 4 x units_per_block
    const int c1 = min(4 * (u0 + units_per_block), cols);
    for (int c = 4 * u0 + threadIdx.x; c < c1; c += blockDim.x) {
      orow[c] = lut_at(s_lut, irow[c], slots);
    }
  }
}

// P7: out = lut . onehot(idx)^T, i.e. out[r][c] = lut[r][idx[c]], as a
// tensor-core product whose one-hot operand never leaves the registers.
// Written as out^T = onehot(idx) . lut^T: M = codes, N = LUT rows, K =
// slots, one mma.sync.m16n8k16 (bf16 in, f32 accumulators) per 16 codes x 8
// rows x 16 slots, 16 K steps (256 slots; slots past ``slots`` are zero).
//   * K order: within each 16-slot step, mma position h*8 + 2t + e holds
//     slot 4t + 2h + e (t = lane & 3). The one-hot does not care, and a
//     lane's B fragments of one step are then 4 consecutive LUT entries:
//     one 16-byte load;
//   * A, the one-hot: each lane sets its own fragment words from its two
//     codes' slots (a "key": the K step and half where its 1 lies, if in
//     its t), so no one-hot is stored anywhere;
//   * B, the LUT: the exact split x = hi + mid + lo into three bf16 parts
//     (hi = bf16_rn(x), mid = bf16_rn(x - hi), lo = bf16(x - hi - mid);
//     exact, since the residue after two parts has at most 8 bits). A warp
//     owns one 8-row N tile and holds its fragments of its K steps in
//     registers (all 16 steps: 64 LUT values a lane, 96 registers of
//     parts), loaded once;
//   * one accumulator per part, and per part two (even and odd K steps) to
//     halve the dependent chain. An output has exactly one non-zero term,
//     so each accumulator holds one bf16 part exactly (the other holds 0);
//     the tensor core never adds two parts. The CUDA cores then add
//     (hi + mid) + lo, which rebuilds x exactly: bit for bit lut[:, idx];
//   * indices: a warp walks a contiguous range of ``tiles_per_warp``
//     16-code tiles in batches of 8 tiles (128 codes, one 16-byte load a
//     lane), staged in its own 512 bytes of shared memory; the next batch's
//     load is in flight while the current batch's products run. No load
//     sits behind a branch: addresses are clamped and the values masked;
//   * K groups: where the codes are too few to give every warp of the card
//     a tile (the script's 128 codes make 8 tiles), the 4 warps of a block
//     share each tile, 4 K steps each, and add their partial results
//     through shared memory: a quarter of the loads, splits and dependent
//     products on each warp's path. An output's partials are 0 but one,
//     so the sum is exact.
// Exact for LUT entries that are 0 or of magnitude in [2^-103, 3.39e38):
// below, a part may fall under bf16's normal range (the tensor core may
// flush it); above, hi rounds to infinity. A NaN or infinite entry poisons
// its whole LUT row through 0 * inf (exact for finite LUT entries only, as
// any product with the one-hot). -0.0 comes out as +0.0. An index outside
// [0, slots) matches no slot and gives 0.
constexpr int kOnehotWarps = 4;
constexpr int kKSteps = kMaxSlots / 16;
constexpr int kBatchTiles = 8;  // 16-code tiles a warp stages at once

// A code's one-hot in lane t's A fragments: ``key`` = 2 * (K step) + half
// of the word that holds its 1, or -1 (not this lane's, past the codes or
// outside [0, slots)); ``word`` = that bf16 pair, 1.0 in the low or high
// half
__device__ __forceinline__ void onehot_key(int s, bool valid, int slots,
                                           int t, int& key, uint32_t& word) {
  valid = valid && static_cast<unsigned>(s) < static_cast<unsigned>(slots);
  key = valid && ((s >> 2) & 3) == t ? ((s >> 4) << 1) | ((s >> 1) & 1) : -1;
  word = (s & 1) ? 0x3f800000u : 0x3f80u;
}

// 4 codes from c on (clamped into the row; masked when used)
template <bool kVec>
__device__ __forceinline__ int4 load_codes(const int* idx, int c, int cols) {
  if (kVec && c + 3 < cols) {
    return __ldg(reinterpret_cast<const int4*>(idx + c));
  }
  return make_int4(__ldg(idx + min(c, cols - 1)),
                   __ldg(idx + min(c + 1, cols - 1)),
                   __ldg(idx + min(c + 2, cols - 1)),
                   __ldg(idx + min(c + 3, cols - 1)));
}

// output q of lane (g, t) of the 16-code tile at c0: d[q] of the mma,
// code c0 + g (+ 8 for q >= 2), LUT row n0 + 2t (+ 1 for odd q)
__device__ __forceinline__ void store_out(float* out, float v, int n0, int c0,
                                          int q, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  const int r = n0 + 2 * (lane & 3) + (q & 1);
  const int c = c0 + (lane >> 2) + (q >> 1) * 8;
  if (r < rows && c < cols) out[static_cast<long long>(r) * cols + c] = v;
}

// kVec: slots % 4 == 0 and 16-byte aligned lut and idx (one 16-byte load
// for a lane's B fragments of a K step, and for its 4 codes of a batch).
// kGroups: warps that share one run of code tiles, each on 16 / kGroups of
// the K steps (1, or 4: the whole block). With 4, each warp adds the four
// partial results of one of its lane's four outputs (three of them are 0,
// so the sum is exact) and stores it.
template <bool kVec, int kGroups>
__global__ void __launch_bounds__(kOnehotWarps * 32, 3)
onehot_dot_kernel(const float* __restrict__ lut, const int* __restrict__ idx,
                  float* __restrict__ out, int rows, int slots, int cols,
                  int tiles_per_warp) {
  constexpr int kSteps = kKSteps / kGroups;  // a warp's K steps
  __shared__ __align__(16) int s_codes[kOnehotWarps][kBatchTiles * 16];
  __shared__ float s_part[2][kGroups][4][32];  // partials, kGroups > 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp % kGroups;  // this warp's K steps start at kg * kSteps
  const int n0 = blockIdx.x * 8;
  const int tiles = (cols + 15) >> 4;
  const long long first =
      (static_cast<long long>(blockIdx.y) * (kOnehotWarps / kGroups) +
       warp / kGroups) * tiles_per_warp;
  // whole warps only, and a K group's warps together: no barrier is missed
  if (first >= tiles) return;
  const int tile0 = static_cast<int>(first);
  const int tile1 = min(tile0 + tiles_per_warp, tiles);
  int4 next = load_codes<kVec>(idx, tile0 * 16 + 4 * lane, cols);
  // B fragments of LUT row n0 + g, slots 16 ks + 4t .. + 3 of each K step
  const bool row_ok = n0 + g < rows;
  const float* lr =
      lut + static_cast<long long>(min(n0 + g, rows - 1)) * slots;
  float4 v[kSteps];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int k = (kg * kSteps + ks) * 16 + 4 * t;
    if (kVec) {
      v[ks] = __ldg(reinterpret_cast<const float4*>(lr + min(k, slots - 4)));
    } else {
      v[ks] = make_float4(__ldg(lr + min(k, slots - 1)),
                          __ldg(lr + min(k + 1, slots - 1)),
                          __ldg(lr + min(k + 2, slots - 1)),
                          __ldg(lr + min(k + 3, slots - 1)));
    }
  }
  uint32_t b[kSteps][3][2];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int k = (kg * kSteps + ks) * 16 + 4 * t;
    uint32_t p[3], q[3];
    split_bf16(row_ok && k < slots ? v[ks].x : 0.f,
               row_ok && k + 1 < slots ? v[ks].y : 0.f, p);
    split_bf16(row_ok && k + 2 < slots ? v[ks].z : 0.f,
               row_ok && k + 3 < slots ? v[ks].w : 0.f, q);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      b[ks][i][0] = p[i];
      b[ks][i][1] = q[i];
    }
  }
  int* codes = s_codes[warp];
  int parity = 0;
  for (int tb = tile0; tb < tile1; tb += kBatchTiles) {
    __syncwarp();
    reinterpret_cast<int4*>(codes)[lane] = next;
    __syncwarp();
    if (tb + kBatchTiles < tile1) {
      next = load_codes<kVec>(idx, (tb + kBatchTiles) * 16 + 4 * lane, cols);
    }
    const int nt = min(kBatchTiles, tile1 - tb);
    for (int j = 0; j < nt; ++j) {
      const int c0 = (tb + j) * 16;
      int ka, kb;
      uint32_t wa, wb;
      onehot_key(codes[j * 16 + g], c0 + g < cols, slots, t, ka, wa);
      onehot_key(codes[j * 16 + g + 8], c0 + g + 8 < cols, slots, t, kb, wb);
      ka -= 2 * kg * kSteps;  // keys relative to this warp's first K step
      kb -= 2 * kg * kSteps;
      float acc[2][3][4] = {};
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const uint32_t a[4] = {ka == 2 * ks ? wa : 0u, kb == 2 * ks ? wb : 0u,
                               ka == 2 * ks + 1 ? wa : 0u,
                               kb == 2 * ks + 1 ? wb : 0u};
#pragma unroll
        for (int i = 0; i < 3; ++i) mma_bf16(acc[ks & 1][i], a, b[ks][i]);
      }
      // d[0], d[1]: code c0 + g, rows n0 + 2t, + 1; d[2], d[3]: code + 8
      float res[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float hi = __fadd_rn(acc[0][0][q], acc[1][0][q]);
        const float mid = __fadd_rn(acc[0][1][q], acc[1][1][q]);
        const float lo = __fadd_rn(acc[0][2][q], acc[1][2][q]);
        res[q] = __fadd_rn(__fadd_rn(hi, mid), lo);
      }
      if (kGroups == 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          store_out(out, res[q], n0, c0, q, rows, cols);
        }
      } else {  // the block's warps are the K groups of one tile
#pragma unroll
        for (int q = 0; q < 4; ++q) s_part[parity][warp][q][lane] = res[q];
        __syncthreads();  // two buffers: one barrier a tile is enough
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kGroups; ++w) {
          sum = __fadd_rn(sum, s_part[parity][w][kg][lane]);
        }
        store_out(out, sum, n0, c0, kg, rows, cols);
        parity ^= 1;
      }
    }
  }
}

// The launch floor: no memory access, one warp
__global__ void empty_kernel() {}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 65535 ? (b > 0 ? b : 1) : 65535);
}

}  // namespace

// Replaces scripts/mosaic_probe.py:47 probe_concat (pallas_call at :39):
// column blocks of ``width`` in reverse order, (rows, width * pieces) f32.
// Bound: 2 x the array's bytes (1.7 KB at width 3, 36 KB at 64), so the
// launch. Asks: a gather of 3-wide (12-byte, unaligned to 16) column blocks
// with no vector loads, against 64-wide blocks.
extern "C" int mosaic_concat(const float* x, float* out, int rows, int width,
                             int pieces, void* stream) {
  if (rows < 1 || width < 1 || pieces < 1) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(rows) * width * pieces;
  concat_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, out, rows, width,
                                                       pieces);
  return cudaGetLastError();
}

// Replaces scripts/mosaic_probe.py:67 probe_sublane_offsets (pallas_call at
// :39): out[r] = (x[r] + x[r+1]) + x[r+2], x (rows_out + 2, cols) f32.
// Bound: 34 KB at (18, 256), so the launch. Asks: the halo read of a 3x3
// tap, rows at +0/+1/+2 shared by three threads through shared memory.
extern "C" int mosaic_sublane_offsets(const float* x, float* out,
                                      int rows_out, int cols, void* stream) {
  if (rows_out < 1 || cols < 1) return cudaErrorInvalidValue;
  const dim3 grid((cols + kTileCols - 1) / kTileCols,
                  (rows_out + kTileRows - 1) / kTileRows);
  sublane_offsets_kernel<<<grid, dim3(kTileCols, kTileRows), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, out, rows_out, cols);
  return cudaGetLastError();
}

// Replaces scripts/mosaic_probe.py:81 probe_sublane_stride2 (pallas_call at
// :39): out[r] = max(x[2r], x[2r+1]), x (2 * rows_out, cols) f32, a 2x1
// max-pool. Bound: 48 KB at (32, 256), so the launch. Asks: rows read at
// stride 2 with no relayout (a compile crash on the v5e).
extern "C" int mosaic_sublane_stride2(const float* x, float* out,
                                      int rows_out, int cols, void* stream) {
  if (rows_out < 1 || cols < 1) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(rows_out) * cols;
  sublane_stride2_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, out, rows_out, cols);
  return cudaGetLastError();
}

// Replaces scripts/mosaic_probe.py:95 probe_k3_dot (pallas_call at :108):
// (m, k) x (k, n) f32 with a tiny contraction (k = 3), f32 FMAs on CUDA
// cores. Bound: 34 KB and 49 kFLOP at (128, 3) x (3, 64), so the launch.
// Asks: a product whose depth is far below any tensor-core tile (wrong
// values on the v5e); here no tile is padded.
extern "C" int mosaic_k3_dot(const float* x, const float* w, float* out,
                             int m, int k, int n, void* stream) {
  if (m < 1 || k < 1 || n < 1) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(m) * n;
  k3_dot_kernel<<<blocks_for(total), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, w, out, m, k, n);
  return cudaGetLastError();
}

// Replaces scripts/mosaic_probe.py:119 probe_take_lut (pallas_call at
// :130): out[r][c] = lut[r][idx[r][c]], lut (rows, slots <= 256) f32, idx
// (rows, cols) int32. Asks: a dynamic gather from a table in shared memory,
// which Mosaic could not do along lanes (so K2's TPU kernel built a one-hot
// instead). Grid (rows, blocks_per_row) of kGatherThreads, each block on
// units_per_block int4 units of its row (tools/mosaic_probe.py:
// take_lut_geometry; they must cover the row). What bounds it on the H100:
// at the script's (8, 256) / (8, 128), 16 KB, far below the launch floor,
// so the launch; the design keeps the launch short (one block per row, one
// 16-byte index load in flight beside the staging, one float4 store a
// thread) where the design it replaces ran one block that staged 8 rows
// with a division per element. At a K2-sized (64, 256) / (64, 100000),
// the bytes (51 MB: idx read once, out written once): 1,088 blocks on
// contiguous ranges stream them with 16-byte accesses.
extern "C" int mosaic_take_lut(const float* lut, const int* idx, float* out,
                               int rows, int slots, int cols,
                               int blocks_per_row, int units_per_block,
                               void* stream) {
  if (rows < 1 || cols < 1 || slots < 1 || slots > kMaxSlots ||
      blocks_per_row < 1 || blocks_per_row > 65535 || units_per_block < 1 ||
      4LL * blocks_per_row * units_per_block < cols) {
    return cudaErrorInvalidValue;
  }
  take_lut_kernel<<<dim3(rows, blocks_per_row), kGatherThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(lut, idx, out, slots,
                                                         cols,
                                                         units_per_block);
  return cudaGetLastError();
}

// Replaces scripts/mosaic_probe.py:141 probe_onehot_dot (pallas_call at
// :161): out = lut . onehot(idx)^T, lut (rows, slots <= 256) f32, idx
// (cols,) int32. Asks: a one-hot built on chip and fed to the matrix unit
// without a round trip through memory, the formulation of a tensor-core K2
// (wrong values on the v5e). Grid (ceil(rows / 8), blocks) of kOnehotWarps
// warps; each run of tiles_per_warp 16-code tiles goes to one warp
// (k_groups 1) or to the block's 4 warps as K groups (k_groups 4)
// (tools/mosaic_probe.py: onehot_dot_geometry; the runs must cover the
// codes). What bounds it on the H100: at the script's (8, 256) x (256,
// 128), 13 KB and 3 x 1 MFLOP of bf16, far below the launch floor, so the
// launch: 32 warps in K groups, each one global round trip (its 16 LUT
// values and its indices together), 8 splits, a chain of 2 products and
// one barrier, where the design it replaces staged a 32 x 256 f32 one-hot
// and a LUT band in shared memory (8,192 stores a block) and then ran 256
// dependent f32 FMAs a thread. At a K2-sized (64, 256) x (256, 100000):
// the function moves 26 MB (0.0078 ms), but the design's own work, 3 bf16
// products of 2 x 64 x 256 x 100000 (9.8 GFLOP, 0.0099 ms at 989
// TFLOP/s), is the larger: by construction it reaches at most ~79% of the
// bytes bound.
extern "C" int mosaic_onehot_dot(const float* lut, const int* idx, float* out,
                                 int rows, int slots, int cols,
                                 int tiles_per_warp, int blocks, int k_groups,
                                 void* stream) {
  if (rows < 1 || cols < 1 || slots < 1 || slots > kMaxSlots ||
      tiles_per_warp < 1 || blocks < 1 || blocks > 65535 ||
      (k_groups != 1 && k_groups != kOnehotWarps) ||
      16LL * (kOnehotWarps / k_groups) * tiles_per_warp * blocks < cols) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((rows + 7) / 8, blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (slots & 3) == 0 && aligned16(lut) && aligned16(idx);
  if (vec && k_groups == 1) {
    onehot_dot_kernel<true, 1><<<grid, kOnehotWarps * 32, 0, st>>>(
        lut, idx, out, rows, slots, cols, tiles_per_warp);
  } else if (vec) {
    onehot_dot_kernel<true, kOnehotWarps><<<grid, kOnehotWarps * 32, 0, st>>>(
        lut, idx, out, rows, slots, cols, tiles_per_warp);
  } else if (k_groups == 1) {
    onehot_dot_kernel<false, 1><<<grid, kOnehotWarps * 32, 0, st>>>(
        lut, idx, out, rows, slots, cols, tiles_per_warp);
  } else {
    onehot_dot_kernel<false, kOnehotWarps><<<grid, kOnehotWarps * 32, 0, st>>>(
        lut, idx, out, rows, slots, cols, tiles_per_warp);
  }
  return cudaGetLastError();
}

// Not a probe: an empty kernel of one warp, no memory access. Its device
// time is the launch floor, the least time any kernel occupies the card,
// which chip_smoke.py measures and counts in every kernel's bound.
extern "C" int mosaic_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
