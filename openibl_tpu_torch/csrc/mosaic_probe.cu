// The layout probes of scripts/mosaic_probe.py for Hopper (sm_90a), CUDA C++
// with plain C entries.
//
// The TPU script asks, one tiny pallas_call each, which layout patterns the
// Mosaic compiler lowers (lane concat, sublane halo and stride-2 slices, a
// K=3 product, a LUT gather, an on-chip one-hot product). Each entry below
// asks the same question of Hopper with a kernel written for it. All of
// them run at the script's sizes, a few KB in and out, so every one is
// bound by its launch (a few microseconds), not by bytes or operations:
// their times say nothing of speed at real sizes.
//
// Every entry takes contiguous row-major device pointers, launches on
// ``stream``, and returns the launch's cudaError_t (0 = ok): a launch the
// card refuses never runs, and only cudaGetLastError() reports it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// P6: out[r][c] = lut[r][idx[r][c]]. A block stages kLutRows rows of the
// LUT (8 x 256 f32 = 8 KB) in shared memory, then each thread gathers one
// entry: K2's inner access pattern. An index outside [0, slots) gives NaN,
// never a read outside the table.
constexpr int kLutRows = 8;
constexpr int kMaxSlots = 256;

__global__ void take_lut_kernel(const float* __restrict__ lut,
                                const int* __restrict__ idx,
                                float* __restrict__ out, int rows, int slots,
                                int cols) {
  __shared__ float s_lut[kLutRows][kMaxSlots];
  const int r0 = blockIdx.x * kLutRows;
  const int nr = min(kLutRows, rows - r0);
  for (int i = threadIdx.x; i < nr * slots; i += blockDim.x) {
    const int rr = i / slots;
    const int s = i - rr * slots;
    s_lut[rr][s] = lut[static_cast<long long>(r0 + rr) * slots + s];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * cols; i += blockDim.x) {
    const int rr = i / cols;
    const long long e =
        static_cast<long long>(r0 + rr) * cols + (i - rr * cols);
    const int s = idx[e];
    out[e] = (s >= 0 && s < slots) ? s_lut[rr][s] : quiet_nan();
  }
}

// P7: out[r][c] = sum_s lut[r][s] * onehot[c][s], onehot[c][s] = (s ==
// idx[c]), built in shared memory from an index comparison and fed to an
// f32 product over all slots. The whole (128, 256) f32 one-hot would be
// 128 KB, above the 48 KB of static shared memory, so a block builds the
// one-hot of kCodes codes only (32 x 257 f32, padded a column so a warp's
// 32 codes fall in 32 banks) beside kLutRows LUT rows: 41 KB. One thread
// per (r, c) of the tile. One non-zero term per sum, so the result is
// lut[r][idx[c]] exactly for finite LUT entries; an index outside
// [0, slots) gives 0, as the one-hot comparison does.
constexpr int kCodes = 32;

__global__ void onehot_dot_kernel(const float* __restrict__ lut,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, int rows,
                                  int slots, int cols) {
  __shared__ float s_lut[kLutRows][kMaxSlots];
  __shared__ float s_hot[kCodes][kMaxSlots + 1];
  const int c0 = blockIdx.x * kCodes;
  const int r0 = blockIdx.y * kLutRows;
  const int tid = threadIdx.y * kCodes + threadIdx.x;
  const int nthreads = kCodes * kLutRows;
  for (int i = tid; i < kLutRows * slots; i += nthreads) {
    const int rr = i / slots;
    const int s = i - rr * slots;
    s_lut[rr][s] =
        r0 + rr < rows ? lut[static_cast<long long>(r0 + rr) * slots + s]
                       : 0.0f;
  }
  for (int i = tid; i < kCodes * slots; i += nthreads) {
    const int cc = i / slots;
    const int s = i - cc * slots;
    s_hot[cc][s] = (c0 + cc < cols && idx[c0 + cc] == s) ? 1.0f : 0.0f;
  }
  __syncthreads();
  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  if (r < rows && c < cols) {
    float acc = 0.0f;
    for (int s = 0; s < slots; ++s) {
      acc = fmaf(s_lut[threadIdx.y][s], s_hot[threadIdx.x][s], acc);
    }
    out[static_cast<long long>(r) * cols + c] = acc;
  }
}

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
// (rows, cols) int32. Bound: 16 KB at (8, 256) / (8, 128), so the launch.
// Asks: a dynamic gather from a table in shared memory, which Mosaic could
// not do along lanes (so K2's TPU kernel built a one-hot instead).
extern "C" int mosaic_take_lut(const float* lut, const int* idx, float* out,
                               int rows, int slots, int cols, void* stream) {
  if (rows < 1 || cols < 1 || slots < 1 || slots > kMaxSlots) {
    return cudaErrorInvalidValue;
  }
  take_lut_kernel<<<(rows + kLutRows - 1) / kLutRows, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(lut, idx, out, rows,
                                                         slots, cols);
  return cudaGetLastError();
}

// Replaces scripts/mosaic_probe.py:141 probe_onehot_dot (pallas_call at
// :161): out = lut . onehot(idx)^T, lut (rows, slots <= 256) f32, idx
// (cols,) int32. Bound: 13 KB moved and 0.5 MFLOP of f32 product at
// (8, 256) x (256, 128), so the launch. Asks: a one-hot built on chip and
// fed to a product without a round trip through device memory, the
// formulation of a tensor-core K2 (wrong values on the v5e).
extern "C" int mosaic_onehot_dot(const float* lut, const int* idx, float* out,
                                 int rows, int slots, int cols,
                                 void* stream) {
  if (rows < 1 || cols < 1 || slots < 1 || slots > kMaxSlots) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((cols + kCodes - 1) / kCodes,
                  (rows + kLutRows - 1) / kLutRows);
  onehot_dot_kernel<<<grid, dim3(kCodes, kLutRows), 0,
                      static_cast<cudaStream_t>(stream)>>>(lut, idx, out,
                                                           rows, slots, cols);
  return cudaGetLastError();
}
