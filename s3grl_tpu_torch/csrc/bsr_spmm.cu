// Block-sparse (BSR) SpMM Y = M @ X on Hopper (sm_90a), float32.
//
// Replaces the TPU kernel s3grl_tpu/ops/spmm_pallas.py::_bsr_spmm_padded.
// M is stored as NB dense 128×128 blocks sorted by row block; row block r
// owns blocks row_ptr[r] .. row_ptr[r+1], and block j covers the columns
// (X's rows) block_cols[j]*128 .. +127. X is [N, C] and Y is [N, C], both
// row-major with no padding: the kernel masks rows >= N and columns >= C.
//
// The TPU kernel sums a row block across consecutive grid steps, which run
// in order there. Blocks of a CUDA grid run in no order, so here one thread
// block owns one (row block, 128-column tile of X) and loops over that row
// block's nonzero blocks itself, keeping the sum in registers, and writes
// its output tile once: no atomics, no second pass, and a fixed summation
// order, so a run repeats bit for bit. A row block with no blocks writes 0.
//
// What bounds it on an H100: operations. Per nonzero block it does
// 2·128²·C FLOP on 64 KB of M and 512·C bytes of X, about 128 FLOP per
// byte at any C, above the card's f32 ratio (67 TFLOP/s over 3.35 TB/s,
// about 20). So the design is a register-tiled f32 product: each k-slice of
// 32 columns of a block (transposed, 16.5 KB) and the matching 32 rows of
// the X tile (16 KB) are staged in shared memory; each of 256 threads keeps
// an 8×8 tile of the 128×128 output in registers (rows and columns in two
// strips of 4, so shared-memory reads are 16-byte and conflict-free) and
// does 64 FMA per 4 shared loads. The next slice's global loads are issued
// into registers before the current slice's FMAs, to hide their latency.
// f32 throughout, no TF32 (the port's precision rule); tensor cores are
// later work. X rows need not be 16-byte aligned (C = 1,025 on the main
// path), so X is read with scalar loads, coalesced along a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 128;       // block size of the BSR layout
constexpr int kTile = 128;     // output columns per thread block
constexpr int kSlice = 32;     // k depth staged per step
constexpr int kThreads = 256;
constexpr int kPadA = 4;       // keeps rows of the transposed slice 16-byte aligned
constexpr int kSteps = kBS / kSlice;
// Per thread and step: M slice 128×32 = 4 float4, X slice 32×128 = 16 floats.
constexpr int kLoadsA = kBS * kSlice / 4 / kThreads;
constexpr int kLoadsB = kSlice * kTile / kThreads;

__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ blocks,    // [NB, 128, 128]
                const int* __restrict__ row_ptr,     // [n_rb + 1]
                const int* __restrict__ block_cols,  // [NB]
                const float* __restrict__ x,         // [N, C]
                float* __restrict__ y,               // [N, C]
                int N, int C) {
  __shared__ __align__(16) float As[kSlice][kBS + kPadA];  // M slice, k-major
  __shared__ __align__(16) float Bs[kSlice][kTile];        // X slice

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group
  const int ty = tid >> 4;   // row group
  const int col0 = blockIdx.x * kTile;
  const int r = blockIdx.y;
  const int first = row_ptr[r];
  const int n_steps = (row_ptr[r + 1] - first) * kSteps;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra[kLoadsA];
  float rb[kLoadsB];
  auto load = [&](int step) {
    const int blk = first + step / kSteps;
    const int k0 = (step % kSteps) * kSlice;
    const float* m = blocks + static_cast<int64_t>(blk) * kBS * kBS;
#pragma unroll
    for (int q = 0; q < kLoadsA; ++q) {
      const int i = tid + q * kThreads;  // float4 index in the 128×32 slice
      const int row = i / (kSlice / 4), kq = i % (kSlice / 4);
      ra[q] = *reinterpret_cast<const float4*>(m + row * kBS + k0 + kq * 4);
    }
    const int64_t xrow0 = static_cast<int64_t>(block_cols[blk]) * kBS + k0;
#pragma unroll
    for (int q = 0; q < kLoadsB; ++q) {
      const int i = tid + q * kThreads;
      const int kk = i / kTile, n = i % kTile;
      const int64_t xr = xrow0 + kk;
      const int col = col0 + n;
      rb[q] = (xr < N && col < C) ? x[xr * C + col] : 0.f;
    }
  };

  if (n_steps > 0) load(0);
  for (int step = 0; step < n_steps; ++step) {
#pragma unroll
    for (int q = 0; q < kLoadsA; ++q) {
      const int i = tid + q * kThreads;
      const int row = i / (kSlice / 4), kq = i % (kSlice / 4);
      As[kq * 4 + 0][row] = ra[q].x;
      As[kq * 4 + 1][row] = ra[q].y;
      As[kq * 4 + 2][row] = ra[q].z;
      As[kq * 4 + 3][row] = ra[q].w;
    }
#pragma unroll
    for (int q = 0; q < kLoadsB; ++q) {
      const int i = tid + q * kThreads;
      Bs[i / kTile][i % kTile] = rb[q];
    }
    __syncthreads();
    if (step + 1 < n_steps) load(step + 1);
#pragma unroll 8
    for (int k = 0; k < kSlice; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise with tx.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r * kBS + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < C) y[static_cast<int64_t>(row) * C + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int s3grl_bsr_spmm(const float* blocks, const int* row_ptr, const int* block_cols,
                   const float* x, float* y, int n_rb, int N, int C, void* stream) {
  const dim3 grid((C + kTile - 1) / kTile, n_rb);
  bsr_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, row_ptr, block_cols, x, y, N, C);
  return static_cast<int>(cudaGetLastError());
}

const char* s3grl_bsr_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
