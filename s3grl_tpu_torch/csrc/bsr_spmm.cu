// Sparse SpMM Y = M @ X on Hopper (sm_90a), float32, walking only M's nonzeros.
//
// Replaces the TPU kernel s3grl_tpu/ops/spmm_pallas.py::_bsr_spmm_padded.
// The TPU kernel multiplies M's 128×128 dense blocks on the matrix unit. On
// the graphs it serves those blocks are mostly zeros (97.5 % on the
// USAir-shaped main path, 99.87 % on a Cora-shaped graph), so here M comes in
// the CSR form that blockify() reads out of the same blocks: row_ptr [N+1],
// cols [nnz], vals [nnz], sorted by (row, column). X and Y are [N, C],
// row-major, unpadded.
//
// What bounds it on an H100: bytes. The least traffic is the nonzeros (value
// and column, 8 bytes each) with X read and Y written once,
// nnz·8 + 2·N·C·4 bytes, for 2·nnz·C FLOP: well under one FLOP per byte.
//
// Design: W warps own one output row and a tile of 32·V columns (V = 1, 2
// or 4 floats a lane, picked by the launcher from C). Each warp walks its
// share of the row's nonzeros, 32 at a time: each lane loads one
// (col, val) pair and __shfl_sync hands each pair to the whole warp, which
// reads row `col` of X coalesced along the columns and accumulates in the
// row's order with f32 FMA (no TF32). W = 1 where no row has more than 32
// nonzeros; else W = 4, warp w taking the nonzeros' 32-runs w, w + 4, ...,
// so a hub row's chain of dependent loads is a quarter as long, and the
// four partial tiles are added in a fixed order in shared memory. No
// atomics, so two runs give the same bits; an empty row writes 0. Y is
// written once. An X row is read again for every nonzero that names it; X
// (1.4 MB on the main path, 15.5 MB on the Cora shape) stays in the 50 MB
// L2, so those re-reads are L2 hits. Rows of C = 1,025 floats are not
// 16-byte aligned, so X is read with scalar loads; where C % 4 == 0 and X
// and Y are 16-byte aligned, with float4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLongRow = 32;  // rows longer than this are split over kSplit warps
constexpr int kSplit = 4;

// Column of accumulator q of lane `lane` in a tile starting at col0: scalar
// route col0 + q·32 + lane; float4 route (V = 4) col0 + lane·4 + q.
template <bool kVec4>
__device__ __forceinline__ int col_of(int col0, int lane, int q) {
  return kVec4 ? col0 + lane * 4 + q : col0 + q * 32 + lane;
}

template <int V, int W, bool kVec4>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const int* __restrict__ row_ptr,  // [N + 1]
                const int* __restrict__ cols,     // [nnz]
                const float* __restrict__ vals,   // [nnz]
                const float* __restrict__ x,      // [N, C]
                float* __restrict__ y,            // [N, C]
                int N, int C, int n_tiles) {
  static_assert(!kVec4 || V == 4, "the float4 route keeps 4 floats a lane");
  __shared__ float part[W > 1 ? kWarps : 1][32 * V];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * (kWarps / W) + warp / W;
  const bool active = item < static_cast<int64_t>(N) * n_tiles;
  if (W == 1 && !active) return;  // whole warps only
  const int row = active ? static_cast<int>(item / n_tiles) : 0;
  const int col0 = active ? static_cast<int>(item % n_tiles) * (32 * V) : C;

  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.f;

  const int first = active ? row_ptr[row] : 0;
  const int last = active ? row_ptr[row + 1] : 0;
  for (int base = first + (warp % W) * 32; base < last; base += 32 * W) {
    const int n = min(32, last - base);  // the same in every lane
    int my_c = 0;
    float my_v = 0.f;
    if (lane < n) {
      my_c = __ldg(cols + base + lane);
      my_v = __ldg(vals + base + lane);
    }
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int c = __shfl_sync(kFull, my_c, j);
      const float v = __shfl_sync(kFull, my_v, j);
      const float* xr = x + static_cast<int64_t>(c) * C;
      if constexpr (kVec4) {
        if (col_of<true>(col0, lane, 0) < C) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(xr + col_of<true>(col0, lane, 0)));
          acc[0] = fmaf(v, t.x, acc[0]);
          acc[1] = fmaf(v, t.y, acc[1]);
          acc[2] = fmaf(v, t.z, acc[2]);
          acc[3] = fmaf(v, t.w, acc[3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int col = col_of<false>(col0, lane, q);
          if (col < C) acc[q] = fmaf(v, __ldg(xr + col), acc[q]);
        }
      }
    }
  }

  if constexpr (W > 1) {
#pragma unroll
    for (int q = 0; q < V; ++q) part[warp][q * 32 + lane] = acc[q];
    __syncthreads();
    if (!active || warp % W != 0) return;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      acc[q] = part[warp][q * 32 + lane];
#pragma unroll
      for (int w = 1; w < W; ++w) acc[q] += part[warp + w][q * 32 + lane];
    }
  }
  float* yr = y + static_cast<int64_t>(row) * C;
  if constexpr (kVec4) {
    const int col = col_of<true>(col0, lane, 0);
    if (col < C) *reinterpret_cast<float4*>(yr + col) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int col = col_of<false>(col0, lane, q);
      if (col < C) yr[col] = acc[q];
    }
  }
}

template <int V, bool kVec4>
cudaError_t launch(const int* row_ptr, const int* cols, const float* vals,
                   const float* x, float* y, int N, int C, int max_row,
                   cudaStream_t stream) {
  const int n_tiles = (C + 32 * V - 1) / (32 * V);
  const int w = max_row > kLongRow ? kSplit : 1;
  const int64_t items = static_cast<int64_t>(N) * n_tiles;
  const int64_t blocks = (items + kWarps / w - 1) / (kWarps / w);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (w == 1) {
    csr_spmm_kernel<V, 1, kVec4><<<grid, kThreads, 0, stream>>>(row_ptr, cols, vals, x, y, N, C, n_tiles);
  } else {
    csr_spmm_kernel<V, kSplit, kVec4><<<grid, kThreads, 0, stream>>>(row_ptr, cols, vals, x, y, N, C, n_tiles);
  }
  return cudaGetLastError();
}

// Floats a lane keeps (V) for C columns on the scalar route.
int lane_width(int C) { return C <= 32 ? 1 : C <= 64 ? 2 : 4; }

}  // namespace

extern "C" {

// Launch on `stream`; `max_row` is the most nonzeros in a row of M.
// Returns the cudaError_t of the launch (0 = success).
int s3grl_csr_spmm(const int* row_ptr, const int* cols, const float* vals,
                   const float* x, float* y, int N, int C, int max_row, void* stream) {
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4) {
    err = launch<4, true>(row_ptr, cols, vals, x, y, N, C, max_row, s);
  } else {
    switch (lane_width(C)) {
      case 1: err = launch<1, false>(row_ptr, cols, vals, x, y, N, C, max_row, s); break;
      case 2: err = launch<2, false>(row_ptr, cols, vals, x, y, N, C, max_row, s); break;
      default: err = launch<4, false>(row_ptr, cols, vals, x, y, N, C, max_row, s); break;
    }
  }
  return static_cast<int>(err);
}

const char* s3grl_csr_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
