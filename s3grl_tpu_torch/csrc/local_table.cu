// Subgraph-local neighbor tables for a batch of node sets, on Hopper (sm_90a).
//
// No TPU counterpart: the JAX package builds this table on the host
// (s3grl_tpu/native/graphcore.cpp, gc_khop_local_tab) and copies it to the
// chip every batch. Here the card builds it from what is already there: the
// node sets and the global neighbor table. For subgraph b and member row s
// (node g = nodes[b, s]) the row lists, in the order of nbr[g, 0:deg[g]],
// the local slot of every neighbor that is a member of the same subgraph,
// with the target link removed from rows 0 and 1 (reference utils.py:78-80):
//     loc[b, s, 0:n)  = those slots (n, the row's local degree),  w = 1
//     loc[b, s, n:W)  = -1,                                       w = 0
// The caller's W is one no row's local degree passes (ops/local_table.py).
// Rows of empty slots are all -1. Keeping the global table's order keeps the
// order in which the global-id route's selector meets the same entries, so
// pos_power_rows adds them in the same order and gives the same bits.
//
// What bounds it on an H100: bytes. It reads the node sets and the member
// rows' live entries of the global table, and writes the table and its
// weights, 8 bytes an entry of width W. At the hub batch (B = 32, S = 1,024,
// W = 1,024) the writes are 268 MB and dominate.
//
// Design: the grid is (block of kRows rows, subgraph), so B = 32 subgraphs
// of 1,024 rows make 512 blocks and fill the card (a block per subgraph
// would leave 100 of 132 SMs idle). Each block hashes its subgraph's member
// ids into an open-addressing table id -> slot in shared memory (T >= 2S
// cells, at most half full; 16 KB at S = 1,024). A warp takes one row, reads
// its live prefix 32 entries at a time (coalesced), looks each id up, and
// writes the hits compacted in order by __ballot_sync and __popc, then pads
// the row. Nothing is added by atomics, so every run writes the same table.
// One launch builds a batch's table: W is the width no row can pass, so no
// count has to reach the host first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;  // rows of one subgraph per block
constexpr unsigned kFull = 0xffffffffu;

// log2 of the hash table's cells: the least power of two >= 2S (>= 2).
__host__ __device__ __forceinline__ int hash_log(int S) {
  int l = 1;
  while ((1 << l) < 2 * S) ++l;
  return l;
}

__device__ __forceinline__ int hash_of(int id, int log_t) {
  return static_cast<int>((static_cast<unsigned>(id) * 2654435761u) >> (32 - log_t));
}

__global__ void __launch_bounds__(kThreads)
local_table_kernel(const int* __restrict__ nbr,                // [N, D_tab] global ids
                   const int* __restrict__ deg,                // [N] live prefix of each row
                   int64_t D_tab,
                   const int* __restrict__ nodes,              // [B, S] global ids
                   const unsigned char* __restrict__ node_mask,  // [B, S] member slots
                   const int* __restrict__ links,              // [B, 2] (src, dst)
                   int S, int W, int log_t,
                   int* __restrict__ loc,                      // [B, S, W]
                   float* __restrict__ w) {                    // [B, S, W]
  extern __shared__ int smem[];
  const int T = 1 << log_t;
  int* hkeys = smem;       // [T] member ids, -1 empty
  int* hslots = smem + T;  // [T] their slots
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* nodes_b = nodes + static_cast<int64_t>(b) * S;
  const unsigned char* mask_b = node_mask + static_cast<int64_t>(b) * S;

  for (int i = tid; i < T; i += kThreads) {
    hkeys[i] = -1;
    hslots[i] = -1;
  }
  __syncthreads();
  // Member ids are unique; where one repeats, its last slot wins (as in the
  // host table build), whatever order the threads insert in.
  for (int j = tid; j < S; j += kThreads) {
    if (!mask_b[j]) continue;
    const int id = nodes_b[j];
    for (int p = hash_of(id, log_t);; p = (p + 1) & (T - 1)) {
      const int prev = atomicCAS(&hkeys[p], -1, id);
      if (prev == -1 || prev == id) {
        atomicMax(&hslots[p], j);
        break;
      }
    }
  }
  __syncthreads();

  const int src = links[2 * static_cast<int64_t>(b)];
  const int dst = links[2 * static_cast<int64_t>(b) + 1];
  const int s_end = min(S, static_cast<int>(blockIdx.x + 1) * kRows);
  for (int s = blockIdx.x * kRows + warp; s < s_end; s += kWarps) {
    const int64_t out = (static_cast<int64_t>(b) * S + s) * W;
    int n = 0;
    if (mask_b[s]) {
      const int g = nodes_b[s];
      const int live = deg[g];
      // The target link's entry leaves rows 0 (src) and 1 (dst).
      const int drop = s == 0 ? dst : (s == 1 ? src : -1);
      const int* row = nbr + static_cast<int64_t>(g) * D_tab;
      for (int d0 = 0; d0 < live; d0 += 32) {  // `live` is the same in every lane
        const int d = d0 + lane;
        int slot = -1;
        if (d < live) {
          const int id = row[d];
          if (id >= 0 && id != drop) {
            for (int p = hash_of(id, log_t);; p = (p + 1) & (T - 1)) {
              const int key = hkeys[p];
              if (key == id) {
                slot = hslots[p];
                break;
              }
              if (key == -1) break;
            }
          }
        }
        const unsigned hit = __ballot_sync(kFull, slot >= 0);
        if (slot >= 0) {
          const int i = n + __popc(hit & ((1u << lane) - 1u));
          if (i < W) {
            loc[out + i] = slot;
            w[out + i] = 1.f;
          }
        }
        n += __popc(hit);
      }
    }
    for (int i = n + lane; i < W; i += 32) {
      loc[out + i] = -1;
      w[out + i] = 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes: the hash table's keys
// and slots.
int64_t s3grl_local_table_smem(int S) { return int64_t{8} << hash_log(S); }

// One launch on `stream` that writes the table at width W. Returns the
// cudaError_t of the launch (0 = success).
int s3grl_local_table(const int* nbr, const int* deg, int64_t D_tab, const int* nodes,
                      const unsigned char* node_mask, const int* links, int B, int S,
                      int W, int* loc, float* w, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int log_t = hash_log(S);
  const int64_t smem = s3grl_local_table_smem(S);
  cudaError_t err = cudaFuncSetAttribute(
      local_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, B);
  local_table_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nbr, deg, D_tab, nodes, node_mask, links, S, W, log_t, loc, w);
  return static_cast<int>(cudaGetLastError());
}

const char* s3grl_local_table_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
